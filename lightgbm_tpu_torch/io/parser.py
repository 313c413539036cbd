"""Text data loading — PyTorch-port copy of lightgbm_tpu/io/parser.py (host
code, no torch), the counterpart of the reference's Parser
(src/io/parser.cpp) and the text-file half of DatasetLoader
(src/io/dataset_loader.cpp).

Format auto-detection mirrors Parser::CreateParser: sniff the first
non-empty lines; ':'-separated index:value tokens ⇒ LibSVM, otherwise the
delimiter (tab/comma/space) picks TSV/CSV.  Side files ``<data>.weight``
and ``<data>.query`` are picked up like Metadata::Init (metadata.cpp).

Parsing is delegated to the chunked readers in data/reader.py (native
multithreaded parser per block, pandas C engine fallback) — the SAME code
path the streamed ingest (data/ingest.py) uses, so single-shot and streaming
loads cannot drift.  This module keeps the column-role slicing
(label/weight/group/ignore) and side-file conventions.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from ..config import Config
from ..utils.log import Log


def sniff_format(path: str, max_lines: int = 32) -> Tuple[str, Optional[str]]:
    """Returns (kind, sep) where kind in {'libsvm','csv','tsv'}."""
    lines: List[str] = []
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if line:
                lines.append(line)
            if len(lines) >= max_lines:
                break
    if not lines:
        Log.fatal("Data file %s is empty", path)
    colon_hits = 0
    for ln in lines:
        toks = ln.replace("\t", " ").split()
        # LibSVM: all tokens after the first look like idx:value
        if len(toks) > 1 and all(":" in t for t in toks[1:]):
            colon_hits += 1
    if colon_hits == len(lines):
        return "libsvm", None
    first = lines[0]
    if "\t" in first:
        return "tsv", "\t"
    if "," in first:
        return "csv", ","
    return "tsv", r"\s+"


def load_text_file(
    path: str, config: Config
) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray], Optional[np.ndarray], List[str], int]:
    """Load a training/validation text file.

    Returns (features, label, weights, group_sizes, feature_names, label_idx).
    ``features`` excludes the label/weight/group/ignored columns, matching how
    the reference's parsers emit (feature_idx, value) pairs with the label
    split out.
    """
    # the same chunked readers as the streaming ingest (data/reader.py),
    # so dense and streaming loads cannot drift; imported lazily, since
    # data/ sits above io/
    from ..data.reader import DenseChunkReader, LibSVMChunkReader

    policy = getattr(config, "bad_row_policy", "error")
    kind, sep = sniff_format(path)
    if kind == "libsvm":
        raw, label = LibSVMChunkReader(path, bad_row_policy=policy).read_all()
        names = [f"Column_{i}" for i in range(raw.shape[1])]
        label_idx = 0
        weights, group = _side_files(path, raw.shape[0])
        return raw, label, weights, group, names, label_idx

    mat, names = DenseChunkReader(path, sep, config.has_header,
                                  bad_row_policy=policy).read_all()
    roles = resolve_roles(config, names, mat.shape[1])
    label = mat[:, roles.label_idx].astype(np.float32)
    weights = None if roles.weight_col < 0 else mat[:, roles.weight_col].astype(np.float32)
    group = None if roles.group_col < 0 else group_sizes_from_ids(mat[:, roles.group_col])
    features = mat[:, roles.keep]
    # side files fill whatever the columns did not give (metadata.cpp)
    fweights, fgroup = _side_files(path, features.shape[0])
    return (features, label, fweights if weights is None else weights,
            fgroup if group is None else group, roles.feat_names, roles.label_idx)


@dataclass
class ColumnRoles:
    """Label/weight/group/ignore column assignment over the FULL parsed
    column set, shared by the in-memory load and the streamed ingest
    (data/ingest.py), so both pick identical feature columns."""

    label_idx: int = 0
    weight_col: int = -1
    group_col: int = -1
    keep: List[int] = field(default_factory=list)
    feat_names: List[str] = field(default_factory=list)


def resolve_roles(config: Config, names: Optional[List[str]], ncols: int) -> ColumnRoles:
    """The columns' roles in a dense file of ``ncols`` columns (header
    ``names`` or None).  Numeric weight/group/ignore indices in the
    reference do NOT count the label column (config.h:119-133) and shift
    past it; ``name:`` indices are header-absolute already."""
    label_idx, _ = _resolve_column(config.label_column, names, default=0)
    weight_idx, weight_abs = _resolve_column(config.weight_column, names, default=-1)
    group_idx, group_abs = _resolve_column(config.group_column, names, default=-1)
    ignore = _resolve_columns(config.ignore_column, names)

    def absolute(idx: int, is_name: bool) -> int:
        if idx < 0 or is_name:
            return idx
        return idx if idx < label_idx else idx + 1

    roles = ColumnRoles(label_idx=label_idx)
    drop = {label_idx}
    if weight_idx >= 0:
        roles.weight_col = absolute(weight_idx, weight_abs)
        drop.add(roles.weight_col)
    if group_idx >= 0:
        roles.group_col = absolute(group_idx, group_abs)
        drop.add(roles.group_col)
    for ig, ig_abs in ignore:
        drop.add(absolute(ig, ig_abs))
    roles.keep = [i for i in range(ncols) if i not in drop]
    roles.feat_names = ([names[i] for i in roles.keep] if names
                        else [f"Column_{i}" for i in range(len(roles.keep))])
    return roles


def group_sizes_from_ids(gid: np.ndarray) -> np.ndarray:
    """A query-id column -> per-query sizes (the run lengths)."""
    change = np.nonzero(np.diff(gid))[0] + 1
    bounds = np.concatenate([[0], change, [len(gid)]])
    return np.diff(bounds).astype(np.int64)


def _resolve_column(spec: str, names: Optional[List[str]], default: int) -> Tuple[int, bool]:
    """Returns (index, is_header_absolute).  name:-resolved indices are
    header-absolute; numeric specs are label-relative (config.h:119-133)."""
    if not spec:
        return default, False
    if spec.startswith("name:"):
        name = spec[5:]
        if not names:
            Log.fatal("Column name '%s' given but the file has no header", name)
        if name not in names:
            Log.fatal("Column '%s' not found in header", name)
        return names.index(name), True
    return int(spec), False


def _resolve_columns(spec: str, names: Optional[List[str]]) -> List[Tuple[int, bool]]:
    if not spec:
        return []
    if spec.startswith("name:"):
        assert names is not None
        return [(names.index(s), True) for s in spec[5:].split(",")]
    return [(int(s), False) for s in spec.split(",")]


def _side_files(path: str, num_data: int):
    """<data>.weight and <data>.query companions (metadata.cpp LoadWeights/
    LoadQueryBoundaries)."""
    weights = None
    group = None
    wpath = path + ".weight"
    if os.path.exists(wpath):
        weights = np.loadtxt(wpath, dtype=np.float32).ravel()
        if len(weights) != num_data:
            Log.fatal("Weight file length mismatch: %d vs %d", len(weights), num_data)
    qpath = path + ".query"
    if os.path.exists(qpath):
        group = np.loadtxt(qpath, dtype=np.int64).ravel()
        if int(group.sum()) != num_data:
            Log.fatal("Query file row total mismatch")
    return weights, group
