"""Two-pass streamed dataset construction — the PyTorch port's copy of
lightgbm_tpu/data/ingest.py (host code, no torch).

The in-memory path (io/parser.load_text_file -> BinnedDataset.from_raw)
materializes the whole file as a float64 matrix before binning: at
Higgs scale (10.5M x 28) a 2.4 GB scratch allocation beside the 300 MB
bin matrix kept.  This pipeline streams instead:

  pass 0  count non-blank data lines (a byte scan, no parse)
  pass 1  parse chunk by chunk: collect the deterministic
          bin-construction row sample (the in-memory path's: the same
          LCG indices over the same row order) and mergeable per-feature
          sketches (data/stats.py); find bins from the sample
  pass 2  parse chunk by chunk again, writing each chunk's bin indices
          straight into the preallocated uint8/uint16 bin matrix

Peak host memory is the bin matrix plus one chunk.  Find-bin consumes
exactly the sample the in-memory path draws, so the bin mappers, the
bin matrix and any model trained from them are bit-identical to the
in-memory construction of the same file.

Routing: ``Dataset(path)`` streams when ``should_stream`` says so —
``LIGHTGBM_TPU_STREAM_INGEST`` = ``0`` (never) / ``1`` (always) /
``<MiB threshold>`` / ``auto`` (default: stream above
``DEFAULT_AUTO_THRESHOLD_MB`` or when ``use_two_round_loading``, the
reference's own low-memory loading flag, is set); the ``stream_ingest``
parameter is the same switch when the variable is unset.  What the JAX
package sends to its tracer (chunks, host RSS, sketch digest, wall) goes
into the dataset's ``ingest_report``.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np

from ..io.parser import ColumnRoles, _side_files, group_sizes_from_ids, resolve_roles
from ..utils.log import Log
from .reader import LibSVMChunkReader, make_reader
from .stats import SampleCollector, SketchCollector

DEFAULT_AUTO_THRESHOLD_MB = 256


def stream_mode(config=None) -> str:
    """'never' | 'always' | 'auto' | '<MiB>' from the environment and the
    config; the environment variable wins."""
    v = os.environ.get("LIGHTGBM_TPU_STREAM_INGEST", "").strip().lower()
    if not v or v == "auto":
        v = str(getattr(config, "stream_ingest", "auto") or "auto").lower()
    if v in ("0", "false", "off", "never"):
        return "never"
    if v in ("1", "true", "on", "always", "force"):
        return "always"
    return v  # 'auto' or a numeric MiB threshold


def should_stream(path: str, config) -> bool:
    mode = stream_mode(config)
    if mode == "never":
        return False
    if mode == "always":
        return True
    threshold_mb = DEFAULT_AUTO_THRESHOLD_MB
    if mode != "auto":
        try:
            threshold_mb = float(mode)
        except ValueError:
            Log.warning("Unparsable stream-ingest mode %r; using auto", mode)
    if getattr(config, "use_two_round_loading", False):
        # the reference's two-round loading IS the low-memory path
        return True
    try:
        return os.path.getsize(path) > threshold_mb * (1 << 20)
    except OSError:
        return False


def resolve_categorical(categorical_feature, feat_names) -> set:
    """The Python API's categorical spec -> feature-matrix column indices,
    with basic.py's name resolution."""
    if categorical_feature in ("auto", None) or not categorical_feature:
        return set()
    cats = set()
    for c in categorical_feature:
        if isinstance(c, str):
            if feat_names and c in feat_names:
                cats.add(feat_names.index(c))
            else:
                Log.fatal("Unknown categorical feature %s", c)
        else:
            cats.add(int(c))
    return cats


def host_rss_mb() -> float:
    """This process's resident set (MiB), from /proc (the peak RSS on
    systems without it); 0 when neither can be read."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return float(line.split()[1]) / 1024.0
    except OSError:
        pass
    try:  # pragma: no cover - non-Linux fallback
        import resource

        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0
    except Exception:  # pragma: no cover
        return 0.0


def stream_dataset(path: str, config, *, feature_name="auto", categorical_feature="auto",
                   reference=None, chunk_rows: Optional[int] = None):
    """Stream ``path`` into a BinnedDataset without materializing the raw
    float matrix.  ``reference`` (a constructed BinnedDataset) lends its
    bin mappers — the CreateValid alignment — and pass 1 is skipped."""
    from ..io.dataset import (BinnedDataset, Metadata, bin_rows_into, bin_sample_indices,
                              find_bin_mappers_from_sample, packed_bin_dtype)

    t_start = time.perf_counter()
    rss_start = rss_peak = host_rss_mb()

    def tick():
        nonlocal rss_peak
        rss_peak = max(rss_peak, host_rss_mb())

    if chunk_rows is None:
        env_rows = os.environ.get("LIGHTGBM_TPU_STREAM_CHUNK_ROWS", "")
        if env_rows:
            chunk_rows = int(env_rows)
        elif int(getattr(config, "stream_chunk_rows", 0) or 0) > 0:
            chunk_rows = int(config.stream_chunk_rows)
    reader = make_reader(path, chunk_rows=chunk_rows, has_header=config.has_header,
                         bad_row_policy=getattr(config, "bad_row_policy", "error"))
    libsvm = isinstance(reader, LibSVMChunkReader)

    # pass 0: the row count, needed up front (the LCG sample draws
    # indices over [0, n), exactly like DatasetLoader)
    n = reader.count_rows()
    if n == 0:
        Log.fatal("Data file %s is empty", path)
    report = {"streamed": True, "path": path, "rows": int(n), "libsvm": bool(libsvm),
              "rss_start_mb": round(rss_start, 1)}

    # pass 1: the sample, the sketches and (dense) the column roles
    chunks_seen = 0
    if reference is None:
        sample_idx = bin_sample_indices(n, config)
        collector = SampleCollector(sample_idx, ncols=None if libsvm else reader.ncols)
        cats: set = set()
        if libsvm:
            sketches = SketchCollector()
            for start, feats, _labels in reader.iter_chunks():
                collector.offer(start, feats)
                sketches.update(feats)
                chunks_seen += 1
                tick()
            width = reader.ncols_seen
            sampled = collector.finish(ncols=width, partial=reader.bad_rows > 0)
            roles = ColumnRoles(label_idx=0, keep=list(range(width)),
                                feat_names=[f"Column_{i}" for i in range(width)])
        else:
            roles = resolve_roles(config, reader.header_names, reader.ncols)
            if feature_name != "auto" and feature_name is not None:
                roles.feat_names = list(feature_name)
            cats = resolve_categorical(categorical_feature, roles.feat_names)
            sketches = SketchCollector(categorical=cats)
            keep = np.asarray(roles.keep, dtype=np.int64)
            for start, chunk in reader.iter_chunks():
                collector.offer(start, chunk)
                sketches.update(chunk[:, keep])
                chunks_seen += 1
                tick()
            sampled = collector.finish(partial=reader.bad_rows > 0)[:, keep]
        if getattr(config, "is_parallel_find_bin", False):
            from ..parallel.distributed import ensure_initialized

            if ensure_initialized(config):
                # every process ends with the same merged sketch bank
                sketches.merge_across_hosts()
        mappers = find_bin_mappers_from_sample(sampled, n, config, cats)
        used = [i for i, m in enumerate(mappers) if not m.is_trivial]
        if not used:
            Log.fatal("Cannot construct Dataset: all features are trivial (constant)")
        bin_mappers = [mappers[i] for i in used]
        used_map = np.asarray(used, dtype=np.int32)
        num_total = len(roles.keep)
        del sampled, collector
        report["sketch"] = sketches.summary()
    else:
        bin_mappers = reference.bin_mappers
        used_map = reference.used_feature_map
        num_total = reference.num_total_features
        if libsvm:
            roles = ColumnRoles(label_idx=0, keep=list(range(num_total)),
                                feat_names=list(reference.feature_names))
        else:
            roles = resolve_roles(config, reader.header_names, reader.ncols)
            roles.feat_names = list(reference.feature_names)

    # pass 2: bin each chunk into the preallocated matrix
    ds = BinnedDataset()
    ds.num_total_features = num_total
    ds.max_bin = reference.max_bin if reference is not None else config.max_bin
    ds.bin_mappers = bin_mappers
    ds.used_feature_map = used_map
    ds.feature_names = roles.feat_names
    ds.label_idx = roles.label_idx

    binned = np.empty((n, len(bin_mappers)), dtype=packed_bin_dtype(bin_mappers))
    label = np.zeros(n, dtype=np.float32)
    weights = np.empty(n, dtype=np.float32) if roles.weight_col >= 0 else None
    gid = np.empty(n, dtype=np.float64) if roles.group_col >= 0 else None
    keep = np.asarray(roles.keep, dtype=np.int64)
    pass2_chunks = 0
    filled = 0
    if libsvm:
        for start, feats, labels_chunk in reader.iter_chunks():
            if feats.shape[1] < num_total:
                feats = np.pad(feats, ((0, 0), (0, num_total - feats.shape[1])))
            elif feats.shape[1] > num_total:
                # a reference narrower than the data truncates, like
                # ValueToBin's unseen-feature clamp
                feats = feats[:, :num_total]
            bin_rows_into(binned, start, feats, bin_mappers, used_map)
            label[start:start + len(labels_chunk)] = labels_chunk
            filled = start + len(labels_chunk)
            pass2_chunks += 1
            tick()
    else:
        for start, chunk in reader.iter_chunks():
            stop = start + chunk.shape[0]
            bin_rows_into(binned, start, chunk[:, keep], bin_mappers, used_map)
            label[start:stop] = chunk[:, roles.label_idx].astype(np.float32)
            if weights is not None:
                weights[start:stop] = chunk[:, roles.weight_col].astype(np.float32)
            if gid is not None:
                gid[start:stop] = chunk[:, roles.group_col]
            filled = stop
            pass2_chunks += 1
            tick()

    if filled < n:
        # bad_row_policy='skip' dropped rows: pass 0's line count
        # over-allocated; both passes skip the same rows (the parse is
        # deterministic), so trim to the survivors
        Log.warning("%s: %d of %d data rows were malformed and skipped", path, n - filled, n)
        report["bad_rows"] = int(n - filled)
        report["rows"] = int(filled)
        binned, label = binned[:filled], label[:filled]
        weights = weights[:filled] if weights is not None else None
        gid = gid[:filled] if gid is not None else None
        n = filled

    ds.binned = binned
    ds.metadata = Metadata(n)
    ds.metadata.set_label(label)
    group = group_sizes_from_ids(gid) if gid is not None else None
    # side files fill whatever the columns did not give (metadata.cpp)
    fweights, fgroup = _side_files(path, n)
    ds.metadata.set_weights(weights if weights is not None else fweights)
    ds.metadata.set_query(group if group is not None else fgroup)

    tick()
    wall = time.perf_counter() - t_start
    report.update({"chunks_pass1": int(chunks_seen), "chunks_pass2": int(pass2_chunks),
                   "chunk_rows": int(reader.chunk_rows()),
                   "num_features_used": int(len(bin_mappers)),
                   "packed_mb": round(binned.nbytes / 1e6, 1), "rss_peak_mb": round(rss_peak, 1),
                   "wall_s": round(wall, 3), "rows_per_s": round(n / max(wall, 1e-9), 1)})
    ds.ingest_report = report
    return ds
