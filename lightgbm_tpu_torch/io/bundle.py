"""Exclusive Feature Bundling (EFB) decision — copied from
lightgbm_tpu/io/bundle.py (the port decides bundling exactly as the JAX
package does; it does not train bundled matrices yet).  Counterpart of
Dataset::FindGroups / FastFeatureBundling (src/io/dataset.cpp:64-208) and
the FeatureGroup bin-offset layout (include/LightGBM/feature_group.h:30-76).

Sparse-wide data (Bosch 968, Expo 700 features) stores mostly-default
columns; bundling packs mutually-(almost-)exclusive features into one
dense column so histogram and partition cost scale with the number of
BUNDLES, not features — the memory/compute win the reference gets from
sparse bins, in the dense form the TPU MXU rewards (see README's sparse
storage decision).

Bundle bin layout (feature_group.h:34-48, PushData :128-136):
    bin 0            : every feature at its default bin
    feature i's bins : offset_i + b  (b != default_i), where offset_i is
                       the running total and a feature whose default bin
                       is 0 drops that bin (bias 1: stored value is
                       offset_i + b - 1 for b in 1..nb-1)
On conflicts (two non-default features in one row) the later feature in
group order wins, exactly like consecutive Bin::Push calls.

Deliberate simplifications vs the reference (documented):
- conflict search scans ALL candidate groups instead of sampling
  max_search_group=100 of them (F is small enough in numpy);
- the final group shuffle (Random(12) swap loop) is skipped — group
  order only affects the reference's threading layout;
- the "take apart small sparse group" branch never fires because sparse
  bin storage is rejected by design (is_enable_sparse is always false).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ..utils.log import Log

# cap each bundle's total bin count so bundled columns stay uint8 — the
# same bound the reference applies on GPU (gpu_max_bin_per_group = 256,
# dataset.cpp:74)
MAX_BIN_PER_BUNDLE = 256


@dataclass
class BundleInfo:
    """Static bundling description for F inner features over G columns."""

    groups: List[List[int]]  # inner feature ids per bundle
    col: np.ndarray  # (F,) bundle column of each feature
    off_lo: np.ndarray  # (F,) first bundle value of the feature's range
    off_hi: np.ndarray  # (F,) one past the last bundle value
    bias: np.ndarray  # (F,) 1 when default_bin==0 (bin dropped), else 0
    num_bin_col: np.ndarray  # (G,) total bins per bundle column
    max_col_bin: int = 0

    @property
    def num_cols(self) -> int:
        return len(self.groups)


if hasattr(np, "bitwise_count"):  # numpy >= 2.0
    def _popcount64(x: np.ndarray) -> int:
        return int(np.bitwise_count(x).sum())
else:
    def _popcount64(x: np.ndarray) -> int:
        return int(np.unpackbits(x.view(np.uint8)).sum())


def _find_groups(nonzero: List[np.ndarray], order: np.ndarray,
                 max_error_cnt: int, num_bin: np.ndarray, default0: np.ndarray) -> List[List[int]]:
    """Greedy conflict-bounded grouping (FindGroups, dataset.cpp:64-134);
    ``nonzero[f]`` is the sampled-row non-default bitmask of feature f,
    packed to uint64 words (the conflict count is a popcount of the AND —
    64x less memory traffic than bool masks; ~1 s at 1000x200k)."""
    groups: List[List[int]] = []
    marks: List[np.ndarray] = []
    conflict: List[int] = []
    bins_in_group: List[int] = []
    for f in order:
        nz = nonzero[f]
        fbins = int(num_bin[f]) - (1 if default0[f] else 0)
        placed = False
        for g in range(len(groups)):
            if bins_in_group[g] + fbins > MAX_BIN_PER_BUNDLE - 1:
                continue
            rest = max_error_cnt - conflict[g]
            if rest < 0:
                continue
            cnt = _popcount64(marks[g] & nz)
            if cnt <= rest:
                groups[g].append(int(f))
                conflict[g] += cnt
                marks[g] |= nz
                bins_in_group[g] += fbins
                placed = True
                break
        if not placed:
            groups.append([int(f)])
            marks.append(nz.copy())
            conflict.append(0)
            bins_in_group.append(fbins)
    return groups


def find_bundles(binned: np.ndarray, mappers, config) -> Optional[BundleInfo]:
    """FastFeatureBundling (dataset.cpp:136-208) over the binned matrix.

    Returns None when bundling gains nothing (G == F) or is disabled."""
    n, f = binned.shape
    if f < 2:
        return None
    sample_cnt = min(n, int(getattr(config, "bin_construct_sample_cnt", 200000)))
    rng = np.random.RandomState(getattr(config, "data_random_seed", 1))
    rows = rng.choice(n, size=sample_cnt, replace=False) if sample_cnt < n else np.arange(n)
    sub = binned[rows]

    default_bin = np.asarray([m.default_bin for m in mappers], np.int64)
    num_bin = np.asarray([m.num_bin for m in mappers], np.int64)
    default0 = default_bin == 0

    nonzero_b = [sub[:, i] != default_bin[i] for i in range(f)]
    nz_cnt = np.asarray([int(m.sum()) for m in nonzero_b])
    # pack to uint64 words for fast AND+popcount conflict tests
    nonzero = [np.packbits(m).view(np.uint8) for m in nonzero_b]
    pad = (-len(nonzero[0])) % 8
    nonzero = [np.pad(m, (0, pad)).view(np.uint64) for m in nonzero]
    max_error_cnt = int(sample_cnt * float(getattr(config, "max_conflict_rate", 0.0)))

    natural = np.arange(f)
    by_cnt = np.argsort(-nz_cnt, kind="stable")
    g1 = _find_groups(nonzero, natural, max_error_cnt, num_bin, default0)
    g2 = _find_groups(nonzero, by_cnt, max_error_cnt, num_bin, default0)
    groups = g2 if len(g2) < len(g1) else g1

    if len(groups) >= f:
        return None

    col = np.zeros(f, np.int32)
    off_lo = np.zeros(f, np.int32)
    off_hi = np.zeros(f, np.int32)
    bias = np.zeros(f, np.int32)
    num_bin_col = np.zeros(len(groups), np.int32)
    for g, feats in enumerate(groups):
        if len(feats) == 1:
            # singleton column stores the RAW bin (off_lo == 0 marks it):
            # no shared zero slot, no offset — also the only layout that
            # fits a full 256-bin feature in uint8
            fe = feats[0]
            col[fe] = g
            off_lo[fe] = 0
            off_hi[fe] = int(num_bin[fe])
            bias[fe] = 0
            num_bin_col[g] = int(num_bin[fe])
            continue
        total = 1  # bin 0 = all-default (feature_group.h:35)
        for fe in feats:
            col[fe] = g
            off_lo[fe] = total
            w = int(num_bin[fe]) - (1 if default0[fe] else 0)
            off_hi[fe] = total + w
            bias[fe] = 1 if default0[fe] else 0
            total += w
        num_bin_col[g] = total
    info = BundleInfo(
        groups=[list(map(int, g)) for g in groups],
        col=col, off_lo=off_lo, off_hi=off_hi, bias=bias,
        num_bin_col=num_bin_col, max_col_bin=int(num_bin_col.max()),
    )
    Log.info(
        "EFB: bundled %d features into %d columns (max %d bins/column)",
        f, info.num_cols, info.max_col_bin,
    )
    return info
