"""Mergeable per-feature statistics sketches for streaming find-bin — the
PyTorch port's copy of lightgbm_tpu/data/sketch.py (host code, no torch).

The reference's DatasetLoader samples rows and feeds raw values to
BinMapper::FindBin.  When data streams through in chunks — or lives on
several hosts — per-feature statistics must instead be collected as
*mergeable summaries*:

- ``NumericSketch``: an exact distinct-value -> count map while the
  cardinality stays under ``cap``; above it, the map spills into a
  GK-style quantile sketch (Greenwald-Khanna, SIGMOD'01) with rank error
  eps·n.  Zero/NaN counts and min/max stay exact through the spill.
- ``CategoricalSketch``: exact count map spilling to Misra-Gries heavy
  hitters (capacity ``cap``), each count's undercount bounded by the
  tracked ``error`` term.

All sketches merge associatively: ``merge(merge(a, b), c)`` and
``merge(a, merge(b, c))`` summarize the same multiset, so the order of
chunks (or, once the port's distributed find-bin lands, of hosts) cannot
change the result of an exact (unspilled) sketch, and only widens error
bounds, not correctness, for spilled ones.

``to_distinct_counts()`` emits the (distinct_values, counts) pairs that
``BinMapper.find_bin_from_distinct`` consumes, so an exact sketch
reproduces the in-memory mapper bit-for-bit.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

DEFAULT_CARDINALITY_CAP = 4096
DEFAULT_GK_EPS = 0.001


class GKSketch:
    """GK-style quantile summary over weighted values.

    Entries are ``(v, g, delta)`` sorted by v: ``g`` is the weight gap to
    the previous entry, ``delta`` the rank uncertainty.  COMPRESS merges
    adjacent entries while ``g_i + g_{i+1} + delta_{i+1} <= 2*eps*n``,
    which keeps any rank query within eps·n of truth (Greenwald-Khanna
    invariant).  Weighted inserts enter with delta=0 (their own rank is
    exact at insert time), so heavy distinct values never lose mass.
    Merging two summaries concatenates by value and adds the error
    budgets (standard mergeable-summary argument: eps_out <= eps_a +
    eps_b; we compress against the COMBINED n, so repeated merges stay
    bounded in size)."""

    __slots__ = ("eps", "vals", "g", "delta", "n")

    def __init__(self, eps: float = DEFAULT_GK_EPS):
        self.eps = float(eps)
        self.vals = np.empty(0, np.float64)
        self.g = np.empty(0, np.int64)
        self.delta = np.empty(0, np.int64)
        self.n = 0

    # ------------------------------------------------------------------
    def insert_batch(self, values: np.ndarray, counts: np.ndarray) -> None:
        """Insert distinct (value, count) pairs (values need not be
        sorted or disjoint from existing entries)."""
        if len(values) == 0:
            return
        order = np.argsort(values, kind="stable")
        v_new = np.asarray(values, np.float64)[order]
        g_new = np.asarray(counts, np.int64)[order]
        self._merge_arrays(v_new, g_new, np.zeros(len(v_new), np.int64),
                           int(g_new.sum()))

    def merge(self, other: "GKSketch") -> None:
        self._merge_arrays(other.vals, other.g, other.delta, other.n)

    def _merge_arrays(self, v2, g2, d2, n2) -> None:
        v = np.concatenate([self.vals, v2])
        g = np.concatenate([self.g, g2])
        d = np.concatenate([self.delta, d2])
        order = np.argsort(v, kind="stable")
        self.vals, self.g, self.delta = v[order], g[order], d[order]
        self.n += int(n2)
        self._compress()

    def _compress(self) -> None:
        if len(self.vals) <= 3:
            return
        budget = max(1, int(2 * self.eps * self.n))
        out_v: List[float] = []
        out_g: List[int] = []
        out_d: List[int] = []
        # walk right-to-left so each merge folds g into the RIGHT
        # neighbor (GK folds tuple i into i+1); endpoints stay exact
        acc_g = int(self.g[-1])
        acc_d = int(self.delta[-1])
        cur_v = float(self.vals[-1])
        for i in range(len(self.vals) - 2, 0, -1):
            gi = int(self.g[i])
            if gi + acc_g + acc_d <= budget:
                acc_g += gi
            else:
                out_v.append(cur_v)
                out_g.append(acc_g)
                out_d.append(acc_d)
                cur_v, acc_g, acc_d = float(self.vals[i]), gi, int(self.delta[i])
        out_v.append(cur_v)
        out_g.append(acc_g)
        out_d.append(acc_d)
        # first entry (minimum) always kept exact
        out_v.append(float(self.vals[0]))
        out_g.append(int(self.g[0]))
        out_d.append(int(self.delta[0]))
        self.vals = np.asarray(out_v[::-1], np.float64)
        self.g = np.asarray(out_g[::-1], np.int64)
        self.delta = np.asarray(out_d[::-1], np.int64)

    # ------------------------------------------------------------------
    def quantile(self, q: float) -> float:
        if len(self.vals) == 0:
            return float("nan")
        target = q * self.n
        ranks = np.cumsum(self.g)
        idx = int(np.searchsorted(ranks, target, side="left"))
        return float(self.vals[min(idx, len(self.vals) - 1)])

    def to_distinct_counts(self) -> Tuple[np.ndarray, np.ndarray]:
        """Representative (value, weight) pairs for find-bin: the sketch
        entries themselves, whose weights sum to n.  Equal values (from
        merges of summaries sharing a support point) are combined so the
        output is strictly increasing, as find-bin requires."""
        if len(self.vals) == 0:
            return self.vals.copy(), self.g.copy()
        keep = np.concatenate([[True], np.diff(self.vals) > 0])
        seg = np.cumsum(keep) - 1
        g = np.zeros(int(seg[-1]) + 1, np.int64)
        np.add.at(g, seg, self.g)
        return self.vals[keep], g


class NumericSketch:
    """Exact distinct-value map spilling to GK above ``cap`` distinct
    non-zero values.  Zero and NaN counts ride exact side counters (they
    get special treatment in FindBin and must never be approximated)."""

    __slots__ = ("cap", "eps", "counts", "gk", "zero_cnt", "nan_cnt",
                 "total_cnt", "min_val", "max_val")

    def __init__(self, cap: int = DEFAULT_CARDINALITY_CAP,
                 eps: float = DEFAULT_GK_EPS):
        self.cap = int(cap)
        self.eps = float(eps)
        self.counts: Optional[Dict[float, int]] = {}
        self.gk: Optional[GKSketch] = None
        self.zero_cnt = 0
        self.nan_cnt = 0
        self.total_cnt = 0
        self.min_val = np.inf
        self.max_val = -np.inf

    @property
    def spilled(self) -> bool:
        return self.gk is not None

    def cardinality(self) -> int:
        """Distinct non-zero values (exact until spilled, then a lower
        bound given by the summary size)."""
        return len(self.gk.vals) if self.spilled else len(self.counts)

    # ------------------------------------------------------------------
    def update(self, column: np.ndarray) -> None:
        """Fold one chunk's raw column in."""
        col = np.asarray(column, np.float64)
        self.total_cnt += len(col)
        nan_mask = np.isnan(col)
        self.nan_cnt += int(nan_mask.sum())
        col = col[~nan_mask]
        zero_mask = col == 0.0
        self.zero_cnt += int(zero_mask.sum())
        col = col[~zero_mask]
        if len(col) == 0:
            return
        self.min_val = min(self.min_val, float(col.min()))
        self.max_val = max(self.max_val, float(col.max()))
        vals, cnts = np.unique(col, return_counts=True)
        self._add_distinct(vals, cnts.astype(np.int64))

    def _add_distinct(self, vals: np.ndarray, cnts: np.ndarray) -> None:
        if self.gk is not None:
            self.gk.insert_batch(vals, cnts)
            return
        for v, c in zip(vals.tolist(), cnts.tolist()):
            self.counts[v] = self.counts.get(v, 0) + c
        if len(self.counts) > self.cap:
            self._spill()

    def _spill(self) -> None:
        gk = GKSketch(self.eps)
        vals = np.fromiter(self.counts.keys(), np.float64, len(self.counts))
        cnts = np.fromiter(self.counts.values(), np.int64, len(self.counts))
        gk.insert_batch(vals, cnts)
        self.gk = gk
        self.counts = None

    # ------------------------------------------------------------------
    def merge(self, other: "NumericSketch") -> None:
        self.zero_cnt += other.zero_cnt
        self.nan_cnt += other.nan_cnt
        self.total_cnt += other.total_cnt
        self.min_val = min(self.min_val, other.min_val)
        self.max_val = max(self.max_val, other.max_val)
        if other.spilled and not self.spilled:
            self._spill()
        if self.spilled:
            if other.spilled:
                self.gk.merge(other.gk)
            elif other.counts:
                vals = np.fromiter(other.counts.keys(), np.float64,
                                   len(other.counts))
                cnts = np.fromiter(other.counts.values(), np.int64,
                                   len(other.counts))
                self.gk.insert_batch(vals, cnts)
        elif other.counts:
            vals = np.fromiter(other.counts.keys(), np.float64,
                               len(other.counts))
            cnts = np.fromiter(other.counts.values(), np.int64,
                               len(other.counts))
            self._add_distinct(vals, cnts)

    # ------------------------------------------------------------------
    def to_distinct_counts(self) -> Tuple[np.ndarray, np.ndarray]:
        """Sorted (distinct non-zero values, counts) — what find-bin
        consumes.  Exact until spilled; sketch representatives after."""
        if self.spilled:
            return self.gk.to_distinct_counts()
        vals = np.fromiter(self.counts.keys(), np.float64, len(self.counts))
        cnts = np.fromiter(self.counts.values(), np.int64, len(self.counts))
        order = np.argsort(vals, kind="stable")
        return vals[order], cnts[order]


class CategoricalSketch:
    """Exact category-count map spilling to Misra-Gries heavy hitters.
    ``error`` bounds how much any surviving counter may undercount."""

    __slots__ = ("cap", "counts", "error", "total_cnt", "nan_cnt", "spilled")

    def __init__(self, cap: int = DEFAULT_CARDINALITY_CAP):
        self.cap = int(cap)
        self.counts: Dict[int, int] = {}
        self.error = 0
        self.total_cnt = 0
        self.nan_cnt = 0
        self.spilled = False

    def update(self, column: np.ndarray) -> None:
        col = np.asarray(column, np.float64)
        self.total_cnt += len(col)
        nan_mask = np.isnan(col)
        self.nan_cnt += int(nan_mask.sum())
        # NaN folds into category 0, like FindBin's zero-block insert
        # does for the in-memory path (NaN rows ride the implied zero
        # count, which lands on categorical value 0)
        iv = np.where(nan_mask, 0.0, col).astype(np.int64)
        vals, cnts = np.unique(iv, return_counts=True)
        for v, c in zip(vals.tolist(), cnts.tolist()):
            self.counts[v] = self.counts.get(v, 0) + c
        self._shrink()

    def _shrink(self) -> None:
        """Misra-Gries decrement: subtract the (cap+1)-th largest count
        from everyone and drop non-positives."""
        if len(self.counts) <= self.cap:
            return
        self.spilled = True
        cnts = sorted(self.counts.values(), reverse=True)
        dec = cnts[self.cap]
        self.error += dec
        self.counts = {v: c - dec for v, c in self.counts.items() if c > dec}

    def merge(self, other: "CategoricalSketch") -> None:
        self.total_cnt += other.total_cnt
        self.nan_cnt += other.nan_cnt
        self.error += other.error
        self.spilled = self.spilled or other.spilled
        for v, c in other.counts.items():
            self.counts[v] = self.counts.get(v, 0) + c
        self._shrink()

    def to_distinct_counts(self) -> Tuple[np.ndarray, np.ndarray]:
        vals = np.fromiter(self.counts.keys(), np.float64, len(self.counts))
        cnts = np.fromiter(self.counts.values(), np.int64, len(self.counts))
        order = np.argsort(vals, kind="stable")
        return vals[order], cnts[order]
