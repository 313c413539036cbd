"""Pass-1 streaming statistics: per-feature mergeable sketches plus the
deterministic bin-construction row sample — the PyTorch port's copy of
lightgbm_tpu/data/stats.py (host code, no torch).

The sample (io/dataset.bin_sample_indices) is what find-bin actually
consumes — it makes streaming construction bit-identical to the
in-memory path.  The sketches are the *mergeable* superset the sample
cannot give: exact distinct-value/cardinality accounting per feature
(spilling to GK quantile summaries above a cap), collected chunk by
chunk with O(cap) memory; they feed the ingest report's diagnostics.
Their cross-host merge (the reference's distributed find-bin allgather)
waits for the port's distributed learners and raises.
"""

from __future__ import annotations

import pickle
from typing import List, Optional

import numpy as np

from .sketch import DEFAULT_CARDINALITY_CAP, DEFAULT_GK_EPS, CategoricalSketch, NumericSketch


class SampleCollector:
    """Collects the rows whose global index is in the (sorted) sample
    index set, with one forward cursor — the streaming equivalent of
    ``data[sample_indices]``.  With ``ncols`` known up front (dense
    files) rows land in a preallocated matrix; ``ncols=None`` (LibSVM,
    where width grows with the max seen index) keeps per-row vectors and
    pads at ``finish(ncols=...)``."""

    def __init__(self, sample_indices: np.ndarray, ncols: Optional[int] = None):
        self.indices = np.asarray(sample_indices, dtype=np.int64)
        self.rows: Optional[np.ndarray] = (
            np.empty((len(self.indices), ncols), dtype=np.float64)
            if ncols is not None else None
        )
        self._row_list: List[np.ndarray] = []
        self._cursor = 0

    def offer(self, start_row: int, chunk: np.ndarray) -> None:
        stop_row = start_row + chunk.shape[0]
        c = self._cursor
        while c < len(self.indices) and self.indices[c] < stop_row:
            row = chunk[self.indices[c] - start_row]
            if self.rows is not None:
                self.rows[c] = row
            else:
                self._row_list.append(np.asarray(row, np.float64))
            c += 1
        self._cursor = c

    def finish(self, ncols: Optional[int] = None,
               partial: bool = False) -> np.ndarray:
        """``partial=True`` accepts an incomplete collection and returns
        only the collected prefix — the bad-row-skip path, where rows
        sampled past the surviving row count never stream by."""
        if self._cursor != len(self.indices) and not partial:
            raise RuntimeError(
                f"sample collection incomplete: {self._cursor}/{len(self.indices)}"
            )
        if self.rows is not None:
            return self.rows[: self._cursor] if partial else self.rows
        width = ncols if ncols is not None else max(
            (len(r) for r in self._row_list), default=0
        )
        out = np.zeros((len(self._row_list), width), dtype=np.float64)
        for i, r in enumerate(self._row_list):
            out[i, : len(r)] = r[:width]
        return out


class SketchCollector:
    """Per-feature sketch bank, updated chunk by chunk.

    ``categorical`` holds FEATURE indices (post label/weight-drop) that
    get a CategoricalSketch; everything else is numeric.  Features may
    appear late (LibSVM width growth): a new column's sketch is
    back-filled with the zero count of every row already seen, so its
    totals match a column that was materialized from row 0."""

    def __init__(self, categorical: Optional[set] = None,
                 cap: int = DEFAULT_CARDINALITY_CAP,
                 eps: float = DEFAULT_GK_EPS):
        self.categorical = set(categorical or ())
        self.cap = cap
        self.eps = eps
        self.sketches: List[object] = []
        self.rows_seen = 0

    def _new_sketch(self, fidx: int):
        if fidx in self.categorical:
            return CategoricalSketch(cap=self.cap)
        return NumericSketch(cap=self.cap, eps=self.eps)

    def _grow_to(self, ncols: int) -> None:
        while len(self.sketches) < ncols:
            s = self._new_sketch(len(self.sketches))
            if self.rows_seen:
                # rows seen before this column appeared are implicit zeros
                s.total_cnt += self.rows_seen
                if isinstance(s, NumericSketch):
                    s.zero_cnt += self.rows_seen
                else:
                    s.counts[0] = s.counts.get(0, 0) + self.rows_seen
            self.sketches.append(s)

    def update(self, features: np.ndarray) -> None:
        """Fold one chunk's FEATURE matrix in (chunk-local width is
        allowed; missing trailing columns count as zeros)."""
        rows, width = features.shape
        self._grow_to(width)
        for f, sk in enumerate(self.sketches):
            if f < width:
                sk.update(features[:, f])
            else:
                sk.total_cnt += rows
                if isinstance(sk, NumericSketch):
                    sk.zero_cnt += rows
                else:
                    sk.counts[0] = sk.counts.get(0, 0) + rows
        self.rows_seen += rows

    # ------------------------------------------------------------------
    def summary(self) -> dict:
        """Trace-friendly digest: per-feature cardinality and spill
        state (what the ingest span attaches as gauges)."""
        spilled = sum(
            1 for s in self.sketches
            if getattr(s, "spilled", False)
        )
        cards = [s.cardinality() if isinstance(s, NumericSketch)
                 else len(s.counts) for s in self.sketches]
        return {
            "features": len(self.sketches),
            "spilled": spilled,
            "max_cardinality": int(max(cards, default=0)),
        }

    def merge_across_hosts(self) -> None:
        """The allgather and feature-wise merge of every process's sketch
        bank, the ingest's mirror of the distributed find-bin (JAX
        stats.py:149); nothing in one process."""
        from ..parallel import collect, distributed

        if distributed.process_count() == 1:
            return
        blobs = collect.allgather_bytes(pickle.dumps(self.sketches,
                                                     protocol=pickle.HIGHEST_PROTOCOL))
        lists = [pickle.loads(b) for b in blobs]
        width = max(len(lst) for lst in lists)
        for lst in lists:
            # a process that saw fewer LibSVM columns: zero-backfilled
            # sketches widen its list, so the feature-wise merge lines up
            rows = lst[0].total_cnt if lst else 0
            while len(lst) < width:
                sk = self._new_sketch(len(lst))
                sk.total_cnt += rows
                if isinstance(sk, NumericSketch):
                    sk.zero_cnt += rows
                else:
                    sk.counts[0] = sk.counts.get(0, 0) + rows
                lst.append(sk)
        merged = lists[0]
        for other in lists[1:]:
            for mine, theirs in zip(merged, other):
                mine.merge(theirs)
        self.sketches = merged
        self.rows_seen = merged[0].total_cnt if merged else 0
