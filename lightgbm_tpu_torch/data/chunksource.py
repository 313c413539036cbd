"""ChunkSource: the streaming seam of out-of-core training — PyTorch
counterpart of lightgbm_tpu/data/chunksource.py.

  ``make_chunk_source``  dataset -> chunk source (the CRC-checked binary
                         cache via data/cache.py when the dataset was
                         loaded from one, else its host or memmapped
                         ``binned`` array)
  ``ChunkStream``        a (source, plan, depth, stats) bundle whose
                         ``stream()`` runs the bounded prefetch ring of
                         data/prefetch.py on the training device
  ``ChunkFolder``        the fold algebra over a ChunkStream: the root
                         histogram fold, the one-pass split fold that
                         partitions ``leaf_id`` and folds both children,
                         the smaller-child-direct / larger-by-subtraction
                         rule, the streamed score pass and the linear
                         leaves' folds

The histogram folds keep B8's float64 (B9's int32) carry until the pass
ends and round it once (ops/histogram.py ``accumulate_histogram``,
``finalize_histogram``), so a streamed tree is the resident mask
grower's for any chunk grid.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.histogram import finalize_histogram, new_carry, num_words
from ..ops.ooc import chunk_matrix, root_hist_chunk, scatter_add_slice, split_chunk, subtract_sibling
from ..ops.predict import predict_words, words_column
from .prefetch import ArrayChunkSource, CacheChunkSource, ChunkPlan, ChunkPrefetcher, PrefetchStats

__all__ = [
    "ArrayChunkSource",
    "CacheChunkSource",
    "ChunkFolder",
    "ChunkPlan",
    "ChunkStream",
    "PrefetchStats",
    "make_chunk_source",
]


def make_chunk_source(train_set):
    """Chunk source for a constructed dataset: checksummed reads straight
    from the binary cache it was loaded from, else its host (or
    memmapped) ``binned`` array."""
    path = getattr(train_set, "cache_path", None)
    if path:
        from .cache import open_cache_reader

        reader = open_cache_reader(path)
        if reader is not None:
            return CacheChunkSource(reader)
    return ArrayChunkSource(np.asarray(train_set.binned))


class ChunkStream:
    """One streaming configuration: a chunk source, the grid over its rows,
    the prefetch depth, the device and the accumulated overlap stats.
    ``stream()`` yields ``(index, start, stop, chunk)`` through one
    prefetcher, whose ring lives from pass to pass."""

    def __init__(self, source, plan: ChunkPlan, depth: int = 2,
                 stats: PrefetchStats | None = None, device="cpu"):
        self.source = source
        self.plan = plan
        self.depth = max(int(depth), 1)
        self.stats = stats if stats is not None else PrefetchStats()
        self.device = torch.device(device)
        self.prefetcher = ChunkPrefetcher(source, plan, self.depth, self.stats, self.device)

    def stream(self):
        return self.prefetcher.stream()


class ChunkFolder:
    """The per-chunk fold algebra over a :class:`ChunkStream`.

    Its only state is a (W + 4) x chunk_rows int32 work buffer on the
    device that each chunk's packed matrix is written into (ops/ooc.py
    ``chunk_matrix``); the row vectors come in and the carries go out."""

    def __init__(self, stream: ChunkStream, num_features: int, num_bins: int, bits: int):
        self.stream = stream
        self.num_features = int(num_features)
        self.num_bins = int(num_bins)
        self.bits = int(bits)
        self.per = 32 // self.bits
        self.num_rows = stream.plan.num_rows
        self._work = None

    def _chunks(self):
        """(start, stop, packed matrix) of each chunk of one pass."""
        if self._work is None:
            rows = min(self.stream.plan.chunk_rows, max(self.num_rows, 1))
            w = num_words(self.num_features, self.per)
            self._work = torch.empty((w + 4) * rows, dtype=torch.int32,
                                     device=self.stream.device)
        for _i, start, stop, chunk in self.stream.stream():
            yield start, stop, chunk_matrix(chunk, self._work)

    def fold_root(self, g_w, h_w, sel_w, quantized: bool) -> torch.Tensor:
        """One streamed pass folding every chunk into the root histogram of
        the (N,) int32 channel rows (``ops/grow.py value_words``): (F, B, 3)
        int32 of ``quantized`` levels, else float32."""
        carry = new_carry(self.num_features, self.num_bins, quantized, g_w.device)
        for start, _stop, p in self._chunks():
            root_hist_chunk(carry, p, g_w, h_w, sel_w, start, self.num_features,
                            self.num_bins, self.per, self.bits)
        return finalize_histogram(carry)

    def fold_split(self, leaf_id, g_w, h_w, sel_w, feat, zero_bin, dbz, thr, is_cat, bl, rl,
                   quantized: bool):
        """One streamed pass applying one split: ``leaf_id`` partitioned in
        place by the split predicate and both children's carries folded.
        Returns ``(n_left, carry_l, carry_r)``, ``n_left`` an int64 device
        scalar."""
        carry_l = new_carry(self.num_features, self.num_bins, quantized, g_w.device)
        carry_r = new_carry(self.num_features, self.num_bins, quantized, g_w.device)
        n_left = torch.zeros((), dtype=torch.int64, device=g_w.device)
        for start, _stop, p in self._chunks():
            n_left = split_chunk(leaf_id, carry_l, carry_r, n_left, p, g_w, h_w, sel_w, start,
                                 feat, zero_bin, dbz, thr, is_cat, bl, rl, self.num_features,
                                 self.num_bins, self.per, self.bits)
        return n_left, carry_l, carry_r

    @staticmethod
    def pick_children(parent_hist, carry_l, carry_r, n_left, n_right):
        """The smaller child by row count keeps its direct histogram, the
        larger is parent - smaller (FeatureHistogram::Subtract), decided on
        the device as the resident grower decides it.  Returns
        ``(left_hist, right_hist)``."""
        left_smaller = n_left < n_right
        smaller = torch.where(left_smaller, finalize_histogram(carry_l),
                              finalize_histogram(carry_r))
        larger = subtract_sibling(parent_hist, smaller)
        return (torch.where(left_smaller, smaller, larger),
                torch.where(left_smaller, larger, smaller))

    def streamed_scores(self, score_k, arrays, lut=None):
        """``score_k`` += the stacked trees' outputs, walked over the chunk
        grid (rollback's score pass when the matrix is not resident); the
        walk is per row, so chunking is exact.  ``lut``: the bin value
        table linear leaves need."""
        w = num_words(self.num_features, self.per)
        for start, _stop, p in self._chunks():
            scatter_add_slice(score_k, predict_words(p[:w], self.per, self.bits, arrays, lut),
                              start)
        return score_k

    # -- linear leaves (tree/linear.py) ----------------------------------
    def fold_linear_stats(self, grad, hess, select, leaf_id, feat_idx, feat_valid, value_lut,
                          num_leaves: int):
        """One streamed pass accumulating the linear fits' normal equations
        (A, b) in float64, rounded to float32 once at the end: the
        out-of-core ``tree.linear.linear_fit_stats``."""
        from ..tree.linear import linear_stats_chunk, new_linear_carry

        w = num_words(self.num_features, self.per)
        a, b = new_linear_carry(feat_idx, num_leaves, grad.device)
        for start, stop, p in self._chunks():
            linear_stats_chunk(a, b, words_column(p[:w], self.per, self.bits), grad, hess, select,
                               leaf_id, start, stop, feat_idx, feat_valid, value_lut, num_leaves)
        return a.float(), b.float()

    def fold_linear_scores(self, score_k, leaf_id, feat_idx, feat_valid, coeff, const, fallback,
                           is_lin, value_lut):
        """``score_k`` += a freshly grown linear tree's outputs at the rows
        of its partition, chunk by chunk (``tree.linear.linear_leaf_scores``
        out of core)."""
        from ..tree.linear import linear_scores_chunk

        w = num_words(self.num_features, self.per)
        for start, stop, p in self._chunks():
            delta = linear_scores_chunk(words_column(p[:w], self.per, self.bits), leaf_id, start,
                                        stop, feat_idx, feat_valid, coeff, const, fallback,
                                        is_lin, value_lut)
            scatter_add_slice(score_k, delta, start)
        return score_k
