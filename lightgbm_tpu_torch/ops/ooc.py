"""Chunk steps of out-of-core tree growth — PyTorch counterpart of
lightgbm_tpu/ops/ooc.py.

Out of core (boosting/ooc.py) every per-row vector (grad, hess, select,
``leaf_id``, scores) stays on the device and only the bin matrix streams,
in row chunks (data/prefetch.py).  These are the mask grower's
(ops/grow.py ``grow_tree``) matrix steps cut at a chunk boundary:

  ``chunk_matrix``       a chunk's bins into the kernels' packed layout
  ``root_hist_chunk``    one chunk's rows into the root histogram's carry
  ``split_chunk``        one chunk's share of a split: its ``leaf_id``
                         slice partitioned by the grower's predicate,
                         the left rows counted, both children's rows
                         folded into their carries
  ``root_totals``        the root sums (the resident vectors' reductions)
  ``find_best_split``    the best split of one accumulated histogram
  ``child_leaf_values``  the two children's outputs
  ``subtract_sibling``   the histogram subtraction trick
  ``scatter_add_slice``  ``vec[start:start + len(delta)] += delta``

A chunk's packed matrix is (W + 4, C) int32: the W bin words, then g, h
and two select rows (the left and the right child's, or the root's
select in the first).  The histograms fold through B8/B9's carry mode
(ops/histogram.py ``accumulate_histogram``): float64 (int32) sums that
are rounded once, after the pass, so the streamed histograms are the
resident grower's for any chunk grid.
"""

from __future__ import annotations

import numpy as np
import torch

from .grow import _best_rows, partition_goes_left, root_totals, word_column
from .histogram import accumulate_histogram, histogram_from_parent
from .split import leaf_output_np

__all__ = ["chunk_matrix", "root_hist_chunk", "split_chunk", "root_totals",
           "find_best_split", "child_leaf_values", "subtract_sibling", "scatter_add_slice"]


def chunk_matrix(chunk: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """The (W + 4, C) packed matrix of a (C, cols) chunk of bins
    (data/prefetch.py: cols whole words), in the flat int32 buffer
    ``out``: rows 0..W-1 get the chunk's words, the other four are left
    for the caller."""
    words = chunk.view(torch.int32)  # (C, W): the packed words, transposed
    c, w = words.shape
    p = out[:(w + 4) * c].view(w + 4, c)
    p[:w].copy_(words.T)
    return p


def root_hist_chunk(carry, p, g_w, h_w, sel_w, start: int, num_features: int, num_bins: int,
                    per: int, bits: int):
    """Fold the chunk of packed matrix ``p`` (rows [start, start + C) of
    the full (N,) int32 channel rows ``g_w``, ``h_w``, ``sel_w``) into the
    root histogram's ``carry``."""
    c = p.shape[1]
    w = p.shape[0] - 4
    p[w].copy_(g_w[start:start + c])
    p[w + 1].copy_(h_w[start:start + c])
    p[w + 2].copy_(sel_w[start:start + c])
    return accumulate_histogram(carry, p, 0, c, num_features, num_bins, per, bits,
                                rows=(w, w + 1, w + 2))


def split_chunk(leaf_id, carry_l, carry_r, n_left, p, g_w, h_w, sel_w, start: int, feat: int,
                zero_bin: int, dbz: int, thr: int, is_cat: bool, bl: int, rl: int,
                num_features: int, num_bins: int, per: int, bits: int):
    """One chunk's share of splitting leaf ``bl`` into ``bl`` (left) and
    ``rl`` (right): the chunk's ``leaf_id`` slice updated in place by the
    grower's predicate, its left rows added to ``n_left`` (an int64
    device scalar; returned), and both children's selected rows folded
    into ``carry_l`` / ``carry_r``.  Both children cost one pass: the
    transfer, not the histogram, bounds the streamed split."""
    c = p.shape[1]
    w = p.shape[0] - 4
    lid = leaf_id[start:start + c]
    goes_left = partition_goes_left(word_column(p[feat // per], feat, per, bits), zero_bin, dbz,
                                    thr, is_cat)
    in_leaf = lid == bl
    lid.masked_fill_(in_leaf & ~goes_left, rl)
    n_left = n_left + (in_leaf & goes_left).sum()
    sel = sel_w[start:start + c]
    p[w].copy_(g_w[start:start + c])
    p[w + 1].copy_(h_w[start:start + c])
    p[w + 2] = torch.where(lid == bl, sel, 0)
    p[w + 3] = torch.where(lid == rl, sel, 0)
    accumulate_histogram(carry_l, p, 0, c, num_features, num_bins, per, bits,
                         rows=(w, w + 1, w + 2))
    accumulate_histogram(carry_r, p, 0, c, num_features, num_bins, per, bits,
                         rows=(w, w + 1, w + 3))
    return n_left


def find_best_split(hist, sums, feature_mask, depth_ok: bool, meta, hyper, params,
                    qscale=None, mono=None, lo=None, hi=None) -> np.ndarray:
    """The best split of one (F, B, 3) histogram (int32 under quantized
    training, with ``qscale``) with the (3,) float32 ``sums``, as the
    grower searches it: (8,) float32 [gain, feat, thr, dbz, lg, lh, lc, 0],
    the gain -inf when ``depth_ok`` is false."""
    dev = hist.device
    quantized = hist.dtype == torch.int32
    s = torch.from_numpy(np.asarray(sums, np.float32).reshape(1, 3)).to(dev)
    qs = None if qscale is None else torch.as_tensor(np.asarray(qscale, np.float32), device=dev)
    bounds = None
    if mono is not None:
        bounds = torch.tensor([[lo], [hi]], dtype=torch.float32, device=dev)
    row = _best_rows(hist[None], s, meta, hyper, feature_mask, params, quantized, qs, mono,
                     bounds)[0].cpu().numpy()
    if not depth_ok:
        row[0] = -np.inf
    return row


def child_leaf_values(left, right, l1, l2, lo=None, hi=None):
    """The two children's outputs (CalculateSplittedLeafOutput) from
    their (g, h) sums, clipped to [lo, hi] when bounds are given."""
    lval = leaf_output_np(left[0], left[1], np.float32(l1), np.float32(l2))
    rval = leaf_output_np(right[0], right[1], np.float32(l1), np.float32(l2))
    if lo is not None:
        lval, rval = np.clip(lval, lo, hi), np.clip(rval, lo, hi)
    return lval, rval


def subtract_sibling(parent_hist, smaller_hist):
    """FeatureHistogram::Subtract: the larger child is parent - smaller."""
    return histogram_from_parent(parent_hist, smaller_hist)


def scatter_add_slice(vec, delta, start: int):
    """``vec[start:start + len(delta)] += delta`` in place (the streamed
    score pass); returns ``vec``."""
    vec[start:start + delta.shape[0]] += delta
    return vec
