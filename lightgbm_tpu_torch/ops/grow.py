"""Mask-based leaf-wise grower — PyTorch counterpart of
lightgbm_tpu/ops/grow.py ``grow_tree`` in serial mode with the default
tree strategy (SerialTreeLearner::Train, serial_tree_learner.cpp:152-207).

The port's second tree learner, beside the partitioned one of
ops/pgrow.py: GBDT routes to it every configuration the fused path
declines (quantized training, more than 16 classes, multiclass GOSS,
more than 256 bins, more than 512 columns; boosting/ptrainer.py
``eligible``).  As in the JAX package:

- rows never move: one ``leaf_id`` (N,) vector is the data partition,
  updated per split by the predicate on the split feature's bin
  (DataPartition::Split with the zero-bin remap, dense_bin.hpp:191-232);
- every leaf keeps its (F, B, 3) histogram in a dense pool; the smaller
  child by row count is built, the larger is parent minus smaller;
- the best-first loop splits the leaf of largest gain (the first on
  ties) and searches only the two new children.

Every histogram is one masked pass over all N rows: the select row of
the packed matrix holds the leaf's rows (bagging select x leaf mask), and
the kernels (ops/histogram.py ``hist_segment``, ``hist_segment_q``) skip
a row whose select is 0 after reading its select word, 4 B.  The JAX
package's ``_tiers`` compaction (grow.py:92-113) exists to give XLA
static gather shapes; its quantized branch already runs un-tiered, and
here both branches do.  Quantized training: int16 levels in, an int32
pool, exact integer root sums, and dequantization only at split-scan time.

The bookkeeping (best-split table, leaf sums and outputs, records) lives
on the host in float32 numpy, the partition, histograms and split search
on the device; each split reads its two children's best splits back,
one host sync.  On the card the two children's split search (hundreds
of small PyTorch operations) is captured once as a CUDA graph and
replayed for every split (``_ChildSearch``): the same kernels in one
launch.

Out of core (boosting/ooc.py) the same loop runs with ``stream``, a
``data/chunksource.py ChunkFolder``, in place of the resident words: the
root histogram and each split's partition and child histograms are one
streamed pass each over row chunks copied to the card (``fold_root``,
``fold_split``), folding both children into float64 (int32) carries that
are rounded once after the pass; everything else is this function's.

Monotone constraints (JAX grow.py l.214-224, 428-429, 455-470, 509-522):
each leaf carries output bounds [lo, hi] in the host bookkeeping, the
root (-inf, +inf).  A split's child outputs are clipped to its parent's
bounds, and on a constrained feature the children's bounds meet at the
midpoint of the two outputs (BasicLeafConstraints); the split search
scores each leaf within its bounds (ops/split.py).  Linear leaves are
fitted after growth (tree/linear.py, boosting/gbdt.py).  The data,
feature and voting modes of the JAX grower are not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..obs.trace import note_compile
from .histogram import hist_segment, hist_segment_q, histogram_from_parent, upload
from .qhist import dequantize_hist, dequantize_sums
from .split import NEG_INF, FeatureMeta, SplitHyper, best_split_all_features, leaf_output_np


class GrowParams(NamedTuple):
    """Growth parameters; ``bits`` is the width of a bin in the packed
    words (8, or 16 for more than 256 bins); ``monotone`` the per-inner-
    feature directions of the tree strategy (``TreeStrategy.split_gain``;
    empty: unconstrained)."""

    num_leaves: int
    num_bins: int  # padded B
    max_depth: int = -1
    use_missing: bool = True
    has_categorical: bool = True
    bits: int = 8
    monotone: tuple = ()


class GrowResult(NamedTuple):
    """The grown tree: split records on the host (record s = s-th
    split), the final leaf of every row on the device."""

    num_splits: int
    leaf_id: torch.Tensor  # (N,) int32
    leaf_value: np.ndarray  # (L,) f32 raw outputs
    leaf_cnt: np.ndarray  # (L,) f32
    rec_leaf: np.ndarray  # (L-1,) int32
    rec_feat: np.ndarray
    rec_thr: np.ndarray
    rec_dbz: np.ndarray
    rec_gain: np.ndarray  # (L-1,) f32
    rec_lval: np.ndarray
    rec_rval: np.ndarray
    rec_lcnt: np.ndarray
    rec_rcnt: np.ndarray
    rec_internal_value: np.ndarray  # the parent's value


def _best_rows(hist, sums, meta, hyper, feature_mask, params, quantized, qs, mono=None,
               bounds=None):
    """(S, 8) float32 best splits [gain, feat, thr, dbz, lg, lh, lc, 0] of
    S leaves on the device: hist (S, F, B, 3), sums (S, 3) float32; with
    ``mono`` the (F,) directions, ``bounds`` the (2, S) leaves' [lo, hi]."""
    if quantized:
        hist = dequantize_hist(hist, qs)
    lo, hi = (None, None) if mono is None else (bounds[0], bounds[1])
    r = best_split_all_features(hist, sums[:, 0], sums[:, 1], sums[:, 2], meta, hyper,
                                feature_mask, params.use_missing, params.has_categorical,
                                xla_prefix=quantized, monotone=mono, leaf_lo=lo, leaf_hi=hi)
    return torch.stack([r.gain, r.feature.float(), r.threshold_bin.float(),
                        r.default_bin_for_zero.float(), r.left_sum_g, r.left_sum_h,
                        r.left_cnt, torch.zeros_like(r.gain)], dim=1)


class _ChildSearch:
    """The split search of two children as one CUDA graph: static input
    buffers (the histograms, sums, feature mask, scales and, under
    monotone constraints, the children's (2, 2) bounds), captured on the
    first call and replayed after; it holds the FeatureMeta it was
    captured with and its own copy of the monotone directions."""

    def __init__(self, dev, F, B, meta, hyper, params, quantized):
        self.meta, self.args = meta, (hyper, params, quantized)
        self.hist = torch.zeros((2, F, B, 3), dtype=torch.int32 if quantized else torch.float32,
                                device=dev)
        self.sums = torch.zeros((2, 3), dtype=torch.float32, device=dev)
        self.fmask = torch.zeros(F, dtype=torch.float32, device=dev)
        self.qs = torch.ones(2, dtype=torch.float32, device=dev)
        self.bounds = torch.zeros((2, 2), dtype=torch.float32, device=dev)
        self.mono = monotone_tensor(params, dev)
        self.graph = None

    def _run(self):
        hyper, params, quantized = self.args
        return _best_rows(self.hist, self.sums, self.meta, hyper, self.fmask, params, quantized,
                          self.qs, self.mono, self.bounds)

    def __call__(self, left, right, sums, feature_mask, qs, bounds=None):
        self.hist[0].copy_(left)
        self.hist[1].copy_(right)
        self.sums.copy_(sums)
        self.fmask.copy_(feature_mask)
        if qs is not None:
            self.qs.copy_(qs)
        if bounds is not None:
            self.bounds.copy_(bounds)
        if self.graph is None:
            side = torch.cuda.Stream(self.hist.device)
            side.wait_stream(torch.cuda.current_stream(self.hist.device))
            with torch.cuda.stream(side):
                self._run()  # warm-up outside the capture
            torch.cuda.current_stream(self.hist.device).wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                self.out = self._run()
            note_compile("graph_capture")
        self.graph.replay()
        return self.out


def monotone_tensor(params: GrowParams, dev):
    """The (F,) int64 monotone directions on ``dev``, or None when no
    feature is constrained."""
    if not any(c != 0 for c in params.monotone):
        return None
    return torch.tensor(params.monotone, dtype=torch.int64, device=dev)


def _child_search(searches: dict, dev, F, B, meta, hyper, params,
                  quantized) -> _ChildSearch:
    """The captured child search for these shapes and parameters, from the
    caller's ``searches`` (each entry holds the meta tensors it keys on,
    so their addresses stay theirs); ``params`` carries the monotone
    directions, so a constrained and an unconstrained search never share
    a graph."""
    key = (str(dev), F, B, tuple(float(v) for v in hyper), params, quantized,
           tuple(t.data_ptr() for t in meta))
    if key not in searches:
        searches[key] = _ChildSearch(dev, F, B, meta, hyper, params, quantized)
    return searches[key]


def word_column(row: torch.Tensor, feat: int, per: int, bits: int) -> torch.Tensor:
    """Feature ``feat``'s bins from its int32 word row (``pack_bin_words``)."""
    return (row >> ((feat % per) * bits)) & ((1 << bits) - 1)


def partition_goes_left(col: torch.Tensor, zero_bin: int, dbz: int, thr: int,
                        is_cat: bool) -> torch.Tensor:
    """DataPartition::Split's predicate on the split feature's bins
    (dense_bin.hpp:191-232): the zero bin takes the split's default bin,
    then ``==`` the threshold (categorical) or ``<=`` it."""
    fval = torch.where(col == zero_bin, dbz, col)
    return (fval == thr) if is_cat else (fval <= thr)


def value_words(grad, hess, select):
    """The kernels' (g, h, select) channel rows as (N,) int32: float32 bits,
    or the int16 levels and the 0/1 select as plain int32 words."""
    if not torch.is_floating_point(grad):
        return grad.to(torch.int32), hess.to(torch.int32), select.to(torch.int32)
    return (grad.to(torch.float32).view(torch.int32), hess.to(torch.float32).view(torch.int32),
            select.to(torch.float32).view(torch.int32))


def root_totals(grad, hess, select, qscale=None) -> np.ndarray:
    """The root's (3,) float32 [sum g, sum h, count] over the selected rows
    (LeafSplits::Init): float64 sums rounded once, or exact integer sums
    of the levels dequantized."""
    if not torch.is_floating_point(grad):
        s64 = select.to(torch.int64)
        sums_q = torch.stack([(grad.to(torch.int64) * s64).sum(),
                              (hess.to(torch.int64) * s64).sum(), s64.sum()]).cpu().numpy()
        return dequantize_sums(sums_q, qscale)
    sel32 = select.to(torch.float32)
    return torch.stack([(grad * sel32).double().sum(), (hess * sel32).double().sum(),
                        sel32.double().sum()]).float().cpu().numpy()


def grow_tree(words: torch.Tensor, grad: torch.Tensor, hess: torch.Tensor,
              select: torch.Tensor, feature_mask: torch.Tensor, meta: FeatureMeta,
              hyper: SplitHyper, params: GrowParams, qscale=None,
              searches: dict = None, stream=None) -> GrowResult:
    """Grow one leaf-wise tree.

    words: the (W, N) int32 bin words of the training bins
    (``histogram.pack_bin_words``, packed once per training), or None
    with ``stream`` (out of core: a ``ChunkFolder`` that streams them);
    grad, hess: (N,) float32, or int16 levels (``qhist.quantize_rows``)
    with ``qscale`` their (2,) float32 scales; select: (N,) float32 0/1
    bagging mask; feature_mask: (F,) float32 0/1; ``searches``: a dict
    the caller keeps from tree to tree, so the split search's CUDA graph
    is captured once (without it, once per tree)."""
    quantized = not torch.is_floating_point(grad)
    if quantized and qscale is None:
        raise ValueError("integer grad/hess require the qscale argument")
    dev = grad.device
    n = grad.shape[0]
    F = int(meta.num_bins.shape[0])
    L, B, bits = params.num_leaves, params.num_bins, params.bits
    per = 32 // bits
    l1, l2 = np.float32(hyper.lambda_l1), np.float32(hyper.lambda_l2)
    default_bin = meta.default_bin.cpu().numpy()
    is_cat = meta.is_categorical.cpu().numpy()
    g_w, h_w, sel_w = value_words(grad, hess, select)
    if quantized:
        qs = upload(torch.from_numpy(np.asarray(qscale, np.float32)), dev)
    mono_t = params.monotone
    mono = monotone_tensor(params, dev)
    if mono is not None and len(mono_t) != F:
        raise ValueError(f"monotone direction vector has {len(mono_t)} entries for {F} features")

    if stream is None:
        # the packed matrix of the kernels: bin words, g, h, and a select
        # row rewritten for each leaf histogram
        W = words.shape[0]
        p = torch.empty((W + 3, n), dtype=torch.int32, device=dev)
        p[:W] = words
        p[W] = g_w
        p[W + 1] = h_w
        hist_fn = hist_segment_q if quantized else hist_segment

        def hist_of(sel_row):
            p[W + 2] = sel_row
            return hist_fn(p, 0, n, F, B, per, bits)

    search = None
    if dev.type == "cuda":
        search = _child_search({} if searches is None else searches, dev, F, B, meta, hyper,
                               params, quantized)

    def find_best(hists, sums, depth_ok, lo=None, hi=None):
        """(S, 8) f32 numpy best splits [gain, feat, thr, dbz, lg, lh, lc,
        0] of S leaves: hists, S (F, B, 3) histograms; sums (S, 3) f32;
        under monotone constraints ``lo``/``hi`` the (S,) bounds."""
        s = upload(torch.from_numpy(np.ascontiguousarray(sums, np.float32)), dev)
        bounds = None
        if mono is not None:
            bounds = upload(torch.from_numpy(np.array([lo, hi], np.float32)), dev)
        if search is not None and len(hists) == 2:
            rows = search(hists[0], hists[1], s, feature_mask, qs if quantized else None, bounds)
        else:
            rows = _best_rows(torch.stack(hists), s, meta, hyper, feature_mask, params,
                              quantized, qs if quantized else None, mono, bounds)
        out = rows.cpu().numpy()
        out[~np.asarray(depth_ok, bool), 0] = NEG_INF
        return out

    # ---- root (LeafSplits::Init + the root histogram)
    root_sums = root_totals(grad, hess, select, qscale)
    root_hist = (hist_of(sel_w) if stream is None
                 else stream.fold_root(g_w, h_w, sel_w, quantized))
    pool = torch.zeros((L, F, B, 3), dtype=root_hist.dtype, device=dev)
    pool[0] = root_hist

    # the leaves' output bounds (monotone constraints; unused without)
    leaf_lo = np.full(L, -np.inf, np.float32)
    leaf_hi = np.full(L, np.inf, np.float32)
    bs = np.full((L, 8), NEG_INF, np.float32)
    bs[0] = find_best([root_hist], root_sums[None], [True], leaf_lo[:1], leaf_hi[:1])[0]
    leaf_sum = np.zeros((L, 3), np.float32)
    leaf_sum[0] = root_sums
    leaf_value = np.zeros(L, np.float32)
    leaf_cnt = np.zeros(L, np.float32)
    leaf_cnt[0] = root_sums[2]
    leaf_depth = np.zeros(L, np.int64)
    leaf_rows = torch.zeros(L, dtype=torch.int64, device=dev)
    leaf_rows[0] = n
    leaf_id = torch.zeros(n, dtype=torch.int32, device=dev)
    rec_i = np.zeros((4, L - 1), np.int32)  # leaf, feat, thr, dbz
    rec_f = np.zeros((6, L - 1), np.float32)  # gain, lval, rval, lcnt, rcnt, internal

    s = 0
    while s < L - 1:
        bl = int(np.argmax(bs[:, 0]))
        gain = bs[bl, 0]
        if not gain > 0.0:  # no split with positive gain (serial_tree_learner.cpp:191)
            break
        right = s + 1
        feat, thr, dbz = int(bs[bl, 1]), int(bs[bl, 2]), int(bs[bl, 3])
        left = bs[bl, 4:7].copy()
        rsum = leaf_sum[bl] - left
        lval = leaf_output_np(left[0], left[1], l1, l2)
        rval = leaf_output_np(rsum[0], rsum[1], l1, l2)
        clo, chi = leaf_lo[[bl, bl]], leaf_hi[[bl, bl]]  # children's (left, right) bounds
        if mono is not None:
            # outputs clipped to the parent's bounds; on a constrained
            # feature the children's bounds meet at the outputs' midpoint
            plo, phi = leaf_lo[bl], leaf_hi[bl]
            lval, rval = np.clip(lval, plo, phi), np.clip(rval, plo, phi)
            mid = (lval + rval) * np.float32(0.5)
            if mono_t[feat] > 0:
                chi[0] = clo[1] = mid
            elif mono_t[feat] < 0:
                clo[0] = chi[1] = mid

        if stream is None:
            # ---- partition by predicate on the split feature's bin
            goes_left = partition_goes_left(word_column(p[feat // per], feat, per, bits),
                                            int(default_bin[feat]), dbz, thr, bool(is_cat[feat]))
            in_leaf = leaf_id == bl
            leaf_id.masked_fill_(in_leaf & ~goes_left, right)

            # ---- the smaller child by row count direct, the larger by
            # subtraction (decided on the device: no sync)
            n_left = (in_leaf & goes_left).sum()
            n_right = leaf_rows[bl] - n_left
            left_smaller = n_left < n_right
            smaller_id = torch.where(left_smaller, bl, right)
            smaller = hist_of(torch.where(leaf_id == smaller_id, sel_w, 0))
            larger = histogram_from_parent(pool[bl], smaller)
            left_hist = torch.where(left_smaller, smaller, larger)
            right_hist = torch.where(left_smaller, larger, smaller)
        else:
            # ---- one streamed pass: the partition and both children's
            # carries; then the same smaller / larger rule
            n_left, carry_l, carry_r = stream.fold_split(
                leaf_id, g_w, h_w, sel_w, feat, int(default_bin[feat]), dbz, thr,
                bool(is_cat[feat]), bl, right, quantized)
            n_right = leaf_rows[bl] - n_left
            left_hist, right_hist = stream.pick_children(pool[bl], carry_l, carry_r, n_left,
                                                         n_right)
        pool[bl] = left_hist
        pool[right] = right_hist
        leaf_rows[bl] = n_left
        leaf_rows[right] = n_right

        # ---- both children's best splits (the max_depth gate)
        depth = leaf_depth[bl] + 1
        ok = params.max_depth <= 0 or depth < params.max_depth
        res = find_best([left_hist, right_hist], np.stack([left, rsum]), [ok, ok], clo, chi)

        rec_i[:, s] = (bl, feat, thr, dbz)
        rec_f[:, s] = (gain, lval, rval, left[2], rsum[2], leaf_value[bl])
        leaf_sum[bl], leaf_sum[right] = left, rsum
        leaf_value[bl], leaf_value[right] = lval, rval
        leaf_cnt[bl], leaf_cnt[right] = left[2], rsum[2]
        leaf_depth[bl] = leaf_depth[right] = depth
        leaf_lo[[bl, right]], leaf_hi[[bl, right]] = clo, chi
        bs[bl], bs[right] = res[0], res[1]
        s += 1

    return GrowResult(s, leaf_id, leaf_value, leaf_cnt, *rec_i, *rec_f)
