"""The partitioned trainer's packed matrix and its kernels.

PyTorch counterpart of lightgbm_tpu/ops/pkernels.py (and of
``hist_segments`` in lightgbm_tpu/ops/histogram_pallas.py).  The training
matrix ``P`` keeps the JAX package's layout exactly: one (C, N + BLK)
int32 tensor whose rows are

    0..W-1          : packed bin words, 32/bits bins per int32
    W..WPAD-1       : padding (WPAD = W rounded up to 8)
    WPAD + 2k       : grad of class k  (f32 bit pattern), k < K
    WPAD + 2k + 1   : hess of class k  (f32 bit pattern)
    WPAD + 2K       : select (f32 bit pattern; 0/1 row mask)
    WPAD + 2K + 1.. : K scores, label, row id, weight (the 8-aligned "band")

K = 1 gives the single-tree order (grad, hess, select, score, ...).
Rows are kept physically partitioned by leaf: each leaf owns a
contiguous column range [start, start + cnt).

Each kernel has a wrapper and a plain PyTorch version beside it:

    update_and_root_hist    /  update_and_root_hist_ref
    update_channels         /  update_channels_ref
    update_multi_and_hists  /  update_multi_and_hists_ref
    level_stream            /  level_stream_ref
    split_stream            /  split_stream_ref
    score_add               /  score_add_ref
    hist_dyn                /  hist_dyn_ref
    hist_segments           /  hist_segments_ref

A wrapper given a tensor on the CPU runs the plain version; given a CUDA
tensor it launches the hand-written kernel (``csrc/``, built by
``ops/_build.py``) and raises if the launch fails — it never falls back.
Each wrapper counts its kernel launches in ``<wrapper>.launches``.

The matrix is updated IN PLACE (the JAX package donates it through
``input_output_aliases``); the wrappers still return it so call sites
read like the JAX ones.  Histograms are returned as f32 (F, B, 3) of
(sum g*sel, sum h*sel, sum sel) — the JAX kernels' 3-term bf16 planes
are already re-summed.  Kernels and plain versions alike sum in float64
and round once (csrc/common.cuh ``hacc``), so both give the correctly
rounded sums, whatever the order of the additions.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..utils.device import device_of, raw_stream
from . import _build
from .histogram import (TALLY_SLOTS, hist_segment, hist_segment_q, reset_selected_rows,
                        segment_hist_launch, selected_rows, stream_workspace, upload)

BLK = 1024  # tail columns past the last row (the JAX kernels' DMA block)
PART_CHUNK = 512  # a partition tile is a whole number of these (one step of a 512-thread block)
PART_MAX_TILE = 1 << 17  # most rows a partition tile takes: its left bits fill 16 KB of shared memory
PART_MAX_SEGMENTS = 512  # rows of a segment table (csrc kPlanThreads: one plan thread each)
MAX_CLASSES = 16  # score channels update_multi_and_hists takes (csrc kMaxK)


def num_words(num_features: int, bits: int = 8) -> int:
    return -(-num_features // (32 // bits))


class PLayout:
    """Channel-row indices inside the packed matrix: K (grad, hess) row
    pairs and K score rows for ``num_score = K`` trees per iteration
    (multiclass computes all K gradient planes once per iteration,
    gbdt.cpp:692-700)."""

    def __init__(self, num_features: int, num_score: int = 1, with_weight: bool = True,
                 bits: int = 8):
        self.F = num_features
        self.bits = bits
        self.per = 32 // bits
        self.W = num_words(num_features, bits)
        self.WPAD = -(-self.W // 8) * 8
        K = num_score
        self.num_score = K
        self.G = self.WPAD  # class-0 pair (g_row(0), h_row(0))
        self.H = self.WPAD + 1
        self.SEL = self.WPAD + 2 * K
        self.SCORE = self.SEL + 1  # .. SCORE + K - 1
        self.LABEL = self.SCORE + K
        self.ROWID = self.LABEL + 1
        self.WEIGHT = self.ROWID + 1 if with_weight else -1
        self.with_weight = with_weight
        band = 2 * K + 1 + K + 2 + (1 if with_weight else 0)
        self.BAND = -(-band // 8) * 8
        self.C = self.WPAD + self.BAND

    def g_row(self, k: int) -> int:
        return self.WPAD + 2 * k

    def h_row(self, k: int) -> int:
        return self.WPAD + 2 * k + 1

    def class_rows(self, k: int):
        """(g, h, sel) row indices of class k."""
        return (self.g_row(k), self.h_row(k), self.SEL)

    @property
    def rows(self):
        """(g, h, sel) row indices of class 0."""
        return (self.G, self.H, self.SEL)


def pack_matrix(bins: np.ndarray, layout: PLayout, label=None, weight=None,
                num_real=None, device="cpu") -> torch.Tensor:
    """The (C, N + BLK) packed matrix from (N, F) uint8 bins, built on the
    host in row chunks and moved to ``device``.  grad/hess start at 0,
    select at 1 (0 for rows >= ``num_real``), the K scores at 0; rowid is
    the original row index."""
    bins = np.asarray(bins)
    n, f = bins.shape
    assert f == layout.F
    assert bins.dtype == np.uint8, "partitioned path requires max_bin <= 256"
    assert int(bins.max(initial=0)) < (1 << layout.bits), (
        f"bin values exceed the {layout.bits}-bit word field")
    nr = n if num_real is None else int(num_real)
    w, per, bits = layout.W, layout.per, layout.bits
    P = np.zeros((layout.C, n + BLK), np.int32)
    step = 1 << 20
    for lo in range(0, n, step):
        hi = min(n, lo + step)
        bb = np.pad(bins[lo:hi], ((0, 0), (0, w * per - f))).astype(np.uint32)
        bb = bb.reshape(hi - lo, w, per)
        words = np.zeros((hi - lo, w), np.uint32)
        for k in range(per):
            words |= bb[:, :, k] << (bits * k)
        P[:w, lo:hi] = words.view(np.int32).T
    P[layout.SEL, :nr] = np.float32(1.0).view(np.int32)
    if label is not None:
        P[layout.LABEL, :n] = np.asarray(label, np.float32).view(np.int32)
    P[layout.ROWID, :n] = np.arange(n, dtype=np.int32)
    if layout.with_weight:
        wv = np.ones(n, np.float32) if weight is None else np.asarray(weight, np.float32)
        P[layout.WEIGHT, :n] = wv.view(np.int32)
    return torch.from_numpy(P).to(device)


def f32_row(p: torch.Tensor, row: int, n: int) -> torch.Tensor:
    """Float32 view of channel ``row`` over the first ``n`` columns
    (shares memory with ``p``)."""
    return p[row, :n].view(torch.float32)


def unpack_bins(p: torch.Tensor, layout: PLayout, lo: int, hi: int) -> torch.Tensor:
    """(F, hi - lo) int64 bins of columns [lo, hi)."""
    words = p[: layout.W, lo:hi].to(torch.int64) & 0xFFFFFFFF
    f = torch.arange(layout.F, device=p.device)
    shift = ((f % layout.per) * layout.bits)[:, None]
    return (words[f // layout.per] >> shift) & ((1 << layout.bits) - 1)


def _hist_cols(cols: torch.Tensor, rows, num_features: int, num_bins: int,
               bits: int) -> torch.Tensor:
    """(F, B, 3) histogram of (g*sel, h*sel, sel) over the columns of a
    (C, m) block — one ``index_add_`` over flattened f*B + bin."""
    g_row, h_row, sel_row = rows
    m = cols.shape[1]
    lay = PLayout(num_features, bits=bits)
    sel = cols[sel_row].view(torch.float32)
    g = cols[g_row].view(torch.float32) * sel
    h = cols[h_row].view(torch.float32) * sel
    return _hist_values(unpack_bins(cols, lay, 0, m), g, h, sel, num_features, num_bins)


def _hist_values(bins, g, h, sel, num_features: int, num_bins: int) -> torch.Tensor:
    """(F, B, 3) float32 histogram of the (g, h, sel) rows by each
    feature's bin."""
    return _hist_matrix(bins, torch.stack([g, h, sel], dim=1), num_features, num_bins)


def _hist_matrix(bins, vals, num_features: int, num_bins: int) -> torch.Tensor:
    """(F, B, V) float32 histogram of the (n, V) value columns by each
    feature's bin: one ``index_add_`` per feature, summed in float64 and
    rounded once, as the kernels do."""
    vals = vals.double()
    out = torch.zeros((num_features, num_bins, vals.shape[1]), dtype=torch.float64,
                      device=bins.device)
    for f in range(num_features):
        keep = bins[f] < num_bins
        out[f].index_add_(0, bins[f][keep], vals[keep])
    return out.float()


def _check_matrix(p: torch.Tensor) -> None:
    if p.dtype != torch.int32 or p.dim() != 2 or not p.is_contiguous():
        raise ValueError("the packed matrix must be a contiguous 2-D int32 tensor")
    if p.device.type != "cuda":
        raise ValueError(f"expected a CUDA tensor, got {p.device}")


def _vec(v, n: int, device) -> torch.Tensor:
    t = torch.as_tensor(v, dtype=torch.float32, device=device).reshape(-1)
    if t.shape[0] < n:
        raise ValueError(f"vector of {t.shape[0]} values for {n} rows")
    return t[:n].contiguous()


# ======================================================================
# update_and_root_hist
# ======================================================================
def _fresh_gradients(p, layout: PLayout, objective, delta, n: int, k: int = 0):
    """score_k (+ delta) and the objective's (g, h) on it, as the update
    kernels compute them: the single-tree objective of ``p``'s rows."""
    score = f32_row(p, layout.SCORE + k, n)
    if delta is not None:
        score = score + _vec(delta, n, p.device)
    label = f32_row(p, layout.LABEL, n)
    weight = f32_row(p, layout.WEIGHT, n) if _use_weight(layout, objective) else None
    g, h = objective.gradients_rowwise(score, label, weight)
    return score, g, h


def update_and_root_hist_ref(p, layout: PLayout, objective, delta=None, sel=None, mul=None, *,
                             num_rows, num_features, num_bins, bits=8, rows=None,
                             with_hist=True):
    """Plain version: score += delta, (g, h) from the objective times
    ``mul``, select = sel, written in place over the first ``num_rows``
    columns; returns (p, root histogram of the fresh values, or None
    when ``with_hist`` is false)."""
    n = int(num_rows)
    score, g, h = _fresh_gradients(p, layout, objective, delta, n)
    if mul is not None:
        m = _vec(mul, n, p.device)
        g, h = g * m, h * m
    selv = _vec(sel, n, p.device) if sel is not None else f32_row(p, layout.SEL, n).clone()
    f32_row(p, layout.G, n).copy_(g)
    f32_row(p, layout.H, n).copy_(h)
    if sel is not None:
        f32_row(p, layout.SEL, n).copy_(selv)
    if delta is not None:
        f32_row(p, layout.SCORE, n).copy_(score)
    if not with_hist:
        return p, None
    hist = _hist_values(unpack_bins(p, layout, 0, n), g * selv, h * selv, selv,
                        num_features, num_bins)
    return p, hist


def _use_weight(layout: PLayout, objective) -> bool:
    return layout.with_weight and getattr(objective, "weights", None) is not None


def update_and_root_hist(p, layout: PLayout, objective, delta=None, sel=None, mul=None, *,
                         num_rows, num_features, num_bins, bits=8, rows=None, with_hist=True):
    """One pass over all rows: score += delta, fresh (g, h) from
    ``objective`` (its ``kernel_params()``) scaled by ``mul`` (GOSS's
    up-weighting of the sampled rest; the select channel is not
    scaled), select = sel, in place; and the root (F, B, 3) histogram of
    the fresh values.  GBDT::Boosting + the root ConstructHistogram
    (gbdt.cpp:692-700).  ``with_hist=False`` runs the same channel writes
    without the histogram and returns (p, None)."""
    if p.device.type == "cpu":
        return update_and_root_hist_ref(
            p, layout, objective, delta, sel, mul, num_rows=num_rows,
            num_features=num_features, num_bins=num_bins, bits=bits, rows=rows,
            with_hist=with_hist)
    _check_matrix(p)
    rows = rows or layout.rows
    if tuple(rows) != layout.rows:
        raise ValueError("update_and_root_hist writes the layout's own g/h/sel rows")
    n = int(num_rows)
    d, s, m = (_vec(v, n, p.device) if v is not None else None for v in (delta, sel, mul))
    cells = num_features * num_bins * 3
    hist = torch.empty((num_features, num_bins, 3), dtype=torch.float32,
                       device=p.device) if with_hist else None
    kind, p0, p1, p2 = objective.kernel_params()
    lib = _build.lib()
    with stream_workspace(p, 0, cells if with_hist else 0) as (w, stream):
        rc = lib.lgbt_update_root_hist(
            p.data_ptr(), p.shape[1], n, *(None if v is None else v.data_ptr() for v in (d, s, m)),
            int(bool(with_hist)), layout.G, layout.H, layout.SEL, layout.SCORE, layout.LABEL,
            layout.WEIGHT, int(_use_weight(layout, objective)), kind, p0, p1, p2,
            num_features, num_bins, bits, w.ticket_ptr, w.cells.data_ptr(),
            None if hist is None else hist.data_ptr(), stream)
    _build.check(rc, "update_and_root_hist")
    update_and_root_hist.launches += 1
    return p, hist


update_and_root_hist.launches = 0


# ======================================================================
# update_channels: score += delta, fresh (g, h), select — no histogram
# ======================================================================
def update_channels_ref(p, layout: PLayout, objective, delta=None, sel=None, k_class=0, *,
                        num_rows):
    """Plain version of update_channels."""
    n = int(num_rows)
    score, g, h = _fresh_gradients(p, layout, objective, delta, n, k_class)
    f32_row(p, layout.G, n).copy_(g)
    f32_row(p, layout.H, n).copy_(h)
    if sel is not None:
        f32_row(p, layout.SEL, n).copy_(_vec(sel, n, p.device))
    if delta is not None:
        f32_row(p, layout.SCORE + k_class, n).copy_(score)
    return p


def update_channels(p, layout: PLayout, objective, delta=None, sel=None, k_class=0, *,
                    num_rows):
    """In place over the first ``num_rows`` columns: score channel
    ``k_class`` += delta, then (g, h) = the objective on that score into
    the layout's class-0 g/h rows, then select = sel when given.  No
    histogram: GOSS's prep pass (ptrainer.py:378-382), the channel writes
    of ``update_and_root_hist(..., with_hist=False)`` bit for bit.  The
    Pallas kernel streams whole 1024-column blocks and so also rewrites
    padding columns past ``num_rows``; this one writes none of them."""
    if p.device.type == "cpu":
        return update_channels_ref(p, layout, objective, delta, sel, k_class,
                                   num_rows=num_rows)
    _check_matrix(p)
    n = int(num_rows)
    if not 0 <= k_class < layout.num_score:
        raise ValueError(f"score channel {k_class} of {layout.num_score}")
    d, s = (_vec(v, n, p.device) if v is not None else None for v in (delta, sel))
    kind, p0, p1, p2 = objective.kernel_params()
    with torch.cuda.device(p.device):
        rc = _build.lib().lgbt_update_channels(
            p.data_ptr(), p.shape[1], n, None if d is None else d.data_ptr(),
            None if s is None else s.data_ptr(), layout.G, layout.H, layout.SEL,
            layout.SCORE + k_class, layout.LABEL, layout.WEIGHT,
            int(_use_weight(layout, objective)), kind, p0, p1, p2, raw_stream(p))
    _build.check(rc, "update_channels")
    update_channels.launches += 1
    return p


update_channels.launches = 0


# ======================================================================
# update_multi_and_hists: K gradient planes + K root histograms
# ======================================================================
def _multi_hists(out: torch.Tensor, K: int) -> torch.Tensor:
    """(F, B, 2K+1) sums [g_0, h_0, .., g_{K-1}, h_{K-1}, cnt] ->
    (K, F, B, 3) histograms sharing the count plane."""
    g = out[..., 0:2 * K:2].permute(2, 0, 1)
    h = out[..., 1:2 * K:2].permute(2, 0, 1)
    c = out[..., 2 * K].expand(K, *out.shape[:2])
    return torch.stack([g, h, c], dim=-1).contiguous()


def update_multi_and_hists_ref(p, layout: PLayout, objective, sel=None, *, num_rows,
                               num_features, num_bins, bits=8):
    """Plain version: all K (g, h) planes from the K score channels
    (``objective.gradients_rowwise_all``), select = sel, written in
    place over the first ``num_rows`` columns; returns (p, (K, F, B, 3)
    root histograms of the fresh values)."""
    n, K = int(num_rows), layout.num_score
    scores = torch.stack([f32_row(p, layout.SCORE + k, n) for k in range(K)])
    label = f32_row(p, layout.LABEL, n)
    weight = f32_row(p, layout.WEIGHT, n) if _use_weight(layout, objective) else None
    g, h = objective.gradients_rowwise_all(scores, label, weight)
    selv = _vec(sel, n, p.device) if sel is not None else f32_row(p, layout.SEL, n).clone()
    for k in range(K):
        f32_row(p, layout.g_row(k), n).copy_(g[k])
        f32_row(p, layout.h_row(k), n).copy_(h[k])
    if sel is not None:
        f32_row(p, layout.SEL, n).copy_(selv)
    vals = torch.stack([g * selv, h * selv], dim=1).reshape(K * 2, n)
    vals = torch.cat([vals, selv[None]], dim=0).t()
    out = _hist_matrix(unpack_bins(p, layout, 0, n), vals, num_features, num_bins)
    return p, _multi_hists(out, K)


def update_multi_and_hists(p, layout: PLayout, objective, sel=None, *, num_rows,
                           num_features, num_bins, bits=8):
    """One pass over all rows: every class's (g, h) from the same score
    snapshot (softmax across the K scores of a row, or one-vs-all), the
    select channel = sel, in place; and the K root (F, B, 3) histograms
    of the fresh values, sharing one count plane.  GBDT::Boosting + the
    root ConstructHistogram for the K trees of a multiclass iteration
    (gbdt.cpp:692-700).  Returns (p, (K, F, B, 3))."""
    if p.device.type == "cpu":
        return update_multi_and_hists_ref(p, layout, objective, sel, num_rows=num_rows,
                                          num_features=num_features, num_bins=num_bins,
                                          bits=bits)
    _check_matrix(p)
    n, K = int(num_rows), layout.num_score
    kind, kk, sigmoid, w_pos, w_neg = objective.kernel_params()
    if kk != K or not 1 <= K <= MAX_CLASSES:
        raise ValueError(f"objective of {kk} classes for a layout of {K} score channels "
                         f"(at most {MAX_CLASSES})")
    s = _vec(sel, n, p.device) if sel is not None else None
    # the label weights go by value in the launch's parameters: no upload
    wts = np.concatenate([w_pos, w_neg]).astype(np.float32)
    hists = torch.empty((K, num_features, num_bins, 3), dtype=torch.float32, device=p.device)
    lib = _build.lib()
    with stream_workspace(p, 0, num_features * num_bins * (2 * K + 1)) as (w, stream):
        rc = lib.lgbt_update_multi_hist(
            p.data_ptr(), p.shape[1], n, None if s is None else s.data_ptr(),
            layout.G, layout.SEL, layout.SCORE, layout.LABEL, layout.WEIGHT,
            int(_use_weight(layout, objective)), kind, K, sigmoid, wts.ctypes.data,
            num_features, num_bins, bits, w.ticket_ptr, w.cells.data_ptr(), hists.data_ptr(),
            stream)
    _build.check(rc, "update_multi_and_hists")
    update_multi_and_hists.launches += 1
    return p, hists


update_multi_and_hists.launches = 0


# ======================================================================
# level_stream / split_stream: partition + both children's histograms
# ======================================================================
def _goes_left(word_row, shift, bits, zero_bin, dbz, thr, is_cat, off_lo, off_hi, bias):
    v = ((word_row.to(torch.int64) & 0xFFFFFFFF) >> shift) & ((1 << bits) - 1)
    fb = torch.where((v >= off_lo) & (v < off_hi), v - off_lo + bias,
                     torch.full_like(v, zero_bin))
    fv = torch.where(fb == zero_bin, torch.full_like(v, dbz), fb)
    return (fv == thr) if is_cat else (fv <= thr)


def _partition_ref(p, row, rows, num_features, num_bins, bits):
    """Stable in-place partition of one segment table row
    [start, cnt, word, shift, zero_bin, dbz, thr, is_cat, off_lo, off_hi,
    bias, _]; returns (nl, left hist, right hist)."""
    start, cnt, word, shift, zb, dbz, thr, cat, lo, hi, bias = (int(x) for x in row[:11])
    seg = p[:, start:start + cnt]
    gl = _goes_left(seg[word], shift, bits, zb, dbz, thr, cat, lo, hi, bias)
    left, right = seg[:, gl], seg[:, ~gl]
    p[:, start:start + cnt] = torch.cat([left, right], dim=1)
    return (left.shape[1], _hist_cols(left, rows, num_features, num_bins, bits),
            _hist_cols(right, rows, num_features, num_bins, bits))


def level_stream_ref(p, seg_tab, n_active, *, num_features, num_bins, bits=8,
                     rows=None, smax):
    """Plain version of level_stream: a boolean-mask stable partition
    per segment and ``index_add_`` histograms."""
    rows = rows or PLayout(num_features, bits=bits).rows
    tab = _host_table(seg_tab)
    nl = torch.zeros((smax,), dtype=torch.int32, device=p.device)
    hists = torch.zeros((smax, 2, num_features, num_bins, 3), dtype=torch.float32,
                        device=p.device)
    for s in range(int(n_active)):
        nl[s], hists[s, 0], hists[s, 1] = _partition_ref(p, tab[s], rows, num_features,
                                                         num_bins, bits)
    return p, nl, hists


def _host_table(seg_tab) -> np.ndarray:
    if isinstance(seg_tab, torch.Tensor):
        return seg_tab.detach().to("cpu", torch.int64).numpy()
    return np.asarray(seg_tab, np.int64)


def partition_tile(cnt: int, num_sms: int) -> int:
    """Rows a block of the partition kernels takes, for ``cnt`` active rows
    on a card of ``num_sms`` SMs: one block an SM (a block fills an SM's
    shared memory with histogram cells), rounded up to a multiple of
    PART_CHUNK, the rows a block stages at a time, and at most
    PART_MAX_TILE (the tile's left bits live in shared memory).  The
    segment-table form computes it on the card (csrc part_plan_kernel)."""
    want = -(-max(int(cnt), 1) // int(num_sms))
    return min(PART_MAX_TILE, -(-want // PART_CHUNK) * PART_CHUNK)


def partition_blocks(cnts, tile: int) -> np.ndarray:
    """Row tiles of each segment (an empty segment owns none)."""
    return -(-np.maximum(np.asarray(cnts, np.int64), 0) // int(tile))


def partition_grid(num_rows: int, num_sms: int, n_seg: int) -> tuple:
    """(largest tile, row tiles launched) of the segment-table form over a
    matrix of ``num_rows`` rows, whatever the counts: disjoint active
    segments hold at most ``num_rows`` rows, so the plan's tile is at most
    partition_tile(num_rows), and a tile of partition_tile(c) rows cuts c
    rows into at most max(SMs, c / PART_MAX_TILE) tiles, plus one ragged
    tile a segment."""
    return (partition_tile(num_rows, num_sms),
            max(int(num_sms), -(-int(num_rows) // PART_MAX_TILE)) + int(n_seg))


@functools.lru_cache(maxsize=None)
def _num_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def partition_work(w, grid: int, n_seg: int) -> tuple:
    """Addresses of the partition kernels' parts of a stream workspace
    ``w`` (ops/histogram.py ``_Workspace``, fitted to them): the look-back
    words (``grid``, after the ticket) and the ticket, zero between calls,
    and the plan's clamped (n_seg, 12) table and [tile, total, first tiles,
    total] (n_seg + 3 words)."""
    flags, plan = w.flags.data_ptr(), w.plan.data_ptr()
    return flags + 8, flags, plan, plan + 4 * 12 * n_seg


def check_split_args(p, start, cnt, word, shift, bits, num_features, rows) -> None:
    """Raise ValueError on a segment the partition kernels cannot take:
    rows outside the matrix's, a predicate field outside a word or the
    matrix, or features or (g, h, sel) rows outside the matrix."""
    C, n = p.shape[0], p.shape[1] - BLK
    if bits not in (4, 8):
        raise ValueError(f"bin words of {bits} bits (4 or 8)")
    if start < 0 or cnt < 0 or start + cnt > n:
        raise ValueError(f"segment [{start}, {start + cnt}) outside the matrix's {n} rows")
    if not 0 <= word < C or shift < 0 or shift % bits or shift + bits > 32:
        raise ValueError(f"predicate field (word {word}, shift {shift}) outside the matrix")
    if num_words(num_features, bits) > C or any(not 0 <= r < C for r in rows):
        raise ValueError(f"{num_features} features or channel rows {tuple(rows)} outside "
                         f"the matrix's {C} channels")


def check_table_args(p, tab: np.ndarray, bits, num_features, rows) -> None:
    """check_split_args for every row of an (n_seg, >= 4) segment table,
    the rows' bounds at once (a negative count is an empty segment)."""
    starts, cnt = tab[:, 0], np.maximum(tab[:, 1], 0)
    if ((starts < 0) | (starts + cnt > p.shape[1] - BLK)).any():
        raise ValueError(f"segment outside the matrix's {p.shape[1] - BLK} rows")
    for word, shift in set(zip(tab[:, 2].tolist(), tab[:, 3].tolist())):
        check_split_args(p, 0, 0, word, shift, bits, num_features, rows)


def _launch_table(p, tab: torch.Tensor, n_active, num_features, num_bins, bits, rows,
                  split=False):
    """Run the CUDA partition kernels over the device segment table ``tab``
    (n_seg, >= 11) int32, of which the first ``n_active`` rows (a device
    int32 scalar, or None for all) are active: the plan on the card, then
    a static grid.  ``split``: split_stream's launch, which tallies its
    rows and whether it had any.  Returns (nl (n_seg,), hists (n_seg, 2,
    F, B, 3))."""
    _check_matrix(p)
    n_seg, C, ld = tab.shape[0], p.shape[0], p.shape[1]
    if not 0 < n_seg <= PART_MAX_SEGMENTS:
        raise ValueError(f"{n_seg} segments (1 to {PART_MAX_SEGMENTS})")
    check_split_args(p, 0, 0, 0, 0, bits, num_features, rows)
    F, B = num_features, num_bins
    sms = _num_sms(p.device.index)
    tile_max, grid = partition_grid(ld - BLK, sms, n_seg)
    nl = torch.empty((n_seg,), dtype=torch.int32, device=p.device)
    hists = torch.empty((n_seg, 2, F, B, 3), dtype=torch.float32, device=p.device)
    lib = _build.lib()
    with stream_workspace(p, 0, n_seg * 2 * F * B * 3, scratch=C * ld, flags=grid + 1,
                          plan=13 * n_seg + 3) as (w, stream):
        flags, ticket, seg, plan = partition_work(w, grid, n_seg)
        tally = w.tally.data_ptr() + 8 * TALLY_SLOTS["split_stream"] if split else None
        rc = lib.lgbt_level_stream(
            p.data_ptr(), ld, C, w.scratch.data_ptr(), tab.data_ptr(), tab.shape[1], n_seg,
            None if n_active is None else n_active.data_ptr(), ld - BLK, sms, tile_max, grid, seg,
            plan, flags, ticket, nl.data_ptr(), tally, int(split), bits, F, B, *rows,
            w.cells.data_ptr(), hists.data_ptr(), stream)
    _build.check(rc, "split_stream" if split else "level_stream")
    return nl, hists


def _device_i32(v, device) -> torch.Tensor:
    """A 0-d int32 tensor on ``device``: a tensor already there, cast, or
    an int written by a fill (no upload, so a CUDA graph can capture it)."""
    if isinstance(v, torch.Tensor):
        if v.device != device:
            raise ValueError(f"a scalar on {v.device} for a matrix on {device}")
        return v.reshape(()).to(torch.int32)
    return torch.full((), int(v), dtype=torch.int32, device=device)


def level_stream(p, seg_tab, n_active, *, num_features, num_bins, bits=8, rows=None,
                 smax):
    """Partition all ``n_active`` leaf segments of ``seg_tab`` in place
    and return every segment's left count and both children's histograms.

    seg_tab: (>= n_active, 12) int rows [start, cnt, word, shift,
    zero_bin, dbz, thr, is_cat, off_lo, off_hi, bias, 0] (the JAX
    contract).  On the card a table and ``n_active`` given as device
    tensors stay there (the JAX contract: rows at or past n_active are
    empty; the kernel clamps each segment to the matrix; active segments
    must be disjoint), so the launch waits for nothing and a CUDA graph
    can replay it; a host table is checked on the host and uploaded.
    Returns (p, nl (smax,) int32, hists (smax, 2, F, B, 3)); rows s >=
    n_active are zero."""
    if p.device.type == "cpu":
        return level_stream_ref(p, seg_tab, n_active, num_features=num_features,
                                num_bins=num_bins, bits=bits, rows=rows, smax=smax)
    rows = rows or PLayout(num_features, bits=bits).rows
    if isinstance(seg_tab, torch.Tensor) and seg_tab.device == p.device:
        tab = seg_tab[:smax].to(torch.int32).contiguous()
        if tab.shape[0] < smax:
            raise ValueError(f"a table of {tab.shape[0]} rows for smax={smax}")
        nact = _device_i32(n_active, p.device)
    else:
        host = _host_table(seg_tab)[: int(n_active)]
        if host.shape[0] > smax:
            raise ValueError(f"{host.shape[0]} segments exceed smax={smax}")
        _check_matrix(p)
        check_table_args(p, host, bits, num_features, rows)
        full = np.zeros((smax, 12), np.int32)
        full[:host.shape[0]] = host[:, :12]
        full[:, 1] = np.maximum(full[:, 1], 0)
        tab, nact = upload(torch.from_numpy(full), p.device), None
    nl, hists = _launch_table(p, tab, nact, num_features, num_bins, bits, rows)
    level_stream.launches += 1
    return p, nl, hists


level_stream.launches = 0


def _split_row(start, cnt, word, shift, zero_bin, dbz, thr, is_cat, off_lo, off_hi, bias):
    return np.asarray([[start, cnt, word, shift, zero_bin, dbz, thr, is_cat, off_lo,
                        off_hi, bias, 0]], np.int64)


def split_stream_ref(p, start, cnt, word, shift, zero_bin, dbz, thr, is_cat, off_lo=0,
                     off_hi=None, bias=0, *, num_features, num_bins, bits=8, rows=None):
    """Plain version of split_stream (ints or 0-d tensors)."""
    rows = rows or PLayout(num_features, bits=bits).rows
    off_hi = (1 << bits) if off_hi is None else off_hi
    row = _split_row(*(int(v) for v in (start, cnt, word, shift, zero_bin, dbz, thr, is_cat,
                                         off_lo, off_hi, bias)))[0]
    nl, lh, rh = _partition_ref(p, row, rows, num_features, num_bins, bits)
    return p, torch.tensor(nl, dtype=torch.int32), lh, rh


def split_stream(p, start, cnt, word, shift, zero_bin, dbz, thr, is_cat, off_lo=0,
                 off_hi=None, bias=0, *, num_features, num_bins, bits=8, rows=None):
    """Partition the leaf segment [start, start+cnt) in place by the
    split predicate and return both children's histograms from the same
    pass: (p, nl, left (F, B, 3), right (F, B, 3)).  Lefts land at
    [start, start+nl), rights after them.

    On the card, given host ints, the segment is checked on the host and
    goes to the kernel by value, with its tiles; given any field as a 0-d
    tensor on the card, the fields stay there (the segment-table kernels
    with one row, its plan and tiles computed on the card, the segment
    clamped to the matrix), so the launch waits for nothing and a CUDA
    graph can replay it for any segment; a count of 0 leaves ``p`` as it
    is.  The rows partitioned are counted: host ints in
    ``split_stream.rows``, device scalars in a tally on the card, beside
    the launches that had any rows (``launch_counts``)."""
    if p.device.type == "cpu":
        return split_stream_ref(p, start, cnt, word, shift, zero_bin, dbz, thr, is_cat,
                                off_lo, off_hi, bias, num_features=num_features,
                                num_bins=num_bins, bits=bits, rows=rows)
    rows = rows or PLayout(num_features, bits=bits).rows
    off_hi = (1 << bits) if off_hi is None else off_hi
    fields = (start, cnt, word, shift, zero_bin, dbz, thr, is_cat, off_lo, off_hi, bias)
    F, B = num_features, num_bins
    if any(isinstance(v, torch.Tensor) for v in fields):
        _check_matrix(p)
        tab = torch.stack([_device_i32(v, p.device) for v in fields])[None]
        nl, hists = _launch_table(p, tab, None, F, B, bits, rows, split=True)
        split_stream.launches += 1
        return p, nl[0], hists[0, 0], hists[0, 1]
    seg = [int(v) for v in fields]
    start, cnt = seg[0], seg[1]
    _check_matrix(p)
    check_split_args(p, start, cnt, seg[2], seg[3], bits, num_features, rows)
    if cnt == 0:
        hists = torch.zeros((2, F, B, 3), device=p.device)
        return p, torch.zeros((), dtype=torch.int32, device=p.device), hists[0], hists[1]
    tile = partition_tile(cnt, _num_sms(p.device.index))
    nl = torch.empty((1,), dtype=torch.int32, device=p.device)
    hists = torch.empty((2, F, B, 3), dtype=torch.float32, device=p.device)
    lib = _build.lib()
    with stream_workspace(p, 0, 2 * F * B * 3, scratch=p.shape[0] * cnt,
                          flags=-(-cnt // tile) + 1) as (w, stream):
        flags, ticket, _, _ = partition_work(w, 0, 0)
        rc = lib.lgbt_split_stream(
            p.data_ptr(), p.shape[1], p.shape[0], w.scratch.data_ptr(), *seg, tile, flags,
            ticket, nl.data_ptr(), bits, F, B, *rows, w.cells.data_ptr(), hists.data_ptr(),
            stream)
    _build.check(rc, "split_stream")
    split_stream.launches += 1
    split_stream.rows += cnt
    return p, nl[0], hists[0], hists[1]


split_stream.launches = 0
split_stream.rows = 0  # rows partitioned given host ints, summed over launches


# ======================================================================
# score_add
# ======================================================================
def score_add_ref(p, layout: PLayout, delta, k: int = 0, *, num_rows):
    """Plain version of score_add."""
    n = int(num_rows)
    row = f32_row(p, layout.SCORE + k, n)
    row.copy_(row + _vec(delta, n, p.device))
    return p


def score_add(p, layout: PLayout, delta, k: int = 0, *, num_rows):
    """Score channel k += delta over the first ``num_rows`` columns, in
    place (the chunk-end settle of the last tree's pending delta).  A
    ``delta`` that is already a contiguous float32 tensor on ``p``'s card
    goes to the kernel as it is."""
    if p.device.type == "cpu":
        return score_add_ref(p, layout, delta, k, num_rows=num_rows)
    _check_matrix(p)
    n = int(num_rows)
    if not 0 <= k < layout.num_score or n > p.shape[1] - BLK:
        raise ValueError(f"score channel {k} of {layout.num_score} over {n} rows")
    if n <= 0:
        return p
    ready = (isinstance(delta, torch.Tensor) and delta.device == p.device
             and delta.dtype == torch.float32 and delta.dim() == 1 and delta.is_contiguous()
             and delta.shape[0] >= n)
    d = delta if ready else _vec(delta, n, p.device)
    with device_of(p):
        rc = _build.lib().lgbt_score_add(p.data_ptr(), p.shape[1], layout.SCORE + k,
                                         d.data_ptr(), n, raw_stream(p))
    _build.check(rc, "score_add")
    score_add.launches += 1
    return p


score_add.launches = 0


# ======================================================================
# hist_dyn / hist_segments: histograms of contiguous leaf segments
# ======================================================================
def hist_segments_ref(p, seg_tab, n_active, *, num_features, num_bins, bits=8, rows=None,
                      smax):
    """Plain version of hist_segments."""
    rows = rows or PLayout(num_features, bits=bits).rows
    tab = _host_table(seg_tab)
    out = torch.zeros((smax, num_features, num_bins, 3), dtype=torch.float32, device=p.device)
    for s in range(int(n_active)):
        start, cnt = int(tab[s, 0]), max(int(tab[s, 1]), 0)
        out[s] = _hist_cols(p[:, start:start + cnt], rows, num_features, num_bins, bits)
    return out


def _launch_segment_hist(p, tab: np.ndarray, num_features, num_bins, bits, rows, smax):
    """Run the CUDA segment-histogram kernels once for each non-empty
    segment of the host table ``tab`` (n_seg, >= 2) of [start, cnt] rows;
    returns ((smax, F, B, 3), launched)."""
    _check_matrix(p)
    n_seg = tab.shape[0]
    if n_seg > smax:
        raise ValueError(f"{n_seg} segments exceed smax={smax}")
    hist = torch.zeros((smax, num_features, num_bins, 3), dtype=torch.float32, device=p.device)
    cnt = np.maximum(tab[:, 1], 0)
    if (tab[:, 0] < 0).any() or (tab[:, 0] + cnt > p.shape[1] - BLK).any():
        raise ValueError("segment outside the matrix's rows")
    for s in np.flatnonzero(cnt):
        start = int(tab[s, 0])
        segment_hist_launch(p, start, start + int(cnt[s]), num_features, num_bins, bits, rows,
                            False, hist[s])
    return hist, bool(cnt.any())


def hist_segments(p, seg_tab, n_active, *, num_features, num_bins, bits=8, rows=None, smax):
    """(smax, F, B, 3) histograms of (g*sel, h*sel, sel) over the first
    ``n_active`` leaf segments of ``seg_tab`` ((>= n_active, 2) rows of
    [start, cnt]), the segment-histogram kernels run once for each
    non-empty segment; rows s >= n_active are zero (the JAX contract
    leaves them undefined).  ``rows`` is the (g, h, sel)
    channel-row triple, by default PLayout's class-0 rows."""
    if p.device.type == "cpu":
        return hist_segments_ref(p, seg_tab, n_active, num_features=num_features,
                                 num_bins=num_bins, bits=bits, rows=rows, smax=smax)
    rows = rows or PLayout(num_features, bits=bits).rows
    tab = _host_table(seg_tab)[: int(n_active)]
    hist, launched = _launch_segment_hist(p, tab, num_features, num_bins, bits, rows, smax)
    if launched:
        hist_segments.launches += 1
    return hist


hist_segments.launches = 0


def hist_dyn_ref(p, start, cnt, num_features, num_bins, bits=8, rows=None):
    """Plain version of hist_dyn."""
    return hist_segments_ref(p, np.asarray([[int(start), int(cnt)]]), 1,
                             num_features=num_features, num_bins=num_bins, bits=bits,
                             rows=rows, smax=1)[0]


def hist_dyn(p, start, cnt, num_features, num_bins, bits=8, rows=None):
    """(F, B, 3) histogram of the leaf segment [start, start+cnt) —
    DenseBin::ConstructHistogram (dense_bin.hpp:66) over the leaf's
    contiguous rows; the one-segment call of the segment-histogram
    kernel."""
    if p.device.type == "cpu":
        return hist_dyn_ref(p, start, cnt, num_features, num_bins, bits=bits, rows=rows)
    rows = rows or PLayout(num_features, bits=bits).rows
    hist, launched = _launch_segment_hist(p, np.asarray([[int(start), int(cnt)]], np.int64),
                                          num_features, num_bins, bits, rows, 1)
    if launched:
        hist_dyn.launches += 1
    return hist[0]


hist_dyn.launches = 0

# every kernel wrapper of the port, the mask grower's (ops/histogram.py) too
KERNELS = (update_and_root_hist, update_multi_and_hists, level_stream, split_stream,
           score_add, hist_dyn, hist_segments, update_channels, hist_segment, hist_segment_q)


def launch_counts() -> dict:
    """Launches of every kernel wrapper, ``split_stream_rows`` (the rows
    split_stream partitioned over its launches), and ``hist_segment_rows``
    and ``hist_segment_q_rows`` (the rows those kernels found selected).
    What was tallied on the card (all but split_stream's rows given host
    ints) syncs when read, so read at a path's end; ``selected_rows()``
    also has ``split_stream_taken``, the launches given device scalars
    that had rows (the fused grower's fallback splits)."""
    tallied = selected_rows()
    return {**{k.__name__: k.launches for k in KERNELS},
            "split_stream_rows": split_stream.rows + tallied["split_stream"],
            "hist_segment_rows": tallied["hist_segment"],
            "hist_segment_q_rows": tallied["hist_segment_q"]}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
    split_stream.rows = 0
    reset_selected_rows()
