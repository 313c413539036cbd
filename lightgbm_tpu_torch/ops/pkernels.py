"""The partitioned trainer's packed matrix and its four kernels.

PyTorch counterpart of lightgbm_tpu/ops/pkernels.py.  The training
matrix ``P`` keeps the JAX package's layout exactly: one (C, N + BLK)
int32 tensor whose rows are

    0..W-1      : packed bin words, 32/bits bins per int32
    W..WPAD-1   : padding (WPAD = W rounded up to 8)
    WPAD + 0    : grad   (f32 bit pattern)
    WPAD + 1    : hess   (f32 bit pattern)
    WPAD + 2    : select (f32 bit pattern; 0/1 row mask)
    WPAD + 3..  : score, label, row id, weight (the 8-aligned "band")

Rows are kept physically partitioned by leaf: each leaf owns a
contiguous column range [start, start + cnt).

Each kernel has a wrapper and a plain PyTorch version beside it:

    update_and_root_hist  /  update_and_root_hist_ref
    level_stream          /  level_stream_ref
    split_stream          /  split_stream_ref
    score_add             /  score_add_ref

A wrapper given a tensor on the CPU runs the plain version; given a CUDA
tensor it launches the hand-written kernel (``csrc/``, built by
``ops/_build.py``) and raises if the launch fails — it never falls back.
Each wrapper counts its kernel launches in ``<wrapper>.launches``.

The matrix is updated IN PLACE (the JAX package donates it through
``input_output_aliases``); the wrappers still return it so call sites
read like the JAX ones.  Histograms are returned as f32 (F, B, 3) of
(sum g*sel, sum h*sel, sum sel) — the JAX kernels' 3-term bf16 planes
are already re-summed.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build

BLK = 1024  # tail columns past the last row (the JAX kernels' DMA block)
PART_TILE = 8192  # rows per block of the CUDA partition kernels


def num_words(num_features: int, bits: int = 8) -> int:
    return -(-num_features // (32 // bits))


class PLayout:
    """Channel-row indices inside the packed matrix (single score
    channel: the slice trains one tree per iteration)."""

    def __init__(self, num_features: int, num_score: int = 1, with_weight: bool = True,
                 bits: int = 8):
        if num_score != 1:
            raise NotImplementedError("multiclass: more than one score channel")
        self.F = num_features
        self.bits = bits
        self.per = 32 // bits
        self.W = num_words(num_features, bits)
        self.WPAD = -(-self.W // 8) * 8
        self.num_score = num_score
        self.G = self.WPAD
        self.H = self.WPAD + 1
        self.SEL = self.WPAD + 2
        self.SCORE = self.SEL + 1
        self.LABEL = self.SCORE + num_score
        self.ROWID = self.LABEL + 1
        self.WEIGHT = self.ROWID + 1 if with_weight else -1
        self.with_weight = with_weight
        band = 2 + 1 + num_score + 2 + (1 if with_weight else 0)
        self.BAND = -(-band // 8) * 8
        self.C = self.WPAD + self.BAND

    @property
    def rows(self):
        """(g, h, sel) row indices."""
        return (self.G, self.H, self.SEL)


def pack_matrix(bins: np.ndarray, layout: PLayout, label=None, weight=None,
                num_real=None, device="cpu") -> torch.Tensor:
    """The (C, N + BLK) packed matrix from (N, F) uint8 bins, built on the
    host in row chunks and moved to ``device``.  grad/hess start at 0,
    select at 1 (0 for rows >= ``num_real``), scores at 0; rowid is the
    original row index."""
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
    feature's bin: one ``index_add_`` per feature, summed in float64 and
    rounded once, so the plain version gives the correctly rounded sums
    that the kernels' float32 atomics approximate in some order."""
    vals = torch.stack([g, h, sel], dim=1).double()
    out = torch.zeros((num_features, num_bins, 3), dtype=torch.float64, device=bins.device)
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


def _stream(p: torch.Tensor) -> int:
    return torch.cuda.current_stream(p.device).cuda_stream


# ======================================================================
# update_and_root_hist
# ======================================================================
def update_and_root_hist_ref(p, layout: PLayout, objective, delta=None, sel=None, *,
                             num_rows, num_features, num_bins, bits=8, rows=None):
    """Plain version: score += delta, (g, h) from the objective, select =
    sel, written in place over the first ``num_rows`` columns; returns
    (p, root histogram of the fresh values)."""
    n = int(num_rows)
    rows = rows or layout.rows
    score = f32_row(p, layout.SCORE, n)
    if delta is not None:
        score = score + _vec(delta, n, p.device)
    label = f32_row(p, layout.LABEL, n)
    weight = f32_row(p, layout.WEIGHT, n) if _use_weight(layout, objective) else None
    g, h = objective.gradients_rowwise(score, label, weight)
    selv = _vec(sel, n, p.device) if sel is not None else f32_row(p, layout.SEL, n).clone()
    f32_row(p, layout.G, n).copy_(g)
    f32_row(p, layout.H, n).copy_(h)
    if sel is not None:
        f32_row(p, layout.SEL, n).copy_(selv)
    if delta is not None:
        f32_row(p, layout.SCORE, n).copy_(score)
    hist = _hist_values(unpack_bins(p, layout, 0, n), g * selv, h * selv, selv,
                        num_features, num_bins)
    return p, hist


def _use_weight(layout: PLayout, objective) -> bool:
    return layout.with_weight and getattr(objective, "weights", None) is not None


def update_and_root_hist(p, layout: PLayout, objective, delta=None, sel=None, *,
                         num_rows, num_features, num_bins, bits=8, rows=None):
    """One pass over all rows: score += delta, fresh (g, h) from
    ``objective`` (its ``kernel_params()``), select = sel, in place; and
    the root (F, B, 3) histogram of the fresh values.  GBDT::Boosting +
    the root ConstructHistogram (gbdt.cpp:692-700)."""
    if p.device.type == "cpu":
        return update_and_root_hist_ref(
            p, layout, objective, delta, sel, num_rows=num_rows,
            num_features=num_features, num_bins=num_bins, bits=bits, rows=rows)
    _check_matrix(p)
    rows = rows or layout.rows
    if tuple(rows) != layout.rows:
        raise ValueError("update_and_root_hist writes the layout's own g/h/sel rows")
    n = int(num_rows)
    d = _vec(delta, n, p.device) if delta is not None else None
    s = _vec(sel, n, p.device) if sel is not None else None
    hist = torch.zeros((num_features, num_bins, 3), dtype=torch.float32, device=p.device)
    kind, sigmoid, w_pos, w_neg = objective.kernel_params()
    with torch.cuda.device(p.device):
        rc = _build.lib().lgbt_update_root_hist(
            p.data_ptr(), p.shape[1], n,
            None if d is None else d.data_ptr(), None if s is None else s.data_ptr(),
            layout.G, layout.H, layout.SEL, layout.SCORE, layout.LABEL, layout.WEIGHT,
            int(_use_weight(layout, objective)), kind, sigmoid, w_pos, w_neg,
            num_features, num_bins, bits, hist.data_ptr(), _stream(p))
    _build.check(rc, "update_and_root_hist")
    update_and_root_hist.launches += 1
    return p, hist


update_and_root_hist.launches = 0


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


def _launch_partition(p, tab: np.ndarray, num_features, num_bins, bits, rows, smax, what):
    """Run the CUDA partition family over the host segment table ``tab``
    (n_seg, 12); returns (nl (smax,), hists (smax, 2, F, B, 3)) or None
    when there is nothing to launch."""
    _check_matrix(p)
    n_seg = tab.shape[0]
    if n_seg > smax:
        raise ValueError(f"{n_seg} segments exceed smax={smax}")
    nl = torch.zeros((smax,), dtype=torch.int32, device=p.device)
    hists = torch.zeros((smax, 2, num_features, num_bins, 3), dtype=torch.float32,
                        device=p.device)
    if n_seg == 0:
        return nl, hists, False
    cnt = np.maximum(tab[:, 1], 0)
    if (tab[:, 0] < 0).any() or (tab[:, 0] + cnt > p.shape[1] - BLK).any():
        raise ValueError("segment outside the matrix's rows")
    tiles = (cnt + PART_TILE - 1) // PART_TILE
    tile_base = np.concatenate([[0], np.cumsum(tiles)])
    total = int(tile_base[-1])
    g_row, h_row, sel_row = rows
    host = np.concatenate([tab[:, :12].astype(np.int32).ravel(),
                           tile_base.astype(np.int32)])
    dev = torch.from_numpy(host).to(p.device)
    scratch = torch.empty_like(p)
    work = torch.empty((2 * max(total, 1),), dtype=torch.int32, device=p.device)
    with torch.cuda.device(p.device):
        rc = _build.lib().lgbt_partition_hist(
            p.data_ptr(), scratch.data_ptr(), p.shape[1], p.shape[0],
            dev.data_ptr(), dev.data_ptr() + 4 * 12 * n_seg, n_seg, total, PART_TILE,
            work.data_ptr(), work.data_ptr() + 4 * max(total, 1), nl.data_ptr(),
            bits, num_features, num_bins, g_row, h_row, sel_row, hists.data_ptr(),
            _stream(p))
    _build.check(rc, what)
    return nl, hists, True


def level_stream(p, seg_tab, n_active, *, num_features, num_bins, bits=8, rows=None,
                 smax):
    """Partition all ``n_active`` leaf segments of ``seg_tab`` in place
    and return every segment's left count and both children's histograms.

    seg_tab: (>= n_active, 12) int rows [start, cnt, word, shift,
    zero_bin, dbz, thr, is_cat, off_lo, off_hi, bias, 0] (the JAX
    contract).  Returns (p, nl (smax,) int32, hists (smax, 2, F, B, 3));
    rows s >= n_active are zero."""
    if p.device.type == "cpu":
        return level_stream_ref(p, seg_tab, n_active, num_features=num_features,
                                num_bins=num_bins, bits=bits, rows=rows, smax=smax)
    rows = rows or PLayout(num_features, bits=bits).rows
    tab = _host_table(seg_tab)[: int(n_active)]
    nl, hists, launched = _launch_partition(p, tab, num_features, num_bins, bits, rows,
                                            smax, "level_stream")
    if launched:
        level_stream.launches += 1
    return p, nl, hists


level_stream.launches = 0


def _split_row(start, cnt, word, shift, zero_bin, dbz, thr, is_cat, off_lo, off_hi, bias):
    return np.asarray([[start, cnt, word, shift, zero_bin, dbz, thr, is_cat, off_lo,
                        off_hi, bias, 0]], np.int64)


def split_stream_ref(p, start, cnt, word, shift, zero_bin, dbz, thr, is_cat, off_lo=0,
                     off_hi=None, bias=0, *, num_features, num_bins, bits=8, rows=None):
    """Plain version of split_stream."""
    rows = rows or PLayout(num_features, bits=bits).rows
    off_hi = (1 << bits) if off_hi is None else off_hi
    row = _split_row(start, cnt, word, shift, zero_bin, dbz, thr, is_cat, off_lo, off_hi,
                     bias)[0]
    nl, lh, rh = _partition_ref(p, row, rows, num_features, num_bins, bits)
    return p, torch.tensor(nl, dtype=torch.int32), lh, rh


def split_stream(p, start, cnt, word, shift, zero_bin, dbz, thr, is_cat, off_lo=0,
                 off_hi=None, bias=0, *, num_features, num_bins, bits=8, rows=None):
    """Partition the leaf segment [start, start+cnt) in place by the
    split predicate and return both children's histograms from the same
    pass: (p, nl, left (F, B, 3), right (F, B, 3)).  Lefts land at
    [start, start+nl), rights after them."""
    if p.device.type == "cpu":
        return split_stream_ref(p, start, cnt, word, shift, zero_bin, dbz, thr, is_cat,
                                off_lo, off_hi, bias, num_features=num_features,
                                num_bins=num_bins, bits=bits, rows=rows)
    rows = rows or PLayout(num_features, bits=bits).rows
    off_hi = (1 << bits) if off_hi is None else off_hi
    tab = _split_row(start, cnt, word, shift, zero_bin, dbz, thr, is_cat, off_lo, off_hi,
                     bias)
    nl, hists, launched = _launch_partition(p, tab, num_features, num_bins, bits, rows, 1,
                                            "split_stream")
    if launched:
        split_stream.launches += 1
    return p, nl[0], hists[0, 0], hists[0, 1]


split_stream.launches = 0


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
    place (the chunk-end settle of the last tree's pending delta)."""
    if p.device.type == "cpu":
        return score_add_ref(p, layout, delta, k, num_rows=num_rows)
    _check_matrix(p)
    n = int(num_rows)
    if n <= 0:
        return p
    d = _vec(delta, n, p.device)
    with torch.cuda.device(p.device):
        rc = _build.lib().lgbt_score_add(p.data_ptr(), p.shape[1], layout.SCORE + k,
                                         d.data_ptr(), n, _stream(p))
    _build.check(rc, "score_add")
    score_add.launches += 1
    return p


score_add.launches = 0

KERNELS = (update_and_root_hist, level_stream, split_stream, score_add)


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
