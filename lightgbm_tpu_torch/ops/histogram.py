"""Histograms of the mask grower — PyTorch counterpart of
lightgbm_tpu/ops/histogram.py (``build_histogram``,
``histogram_from_parent``) and of the column-packed kernels of
lightgbm_tpu/ops/histogram_pallas.py (``hist_segment``,
``hist_segment_q``, ``pack_columns``, ``pack_columns_q``).

The packed layout is the JAX package's: one (W + 3, N) int32 matrix
whose rows are

    0..W-1 : bin words, ``per`` bins of ``bits`` bits each per int32
             (per 4 at 8 bits for uint8 bins, 2 at 16 bits for uint16)
    W      : grad      float32 bits, or an int16 level as a plain int32
    W + 1  : hess      (likewise)
    W + 2  : select    float32 0/1, or int32 0/1

``hist_segment`` (B8) is the (F, B, 3) float32 histogram of (g*sel,
h*sel, sel) over columns [lo, hi); ``hist_segment_q`` (B9) the exact
int32 histogram of the quantized layout.  Both run
``csrc/segment_hist.cu`` on a CUDA tensor (float64 cells rounded once,
or int32 cells) and their plain versions (``*_ref``, ``index_add_`` in
float64 or int64) on a CPU tensor; a failed launch raises.  Each wrapper
counts its launches in ``<wrapper>.launches``; on the card the kernels
also tally the rows they found selected (``selected_rows``), on the
device, so reading the tally is the only sync.

The kernels first list the selected columns, then histogram only those,
so a launch costs what the leaf holds rather than hi - lo.  Their index
list, two counters and float64 accumulator are a workspace cached for
each stream of a card (``_Workspace``), which the kernels leave zeroed
for the next call on that stream; one lock orders the calls of threads,
so each call's two launches follow each other on its stream.

``build_histogram`` is the JAX function's contract on (N, F) bins: it
packs and takes the float32 branch (B8) or, for integer grad/hess, the
int32 branch (B9).

Out-of-core training (boosting/ooc.py) folds row chunks into one
histogram with the kernels' carry mode: ``accumulate_histogram`` adds a
chunk's selected rows into a caller-owned (F, B, 3) carry, float64 for
B8 and int32 for B9, without rounding it; ``finalize_histogram`` rounds
a float64 carry to float32 once, after the last chunk.  The JAX package
keeps its float32 block adds bit-identical by aligning chunks to
``ROW_BLOCK`` (its ops/histogram.py:154); here the float64 sums do not
depend on the cut, so any chunk grid gives the resident histogram (the
plan still rounds chunks up to ``ROW_BLOCK``, which keeps its
fingerprint the JAX package's string).
"""

from __future__ import annotations

import contextlib
import threading

import torch

from ..utils.device import device_of, raw_stream
from . import _build

# the JAX package's histogram row block (ops/histogram.py ROW_BLOCK): the
# out-of-core chunk plan rounds its chunks up to a multiple of it
ROW_BLOCK = 4096
# the workspace grows in steps of this many words (int32 list entries, or
# 8-byte accumulator cells), so nearby sizes share one allocation
WORK_STEP = 1 << 16
# tally slots: the rows hist_segment and hist_segment_q found selected, and
# the rows split_stream partitioned given device scalars (ops/pkernels.py)
# and its launches that had any
TALLY_SLOTS = {"hist_segment": 0, "hist_segment_q": 1, "split_stream": 2,
               "split_stream_taken": 3}


def word_layout(bins) -> tuple:
    """(per, bits) of a bin matrix's dtype: 4 x 8 bits for uint8 bins, 2 x
    16 bits for wider ones (max_bin > 255)."""
    return (4, 8) if bins.dtype == torch.uint8 else (2, 16)


def num_words(num_features: int, per: int) -> int:
    return -(-num_features // per)


def pack_bin_words(bins: torch.Tensor, per: int = 4, bits: int = 8) -> torch.Tensor:
    """(W, N) int32 bin words of the (N, F) bins, feature f in word f //
    per at bit (f % per) * bits; packed in row chunks on the bins' device."""
    n, f = bins.shape
    w = num_words(f, per)
    out = torch.empty((w, n), dtype=torch.int32, device=bins.device)
    shifts = torch.arange(per, device=bins.device, dtype=torch.int64) * bits
    step = 1 << 20
    for lo in range(0, n, step):
        hi = min(n, lo + step)
        bb = torch.zeros((hi - lo, w * per), dtype=torch.int64, device=bins.device)
        bb[:, :f] = bins[lo:hi].to(torch.int64)
        words = torch.sum(bb.reshape(hi - lo, w, per) << shifts, dim=2)
        out[:, lo:hi] = torch.where(words >= 2 ** 31, words - 2 ** 32, words).T.to(torch.int32)
    return out


def _as_bits(x) -> torch.Tensor:
    return x.to(torch.float32).contiguous().view(torch.int32)


def pack_columns(bins, grad, hess, select, per: int = 4, bits: int = 8):
    """The (W + 3, N) int32 matrix of B8: bin words, then grad, hess and
    select as float32 bits."""
    return torch.cat([pack_bin_words(bins, per, bits), _as_bits(grad)[None],
                      _as_bits(hess)[None], _as_bits(select)[None]], dim=0)


def pack_columns_q(bins, qgrad, qhess, select, per: int = 4, bits: int = 8):
    """The quantized twin (B9): the value rows hold the int16 levels and
    the 0/1 select widened to plain int32 words."""
    return torch.cat([pack_bin_words(bins, per, bits), qgrad.to(torch.int32)[None],
                      qhess.to(torch.int32)[None], select.to(torch.int32)[None]], dim=0)


def _rows(rows, num_features: int, per: int):
    if rows is not None:
        return tuple(int(r) for r in rows)
    w = num_words(num_features, per)
    return (w, w + 1, w + 2)


def _check_range(p, lo: int, hi: int) -> None:
    if p.dtype != torch.int32 or p.dim() != 2 or not p.is_contiguous():
        raise ValueError("the packed matrix must be a contiguous 2-D int32 tensor")
    if not 0 <= lo <= hi <= p.shape[1]:
        raise ValueError(f"column range [{lo}, {hi}) outside the matrix's {p.shape[1]} columns")


def _segment_hist_ref(p, lo, hi, num_features, num_bins, per, bits, rows, quantized,
                      carry=None):
    """The plain version of both kernels: per feature, one ``index_add_``
    of the rows whose select is not 0, in float64 (int64) and rounded
    (cast) once; with ``carry`` (the carry mode) the float64 (int64)
    sums are added into it instead, and it is returned unrounded."""
    lo, hi = int(lo), int(hi)
    _check_range(p, lo, hi)
    g_row, h_row, s_row = _rows(rows, num_features, per)
    cols = p[:, lo:hi]
    if quantized:
        sel = cols[s_row].to(torch.int64)
        keep = sel != 0
        vals = torch.stack([cols[g_row].to(torch.int64) * sel, cols[h_row].to(torch.int64) * sel,
                            sel], dim=1)[keep]
        acc = torch.int64
    else:
        sel = cols[s_row].view(torch.float32)
        keep = sel != 0
        vals = torch.stack([cols[g_row].view(torch.float32) * sel,
                            cols[h_row].view(torch.float32) * sel, sel], dim=1)[keep].double()
        acc = torch.float64
    out = torch.zeros((num_features, num_bins, 3), dtype=acc, device=p.device)
    words = cols[:, keep]
    mask = (1 << bits) - 1
    for f in range(num_features):
        b = (words[f // per].to(torch.int64) >> ((f % per) * bits)) & mask
        ok = b < num_bins
        out[f].index_add_(0, b[ok], vals[ok])
    if carry is not None:
        return carry.add_(out.to(carry.dtype))
    return out.to(torch.int32) if quantized else out.float()


def hist_segment_ref(p, lo, hi, num_features, num_bins, per=4, bits=8, rows=None):
    """Plain version of hist_segment."""
    return _segment_hist_ref(p, lo, hi, num_features, num_bins, per, bits, rows, False)


def hist_segment_q_ref(p, lo, hi, num_features, num_bins, per=4, bits=8, rows=None):
    """Plain version of hist_segment_q."""
    return _segment_hist_ref(p, lo, hi, num_features, num_bins, per, bits, rows, True)


def upload(t: torch.Tensor, device) -> torch.Tensor:
    """A small host tensor on ``device``; to a card through pinned memory,
    without waiting for the stream (a pageable copy would)."""
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def workspace_size(rows: int, cells: int, have: tuple = (0, 0)) -> tuple:
    """(int32 words, 8-byte cells) of a workspace for a column range of
    ``rows`` and an (F, B, 3) histogram of ``cells``, given one of
    ``have``: the two counters and the index list, and the accumulator,
    each rounded up to WORK_STEP and never smaller than before."""
    def step(n):
        return -(-int(n) // WORK_STEP) * WORK_STEP
    return max(have[0], step(2 + rows)), max(have[1], step(cells))


class _Workspace:
    """One stream's index list and counters (``words``: [count, ticket,
    list...]), float64 (or int32) accumulator (``cells``), all zero
    between calls, and the tallies (``tally``).  The update kernels (B1,
    B2) use the ticket and the accumulator too; the partition kernels
    (B3, B4) the accumulator, a scratch of the matrix's size
    (``scratch``), look-back words and their ticket (``flags``, zero
    between calls) and the plan of their segment table (``plan``)."""

    def __init__(self, device):
        self.words = torch.zeros(0, dtype=torch.int32, device=device)
        self.cells = torch.zeros(0, dtype=torch.int64, device=device)
        self.tally = torch.zeros(len(TALLY_SLOTS), dtype=torch.int64, device=device)
        self.scratch = torch.zeros(0, dtype=torch.int32, device=device)
        self.flags = torch.zeros(0, dtype=torch.int64, device=device)
        self.plan = torch.zeros(0, dtype=torch.int32, device=device)

    def fit(self, rows: int, cells: int, scratch: int = 0, flags: int = 0, plan: int = 0) -> None:
        """Grow (zeroed) to take ``rows`` columns, ``cells`` cells, and
        ``scratch``, ``flags`` and ``plan`` words of the partition kernels."""
        words, ncells = workspace_size(rows, cells, (self.words.numel(), self.cells.numel()))
        dev = self.tally.device
        if words > self.words.numel():
            self.words = torch.zeros(words, dtype=torch.int32, device=dev)
        if ncells > self.cells.numel():
            self.cells = torch.zeros(ncells, dtype=torch.int64, device=dev)
        # the scratch is one allocation of the matrix's size, never a step
        # more: its contents need no zeroing
        if scratch > self.scratch.numel():
            self.scratch = torch.empty(scratch, dtype=torch.int32, device=dev)
        if flags > self.flags.numel():
            self.flags = torch.zeros(workspace_size(0, flags)[1], dtype=torch.int64, device=dev)
        if plan > self.plan.numel():
            self.plan = torch.zeros(workspace_size(0, plan)[1], dtype=torch.int32, device=dev)

    @property
    def ticket_ptr(self) -> int:
        """Address of the ticket, ``words[1]``."""
        return self.words.data_ptr() + 4


_WORK = {}  # (device index, raw stream) -> _Workspace
_RETIRED = []  # the tallies of released workspaces, until the next reset
_WORK_LOCK = threading.Lock()  # held from a workspace's lookup to the end of its launches


def _settled_workspaces():
    """The workspaces, once every card that holds one has finished its
    streams' work (the tallies are written on the streams that launched)."""
    for index in {index for index, _ in _WORK} | {t.device.index for t in _RETIRED}:
        torch.cuda.synchronize(index)
    return list(_WORK.values())


def selected_rows() -> dict:
    """Rows each tallying kernel found selected (B8, B9) or partitioned
    (B4 given device scalars), summed over its launches on every card and
    stream since the last ``reset_selected_rows`` (one sync a card)."""
    out = dict.fromkeys(TALLY_SLOTS, 0)
    for tally in [w.tally for w in _settled_workspaces()] + _RETIRED:
        tally = tally.tolist()
        for name, slot in TALLY_SLOTS.items():
            out[name] += tally[slot]
    return out


def reset_selected_rows() -> None:
    for w in _settled_workspaces():
        w.tally.zero_()
    _RETIRED.clear()


@contextlib.contextmanager
def stream_workspace(p, rows: int, cells: int, **partition):
    """The workspace of ``p``'s card and current stream, grown to take
    ``rows`` listed columns and ``cells`` accumulator cells (and the
    partition kernels' ``scratch``, ``flags`` and ``plan`` words), as
    (workspace, raw stream); the lock is held until the block ends, so the
    launches that use it are enqueued inside.  A CUDA graph captures the
    workspace's addresses: its replays need the workspace of the capture
    stream to stay as it was (``release_stream_workspace`` when the graph
    goes)."""
    with device_of(p), _WORK_LOCK:
        stream = raw_stream(p)
        w = _WORK.get((p.device.index, stream))
        if w is None:
            w = _WORK[(p.device.index, stream)] = _Workspace(p.device)
        w.fit(rows, cells, **partition)
        yield w, stream


def release_stream_workspace(index: int, stream: int) -> None:
    """Drop the workspace of card ``index``'s raw ``stream`` (a stream
    that goes with the graphs captured on it)."""
    with _WORK_LOCK:
        w = _WORK.pop((index, stream), None)
        if w is not None:
            _RETIRED.append(w.tally)


def segment_hist_launch(p, lo: int, hi: int, num_features: int, num_bins: int, bits: int,
                        rows, quantized: bool, out: torch.Tensor, tally=None) -> None:
    """Launch the segment-histogram kernels over columns [lo, hi) (hi >
    lo) of the CUDA matrix ``p`` into ``out``, a contiguous (F, B, 3)
    float32 (int32 when ``quantized``) tensor on its card; ``tally``
    names the slot that counts the selected rows, or None."""
    lib = _build.lib()
    with stream_workspace(p, hi - lo, num_features * num_bins * 3) as (w, stream):
        tally_ptr = None if tally is None else w.tally.data_ptr() + 8 * TALLY_SLOTS[tally]
        rc = lib.lgbt_segment_hist(
            p.data_ptr(), p.shape[1], lo, hi, bits, num_features, num_bins, *rows,
            int(quantized), w.words.data_ptr(), w.cells.data_ptr(), tally_ptr, out.data_ptr(),
            stream)
    _build.check(rc, tally or "segment histogram")


def _launch(p, lo, hi, num_features, num_bins, per, bits, rows, quantized):
    """Run the segment-histogram kernels over [lo, hi); returns the (F, B,
    3) histogram and whether a kernel was launched."""
    lo, hi = int(lo), int(hi)
    _check_range(p, lo, hi)
    if p.device.type != "cuda":
        raise ValueError(f"expected a CUDA tensor, got {p.device}")
    if per * bits != 32:
        raise ValueError(f"{per} bins of {bits} bits do not fill a 32-bit word")
    dtype = torch.int32 if quantized else torch.float32
    if hi == lo:
        return torch.zeros((num_features, num_bins, 3), dtype=dtype, device=p.device), False
    hist = torch.empty((num_features, num_bins, 3), dtype=dtype, device=p.device)
    segment_hist_launch(p, lo, hi, num_features, num_bins, bits,
                        _rows(rows, num_features, per), quantized, hist,
                        "hist_segment_q" if quantized else "hist_segment")
    return hist, True


def hist_segment(p, lo, hi, num_features, num_bins, per=4, bits=8, rows=None):
    """(F, B, 3) float32 histogram of (g*sel, h*sel, sel) over columns [lo,
    hi) of the ``pack_columns`` matrix ``p``; ``rows`` is the (g, h, sel)
    channel-row triple, by default W..W+2."""
    if p.device.type == "cpu":
        return hist_segment_ref(p, lo, hi, num_features, num_bins, per, bits, rows)
    hist, launched = _launch(p, lo, hi, num_features, num_bins, per, bits, rows, False)
    hist_segment.launches += int(launched)
    return hist


hist_segment.launches = 0


def hist_segment_q(p, lo, hi, num_features, num_bins, per=4, bits=8, rows=None):
    """(F, B, 3) exact int32 histogram over columns [lo, hi) of the
    ``pack_columns_q`` matrix ``p`` (int16 levels as int32 words)."""
    if p.device.type == "cpu":
        return hist_segment_q_ref(p, lo, hi, num_features, num_bins, per, bits, rows)
    hist, launched = _launch(p, lo, hi, num_features, num_bins, per, bits, rows, True)
    hist_segment_q.launches += int(launched)
    return hist


hist_segment_q.launches = 0


def new_carry(num_features: int, num_bins: int, quantized: bool, device) -> torch.Tensor:
    """A zeroed (F, B, 3) carry: int32 for B9, float64 for B8."""
    return torch.zeros((num_features, num_bins, 3),
                       dtype=torch.int32 if quantized else torch.float64, device=device)


def accumulate_histogram(carry, p, lo, hi, num_features, num_bins, per=4, bits=8, rows=None):
    """Add the selected rows of columns [lo, hi) of the packed matrix ``p``
    into ``carry`` (``new_carry``) without rounding: B8's carry mode for a
    float64 carry, B9's for an int32 one.  On a CUDA tensor it launches
    the kernels (counted in ``hist_segment.launches`` or
    ``hist_segment_q.launches``), on a CPU tensor it runs their plain
    version.  Returns ``carry``."""
    quantized = carry.dtype == torch.int32
    if not quantized and carry.dtype != torch.float64:
        raise ValueError(f"a carry is float64 or int32, got {carry.dtype}")
    if tuple(carry.shape) != (num_features, num_bins, 3) or not carry.is_contiguous():
        raise ValueError(f"the carry must be a contiguous ({num_features}, {num_bins}, 3) tensor")
    if p.device.type == "cpu":
        return _segment_hist_ref(p, lo, hi, num_features, num_bins, per, bits, rows, quantized,
                                 carry=carry)
    lo, hi = int(lo), int(hi)
    _check_range(p, lo, hi)
    if p.device != carry.device:
        raise ValueError(f"the carry is on {carry.device}, the matrix on {p.device}")
    if per * bits != 32:
        raise ValueError(f"{per} bins of {bits} bits do not fill a 32-bit word")
    if hi == lo:
        return carry
    name = "hist_segment_q" if quantized else "hist_segment"
    r = _rows(rows, num_features, per)
    lib = _build.lib()
    with stream_workspace(p, hi - lo, 0) as (w, stream):
        rc = lib.lgbt_segment_hist_carry(
            p.data_ptr(), p.shape[1], lo, hi, bits, num_features, num_bins, *r, int(quantized),
            w.words.data_ptr(), carry.data_ptr(), w.tally.data_ptr() + 8 * TALLY_SLOTS[name],
            stream)
    _build.check(rc, name + " (carry)")
    if quantized:
        hist_segment_q.launches += 1
    else:
        hist_segment.launches += 1
    return carry


def finalize_histogram(carry) -> torch.Tensor:
    """The (F, B, 3) histogram of a carry: a float64 carry rounded to
    float32 once (on the card by B8's rounding kernel), an int32 one as it
    is (a copy)."""
    if carry.dtype == torch.int32:
        return carry.clone()
    if carry.dtype != torch.float64 or not carry.is_contiguous():
        raise ValueError("a carry is a contiguous float64 or int32 tensor")
    if carry.device.type == "cpu":
        return carry.float()
    out = torch.empty(carry.shape, dtype=torch.float32, device=carry.device)
    with device_of(carry):
        rc = _build.lib().lgbt_segment_hist_round(carry.data_ptr(), out.data_ptr(),
                                                  carry.numel(), raw_stream(carry))
    _build.check(rc, "hist_segment (round)")
    return out


def build_histogram(bins, grad, hess, select, num_bins: int) -> torch.Tensor:
    """The (F, B, 3) histogram of (sum g*sel, sum h*sel, sum sel) by bin
    (DenseBin::ConstructHistogram, dense_bin.hpp:66, over every feature
    with the rows masked by ``select``).  Integer (int16 quantized)
    grad/hess give the exact int32 histogram (B9), float32 ones the
    float32 histogram (B8)."""
    per, bits = word_layout(bins)
    n, f = bins.shape
    if not torch.is_floating_point(grad):
        p = pack_columns_q(bins, grad, hess, select, per, bits)
        return hist_segment_q(p, 0, n, f, num_bins, per, bits)
    p = pack_columns(bins, grad, hess, select, per=per, bits=bits)
    return hist_segment(p, 0, n, f, num_bins, per, bits)


def histogram_from_parent(parent_hist: torch.Tensor, sibling_hist: torch.Tensor) -> torch.Tensor:
    """The subtraction trick (FeatureHistogram::Subtract,
    serial_tree_learner.cpp:484-489): the larger child is parent - smaller
    sibling, exact for the int32 histograms of quantized training."""
    return parent_hist - sibling_hist
