"""Partitioned leaf-wise grower — PyTorch counterpart of
lightgbm_tpu/ops/pgrow.py (SerialTreeLearner::Train + DataPartition,
serial_tree_learner.cpp:152-207).

Rows live physically partitioned by leaf inside the packed matrix of
ops/pkernels.py, so each split costs one pass over the parent segment.
Growth has the JAX package's two phases:

1. level-batched expansion: one ``level_stream`` launch partitions every
   active frontier segment and returns both children's histograms, and
   one batched split search scores all children of the level;
2. the exact best-first replay of SerialTreeLearner::Train's
   argmax-over-leaves order (lowest leaf index wins ties) over the
   candidate tables; nodes the selection wants beyond the expanded
   levels fall back to a per-split ``split_stream`` in the same loop.

The JAX package runs both phases inside one device program, and so does
this one: the small per-leaf tables (segments, best splits, leaf sums)
are float32 and int64 tensors on the matrix's device, the levels are
unrolled and phase 2 takes L-1 fixed steps, so a tree never waits for
the device; on the card ``TreeGraphs`` replays the whole tree as one
CUDA graph.  Leaf outputs are computed at one site for both phases, so
accepted values depend only on the children's sums.

EFB: with a bundle the matrix holds G bundle columns of BH bins; the
kernels stream those, and the split search expands each (G, BH, 3)
histogram to the real features' (F, B, 3) first (``BundleMeta``).
"""

from __future__ import annotations

import os
import weakref
from typing import NamedTuple

import numpy as np
import torch

from ..obs.trace import note_compile
from .histogram import release_stream_workspace
from .pkernels import KERNELS, PLayout, hist_dyn, hist_segments, level_stream, split_stream
from .split import (
    NEG_INF,
    FeatureMeta,
    SplitHyper,
    _f32,
    best_split_all_features,
    leaf_output,
)


class PGrowParams(NamedTuple):
    """Parameters of the partitioned grower."""

    num_leaves: int
    num_bins: int  # padded per-feature B (<= 256)
    num_features: int
    num_rows: int  # real data rows (P has BLK tail padding)
    max_depth: int = -1
    use_missing: bool = True
    has_categorical: bool = True
    # EFB: physical matrix columns / histogram bins per column; 0 means
    # unbundled (columns == features, bins == num_bins)
    num_cols: int = 0
    num_bins_hist: int = 0
    bits: int = 8
    levelwise: bool = True

    @property
    def cols(self) -> int:
        """Columns of the packed matrix (G)."""
        return self.num_cols or self.num_features

    @property
    def bins_hist(self) -> int:
        """Histogram bins per matrix column (BH)."""
        return self.num_bins_hist or self.num_bins


MAX_LEVELS = 24  # phase-1 depth cap (the JAX package's default)


def levelgrow_env_params() -> dict:
    """The level-grower switch, read once at trainer construction
    (LIGHTGBM_TPU_LEVELGROW=0 forces the per-split path)."""
    return {"levelwise": os.environ.get("LIGHTGBM_TPU_LEVELGROW", "1") != "0"}


class BundleMeta(NamedTuple):
    """EFB maps (io/bundle.py BundleInfo) on the device.

    idx maps (feature, feature-bin) to a flat bundle-histogram slot, with
    default and padding bins pointing at an appended zero slot; the
    default bin's mass is rebuilt as leaf totals minus the non-default
    sums (the reference's bias/zero-bin subtraction in
    FeatureHistogram::FindBestThreshold)."""

    col: torch.Tensor  # (F,) int64 bundle column per feature
    off_lo: torch.Tensor  # (F,) int64
    off_hi: torch.Tensor  # (F,) int64
    bias: torch.Tensor  # (F,) int64
    idx: torch.Tensor  # (F, B) int64 into (G*BH [+1 zero slot], 3)
    defmask: torch.Tensor  # (F, B) bool

    @classmethod
    def build(cls, bundle, train_set, num_bins: int, device="cpu") -> "BundleMeta":
        """From the dataset's BundleInfo and bin mappers
        (ptrainer.py:1585 _build_bundle_meta)."""
        f, b, bh = train_set.num_features, num_bins, int(bundle.max_col_bin)
        default_bin = [m.default_bin for m in train_set.bin_mappers]
        nb = [m.num_bin for m in train_set.bin_mappers]
        idx = np.full((f, b), bundle.num_cols * bh, np.int64)  # the zero slot
        defmask = np.zeros((f, b), bool)
        for fe in range(f):
            base = int(bundle.col[fe]) * bh
            if int(bundle.off_lo[fe]) == 0:
                # singleton raw column: every bin (default too) maps direct
                idx[fe, :nb[fe]] = base + np.arange(nb[fe])
                continue
            for bi in range(nb[fe]):
                if bi == default_bin[fe]:
                    defmask[fe, bi] = True
                else:
                    idx[fe, bi] = base + int(bundle.off_lo[fe]) + bi - int(bundle.bias[fe])

        def t(x, dtype=torch.int64):
            return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

        return cls(t(bundle.col), t(bundle.off_lo), t(bundle.off_hi), t(bundle.bias), t(idx),
                   t(defmask, torch.bool))


def _expand_bundle_hist(hist_g: torch.Tensor, sums: torch.Tensor, bmeta: BundleMeta, f: int,
                        b: int) -> torch.Tensor:
    """(S, G, BH, 3) bundle histograms -> (S, F, B, 3) per-feature
    histograms, given each leaf's (S, 3) totals."""
    s = hist_g.shape[0]
    flat = torch.cat([hist_g.reshape(s, -1, 3),
                      torch.zeros((s, 1, 3), dtype=hist_g.dtype, device=hist_g.device)], dim=1)
    hf = flat[:, bmeta.idx.reshape(-1)].reshape(s, f, b, 3)
    nd = torch.sum(hf.double(), dim=2).float()  # (S, F, 3): non-default mass
    dfl = sums[:, None, :] - nd  # the default bin's mass
    return torch.where(bmeta.defmask[None, :, :, None], dfl[:, :, None, :], hf)


class PTreeResult(NamedTuple):
    """One grown tree: split records in acceptance order plus the final
    leaf segments for the score update.  ``grow_tree_partitioned`` gives
    tensors on the matrix's device (a 0-d ``num_splits``); ``to_host``
    the numpy view that ``Tree.from_grow_result`` reads."""

    num_splits: object  # int, or a 0-d int64 tensor
    starts: object  # (L,) physical segment start per leaf
    cnts: object  # (L,) rows per leaf
    leaf_value: object  # (L,) f32 raw (pre-shrinkage) outputs
    leaf_cnt: object  # (L,) f32 selected counts
    recs_raw: object  # (L-1, 12) f32 [leaf, feat, thr, dbz, gain, lval,
    #                    rval, lcnt, rcnt, ival, 0, 0]

    def to_host(self) -> "PTreeResult":
        """The numpy view (reading a device tree syncs)."""
        def host(x):
            return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        return PTreeResult(int(self.num_splits), *(host(x) for x in self[1:]))

    @classmethod
    def from_records(cls, num_splits: int, recs_raw: np.ndarray) -> "PTreeResult":
        """The host view of a tree known by its records alone (a chunk's
        trees, read back once at the chunk's end): what
        ``Tree.from_grow_result`` reads."""
        return cls(int(num_splits), None, None, None, None, recs_raw)

    @property
    def rec_leaf(self):
        return self.recs_raw[:, 0].astype(np.int32)

    @property
    def rec_feat(self):
        return self.recs_raw[:, 1].astype(np.int32)

    @property
    def rec_thr(self):
        return self.recs_raw[:, 2].astype(np.int32)

    @property
    def rec_dbz(self):
        return self.recs_raw[:, 3].astype(np.int32)

    @property
    def rec_gain(self):
        return self.recs_raw[:, 4]

    @property
    def rec_lval(self):
        return self.recs_raw[:, 5]

    @property
    def rec_rval(self):
        return self.recs_raw[:, 6]

    @property
    def rec_lcnt(self):
        return self.recs_raw[:, 7]

    @property
    def rec_rcnt(self):
        return self.recs_raw[:, 8]

    @property
    def rec_internal_value(self):
        return self.recs_raw[:, 9]


def split_audit_rows(gr):
    """The accepted splits of a grown tree's host records, in acceptance
    order (pgrow.py:621): the audit trail's rows (obs/audit.py).  Takes
    anything with the record fields ``Tree.from_grow_result`` reads
    (``ops/grow.GrowResult`` of the mask grower, the host
    :class:`PTreeResult` of a fused chunk), so both growers' trails are
    comparable; floats keep their float32 values."""
    ns = int(gr.num_splits)
    if ns <= 0:
        return
    leaf, thr, dbz = (np.asarray(x) for x in (gr.rec_leaf, gr.rec_thr, gr.rec_dbz))
    gain, lcnt, rcnt = (np.asarray(x) for x in (gr.rec_gain, gr.rec_lcnt, gr.rec_rcnt))
    for s in range(ns):
        yield {"s": s, "leaf": int(leaf[s]), "bin": int(thr[s]), "dbz": int(dbz[s]),
               "gain": float(gain[s]), "lcnt": int(lcnt[s]), "rcnt": int(rcnt[s])}


def _meta_table(meta: FeatureMeta, bmeta, f: int, bits: int) -> torch.Tensor:
    """(F, 6) int64 per-feature partition constants on the meta's device:
    [default_bin, is_cat, col, off_lo, off_hi, bias] (unbundled: col =
    feature, the whole bin field in range)."""
    dev = meta.default_bin.device
    if bmeta is not None:
        col, off_lo, off_hi, bias = bmeta[:4]
    else:
        col = torch.arange(f, dtype=torch.int64, device=dev)
        off_lo = bias = torch.zeros(f, dtype=torch.int64, device=dev)
        off_hi = torch.full((f,), 1 << bits, dtype=torch.int64, device=dev)
    return torch.stack([meta.default_bin, meta.is_categorical.to(torch.int64), col, off_lo,
                        off_hi, bias], dim=1)


def grow_tree_partitioned(p: torch.Tensor, feature_mask: torch.Tensor, meta: FeatureMeta,
                          hyper: SplitHyper, params: PGrowParams, root_hist=None,
                          rows: tuple = None, bmeta: BundleMeta = None):
    """Grow one leaf-wise tree over the partitioned matrix ``p`` (updated
    in place).  ``root_hist`` is the (G, BH, 3) histogram of all rows with
    the g/h/sel channels freshly written; without it the grower builds it
    (``hist_segments`` over the one root segment when the level grower is
    on, ``hist_dyn`` when it is off).  ``rows`` is the (g, h, sel) triple
    of the tree's class (PLayout.class_rows(k)).  Returns (PTreeResult of
    tensors on ``p``'s device, p).

    Every table lives on the device and every shape is static, so the
    call never waits for the device (``TreeGraphs`` captures it whole as
    one CUDA graph): the levels are unrolled (level k has at most
    min(2^k, SMAX/2) active segments; a level with none launches empty
    work), and phase 2 takes L-1 fixed steps, each taking the
    precomputed children or the fallback ``split_stream`` (with a count of
    0 when not needed) by ``torch.where``; a step after the last split
    changes nothing.  JAX's ``mode="drop"`` scatters write a dump row past
    each table's end."""
    L, F, B, n = params.num_leaves, params.num_features, params.num_bins, params.num_rows
    G, BH = params.cols, params.bins_hist  # what the kernels stream
    bits = params.bits
    per = 32 // bits
    rows = rows or PLayout(G, bits=bits).rows
    dev = p.device
    mtab = _meta_table(meta, bmeta, F, bits)
    l1, l2 = _f32(hyper.lambda_l1, p), _f32(hyper.lambda_l2, p)
    levelwise = params.levelwise and L > 4

    def find(hist, sums, depth_ok):
        """Best split of each leaf of a batch: hist (S, G, BH, 3), sums (S,
        3) f32, depth_ok (S,) bool or None -> (S, 8) f32 best-split rows
        [gain, feat, thr, dbz, lg, lh, lc, 0]."""
        if bmeta is not None:
            hist = _expand_bundle_hist(hist, sums, bmeta, F, B)
        r = best_split_all_features(hist, sums[:, 0], sums[:, 1], sums[:, 2], meta, hyper,
                                    feature_mask, params.use_missing,
                                    params.has_categorical)
        gain = r.gain if depth_ok is None else torch.where(depth_ok, r.gain, NEG_INF)
        return torch.stack([
            gain, r.feature.float(), r.threshold_bin.float(),
            r.default_bin_for_zero.float(), r.left_sum_g, r.left_sum_h, r.left_cnt,
            torch.zeros_like(r.gain)], dim=1)

    def depth_ok(depth):
        return None if params.max_depth <= 0 else depth < params.max_depth

    def seg_fields(start, cnt, fti):
        """[start, cnt, word, shift, zero_bin, dbz, thr, is_cat, off_lo,
        off_hi, bias] of segments splitting on fti [..., (feat, thr, dbz)]."""
        feat = fti[..., 0].clamp(0, F - 1)
        # index_select: indexing by a 0-d tensor would read it on the host
        m = mtab.index_select(0, feat.reshape(-1)).reshape(*feat.shape, 6)
        col = m[..., 2]
        return [start, cnt, col // per, (col % per) * bits, m[..., 0], fti[..., 2],
                fti[..., 1], m[..., 1], m[..., 3], m[..., 4], m[..., 5]]

    def leaf_rows(sums, depth):
        """(S, 8) leaf rows [g, h, cnt, value (set at acceptance), cnt,
        depth, 0, 0] of children with (S, 3) sums at depth (S,)."""
        z = torch.zeros_like(depth)
        return torch.stack([sums[:, 0], sums[:, 1], sums[:, 2], z, sums[:, 2], depth, z, z],
                           dim=1)

    if root_hist is None:
        if levelwise:
            seg0 = np.zeros((8, 2), np.int64)
            seg0[0, 1] = n
            root_hist = level_hists(p, seg0, 1, params, rows=rows)[0]
        else:
            root_hist = hist_dyn(p, 0, n, G, BH, bits=bits, rows=rows)
    # totals via column 0, summed in float64 and rounded once (split.py)
    root_sums = root_hist[0].double().sum(dim=0).float()
    root_bs = find(root_hist[None], root_sums[None], None)[0]
    root_leaf = leaf_rows(root_sums[None], torch.zeros(1, device=dev))[0]
    root_leaf[3] = leaf_output(root_sums[0], root_sums[1], l1, l2)

    # ---- phase 1: level-batched expansion into candidate tables (row
    # CANDMAX of each is the dump row)
    SMAX = min(-(-(L + 1) // 8) * 8, 512)
    CANDMAX = 2 * SMAX
    c_seg = torch.zeros((CANDMAX + 1, 2), dtype=torch.int64, device=dev)
    c_bs = torch.full((CANDMAX + 1, 8), NEG_INF, device=dev)
    c_leaf = torch.zeros((CANDMAX + 1, 8), device=dev)
    c_childlo = torch.full((CANDMAX + 1,), -1, dtype=torch.int64, device=dev)
    c_seg[0, 1].fill_(n)  # a fill: a python scalar's setitem copies from the host
    c_bs[0] = root_bs
    c_leaf[0] = root_leaf
    if levelwise:
        frontier = torch.zeros(1, dtype=torch.int64, device=dev)  # slot 0, the root
        frontier_n = torch.ones((), dtype=torch.int64, device=dev)
        cand_n = torch.ones((), dtype=torch.int64, device=dev)
        for _ in range(MAX_LEVELS):
            A = min(frontier.shape[0], SMAX // 2)  # this level's most active segments
            idx = torch.arange(frontier.shape[0], device=dev)
            active = (idx < frontier_n) & (c_bs[frontier, 0] > 0.0)
            n_act = torch.minimum(active.sum(), (CANDMAX - cand_n) // 2).clamp(0, SMAX // 2)
            # the active slots to the front, in frontier order
            aslots = frontier[torch.argsort((~active).to(torch.int64), stable=True)[:A]]
            ar = idx[:A]
            arow = ar < n_act
            segs = c_seg[aslots]
            bsr = torch.where(arow[:, None], c_bs[aslots], 0.0)
            lrow = c_leaf[aslots]
            fields = seg_fields(segs[:, 0], torch.where(arow, segs[:, 1], 0),
                                bsr[:, 1:4].long())
            tab = torch.stack(fields + [torch.zeros_like(segs[:, 0])], dim=1)
            p, nl, hists = level_stream(p, tab, n_act, num_features=G, num_bins=BH, bits=bits,
                                        rows=rows, smax=A)
            nl = nl.long()
            lsums = bsr[:, 4:7]
            rsums = lrow[:, 0:3] - lsums
            cdepth = lrow[:, 5] + 1.0
            sums2 = torch.stack([lsums, rsums], dim=1).reshape(2 * A, 3)
            dok = depth_ok(cdepth)
            res = find(hists.reshape(2 * A, G, BH, 3), sums2,
                       None if dok is None else dok[:, None].expand(A, 2).reshape(-1))
            il = torch.where(arow, cand_n + 2 * ar, CANDMAX)
            ir = torch.where(arow, cand_n + 2 * ar + 1, CANDMAX)
            c_seg.index_copy_(0, il, torch.stack([segs[:, 0], nl], dim=1))
            c_seg.index_copy_(0, ir, torch.stack([segs[:, 0] + nl, segs[:, 1] - nl], dim=1))
            c_bs.index_copy_(0, il, res[0::2])
            c_bs.index_copy_(0, ir, res[1::2])
            c_leaf.index_copy_(0, il, leaf_rows(lsums, cdepth))
            c_leaf.index_copy_(0, ir, leaf_rows(rsums, cdepth))
            c_childlo.index_copy_(0, torch.where(arow, aslots, CANDMAX), torch.where(arow, il, -1))
            frontier = torch.stack([il, ir], dim=1).reshape(-1)[:SMAX]
            frontier_n = 2 * n_act
            cand_n = cand_n + 2 * n_act

    # ---- phase 2: exact best-first selection, L-1 fixed steps (row L of
    # seg/bs/leaf/pslot and row L-1 of recs are the dump rows)
    seg = torch.zeros((L + 1, 2), dtype=torch.int64, device=dev)
    bs = torch.full((L + 1, 8), NEG_INF, device=dev)
    leaf = torch.zeros((L + 1, 8), device=dev)
    recs = torch.zeros((L, 12), device=dev)
    pslot = torch.full((L + 1,), -1, dtype=torch.int64, device=dev)
    seg[0, 1].fill_(n)
    bs[0] = root_bs
    leaf[0] = root_leaf
    if levelwise:
        pslot[0].fill_(0)
    num_splits = torch.zeros((), dtype=torch.int64, device=dev)
    step = torch.arange(L + 1, device=dev)
    zero = torch.zeros((), device=dev)
    for s in range(L - 1):
        # the first leaf of the largest gain, as a (1,) index: rows are read
        # by index_select, since indexing by a 0-d tensor reads it on the host
        bl = torch.argmax(bs[:L, 0]).reshape(1)
        row = bs.index_select(0, bl)[0]
        go = row[0] > 0.0
        bsrow = torch.where(go, row, 0.0)  # finite when no split is taken
        fti = bsrow[1:4].long()
        left = bsrow[4:7]
        leafrow = leaf.index_select(0, bl)[0]
        start, cnt = seg.index_select(0, bl)[0]
        slot = pslot.index_select(0, bl)
        childlo = torch.where(slot >= 0, c_childlo.index_select(0, slot.clamp(min=0)), -1)[0]
        has_pre = childlo >= 0
        # the fallback split: an empty segment unless it is taken
        fields = seg_fields(start, torch.where(go & ~has_pre, cnt, 0), fti)
        p, nl, lh, rh = split_stream(p, *torch.stack(fields).to(torch.int32), num_features=G,
                                     num_bins=BH, bits=bits, rows=rows)
        nl = nl.long()
        sums2 = torch.stack([left, leafrow[0:3] - left])
        child_depth = leafrow[5] + 1.0
        dok = depth_ok(child_depth)
        bs2 = find(torch.stack([lh, rh]), sums2, None if dok is None else dok.expand(2))
        seg2 = torch.stack([torch.stack([start, nl]), torch.stack([start + nl, cnt - nl])])
        leaf2 = leaf_rows(sums2, child_depth.expand(2))
        ch = torch.stack([childlo, childlo + 1]).clamp(0, CANDMAX - 1)
        seg2 = torch.where(has_pre, c_seg[ch], seg2)
        bs2 = torch.where(has_pre, c_bs[ch], bs2)
        leaf2 = torch.where(has_pre, c_leaf[ch], leaf2)
        ps2 = torch.where(has_pre, ch, -1)
        # child outputs at ONE site for both phases: accepted leaf values
        # depend only on the children's g/h sums
        vals = leaf_output(leaf2[:, 0], leaf2[:, 1], l1, l2)
        leaf2 = torch.cat([leaf2[:, :3], vals[:, None], leaf2[:, 4:]], dim=1)
        rec = torch.stack([bl[0].float(), bsrow[1], bsrow[2], bsrow[3], bsrow[0], vals[0],
                           vals[1], leaf2[0, 2], leaf2[1, 2], leafrow[3], zero, zero])
        idx2 = torch.where(go, torch.cat([bl, step[s + 1:s + 2]]), L)
        seg.index_copy_(0, idx2, seg2)
        bs.index_copy_(0, idx2, bs2)
        leaf.index_copy_(0, idx2, leaf2)
        pslot.index_copy_(0, idx2, ps2)
        recs.index_copy_(0, torch.where(go, step[s], L - 1)[None], rec[None])
        num_splits += go
    res = PTreeResult(num_splits=num_splits, starts=seg[:L, 0], cnts=seg[:L, 1],
                      leaf_value=leaf[:L, 3], leaf_cnt=leaf[:L, 4], recs_raw=recs[:L - 1])
    return res, p


class TreeGraphs:
    """``grow_tree_partitioned`` for one trainer.  On the card each static
    signature (the class's channel rows, the split hyperparameters, whether
    a root histogram is given, the matrix) is captured once as a CUDA
    graph, from the root histogram to the tables, and replayed for every
    tree: static input buffers (root histogram, feature mask), the matrix
    updated in place, the partition kernels' workspace of the graphs' own
    stream (released with this object).  The first call of a signature
    runs eagerly on that stream (it sizes the workspace and is the tree's
    result), then captures; its K graphs share one memory pool, so a
    replay's tables are read before the next replay.  On the CPU the same
    code runs eagerly.  Each kernel wrapper's launch count grows by its
    launches in the graph at every replay, not at the capture."""

    def __init__(self, meta: FeatureMeta, bmeta, params: PGrowParams, device):
        self.meta, self.bmeta, self.params = meta, bmeta, params
        self.graphs = {}
        self.stream = self.pool = None
        if torch.device(device).type == "cuda":
            self.stream = torch.cuda.Stream(device)
            self.pool = torch.cuda.graph_pool_handle()
            weakref.finalize(self, release_stream_workspace, self.stream.device.index,
                             self.stream.cuda_stream)

    def grow(self, p, feature_mask, hyper: SplitHyper, root_hist=None, rows=None) -> PTreeResult:
        """One tree over ``p``: the PTreeResult of tensors on its device
        (on the card, the graph's output tables, valid until the next
        replay of this object's graphs)."""
        def run(fmask, root):
            return grow_tree_partitioned(p, fmask, self.meta, hyper, self.params, root,
                                         rows=rows, bmeta=self.bmeta)[0]

        if p.device.type != "cuda":
            return run(feature_mask, root_hist)
        key = (rows and tuple(rows), tuple(float(v) for v in hyper), root_hist is None,
               p.data_ptr(), tuple(p.shape))
        g = self.graphs.get(key)
        if g is None:
            g = self.graphs[key] = _TreeGraph(feature_mask, root_hist)
            return g.capture(run, self.stream, self.pool)
        return g.replay(feature_mask, root_hist)


class _TreeGraph:
    """One captured tree: its static inputs, graph, output tables and the
    kernel launches of one replay."""

    def __init__(self, feature_mask, root_hist):
        self.fmask = feature_mask.clone()
        self.root = None if root_hist is None else root_hist.clone()

    def capture(self, run, stream, pool) -> PTreeResult:
        cur = torch.cuda.current_stream(stream.device)
        stream.wait_stream(cur)
        with torch.cuda.stream(stream):
            first = run(self.fmask, self.root)
        cur.wait_stream(stream)
        before = [k.launches for k in KERNELS]
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, pool=pool, stream=stream):
            self.out = run(self.fmask, self.root)
        note_compile("graph_capture")
        # the capture launched nothing: its launches happen at each replay
        self.launches = [k.launches - b for k, b in zip(KERNELS, before)]
        for k, b in zip(KERNELS, before):
            k.launches = b
        return first

    def replay(self, feature_mask, root_hist) -> PTreeResult:
        self.fmask.copy_(feature_mask)
        if root_hist is not None:
            self.root.copy_(root_hist)
        self.graph.replay()
        for k, n in zip(KERNELS, self.launches):
            k.launches += n
        return self.out


def level_hists(p, seg_tab, n_active, params: PGrowParams, rows=None) -> torch.Tensor:
    """(smax, G, BH, 3) histograms of every active leaf segment of a
    level in one ``hist_segments`` launch, for segment histograms outside
    a partition (the grower's own root with the level grower on).
    seg_tab: (smax, 2) rows of [start, cnt]."""
    rows = rows or PLayout(params.cols, bits=params.bits).rows
    return hist_segments(p, seg_tab, n_active, num_features=params.cols,
                         num_bins=params.bins_hist, bits=params.bits, rows=rows,
                         smax=int(seg_tab.shape[0]))


def segment_values(tree: PTreeResult, num_rows: int, values: torch.Tensor) -> torch.Tensor:
    """(N,) vector giving every position of leaf l's segment the value
    ``values[l]`` ((L,) float32 on the tree's device) — the exact
    integer-rank lookup of the JAX package: an integer cumsum over
    segment-start marks ranks each position's covering segment and the
    value is gathered, so every row of a leaf gets the bit-identical value
    whatever its position."""
    L = tree.starts.shape[0]
    dev = tree.starts.device
    active = torch.arange(L, device=dev) <= tree.num_splits
    v = torch.where(active, values, 0.0)
    s = torch.where(active & (tree.cnts > 0), tree.starts, num_rows)
    marks = torch.zeros((num_rows + 1,), dtype=torch.int64, device=dev)
    marks.index_add_(0, s, torch.ones_like(s))
    rank = torch.cumsum(marks, 0)[:num_rows] - 1
    order = torch.argsort(s, stable=True)
    return v[order[rank.clamp(0, L - 1)]]
