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

The JAX package runs both phases inside one device program.  Here the
small per-leaf tables (segments, best splits, leaf sums) live on the
host in float32 numpy and the device runs the kernels and the split
search; every level and every fallback split reads its results back
(one host sync each).  Leaf outputs are computed at one host site for
both phases, so accepted values depend only on the children's sums.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from .pkernels import PLayout, level_stream, split_stream
from .split import (
    NEG_INF,
    FeatureMeta,
    SplitHyper,
    best_split_all_features,
    leaf_output_np,
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
    bits: int = 8
    levelwise: bool = True


MAX_LEVELS = 24  # phase-1 depth cap (the JAX package's default)


def levelgrow_env_params() -> dict:
    """The level-grower switch, read once at trainer construction
    (LIGHTGBM_TPU_LEVELGROW=0 forces the per-split path)."""
    return {"levelwise": os.environ.get("LIGHTGBM_TPU_LEVELGROW", "1") != "0"}


class PTreeResult(NamedTuple):
    """One grown tree (host arrays): split records in acceptance order
    plus the final leaf segments for the score update."""

    num_splits: int
    starts: np.ndarray  # (L,) physical segment start per leaf
    cnts: np.ndarray  # (L,) rows per leaf
    leaf_value: np.ndarray  # (L,) f32 raw (pre-shrinkage) outputs
    leaf_cnt: np.ndarray  # (L,) f32 selected counts
    recs_raw: np.ndarray  # (L-1, 12) f32 [leaf, feat, thr, dbz, gain, lval,
    #                        rval, lcnt, rcnt, ival, 0, 0]

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


def _meta_table(meta: FeatureMeta, f: int, bits: int) -> np.ndarray:
    """(F, 6) int64 per-feature partition constants: [default_bin,
    is_cat, col, off_lo, off_hi, bias] (unbundled: col = feature)."""
    return np.stack([
        meta.default_bin.cpu().numpy(), meta.is_categorical.cpu().numpy().astype(np.int64),
        np.arange(f), np.zeros(f, np.int64), np.full(f, 1 << bits), np.zeros(f, np.int64),
    ], axis=1).astype(np.int64)


def grow_tree_partitioned(p: torch.Tensor, feature_mask: torch.Tensor, meta: FeatureMeta,
                          hyper: SplitHyper, params: PGrowParams, root_hist: torch.Tensor,
                          rows: tuple = None):
    """Grow one leaf-wise tree over the partitioned matrix ``p`` (updated
    in place).  ``root_hist`` is the (F, B, 3) histogram of all rows with
    the g/h/sel channels freshly written.  Returns (PTreeResult, p)."""
    L, F, B, n = params.num_leaves, params.num_features, params.num_bins, params.num_rows
    bits = params.bits
    per = 32 // bits
    rows = rows or PLayout(F, bits=bits).rows
    mtab = _meta_table(meta, F, bits)
    l1, l2 = np.float32(hyper.lambda_l1), np.float32(hyper.lambda_l2)
    levelwise = params.levelwise and L > 4
    dev = p.device

    def find(hist, sums, depth_ok):
        """Best split of each leaf of a batch: hist (S, F, B, 3) on the
        device, sums (S, 3) f32 numpy, depth_ok (S,) bool numpy ->
        (S, 8) f32 numpy best-split rows [gain, feat, thr, dbz, lg, lh,
        lc, 0]."""
        s = torch.from_numpy(np.ascontiguousarray(sums, np.float32)).to(dev)
        r = best_split_all_features(hist, s[:, 0], s[:, 1], s[:, 2], meta, hyper,
                                    feature_mask, params.use_missing,
                                    params.has_categorical)
        out = torch.stack([
            r.gain, r.feature.float(), r.threshold_bin.float(),
            r.default_bin_for_zero.float(), r.left_sum_g, r.left_sum_h, r.left_cnt,
            torch.zeros_like(r.gain)], dim=1).cpu().numpy()
        out[~np.asarray(depth_ok, bool), 0] = NEG_INF
        return out

    def seg_row(start, cnt, feat, thr, dbz):
        m = mtab[feat]
        col = int(m[2])
        return [start, cnt, col // per, (col % per) * bits, int(m[0]), dbz, thr, int(m[1]),
                int(m[3]), int(m[4]), int(m[5]), 0]

    def depth_ok(depth):
        return np.ones(depth.shape, bool) if params.max_depth <= 0 else depth < params.max_depth

    root_sums = root_hist[0].sum(dim=0).cpu().numpy()  # totals via feature 0
    root_bs = find(root_hist[None], root_sums[None], np.ones(1, bool))[0]
    root_leaf = np.array([root_sums[0], root_sums[1], root_sums[2],
                          leaf_output_np(root_sums[0], root_sums[1], l1, l2),
                          root_sums[2], 0, 0, 0], np.float32)

    # ---- phase 1: level-batched expansion into candidate tables
    SMAX = min(-(-(L + 1) // 8) * 8, 512)
    CANDMAX = 2 * SMAX
    c_seg = np.zeros((CANDMAX, 2), np.int64)
    c_bs = np.full((CANDMAX, 8), NEG_INF, np.float32)
    c_leaf = np.zeros((CANDMAX, 8), np.float32)
    c_childlo = np.full((CANDMAX,), -1, np.int64)
    c_seg[0] = (0, n)
    c_bs[0] = root_bs
    c_leaf[0] = root_leaf
    if levelwise:
        frontier = np.zeros(1, np.int64)
        cand_n, level = 1, 0
        while frontier.size > 0 and level < MAX_LEVELS:
            active = frontier[c_bs[frontier, 0] > 0.0]
            n_act = min(active.size, SMAX // 2, max((CANDMAX - cand_n) // 2, 0))
            if n_act == 0:
                break
            aslots = active[:n_act]
            segs = c_seg[aslots]
            bsr = c_bs[aslots]
            feat = np.clip(bsr[:, 1].astype(np.int64), 0, F - 1)
            tab = np.asarray([seg_row(int(segs[i, 0]), int(segs[i, 1]), int(feat[i]),
                                      int(bsr[i, 2]), int(bsr[i, 3])) for i in range(n_act)],
                             np.int64)
            p, nl_t, hists = level_stream(p, torch.from_numpy(tab), n_act, num_features=F,
                                          num_bins=B, bits=bits, rows=rows, smax=SMAX)
            nl = nl_t[:n_act].cpu().numpy().astype(np.int64)
            lsums = bsr[:, 4:7]
            rsums = c_leaf[aslots, 0:3] - lsums
            cdepth = c_leaf[aslots, 5] + np.float32(1.0)
            sums2 = np.stack([lsums, rsums], axis=1).reshape(2 * n_act, 3)
            res = find(hists[:n_act].reshape(2 * n_act, F, B, 3), sums2,
                       np.repeat(depth_ok(cdepth), 2))
            il = cand_n + 2 * np.arange(n_act)
            ir = il + 1
            c_seg[il] = np.stack([segs[:, 0], nl], axis=1)
            c_seg[ir] = np.stack([segs[:, 0] + nl, segs[:, 1] - nl], axis=1)
            c_bs[il], c_bs[ir] = res[0::2], res[1::2]
            for side, idx in ((0, il), (1, ir)):
                sm = sums2[side::2]
                z = np.zeros(n_act, np.float32)
                c_leaf[idx] = np.stack([sm[:, 0], sm[:, 1], sm[:, 2], z, sm[:, 2], cdepth,
                                        z, z], axis=1)
            c_childlo[aslots] = il
            frontier = np.stack([il, ir], axis=1).reshape(-1)
            cand_n += 2 * n_act
            level += 1

    # ---- phase 2: exact best-first selection
    seg = np.zeros((L, 2), np.int64)
    bs = np.full((L, 8), NEG_INF, np.float32)
    leaf = np.zeros((L, 8), np.float32)
    recs = np.zeros((L - 1, 12), np.float32)
    pslot = np.full((L,), -1, np.int64)
    seg[0], bs[0], leaf[0] = (0, n), root_bs, root_leaf
    if levelwise:
        pslot[0] = 0
    s = 0
    while s < L - 1:
        gains = bs[:, 0]
        bl = int(np.argmax(gains))
        if not gains[bl] > 0.0:
            break
        rl = s + 1
        bsrow = bs[bl].copy()
        gain = bsrow[0]
        feat, thr, dbz = int(bsrow[1]), int(bsrow[2]), int(bsrow[3])
        left = bsrow[4:7]
        leafrow = leaf[bl].copy()
        start, cnt = int(seg[bl, 0]), int(seg[bl, 1])
        slot = int(pslot[bl])
        childlo = int(c_childlo[slot]) if slot >= 0 else -1
        if childlo >= 0:
            ch = [childlo, childlo + 1]
            seg2, bs2, leaf2 = c_seg[ch].copy(), c_bs[ch].copy(), c_leaf[ch].copy()
            ps2 = np.asarray(ch, np.int64)
        else:
            tabrow = seg_row(start, cnt, feat, thr, dbz)
            p, nl_t, lhist, rhist = split_stream(
                p, *tabrow[:11], num_features=F, num_bins=B, bits=bits, rows=rows)
            nl = int(nl_t)
            sums2 = np.stack([left, leafrow[0:3] - left]).astype(np.float32)
            child_depth = leafrow[5] + np.float32(1.0)
            bs2 = find(torch.stack([lhist, rhist]), sums2,
                       np.repeat(depth_ok(np.asarray([child_depth])), 2))
            seg2 = np.asarray([[start, nl], [start + nl, cnt - nl]], np.int64)
            z = np.zeros(2, np.float32)
            leaf2 = np.stack([sums2[:, 0], sums2[:, 1], sums2[:, 2], z, sums2[:, 2],
                              np.full(2, child_depth, np.float32), z, z], axis=1)
            ps2 = np.full(2, -1, np.int64)
        # child outputs at ONE site for both phases: accepted leaf values
        # depend only on the children's g/h sums
        leaf2[:, 3] = leaf_output_np(leaf2[:, 0], leaf2[:, 1], l1, l2)
        recs[s] = [bl, feat, thr, dbz, gain, leaf2[0, 3], leaf2[1, 3], leaf2[0, 2],
                   leaf2[1, 2], leafrow[3], 0, 0]
        seg[[bl, rl]] = seg2
        bs[[bl, rl]] = bs2
        leaf[[bl, rl]] = leaf2
        pslot[[bl, rl]] = ps2
        s += 1
    res = PTreeResult(num_splits=s, starts=seg[:, 0].copy(), cnts=seg[:, 1].copy(),
                      leaf_value=leaf[:, 3].copy(), leaf_cnt=leaf[:, 4].copy(), recs_raw=recs)
    return res, p


def segment_values(tree: PTreeResult, num_rows: int, values, device="cpu") -> torch.Tensor:
    """(N,) vector giving every position of leaf l's segment the value
    ``values[l]`` — the exact integer-rank lookup of the JAX package: an
    integer cumsum over segment-start marks ranks each position's
    covering segment and the value is gathered, so every row of a leaf
    gets the bit-identical value whatever its position."""
    L = tree.starts.shape[0]
    active = np.arange(L) <= tree.num_splits
    v = torch.as_tensor(np.where(active, values, 0.0).astype(np.float32), device=device)
    s = np.where(active & (tree.cnts > 0), tree.starts, num_rows)
    s_t = torch.as_tensor(s, dtype=torch.int64, device=device)
    marks = torch.zeros((num_rows + 1,), dtype=torch.int64, device=device)
    marks.index_add_(0, s_t, torch.ones_like(s_t))
    rank = torch.cumsum(marks, 0)[:num_rows] - 1
    order = torch.argsort(s_t, stable=True)
    return v[order[rank.clamp(0, L - 1)]]
