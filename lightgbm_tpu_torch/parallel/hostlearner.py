"""Host-driven parallel tree learners — PyTorch counterpart of
lightgbm_tpu/parallel/hostlearner.py.

The leaf-wise loop of ops/grow.py ``grow_tree`` with the host driving
control flow over a ``Comm`` (parallel/comm.py), every exchange an
allgather of bytes:

- ``mode="data"``: rows sharded; each node's local (F, B, 3) histogram
  is allgathered and merged in rank order (DataParallelTreeLearner;
  O(F*B) bytes a node);
- ``mode="feature"``: columns sharded, rows replicated; each rank
  searches only its column block, a 28-byte best-split record is
  allgathered, and the split's owner broadcasts the partition bitmap
  (FeatureParallelTreeLearner; O(1) a node besides the bitmap);
- ``mode="voting"``: PV-Tree; each rank votes its local top-k features,
  the election keeps the top 2k, and only their histograms travel
  (O(2k*B) a node).

Each node histogram is B8 (``hist_segment``) or, quantized, B9
(``hist_segment_q``) over the rank's shard: the shard's bin words are
packed once a tree, and each node rewrites only the select row, the
rank's select masked to the node's rows.  The larger child is the
parent less the smaller, as in the serial grower.

Bit-parity contracts (tests/test_torch_parallel.py):

- feature mode equals the port's serial ``grow_tree`` bitwise: the
  split scan is elementwise in F, and a histogram of a column block is
  that block of the whole histogram (float64 cells rounded once), so
  sharding columns changes no arithmetic; the records carry float32
  values exactly;
- voting with 2k >= F equals data mode bitwise: the elected set covers
  every column, so the rank-order merge makes the same float32 adds.

Across packages the float histograms differ in the sixth digit (the port
rounds float64 cells once), so float trees are held to the JAX
package's by split lines.  Quantized training (data and voting modes):
one global scale a tree from the allgathered maxima, int16 levels keyed
by each value's bits, exact int32 histograms shipped as the 2-plane
``hist_q`` wire (ops/qhist.py) and merged in exact integer arithmetic,
with the count plane derived at the receiver (a rank whose hessian mass
for the node quantized to zero ships its counts as a third plane); the
merged planes, and the tree, are the same for any rank count and equal
the JAX package's bit for bit.  Feature mode ignores quantization: it
ships no histogram.

Ledger purposes (``net.bytes{purpose=...}``): ``hist``, ``best_split``
(records, bitmaps, node counts and sums), ``vote``, ``elect`` and
``hist_q`` (scale maxima, integer root totals, quantized histograms).
Every rank takes the same decisions from the same gathered bytes, so the
exchanges stay in lockstep.
"""

from __future__ import annotations

import struct
from typing import Dict, List

import numpy as np
import torch

from ..obs import tracer
from ..ops import qhist
from ..ops.grow import GrowParams, GrowResult, partition_goes_left, value_words, word_column
from ..ops.histogram import hist_segment, hist_segment_q, pack_bin_words, upload
from ..ops.split import (NEG_INF, best_split_feature_block, best_split_per_feature,
                         leaf_output_np, slice_features)

# the 28-byte best-split record: gain, feature, threshold_bin,
# default_bin_for_zero, left (sum_g, sum_h, cnt); the right side is the
# leaf's totals less the left, recomputed exactly
_REC = struct.Struct("<fiiifff")
_CNT = struct.Struct("<ii")
_SUMS = struct.Struct("<fff")
# quantized training: each rank's (max|g|, max|h|) for the global scale,
# and its exact integer root totals (sum_qg, sum_qh, count)
_QMAX = struct.Struct("<ff")
_QSUMS = struct.Struct("<qqq")


def _merge_f32(blobs: List[bytes], shape) -> np.ndarray:
    """Rank-order sequential float32 adds: the anchor of the data <->
    voting bit-parity contract."""
    parts = [np.frombuffer(b, np.float32).reshape(shape) for b in blobs]
    tot = parts[0].copy()
    for p in parts[1:]:
        tot = tot + p
    return tot


def _merge_q(blobs: List[bytes], f: int, b: int):
    """Exact integer merge of ``hist_q`` payloads, independent of rank
    count and order: the (F, B, 2) int64 (g, h) planes, and the summed
    (F, B) exact count plane of any 3-plane payloads (None when every
    rank shipped two planes)."""
    tot = np.zeros((f, b, 2), np.int64)
    counts = None
    for blob in blobs:
        arr = qhist.unpack_hist_q(blob, f, b)
        tot = tot + arr[..., :2]
        if arr.shape[-1] == 3:
            c = arr[..., 2].astype(np.int64)
            counts = c if counts is None else counts + c
    return tot, counts


def _q_counts_if_degenerate(hist3: np.ndarray):
    """The exact count plane iff this rank's quantized hessian mass for
    the node is zero while it holds rows (hessians are non-negative, so
    the global mass is zero iff every rank's is: each such rank ships its
    counts, and the receiver needs no second exchange)."""
    if int(hist3[0, :, 1].sum()) == 0 and int(hist3[0, :, 2].sum()) > 0:
        return hist3[..., 2]
    return None


def _split_rows(res) -> np.ndarray:
    """The (S, 7) float64 host rows [gain, feat, thr, dbz, lg, lh, lc] of
    a SplitResult of S leaves (one device read)."""
    return torch.stack([res.gain.double(), res.feature.double(), res.threshold_bin.double(),
                        res.default_bin_for_zero.double(), res.left_sum_g.double(),
                        res.left_sum_h.double(), res.left_cnt.double()], dim=1).cpu().numpy()


class HostParallelLearner:
    """Leaf-wise grower driven from the host over a ``Comm``.

    ``grow(bins, grad, hess, select, feature_mask, meta, hyper)`` takes
    this rank's shard (its rows in data and voting modes, the whole
    matrix in feature mode) on the device and returns ops/grow.py's
    ``GrowResult``, with ``leaf_id`` over the shard's rows.  ``top_k`` is
    the voting ballot's size; ``quantized`` (data and voting modes)
    rounds the float32 gradients it is given to ``quant_bits`` levels,
    keyed by ``quant_seed`` and the tree's index."""

    # the quantization scale is a maximum over every rank's rows, so the
    # learner takes float32 gradients and quantizes them itself
    quantizes_internally = True

    def __init__(self, mode: str, comm, params: GrowParams, top_k: int = 20,
                 quantized: bool = False, quant_bits: int = qhist.QUANT_BITS,
                 quant_seed: int = 0):
        if mode not in ("data", "feature", "voting"):
            raise ValueError(f"unknown host learner mode {mode!r}")
        self.mode = mode
        self.comm = comm
        self.params = params
        self.top_k = int(top_k)
        self.quant = bool(quantized) and mode in ("data", "voting")
        self.quant_bits = int(quant_bits)
        self.quant_seed = int(quant_seed)
        self._qiter = -1  # the trees quantized so far (the rounding key)
        self._qscales = None  # (2,) np.float32 scales of the current tree

    def set_plan(self, plan) -> None:
        """The shard-plan seam: the learner keeps no state of rows between
        trees (each grow packs the shard it is given), so a move of row
        ownership needs nothing here."""
        del plan

    def _feature_block(self, f: int):
        """(per, lo, hi): the contiguous column block [lo, hi) this rank
        owns, ``per`` columns a rank."""
        per = -(-f // self.comm.nproc)
        lo = min(f, self.comm.rank * per)
        return per, lo, min(f, lo + per)

    # -- the best splits of a node's leaves, one exchange pattern a mode --

    def _search(self, hists, lo, sums, meta, hyper, fmask, mono):
        """The split scan of S leaves at once: ``hists`` (S, F, B, 3)
        float32 on the device, ``sums`` (S, 3); ``mono`` is (directions,
        leaf_lo (S,), leaf_hi (S,)) or None.  A leaf's result does not
        depend on S.  Returns the (S, 7) host rows."""
        p = self.params
        s = upload(torch.from_numpy(np.ascontiguousarray(sums.T)), hists.device)
        kw = {} if mono is None else dict(monotone=mono[0], leaf_lo=mono[1], leaf_hi=mono[2])
        res = best_split_feature_block(hists, lo, s[0], s[1], s[2], meta, hyper, fmask,
                                       p.use_missing, p.has_categorical, self.quant, **kw)
        return _split_rows(res)

    def _merge_node(self, hist, node_cnt, f):
        """Data mode: this rank's node histogram allgathered and merged,
        (F, B, 3) float32 on the host: the float32 wire merged in rank
        order, or the 2-plane int16 ``hist_q`` wire merged in exact
        integers with the count plane derived from the hessian plane and
        the node's count (a rank with zero hessian mass here ships its
        counts)."""
        B = self.params.num_bins
        if self.quant:
            h3 = hist.cpu().numpy()
            blobs = self.comm.allgather(
                qhist.pack_hist_q(h3[..., :2], _q_counts_if_degenerate(h3)), "hist_q")
            merged, exact_cnt = _merge_q(blobs, f, B)
            return qhist.assemble_hist(merged, self._qscales, float(node_cnt), counts=exact_cnt)
        blobs = self.comm.allgather(hist.cpu().numpy().tobytes(), "hist")
        return _merge_f32(blobs, (f, B, 3))

    def _find_best(self, hists, sums, depth_ok, meta, hyper, feature_mask, f, lo, mono=None):
        """[(gain, feat, thr, dbz, left (3,))] of the S leaves of ``hists``
        (this rank's (F, B, 3) histograms, None for a rank without
        columns), the same on every rank.  The exchanges go leaf by leaf,
        in the JAX package's order; the scans of the leaves are one
        batched call."""
        S = len(hists)
        if self.mode == "feature":
            if hists[0] is not None:
                rows = self._search(torch.stack(hists), lo, sums, meta, hyper, feature_mask,
                                    mono)
                recs = [_REC.pack(float(r[0]), int(r[1]), int(r[2]), int(r[3]), float(r[4]),
                                  float(r[5]), float(r[6])) for r in rows]
            else:  # more ranks than column blocks: a vacuous candidate
                recs = [_REC.pack(NEG_INF, 0, 0, 0, 0.0, 0.0, 0.0)] * S
            out = []
            for rec in recs:
                got = [_REC.unpack(b) for b in self.comm.allgather(rec, "best_split")]
                # first max: a tie goes to the lowest rank, the lowest global
                # feature under contiguous blocks, as the serial argmax
                w = got[int(np.argmax(np.array([r[0] for r in got], np.float32)))]
                out.append((w[0], w[1], w[2], w[3], np.array(w[4:7], np.float32)))
        else:
            dev = hists[0].device
            if self.mode == "voting":
                ghists, vmasks = self._vote_and_merge(hists, sums, meta, hyper, feature_mask, f,
                                                      mono)
                fmask = feature_mask[None, :] * upload(torch.from_numpy(vmasks), dev)
            else:
                ghists = [self._merge_node(h, sums[i, 2], f) for i, h in enumerate(hists)]
                fmask = feature_mask
            rows = self._search(upload(torch.from_numpy(np.stack(ghists)), dev), 0, sums, meta,
                                hyper, fmask, mono)
            out = [(r[0], r[1], r[2], r[3], r[4:7].astype(np.float32)) for r in rows]
        return [(np.float32(g if depth_ok else NEG_INF), int(ft), int(t), int(d), left)
                for g, ft, t, d, left in out]

    def _vote_and_merge(self, hists, sums, meta, hyper, feature_mask, f, mono):
        """PV-Tree, leaf by leaf: ballot -> election -> merge of the
        elected columns.  Returns each leaf's (F, B, 3) float32 global
        histogram, zero outside its elected columns, and the (S, F) 0/1
        masks of the elected columns.  The ballots' local scans (of all S
        leaves at once) run under the monotone bounds too, so ranks vote
        for splits the global scan can take."""
        p = self.params
        nproc = self.comm.nproc
        k = max(min(self.top_k, f), 1)
        k2 = min(2 * k, f)
        local = torch.stack(hists)
        if self.quant:
            # ballots come from the dequantized local histograms (their
            # count planes exact); only the elected columns ship, as hist_q
            local = qhist.dequantize_hist(local, self._qscales)
        # the leaves' local totals: feature 0's bins (every row lands in one)
        lt = local[:, 0].double().sum(dim=1).float()
        # local proposals under constraints relaxed by the rank count
        # (voting_parallel_tree_learner.cpp:54-56)
        local_hyper = hyper._replace(
            min_data_in_leaf=np.float32(hyper.min_data_in_leaf / np.float32(nproc)),
            min_sum_hessian_in_leaf=np.float32(hyper.min_sum_hessian_in_leaf
                                               / np.float32(nproc)))
        kw = {} if mono is None else dict(monotone=mono[0], leaf_lo=mono[1], leaf_hi=mono[2])
        gains = best_split_per_feature(local, lt[:, 0], lt[:, 1], lt[:, 2], meta, local_hyper,
                                       feature_mask, p.use_missing, p.has_categorical,
                                       self.quant, **kw)[0].cpu().numpy()
        ghists, vmasks = [], np.zeros((len(hists), f), np.float32)
        for i, lg_f in enumerate(gains):
            ballot = np.argsort(-lg_f, kind="stable")[:k].astype(np.int32)
            votes = np.zeros((f,), np.float32)
            for b in self.comm.allgather(ballot.tobytes(), "vote"):
                votes[np.frombuffer(b, np.int32)] += 1.0
            # stable sort: vote ties go to the lower feature index
            elected = np.sort(np.argsort(-votes, kind="stable")[:k2]).astype(np.int32)
            echo = self.comm.allgather(elected.tobytes(), "elect")
            if any(e != echo[0] for e in echo):
                raise RuntimeError("voting-parallel election disagreed across ranks: "
                                   "non-deterministic local gains?")
            sub3 = hists[i].cpu().numpy()[elected]
            if self.quant:
                parts = self.comm.allgather(
                    qhist.pack_hist_q(sub3[..., :2], _q_counts_if_degenerate(sub3)), "hist_q")
                merged_q, exact_cnt = _merge_q(parts, k2, p.num_bins)
                # an elected column's hessian plane sums to the node's
                # total, which the count derivation needs
                merged = qhist.assemble_hist(merged_q, self._qscales, float(sums[i, 2]),
                                             counts=exact_cnt)
            else:
                parts = self.comm.allgather(np.ascontiguousarray(sub3).tobytes(), "hist")
                merged = _merge_f32(parts, (k2, p.num_bins, 3))
            ghist = np.zeros((f, p.num_bins, 3), np.float32)
            ghist[elected] = merged
            ghists.append(ghist)
            vmasks[i, elected] = 1.0
        return ghists, vmasks

    # -- the leaf-wise loop --------------------------------------------

    def grow(self, bins, grad, hess, select, feature_mask, meta, hyper) -> GrowResult:
        """Grow one tree from this rank's shard: ``bins`` (n, F) (uint8,
        or int32 for 16-bit words), ``grad``/``hess``/``select`` (n,)
        float32, ``feature_mask`` (F,) float32, ``meta`` the FeatureMeta
        of all F features, all on the same device."""
        with tracer.span("learner.grow", mode=self.mode, nproc=self.comm.nproc):
            return self._grow(bins, grad, hess, select, feature_mask, meta, hyper)

    def _grow(self, bins, grad, hess, select, feature_mask, meta, hyper) -> GrowResult:
        p = self.params
        dev = grad.device
        n, f = bins.shape
        L, B, bits = p.num_leaves, p.num_bins, p.bits
        per_word = 32 // bits
        rowed = self.mode in ("data", "voting")

        if self.mode == "feature":
            per, lo, hi = self._feature_block(f)
            hmeta = slice_features(meta, lo, hi)
            hmask = feature_mask[lo:hi]
        else:
            per, lo, hi = f, 0, f
            hmeta, hmask = meta, feature_mask
        default_bin = meta.default_bin.cpu().numpy()
        is_cat = meta.is_categorical.cpu().numpy()

        # monotone constraints: the host replays the bounds as the serial
        # grower does; each rank scans its own columns' directions
        mono_t = p.monotone
        use_mono = any(c != 0 for c in mono_t)
        if use_mono and len(mono_t) != f:
            raise ValueError(f"monotone direction vector has {len(mono_t)} entries for "
                             f"{f} features")
        hmono = (torch.tensor(mono_t[lo:hi], dtype=torch.int64, device=dev)
                 if use_mono and hi > lo else None)
        leaf_lo = np.full((L,), -np.inf, np.float32)
        leaf_hi = np.full((L,), np.inf, np.float32)

        if self.quant:
            # one global scale from the allgathered local maxima (every
            # rank derives the same float32 scale), then rounding keyed by
            # each value's bits: a row quantizes alike on any rank
            self._qiter += 1
            seed = (self.quant_seed * 2654435761 + self._qiter * 97 + 1) & 0xFFFFFFFF
            mx = qhist.local_absmax(grad, hess, select).cpu().numpy()
            maxima = [_QMAX.unpack(b) for b in self.comm.allgather(
                _QMAX.pack(float(mx[0]), float(mx[1])), "hist_q")]
            self._qscales = qhist.scales_from_max(max(m[0] for m in maxima),
                                                  max(m[1] for m in maxima), self.quant_bits)
            grad, hess = qhist.quantize_rows(grad, hess, self._qscales, seed, self.quant_bits)

        # the shard's packed matrix, once a tree: bin words of the columns
        # this rank histograms, then g, h and a select row that each node
        # rewrites (ops/histogram.py layout)
        g_w, h_w, sel_w = value_words(grad, hess, select)
        fh = hi - lo
        if fh > 0:
            words = pack_bin_words(bins[:, lo:hi], per_word, bits)
            W = words.shape[0]
            pm = torch.empty((W + 3, n), dtype=torch.int32, device=dev)
            pm[:W] = words
            pm[W], pm[W + 1] = g_w, h_w
            del words
        hist_fn = hist_segment_q if self.quant else hist_segment

        def node_hist(leaf_id, target):
            if fh <= 0:
                return None
            pm[W + 2] = torch.where(leaf_id == target, sel_w, 0)
            return hist_fn(pm, 0, n, fh, B, per_word, bits)

        # ---- root totals (LeafSplits::Init)
        if self.quant:
            s64 = select.to(torch.int64)
            local = torch.stack([(grad.to(torch.int64) * s64).sum(),
                                 (hess.to(torch.int64) * s64).sum(), s64.sum()]).tolist()
            sums_i = [_QSUMS.unpack(b) for b in self.comm.allgather(
                _QSUMS.pack(*(int(v) for v in local)), "hist_q")]
            tg = np.float32(np.float32(sum(s[0] for s in sums_i)) * self._qscales[0])
            th = np.float32(np.float32(sum(s[1] for s in sums_i)) * self._qscales[1])
            tc = np.float32(sum(s[2] for s in sums_i))
            root = np.array([tg, th, tc], np.float32)
        else:
            sel32 = select.to(torch.float32)
            root = torch.stack([(grad * sel32).double().sum(), (hess * sel32).double().sum(),
                                sel32.double().sum()]).float().cpu().numpy()
            if rowed:
                blobs = self.comm.allgather(_SUMS.pack(*(float(v) for v in root)),
                                            "best_split")
                root = _merge_f32([np.array(_SUMS.unpack(b), np.float32).tobytes()
                                   for b in blobs], (3,))

        leaf_id = torch.zeros((n,), dtype=torch.int32, device=dev)
        root_hist = node_hist(leaf_id, 0)

        bs_gain = np.full((L,), NEG_INF, np.float32)
        bs_feat = np.zeros((L,), np.int32)
        bs_thr = np.zeros((L,), np.int32)
        bs_dbz = np.zeros((L,), np.int32)
        bs_left = np.zeros((L, 3), np.float32)
        leaf_sum = np.zeros((L, 3), np.float32)
        leaf_value = np.zeros((L,), np.float32)
        leaf_cnt = np.zeros((L,), np.float32)
        leaf_depth = np.zeros((L,), np.int32)
        leaf_rows = np.zeros((L,), np.int64)  # this rank's rows
        rec_i = np.zeros((4, L - 1), np.int32)  # leaf, feat, thr, dbz
        rec_f = np.zeros((6, L - 1), np.float32)  # gain, lval, rval, lcnt, rcnt, internal

        leaf_sum[0] = root
        leaf_cnt[0] = root[2]
        leaf_rows[0] = n
        pool: Dict[int, torch.Tensor] = {0: root_hist}

        def find(hists, sums, depth_ok, leaves):
            mono = None
            if hmono is not None:
                b = upload(torch.from_numpy(np.stack([leaf_lo[leaves], leaf_hi[leaves]])), dev)
                mono = (hmono, b[0], b[1])
            return self._find_best(hists, np.asarray(sums, np.float32).reshape(-1, 3), depth_ok,
                                   hmeta, hyper, hmask, f, lo, mono)

        def store(leaf, res):
            bs_gain[leaf], bs_feat[leaf], bs_thr[leaf], bs_dbz[leaf] = res[:4]
            bs_left[leaf] = res[4]

        store(0, find([root_hist], leaf_sum[0], True, [0])[0])
        l1, l2 = np.float32(hyper.lambda_l1), np.float32(hyper.lambda_l2)
        s = 0
        while s < L - 1:
            bl = int(np.argmax(bs_gain))  # first max
            if not bs_gain[bl] > 0.0:
                break  # no split with positive gain
            right = s + 1
            feat, thr, dbz = int(bs_feat[bl]), int(bs_thr[bl]), int(bs_dbz[bl])
            left = bs_left[bl].copy()
            rsum = leaf_sum[bl] - left
            lval = leaf_output_np(left[0], left[1], l1, l2)
            rval = leaf_output_np(rsum[0], rsum[1], l1, l2)
            if use_mono:
                # outputs clipped to the parent's bounds; on a constrained
                # feature the children's bounds meet at the midpoint
                plo, phi = leaf_lo[bl], leaf_hi[bl]
                lval, rval = np.clip(lval, plo, phi), np.clip(rval, plo, phi)
                cdir = int(mono_t[feat])
                mid = (lval + rval) * np.float32(0.5)
                leaf_lo[bl] = mid if cdir < 0 else plo
                leaf_hi[bl] = mid if cdir > 0 else phi
                leaf_lo[right] = mid if cdir > 0 else plo
                leaf_hi[right] = mid if cdir < 0 else phi

            # ---- partition (DataPartition::Split)
            if self.mode == "feature":
                owner = feat // per
                if owner == self.comm.rank:
                    fl = feat - lo
                    col = word_column(pm[fl // per_word], fl, per_word, bits)
                    gl = partition_goes_left(col, int(default_bin[feat]), dbz, thr,
                                             bool(is_cat[feat]))
                    blob = np.packbits(gl.cpu().numpy()).tobytes()
                else:
                    blob = b""
                blobs = self.comm.allgather(blob, "best_split")
                mask = np.unpackbits(np.frombuffer(blobs[owner], np.uint8), count=n)
                goes_left = upload(torch.from_numpy(mask.astype(bool)), dev)
            else:
                col = word_column(pm[feat // per_word], feat, per_word, bits)
                goes_left = partition_goes_left(col, int(default_bin[feat]), dbz, thr,
                                                bool(is_cat[feat]))
            in_leaf = leaf_id == bl
            leaf_id.masked_fill_(in_leaf & ~goes_left, right)
            n_left = int((in_leaf & goes_left).sum())
            n_right = int(leaf_rows[bl]) - n_left

            # ---- the smaller child by global row count; the larger is
            # the parent less the smaller
            if rowed:
                cnts = [_CNT.unpack(b) for b in self.comm.allgather(
                    _CNT.pack(n_left, n_right), "best_split")]
                g_left, g_right = sum(c[0] for c in cnts), sum(c[1] for c in cnts)
            else:
                g_left, g_right = n_left, n_right
            left_smaller = g_left < g_right
            smaller = node_hist(leaf_id, bl if left_smaller else right)
            larger = None if smaller is None else pool[bl] - smaller
            pool[bl], pool[right] = (smaller, larger) if left_smaller else (larger, smaller)

            # ---- both children's best splits (the max_depth gate)
            depth = int(leaf_depth[bl]) + 1
            ok = p.max_depth <= 0 or depth < p.max_depth
            lres, rres = find([pool[bl], pool[right]], np.stack([left, rsum]), ok,
                              [bl, right])

            rec_i[:, s] = (bl, feat, thr, dbz)
            rec_f[:, s] = (bs_gain[bl], lval, rval, left[2], rsum[2], leaf_value[bl])
            leaf_sum[bl], leaf_sum[right] = left, rsum
            leaf_value[bl], leaf_value[right] = lval, rval
            leaf_cnt[bl], leaf_cnt[right] = left[2], rsum[2]
            leaf_depth[bl] = leaf_depth[right] = depth
            leaf_rows[bl], leaf_rows[right] = n_left, n_right
            store(bl, lres)
            store(right, rres)
            s += 1

        return GrowResult(s, leaf_id, leaf_value, leaf_cnt, *rec_i, *rec_f)
