"""Rank-sharded out-of-core training: every rank streams its own shard —
PyTorch counterpart of lightgbm_tpu/boosting/oocdist.py.

Two scale axes compose here: the streamed matrix (boosting/ooc.py) and
the data-parallel fleet (parallel/hostlearner.py).  Each rank streams its
own contiguous row shard from its own chunk source through the prefetch
ring, folds each node's histogram over its chunks through B8's (B9's)
carry mode (data/chunksource.py ``ChunkFolder``), and exchanges only the
node histograms over its ``Comm``.  A rank's device holds its row vectors
and ``depth`` chunks, never its shard's matrix; the wire carries O(F·B)
bytes a node.

The exchanges of a tree are the data-parallel host learner's, in its
order:

- quantized: the (max|g|, max|h|) ``_QMAX`` allgather gives one global
  scale; the exact int64 root totals travel as ``_QSUMS``; every node's
  histogram ships as the 2-plane ``hist_q`` wire (F*B*4 bytes against
  float32's F*B*12) and merges in exact integers;
- float: the root totals (``_SUMS``) and histograms merge by rank-order
  float32 adds;
- the smaller child is chosen by global row counts (the 8-byte ``_CNT``
  allgather), so every rank subtracts the same sibling; quantized, both
  children's carries are exact and taken direct.

Determinism: quantized, a chunk's int32 partials add associatively, so
the merged node histograms, and the model, are the same bytes for any
chunk grid and any rank count; the float carries are float64 rounded once
a pass, so a rank's streamed histogram is its resident one bit for bit,
and the float model is the in-memory data-parallel learner's at the same
world (world-dependent, as that learner's rank-order merge is).

Every rank replays the same decisions from the same gathered bytes, so
the collectives stay in lockstep.  A checkpoint records the rank's chunk
grid as a ``dist/`` schedule fingerprint, which ckpt/state.py ``restore``
exempts from its grid-equality refusal: per-rank grids differ between
world sizes, and the global dataset fingerprint still gates the resume.
"""

from __future__ import annotations

import numpy as np
import torch

from ..data.chunksource import ChunkFolder, ChunkPlan, ChunkStream, PrefetchStats, make_chunk_source
from ..obs import tracer
from ..ops import qhist
from ..ops.grow import GrowResult, value_words
from ..ops.histogram import finalize_histogram, histogram_from_parent, upload
from ..ops.split import NEG_INF, leaf_output_np
from ..parallel.hostlearner import (_CNT, _QMAX, _QSUMS, _SUMS, HostParallelLearner,
                                    _merge_f32, _read_children)
from ..utils.log import Log
from .ooc import OocTrainer

__all__ = ["DistributedOocTrainer"]


class DistributedOocTrainer(HostParallelLearner):
    """The ``learner`` of GBDT over a ``Comm`` when the matrix streams:
    ``grow()`` takes the host learner's arguments (the bins ignored: they
    come from this rank's chunk source), and the row vectors of this
    rank's shard on the device."""

    def __init__(self, train_set, config, grow_params, chunk_rows: int, comm, device="cpu"):
        super().__init__("data", comm, grow_params, top_k=config.top_k,
                         quantized=config.quantized_training,
                         quant_bits=config.quantized_grad_bits, quant_seed=config.seed)
        self.num_rows = int(train_set.num_data)  # this rank's rows
        self.num_features = int(train_set.num_features)
        self.plan = ChunkPlan(self.num_rows, chunk_rows)
        self.stats = PrefetchStats()
        self.depth = max(int(getattr(config, "ooc_prefetch_depth", 2) or 2), 1)
        self.source = make_chunk_source(train_set)
        self.chunks = ChunkStream(self.source, self.plan, self.depth, self.stats, device)
        self.folder = ChunkFolder(self.chunks, self.num_features, grow_params.num_bins,
                                  grow_params.bits)
        self._trees_grown = 0
        tracer.event("ooc.plan", rows=self.num_rows, features=self.num_features,
                     chunk_rows=self.plan.chunk_rows, chunks=self.plan.num_chunks,
                     depth=self.depth, source=self.source.describe(), rank=self.comm.rank,
                     world=self.comm.nproc)
        Log.info("Distributed out-of-core training: rank %d/%d streams %d rows in %d chunks "
                 "of %d (%s, prefetch depth %d, %s histogram wire)", self.comm.rank,
                 self.comm.nproc, self.num_rows, self.plan.num_chunks, self.plan.chunk_rows,
                 self.source.describe(), self.depth,
                 "hist_q int16/int32" if self.quant else "f32")

    def schedule_fingerprint(self) -> str:
        """The rank's chunk-schedule identity; the ``dist/`` prefix tells
        ckpt/state.py the grid is rank-local, so a resume at another world
        size (another per-rank grid) is admitted."""
        return f"dist/{self.comm.nproc}w/r{self.comm.rank}/{self.plan.fingerprint()}"

    def set_plan(self, plan) -> None:
        """The shard-plan seam: streamed rows are disk-resident, so
        rebalancing is declined for them (GBDT._init_rebalance)."""
        del plan

    def _root_sums(self, grad, hess, select) -> np.ndarray:
        """The global (3,) float32 root totals: exact integer sums of the
        quantized levels then one scale, or rank-order float32 adds of the
        ranks' float64-rounded sums (the host learner's)."""
        if self.quant:
            s64 = select.to(torch.int64)
            local = torch.stack([(grad.to(torch.int64) * s64).sum(),
                                 (hess.to(torch.int64) * s64).sum(), s64.sum()]).tolist()
            sums_i = [_QSUMS.unpack(b) for b in self.comm.allgather(
                _QSUMS.pack(*(int(v) for v in local)), "hist_q")]
            tg = np.float32(np.float32(sum(s[0] for s in sums_i)) * self._qscales[0])
            th = np.float32(np.float32(sum(s[1] for s in sums_i)) * self._qscales[1])
            return np.array([tg, th, np.float32(sum(s[2] for s in sums_i))], np.float32)
        sel32 = select.to(torch.float32)
        root = torch.stack([(grad * sel32).double().sum(), (hess * sel32).double().sum(),
                            sel32.double().sum()]).float().cpu().numpy()
        blobs = self.comm.allgather(_SUMS.pack(*(float(v) for v in root)), "best_split")
        return _merge_f32([np.array(_SUMS.unpack(b), np.float32).tobytes() for b in blobs], (3,))

    def grow(self, bins_ignored, grad, hess, select, feature_mask, meta, hyper) -> GrowResult:
        """Grow one leaf-wise tree: this rank streams its shard a pass a
        node and the node histograms merge across ranks."""
        del bins_ignored
        stats0 = dict(self.stats.as_dict())
        with tracer.span("ooc.grow", tree=self._trees_grown, chunks=self.plan.num_chunks,
                         rank=self.comm.rank):
            gr = self._grow_streamed(grad, hess, select, feature_mask, meta, hyper)
        self._trees_grown += 1
        OocTrainer._emit_stream_obs(self, stats0, rank=self.comm.rank)
        return gr

    def _grow_streamed(self, grad, hess, select, feature_mask, meta, hyper) -> GrowResult:
        p = self.params
        dev = grad.device
        n, f = self.num_rows, self.num_features
        L = p.num_leaves
        default_bin = meta.default_bin.cpu().numpy()
        is_cat = meta.is_categorical.cpu().numpy()
        mono_t = p.monotone
        use_mono = any(c != 0 for c in mono_t)
        if use_mono and len(mono_t) != f:
            raise ValueError(f"monotone direction vector has {len(mono_t)} entries for "
                             f"{f} features")
        hmono = torch.tensor(mono_t, dtype=torch.int64, device=dev) if use_mono else None
        leaf_lo = np.full((L,), -np.inf, np.float32)
        leaf_hi = np.full((L,), np.inf, np.float32)

        if self.quant:
            # one global scale from the allgathered maxima, then rounding
            # keyed by each value's bits: a row quantizes alike on any rank
            # and in any chunk; ``_qiter`` is re-anchored on a restore
            self._qiter += 1
            seed = (self.quant_seed * 2654435761 + self._qiter * 97 + 1) & 0xFFFFFFFF
            mx = qhist.local_absmax(grad, hess, select).cpu().numpy()
            maxima = [_QMAX.unpack(b) for b in self.comm.allgather(
                _QMAX.pack(float(mx[0]), float(mx[1])), "hist_q")]
            self._qscales = qhist.scales_from_max(max(m[0] for m in maxima),
                                                  max(m[1] for m in maxima), self.quant_bits)
            grad, hess = qhist.quantize_rows(grad, hess, self._qscales, seed, self.quant_bits)
        g_w, h_w, sel_w = value_words(grad, hess, select)

        root = self._root_sums(grad, hess, select)
        root_hist = self.folder.fold_root(g_w, h_w, sel_w, self.quant)

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
        pool = {0: root_hist}

        def find(hists, sums, depth_ok, leaves, host=None):
            mono = None
            if hmono is not None:
                b = upload(torch.from_numpy(np.stack([leaf_lo[leaves], leaf_hi[leaves]])), dev)
                mono = (hmono, b[0], b[1])
            return self._find_best(hists, np.asarray(sums, np.float32).reshape(-1, 3), depth_ok,
                                   meta, hyper, feature_mask, f, 0, mono, host)

        def store(leaf, res):
            bs_gain[leaf], bs_feat[leaf], bs_thr[leaf], bs_dbz[leaf] = res[:4]
            bs_left[leaf] = res[4]

        store(0, find([root_hist], leaf_sum[0], True, [0])[0])
        l1, l2 = np.float32(hyper.lambda_l1), np.float32(hyper.lambda_l2)
        leaf_id = torch.zeros((n,), dtype=torch.int32, device=dev)
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
                plo, phi = leaf_lo[bl], leaf_hi[bl]
                lval, rval = np.clip(lval, plo, phi), np.clip(rval, plo, phi)
                cdir = int(mono_t[feat])
                mid = (lval + rval) * np.float32(0.5)
                leaf_lo[bl] = mid if cdir < 0 else plo
                leaf_hi[bl] = mid if cdir > 0 else phi
                leaf_lo[right] = mid if cdir > 0 else plo
                leaf_hi[right] = mid if cdir < 0 else phi

            # ---- one streamed pass: the partition and both children's carries
            n_left_t, carry_l, carry_r = self.folder.fold_split(
                leaf_id, g_w, h_w, sel_w, feat, int(default_bin[feat]), dbz, thr,
                bool(is_cat[feat]), bl, right, self.quant)
            host = None
            if self.quant:
                # exact integer carries: both children direct are the
                # parent-less-sibling rule's, read with the count at once
                pool[bl], pool[right] = finalize_histogram(carry_l), finalize_histogram(carry_r)
                n_left, host = _read_children(pool[bl], pool[right], n_left_t)
            else:
                n_left = int(n_left_t)
            n_right = int(leaf_rows[bl]) - n_left
            # the smaller child by global row count: every rank keeps the
            # direct histogram of the same child, so the merge never mixes
            # siblings
            cnts = [_CNT.unpack(b) for b in self.comm.allgather(_CNT.pack(n_left, n_right),
                                                                 "best_split")]
            if host is None:
                left_smaller = sum(c[0] for c in cnts) < sum(c[1] for c in cnts)
                smaller = finalize_histogram(carry_l if left_smaller else carry_r)
                larger = histogram_from_parent(pool[bl], smaller)
                pool[bl], pool[right] = (smaller, larger) if left_smaller else (larger, smaller)

            depth = int(leaf_depth[bl]) + 1
            ok = p.max_depth <= 0 or depth < p.max_depth
            lres, rres = find([pool[bl], pool[right]], np.stack([left, rsum]), ok, [bl, right],
                              host)

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

    def add_tree_scores(self, score_k, arrays, lut=None):
        """``score_k`` += the stacked trees' outputs, streamed over this
        rank's chunk grid."""
        return self.folder.streamed_scores(score_k, arrays, lut)
