"""Partitioned trainer — PyTorch counterpart of
lightgbm_tpu/boosting/ptrainer.py (PartitionedTrainer).

Per iteration, exactly as the JAX package's fused chunk program, one tree
(K = 1):

  canonical row order restored (one gather through the ROWID channel, so
    every tree's float sums are independent of the previous tree's
    partition history, and every random draw below is tied to an
    original row)
  -> the iteration's draws from the threefry key stream (bagging select,
     feature_fraction mask; see ``_draws``)
  -> update_and_root_hist   (score += the previous tree's pending delta,
                             fresh gradients, bagging select, root
                             histogram)                           [kernel]
     or, for GOSS after its warm-up iterations:
     update_channels        (score += pending delta, fresh gradients)
                                                                  [kernel]
     -> |g*h| ranking, exact top rows + a Bernoulli sample of the rest
     -> update_and_root_hist (select, the rest's gradients up-weighted,
                              root histogram)                     [kernel]
  -> grow_tree_partitioned  (level_stream / split_stream)        [kernels]
  -> the tree's score delta stays PENDING for the next update (the row
     layout does not change in between)
and at the end of the run score_add settles the last delta [kernel];

or K trees (multiclass, gbdt.cpp:445-480):

  canonical row order restored, the iteration's draws
  -> update_multi_and_hists (all K gradient planes, the bagging select
                             and K root histograms from one score
                             snapshot)                            [kernel]
  -> for each class k: grow_tree_partitioned on class k's g/h rows,
     then score_add of tree k's delta at once, while its partition
     layout is current (the precomputed gradient planes make that safe;
     there is no pending delta)                                  [kernels]

The scores are gathered back to original row order through ROWID.  The
last chunk's last delta (K = 1) is kept while the matrix holds that
tree's row order, so ``rollback_last`` can take it back off through
score_add; any other change to the scores made outside the band (a
rollback at K > 1, or after a chunk that stopped early) marks the band
dirty, and the next chunk first rewrites it from the original-order
scores (``sync_scores_from``).  With
EFB bundles the matrix packs the dataset's (N, G) bundle bins and the
grower expands bundle histograms through ``BundleMeta``.

The random draws are the JAX package's bits (utils/threefry.py): one
base key ``PRNGKey((bagging_seed << 1) ^ feature_fraction_seed)``
folded with a purpose tag (0 bagging, 1 feature_fraction, 2 GOSS) and
then with the global iteration number (for bagging, the iteration
divided by bagging_freq), so a sampled run grows the JAX package's trees.

A chunk of iterations runs as the JAX package's ``fori_loop`` does: no
host read between iterations (the draws are made on the card from keys
folded on the host, each tree is one CUDA graph replay, ``TreeGraphs``),
a tree with no split stops the chunk on the card (JAX's live-iteration
guard: the later iterations change no score and record no tree), and
every tree's records and the iteration count come back in one read at
the chunk's end.  ``iter_seconds`` holds, per iteration, the time between
CUDA events recorded on the stream at the iteration's boundaries (on the
CPU, the host clock), read at the chunk's end; ``chunk_seconds`` the
chunk's wall time and its iterations.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..ops.pgrow import (
    BundleMeta,
    PGrowParams,
    PTreeResult,
    TreeGraphs,
    levelgrow_env_params,
    segment_values,
)
from ..ops.pkernels import (
    MAX_CLASSES,
    PLayout,
    f32_row,
    pack_matrix,
    score_add,
    update_and_root_hist,
    update_channels,
    update_multi_and_hists,
)
from ..ops.split import FeatureMeta, SplitHyper, _f32
from ..utils import threefry


class PartitionedTrainer:
    """Owns the packed matrix and runs boosting iterations on it."""

    def __init__(self, train_set, config, objective, meta: FeatureMeta, hyper: SplitHyper,
                 device):
        binned = train_set.binned
        n, f = binned.shape
        self.device = torch.device(device)
        md = train_set.metadata
        max_bin = int(train_set.max_num_bin)
        # K score channels and K trees per iteration for multiclass
        self.K = int(objective.num_tree_per_iteration)
        # EFB: pack the (N, G) bundle bins instead of (N, F); split search
        # and the model stay in real-feature space through BundleMeta
        bundle = train_set.bundle
        self.bmeta = None
        num_cols, num_bins_hist = 0, 0
        if bundle is not None:
            matrix = train_set.bundled
            num_cols, num_bins_hist = bundle.num_cols, int(bundle.max_col_bin)
            self.bmeta = BundleMeta.build(bundle, train_set, max_bin, device=self.device)
            max_col_bin = num_bins_hist
        else:
            matrix = binned
            max_col_bin = max_bin
        bits = 4 if max_col_bin <= 16 else 8
        self.layout = PLayout(matrix.shape[1], num_score=self.K, with_weight=True, bits=bits)
        self.p = pack_matrix(matrix, self.layout, label=md.label, weight=md.weights,
                             device=self.device)
        self.num_rows = n
        self.meta = meta
        self.hyper = hyper
        self.objective = objective
        self.config = config
        self.params = PGrowParams(
            num_leaves=max(2, int(config.num_leaves)),
            num_bins=max_bin,
            num_features=f,
            num_rows=n,
            max_depth=int(config.max_depth),
            use_missing=bool(config.use_missing),
            has_categorical=bool(meta.is_categorical.any()),
            num_cols=num_cols,
            num_bins_hist=num_bins_hist,
            bits=bits,
            **levelgrow_env_params(),
        )
        self.feature_mask = torch.ones(f, dtype=torch.float32, device=self.device)
        self.trees = TreeGraphs(meta, self.bmeta, self.params, self.device)
        self.iter_seconds = []  # each iteration's seconds between its boundary events
        self.chunk_seconds = []  # (wall seconds, iterations) of each chunk
        self._base_key = threefry.PRNGKey(
            (int(config.bagging_seed) << 1) ^ int(config.feature_fraction_seed))
        self.score_dirty = False  # the band lags GBDT.scores until sync_scores_from
        self._last_delta = None  # the last tree's positional delta, for rollback_last

    def add_score(self, delta, k: int = 0) -> None:
        """score channel k += delta (a float32 scalar or (N,) array in
        original row order; boost-from-average, init scores), through
        score_add while the matrix is still in original row order."""
        d = torch.as_tensor(delta, dtype=torch.float32, device=self.device)
        d = d.expand(self.num_rows).contiguous()
        self.p = score_add(self.p, self.layout, d, k, num_rows=self.num_rows)

    def sync_scores_from(self, scores) -> None:
        """Bring the K score channels to the (K, N) original-order
        ``scores``: each channel gets target - current through score_add
        (ptrainer.py:216-226)."""
        lay, n = self.layout, self.num_rows
        rowid = self.p[lay.ROWID, :n].to(torch.int64)
        for k in range(self.K):
            target = torch.index_select(scores[k].to(self.device), 0, rowid)
            diff = (target - f32_row(self.p, lay.SCORE + k, n)).contiguous()
            self.p = score_add(self.p, lay, diff, k, num_rows=n)
        self.score_dirty = False
        self._last_delta = None

    def rollback_last(self) -> bool:
        """Take the last tree's delta back off the score band through
        score_add, which is exact in position while the matrix holds that
        tree's row order (until the next chunk's canonical gather).
        False when no such delta is held (K > 1, a chunk that stopped
        early, or a second rollback): the caller then marks the band dirty
        (ptrainer.py:238-246)."""
        if self._last_delta is None:
            return False
        self.p = score_add(self.p, self.layout, -self._last_delta, 0, num_rows=self.num_rows)
        self._last_delta = None
        return True

    def export_perm(self) -> np.ndarray:
        """The (N,) int32 ROWID channel: the row order the last tree left
        (ptrainer.py:250).  Checkpoints carry it for the JAX package's
        trainer, whose float sums follow the layout; this trainer gathers
        canonical row order before every tree, so its trees do not depend
        on it."""
        return self.p[self.layout.ROWID, :self.num_rows].cpu().numpy().astype(np.int32)

    def import_perm(self, rowid=None) -> None:
        """A checkpoint's restore into a freshly packed matrix
        (ptrainer.py:258): the columns permuted to ``rowid``'s row order
        when given (a JAX or port checkpoint; any order gives the same
        trees here), the K score channels zeroed, the band marked dirty
        so that the next chunk writes the restored scores into them
        exactly (``sync_scores_from``: 0 + target)."""
        lay, n = self.layout, self.num_rows
        if rowid is not None:
            rowid = np.asarray(rowid, np.int64)
            if rowid.shape != (n,):
                raise ValueError(f"checkpoint row permutation has shape {rowid.shape}, "
                                 f"expected ({n},)")
            idx = torch.from_numpy(rowid).to(self.device)
            self.p[:, :n] = torch.index_select(self.p[:, :n], 1, idx)
        self.p[lay.SCORE:lay.SCORE + self.K, :n] = 0  # int32 0 is +0.0f
        self._last_delta = None
        self.score_dirty = True

    def _canonical_order(self, delta=None):
        """Gather the matrix back to original row order (column j holds
        row j) and re-map the positional pending delta, if any, through
        the same ROWID."""
        n = self.num_rows
        rowid = self.p[self.layout.ROWID, :n].to(torch.int64)
        canon = None
        if delta is not None:
            canon = torch.empty_like(delta).index_copy_(0, rowid, delta)
        inv = torch.empty_like(rowid).index_copy_(0, rowid, torch.arange(n, device=self.device))
        self.p[:, :n] = torch.index_select(self.p[:, :n], 1, inv)
        return canon

    def _tree_delta(self, tree, lr, keep):
        """+lr * leaf value over each segment, clamped like Tree.shrinkage
        (tree.h:13 kMaxTreeOutput); zero where ``keep`` (a 0-d bool) is
        false.  ``lr`` is a float32 0-d tensor."""
        lval = torch.clamp(lr * tree.leaf_value, -100.0, 100.0)
        return segment_values(tree, self.num_rows, torch.where(keep, lval, 0.0))

    def _draws(self, it: int):
        """(bagging select (N,) float32 or None, feature mask (F,) float32)
        of global iteration ``it``."""
        cfg, F = self.config, self.params.num_features
        sel = None
        if cfg.bagging_fraction < 1.0 and cfg.bagging_freq > 0:
            sel = bagging_select(self._base_key, it, int(cfg.bagging_freq),
                                 cfg.bagging_fraction, self.num_rows, self.device)
        fmask = self.feature_mask
        if cfg.feature_fraction < 1.0:
            used = max(1, int(F * cfg.feature_fraction))
            fmask = feature_mask(self._base_key, it, F, used, self.device)
        return sel, fmask

    def goss_constants(self):
        """(top_cnt, rest probability, rest multiplier, warm-up iterations)
        of GOSS (ptrainer.py:296-301) from the current config, or None
        without GOSS.  Taken once per chunk, as the JAX package bakes them
        into each chunk program it builds."""
        cfg, n = self.config, self.num_rows
        if cfg.boosting_type.lower() != "goss":
            return None
        top = max(1, int(n * float(cfg.top_rate)))
        other = max(1, int(n * float(cfg.other_rate)))
        return (top, float(other / max(n - top, 1)), float((n - top) / other),
                int(1.0 / float(cfg.learning_rate)))

    def _update_single(self, it: int, delta, sel, goss):
        """The iteration's channel update and root histogram (K = 1).  A
        sampled GOSS iteration (goss.hpp:126-198, ptrainer.py:369-404)
        first settles the delta and refreshes the gradients, then keeps
        the top_cnt rows by |g*h| and a sample of the rest, whose
        gradients it up-weights."""
        lay, n, params = self.layout, self.num_rows, self.params
        kw = dict(num_rows=n, num_features=params.cols, num_bins=params.bins_hist,
                  bits=params.bits)
        if goss is not None and it >= goss[3]:
            self.p = update_channels(self.p, lay, self.objective, delta=delta, num_rows=n)
            gscore = (f32_row(self.p, lay.G, n) * f32_row(self.p, lay.H, n)).abs()
            selv, mulv = goss_select(gscore, *goss[:3],
                                     threefry.fold_in(threefry.fold_in(self._base_key, 2), it))
            return update_and_root_hist(self.p, lay, self.objective, sel=selv, mul=mulv, **kw)
        if goss is not None:
            # a GOSS warm-up iteration (GOSS forbids bagging, so sel is
            # None): every row with weight 1, the JAX package's two passes
            # with sel = mul = 1 in one.  The select is written, not
            # inherited: a learning-rate schedule can lead back into
            # warm-up after a sampled iteration left its selection in P.
            sel = torch.ones((n,), dtype=torch.float32, device=self.device)
        return update_and_root_hist(self.p, lay, self.objective, delta=delta, sel=sel, **kw)

    def train_chunk(self, T: int, lr: float, iter0: int = 0):
        """Run up to T boosting iterations, the first of which is global
        iteration ``iter0`` (the random draws fold it in).  Returns (one
        list of K host PTreeResults per iteration, original-order scores
        (K, N) f32 tensor, n_done); the first iteration in which no tree
        found a split stops the chunk (it and the later ones are not
        returned).  Nothing reads the device until the chunk's end."""
        self._last_delta = None
        if self.K > 1:
            return self._train_chunk_multi(T, lr, iter0)
        lay, n = self.layout, self.num_rows
        lr32 = _f32(lr, self.p)
        goss = self.goss_constants()
        run = _ChunkRun(self, T)
        delta = torch.zeros((n,), dtype=torch.float32, device=self.device)
        for t in range(run.T):
            run.mark(t)
            delta = self._canonical_order(delta)
            sel, fmask = self._draws(iter0 + t)
            self.p, root_hist = self._update_single(iter0 + t, delta, sel, goss)
            tree = self.trees.grow(self.p, fmask, self.hyper, root_hist)
            delta = self._tree_delta(tree, lr32, run.keep(tree))
            run.record(t, 0, tree)
            run.stop_unless(tree.num_splits > 0)
        run.mark(run.T)
        # settle the last tree's delta, then original-order scores
        self.p = score_add(self.p, lay, delta, 0, num_rows=n)
        trees, scores, n_done = run.finish()
        # a chunk that stopped early regathered the rows after its last tree
        if 0 < n_done == run.T:
            self._last_delta = delta
        return trees, scores, n_done

    def _train_chunk_multi(self, T: int, lr: float, iter0: int):
        lay, n, params = self.layout, self.num_rows, self.params
        G, BH = params.cols, params.bins_hist
        lr32 = _f32(lr, self.p)
        run = _ChunkRun(self, T)
        for t in range(run.T):
            run.mark(t)
            self._canonical_order()
            sel, fmask = self._draws(iter0 + t)
            self.p, hists = update_multi_and_hists(
                self.p, lay, self.objective, sel=sel, num_rows=n, num_features=G, num_bins=BH,
                bits=params.bits)
            any_split = torch.zeros((), dtype=torch.bool, device=self.device)
            for k in range(self.K):
                tree = self.trees.grow(self.p, fmask, self.hyper, hists[k], lay.class_rows(k))
                # tree k's delta at once, while its partition layout is
                # current (zero once the chunk has stopped)
                self.p = score_add(self.p, lay, self._tree_delta(tree, lr32, run.keep(tree)), k,
                                   num_rows=n)
                run.record(t, k, tree)
                any_split = any_split | (tree.num_splits > 0)
            run.stop_unless(any_split)
        run.mark(run.T)
        return run.finish()

    def _scores(self) -> torch.Tensor:
        """(K, N) scores in original row order."""
        lay, n = self.layout, self.num_rows
        rowid = self.p[lay.ROWID, :n].to(torch.int64)
        scores = torch.empty((self.K, n), dtype=torch.float32, device=self.device)
        for k in range(self.K):
            scores[k].index_copy_(0, rowid, f32_row(self.p, lay.SCORE + k, n))
        return scores


class _ChunkRun:
    """A chunk's bookkeeping on the device: the stop flag (JAX's
    live-iteration guard), every tree's split count and records, and the
    iteration boundaries' CUDA events; ``finish`` reads them back in one
    transfer."""

    def __init__(self, trainer, T: int):
        self.trainer, self.T = trainer, max(int(T), 0)
        dev, L, K = trainer.device, trainer.params.num_leaves, trainer.K
        self.stopped = torch.zeros((), dtype=torch.bool, device=dev)
        # [split count, (L-1) x 12 records] of each (iteration, class)
        self.out = torch.zeros((self.T, K, 1 + (L - 1) * 12), dtype=torch.float32, device=dev)
        self.cuda = dev.type == "cuda"
        self.marks = []
        self.t0 = time.perf_counter()

    def mark(self, t: int) -> None:
        """The boundary before iteration t (t = T: the chunk's end)."""
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def keep(self, tree):
        """Whether a tree's delta lands: it split and the chunk runs on."""
        return (tree.num_splits > 0) & ~self.stopped

    def record(self, t: int, k: int, tree) -> None:
        """Tree k of iteration t, as no split once the chunk has stopped."""
        self.out[t, k, 0] = torch.where(self.stopped, 0, tree.num_splits)
        self.out[t, k, 1:] = tree.recs_raw.reshape(-1)

    def stop_unless(self, grew) -> None:
        self.stopped = self.stopped | ~grew

    def finish(self):
        """(trees, scores, n_done) after the chunk's one read of the device."""
        tr = self.trainer
        scores = tr._scores()
        host = self.out.cpu().numpy()
        L = tr.params.num_leaves
        ns = host[:, :, 0].astype(np.int64)
        empty = np.flatnonzero((ns == 0).all(axis=1))
        n_done = int(empty[0]) if empty.size else self.T
        trees = [[PTreeResult.from_records(ns[t, k], host[t, k, 1:].reshape(L - 1, 12))
                  for k in range(tr.K)] for t in range(n_done)]
        if self.cuda:
            secs = [a.elapsed_time(b) / 1e3 for a, b in zip(self.marks, self.marks[1:])]
        else:
            secs = list(np.diff(self.marks))
        tr.iter_seconds.extend(secs[:n_done])
        tr.chunk_seconds.append((time.perf_counter() - self.t0, n_done))
        return trees, scores, n_done


def bagging_select(key, it: int, freq: int, fraction: float, n: int, device):
    """(N,) float32 bagging select of global iteration ``it``
    (ptrainer.py:351-357): Bernoulli(fraction) per row under the bagging
    stream's key for ``it // freq``, so the mask holds for ``freq``
    iterations."""
    bkey = threefry.fold_in(threefry.fold_in(key, 0), it // freq)
    return threefry.bernoulli(bkey, fraction, n, device).float()


def feature_mask(key, it: int, num_features: int, used: int, device="cpu") -> torch.Tensor:
    """(F,) float32 feature_fraction mask of global iteration ``it``, made
    on ``device`` (ptrainer.py:358-362): the ``used`` features with the
    largest uniforms, ties to the lower index as ``jax.lax.top_k`` breaks
    them."""
    u = threefry.uniform(threefry.fold_in(threefry.fold_in(key, 1), it), num_features, device)
    mask = torch.zeros(num_features, dtype=torch.float32, device=device)
    return mask.index_fill_(0, torch.sort(u, descending=True, stable=True).indices[:used], 1.0)


def goss_select(gscore: torch.Tensor, top_cnt: int, prob: float, mult: float, key):
    """GOSS's (select, multiplier) from the (N,) |g*h| scores: the first
    ``top_cnt`` rows of a stable descending sort (``jax.lax.top_k``'s
    selection, lower index first on ties), and each other row whose
    ``uniform(key)`` draw is below ``prob``, its gradients multiplied by
    ``mult`` (ptrainer.py:385-397)."""
    n = gscore.shape[0]
    top_idx = torch.sort(gscore, descending=True, stable=True).indices[:top_cnt]
    is_top = torch.zeros(n, dtype=torch.bool, device=gscore.device)
    is_top.index_fill_(0, top_idx, True)
    u = threefry.uniform(key, n, gscore.device)
    sampled = ~is_top & (u < _f32(prob, gscore))
    sel = (is_top | sampled).float()
    one = torch.ones((), dtype=torch.float32, device=gscore.device)
    mul = torch.where(sampled, _f32(mult, gscore), one)
    return sel, mul


def eligible(config, train_set, objective, num_tree_per_iteration: int):
    """Why the partitioned trainer cannot drive this configuration, or
    None when it can: the JAX package's decline rules
    (ptrainer.py:1513-1582).  GBDT sends what it declines to the mask
    grower (ops/grow.py), as the JAX package does.  A parallel
    ``tree_learner`` is taken as serial in one process: GBDT trains it so
    (boosting/gbdt.py ``_route_tree_learner``), where the JAX package
    sends feature and voting to its mask grower.  Over several processes
    it is declined: the host-driven learner runs on the mask grower's
    iteration (the JAX package's ``ShardedPartitionedTrainer``, the fused
    trainer over a device mesh, is not ported).
    ``LIGHTGBM_TPU_PGROW=0`` declines everything, so the mask grower can
    be held against the JAX package on data the fused path would take."""
    if os.environ.get("LIGHTGBM_TPU_PGROW", "") == "0":
        return "LIGHTGBM_TPU_PGROW=0"
    if config.tree_learner.lower() in ("data", "feature", "voting"):
        from ..parallel.distributed import process_count

        if process_count() > 1:
            return f"tree_learner={config.tree_learner} over {process_count()} processes"
    if objective is None:
        return "a custom objective (objective=none)"
    if getattr(config, "quantized_training", False):
        return "quantized training"
    if getattr(config, "linear_tree", False):
        return "linear trees"
    if hasattr(config, "_monotone_active") and config._monotone_active():
        return "monotone constraints"
    if num_tree_per_iteration == 1:
        if not getattr(objective, "rowwise", False):
            return f"objective {objective.name} (not row-local)"
    else:
        # multiclass: the all-classes row-local gradient planes
        # (gradients_rowwise_all), at most 16 score channels, no GOSS
        if not getattr(objective, "rowwise_multi", False):
            return f"objective {objective.name} (not row-local)"
        if num_tree_per_iteration > MAX_CLASSES:
            return f"more than {MAX_CLASSES} classes"
        if config.boosting_type.lower() == "goss":
            return "GOSS with more than one tree per iteration"
    if np.asarray(train_set.binned).dtype != np.uint8 or train_set.max_num_bin > 256:
        return "more than 256 bins per feature"
    # the JAX kernels' VMEM budget caps the fused path at 512 columns
    # (ptrainer.py:1566-1581); kept as the same routing rule here
    train_set.ensure_bundles(config)
    bundle = train_set.bundle
    cols = bundle.num_cols if bundle is not None else train_set.num_features
    if cols > 512:
        return "more than 512 feature columns"
    return None
