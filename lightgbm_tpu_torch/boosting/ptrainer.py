"""Partitioned trainer — PyTorch counterpart of
lightgbm_tpu/boosting/ptrainer.py (PartitionedTrainer).

Per iteration, exactly as the JAX package's fused chunk program, one tree
(K = 1):

  canonical row order restored (one gather through the ROWID channel, so
    every tree's float sums are independent of the previous tree's
    partition history)
  -> update_and_root_hist   (score += the previous tree's pending delta,
                             fresh gradients, root histogram)   [kernel]
  -> grow_tree_partitioned  (level_stream / split_stream)        [kernels]
  -> the tree's score delta stays PENDING for the next update (the row
     layout does not change in between)
and at the end of the run score_add settles the last delta [kernel];

or K trees (multiclass, gbdt.cpp:445-480):

  canonical row order restored
  -> update_multi_and_hists (all K gradient planes and K root histograms
                             from one score snapshot)            [kernel]
  -> for each class k: grow_tree_partitioned on class k's g/h rows,
     then score_add of tree k's delta at once, while its partition
     layout is current (the precomputed gradient planes make that safe;
     there is no pending delta)                                  [kernels]

The scores are gathered back to original row order through ROWID.  With
EFB bundles the matrix packs the dataset's (N, G) bundle bins and the
grower expands bundle histograms through ``BundleMeta``.

The JAX package runs a chunk of iterations as one device program; here
the iteration loop is Python and the grower reads each level's results
back to the host.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..ops.pgrow import (
    BundleMeta,
    PGrowParams,
    grow_tree_partitioned,
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
    update_multi_and_hists,
)
from ..ops.split import FeatureMeta, SplitHyper


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
        self.iter_seconds = []  # wall time of each iteration (device-synced)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def add_score(self, delta, k: int = 0) -> None:
        """score channel k += delta (a float32 scalar or (N,) array in
        original row order; boost-from-average, init scores), through
        score_add while the matrix is still in original row order."""
        d = torch.as_tensor(delta, dtype=torch.float32, device=self.device)
        d = d.expand(self.num_rows).contiguous()
        self.p = score_add(self.p, self.layout, d, k, num_rows=self.num_rows)

    def _canonical_order(self, delta=None):
        """Gather the matrix back to original row order (column j holds
        row j) and re-map the positional pending delta, if any, through
        the same ROWID."""
        n = self.num_rows
        rowid = self.p[self.layout.ROWID, :n].to(torch.int64)
        canon = None
        if delta is not None:
            canon = torch.empty_like(delta)
            canon[rowid] = delta
        inv = torch.empty_like(rowid)
        inv[rowid] = torch.arange(n, device=self.device)
        self.p[:, :n] = torch.index_select(self.p[:, :n], 1, inv)
        return canon

    def _tree_delta(self, tree, lr32):
        """+lr * leaf value over each segment, clamped like Tree.shrinkage
        (tree.h:13 kMaxTreeOutput)."""
        lval = np.clip(lr32 * tree.leaf_value, np.float32(-100.0), np.float32(100.0))
        return segment_values(tree, self.num_rows, lval, device=self.device)

    def train_chunk(self, T: int, lr: float):
        """Run up to T boosting iterations.  Returns (one list of K
        PTreeResults per iteration, original-order scores (K, N) f32
        tensor, n_done); stops early at the first iteration in which no
        tree found a split."""
        if self.K > 1:
            return self._train_chunk_multi(T, lr)
        lay, n, params = self.layout, self.num_rows, self.params
        G, BH = params.cols, params.bins_hist
        lr32 = np.float32(lr)
        delta = torch.zeros((n,), dtype=torch.float32, device=self.device)
        trees = []
        for _ in range(int(T)):
            t0 = time.perf_counter()
            delta = self._canonical_order(delta)
            self.p, root_hist = update_and_root_hist(
                self.p, lay, self.objective, delta=delta, num_rows=n, num_features=G,
                num_bins=BH, bits=params.bits)
            tree, self.p = grow_tree_partitioned(self.p, self.feature_mask, self.meta,
                                                 self.hyper, params, root_hist, bmeta=self.bmeta)
            if tree.num_splits == 0:
                delta = torch.zeros_like(delta)
                break
            delta = self._tree_delta(tree, lr32)
            trees.append([tree])
            self._sync()
            self.iter_seconds.append(time.perf_counter() - t0)
        # settle the last tree's delta, then original-order scores
        self.p = score_add(self.p, lay, delta, 0, num_rows=n)
        return trees, self._scores(), len(trees)

    def _train_chunk_multi(self, T: int, lr: float):
        lay, n, params = self.layout, self.num_rows, self.params
        G, BH = params.cols, params.bins_hist
        lr32 = np.float32(lr)
        trees = []
        for _ in range(int(T)):
            t0 = time.perf_counter()
            self._canonical_order()
            self.p, hists = update_multi_and_hists(
                self.p, lay, self.objective, num_rows=n, num_features=G, num_bins=BH,
                bits=params.bits)
            iter_trees = []
            for k in range(self.K):
                tree, self.p = grow_tree_partitioned(
                    self.p, self.feature_mask, self.meta, self.hyper, params, hists[k],
                    rows=lay.class_rows(k), bmeta=self.bmeta)
                if tree.num_splits > 0:
                    self.p = score_add(self.p, lay, self._tree_delta(tree, lr32), k,
                                       num_rows=n)
                iter_trees.append(tree)
            if all(t.num_splits == 0 for t in iter_trees):
                break
            trees.append(iter_trees)
            self._sync()
            self.iter_seconds.append(time.perf_counter() - t0)
        return trees, self._scores(), len(trees)

    def _scores(self) -> torch.Tensor:
        """(K, N) scores in original row order."""
        lay, n = self.layout, self.num_rows
        rowid = self.p[lay.ROWID, :n].to(torch.int64)
        scores = torch.empty((self.K, n), dtype=torch.float32, device=self.device)
        for k in range(self.K):
            scores[k, rowid] = f32_row(self.p, lay.SCORE + k, n)
        return scores


def eligible(config, train_set, objective, num_tree_per_iteration: int):
    """Why the partitioned trainer cannot drive this configuration, or
    None when it can (the JAX package's decline rules; there the rest
    falls back to the mask-based grower, which the port does not have)."""
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
        if getattr(config, "boosting", "gbdt") == "goss":
            return "GOSS with more than one tree per iteration"
    if config.tree_learner != "serial":
        return f"tree_learner={config.tree_learner}"
    if np.asarray(train_set.binned).dtype != np.uint8 or train_set.max_num_bin > 256:
        return "more than 256 bins per feature"
    # the JAX kernels' VMEM budget caps the fused path at 512 columns
    # (ptrainer.py:1566-1581); kept as the same decline rule here
    train_set.ensure_bundles(config)
    bundle = train_set.bundle
    cols = bundle.num_cols if bundle is not None else train_set.num_features
    if cols > 512:
        return "more than 512 feature columns"
    return None
