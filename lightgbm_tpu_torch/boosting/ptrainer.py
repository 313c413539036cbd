"""Partitioned trainer — PyTorch counterpart of
lightgbm_tpu/boosting/ptrainer.py (PartitionedTrainer, single score
channel).

Per iteration, exactly as the JAX package's fused chunk program:

  canonical row order restored (one gather through the ROWID channel, so
    every tree's float sums are independent of the previous tree's
    partition history)
  -> update_and_root_hist   (score += the previous tree's pending delta,
                             fresh gradients, root histogram)   [kernel]
  -> grow_tree_partitioned  (level_stream / split_stream)        [kernels]
  -> the tree's score delta stays PENDING for the next update (the row
     layout does not change in between)
and at the end of the run score_add settles the last delta [kernel] and
the scores are gathered back to original row order through ROWID.

The JAX package runs a chunk of iterations as one device program; here
the iteration loop is Python and the grower reads each level's results
back to the host.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..ops.pgrow import PGrowParams, grow_tree_partitioned, levelgrow_env_params, segment_values
from ..ops.pkernels import PLayout, f32_row, pack_matrix, score_add, update_and_root_hist
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
        bits = 4 if max_bin <= 16 else 8
        self.layout = PLayout(f, num_score=1, with_weight=True, bits=bits)
        self.p = pack_matrix(binned, self.layout, label=md.label, weight=md.weights,
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
            bits=bits,
            **levelgrow_env_params(),
        )
        self.feature_mask = torch.ones(f, dtype=torch.float32, device=self.device)
        self.iter_seconds = []  # wall time of each iteration (device-synced)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def add_score(self, delta) -> None:
        """score channel += delta (a float32 scalar or (N,) array in
        original row order; boost-from-average, init scores), through
        score_add while the matrix is still in original row order."""
        d = torch.as_tensor(delta, dtype=torch.float32, device=self.device)
        d = d.expand(self.num_rows).contiguous()
        self.p = score_add(self.p, self.layout, d, num_rows=self.num_rows)

    def _canonical_order(self, delta):
        """Gather the matrix back to original row order (column j holds
        row j) and re-map the positional pending delta through the same
        ROWID."""
        n = self.num_rows
        rowid = self.p[self.layout.ROWID, :n].to(torch.int64)
        canon = torch.empty_like(delta)
        canon[rowid] = delta
        inv = torch.empty_like(rowid)
        inv[rowid] = torch.arange(n, device=self.device)
        self.p[:, :n] = torch.index_select(self.p[:, :n], 1, inv)
        return canon

    def train_chunk(self, T: int, lr: float):
        """Run up to T boosting iterations.  Returns (list of PTreeResult,
        original-order scores (N,) f32 tensor, n_done); stops early at the
        first tree with no split."""
        lay, n, params = self.layout, self.num_rows, self.params
        lr32 = np.float32(lr)
        delta = torch.zeros((n,), dtype=torch.float32, device=self.device)
        trees = []
        for _ in range(int(T)):
            t0 = time.perf_counter()
            delta = self._canonical_order(delta)
            self.p, root_hist = update_and_root_hist(
                self.p, lay, self.objective, delta=delta, num_rows=n,
                num_features=params.num_features, num_bins=params.num_bins, bits=params.bits)
            tree, self.p = grow_tree_partitioned(self.p, self.feature_mask, self.meta,
                                                 self.hyper, params, root_hist)
            if tree.num_splits == 0:
                delta = torch.zeros_like(delta)
                break
            # +lr * leaf value over each segment, clamped like
            # Tree.shrinkage (tree.h:13 kMaxTreeOutput)
            lval = np.clip(lr32 * tree.leaf_value, np.float32(-100.0), np.float32(100.0))
            delta = segment_values(tree, n, lval, device=self.device)
            trees.append(tree)
            self._sync()
            self.iter_seconds.append(time.perf_counter() - t0)
        # settle the last tree's delta, then original-order scores
        self.p = score_add(self.p, lay, delta, 0, num_rows=n)
        rowid = self.p[lay.ROWID, :n].to(torch.int64)
        scores = torch.empty((n,), dtype=torch.float32, device=self.device)
        scores[rowid] = f32_row(self.p, lay.SCORE, n)
        return trees, scores, len(trees)


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
    if num_tree_per_iteration != 1:
        return "multiclass"
    if not getattr(objective, "rowwise", False):
        return f"objective {objective.name} (not row-local)"
    if config.tree_learner != "serial":
        return f"tree_learner={config.tree_learner}"
    if np.asarray(train_set.binned).dtype != np.uint8 or train_set.max_num_bin > 256:
        return "more than 256 bins per feature"
    # the JAX kernels' VMEM budget caps the fused path at 512 columns
    # (ptrainer.py:1566-1581); kept as the same decline rule here
    if train_set.num_features > 512:
        return "more than 512 feature columns"
    return None
