"""GOSS (Gradient-based One-Side Sampling) — PyTorch counterpart of
lightgbm_tpu/boosting/goss.py (src/boosting/goss.hpp).

On the partitioned trainer the sampling runs inside
``PartitionedTrainer`` (K = 1, keys folded with the iteration).  On the
mask grower (multiclass GOSS, and every GOSS configuration the
partitioned trainer declines) it runs through the hooks below, as in the
JAX package (goss.py:43-70): no sampling for the first 1/learning_rate
iterations, then the top_rate rows by sum over classes of |g*h| and an
other_rate sample of the rest, up-weighted, drawn from one key that is
split each sampled iteration.  The model is named "tree", as GBDT's is.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import threefry
from ..utils.log import Log
from .gbdt import GBDT
from .ptrainer import goss_select


class GOSS(GBDT):
    def init(self, config, train_set, objective, training_metrics=()):
        if config.bagging_freq > 0 and config.bagging_fraction != 1.0:
            Log.fatal("Cannot use bagging in GOSS")
        super().init(config, train_set, objective, training_metrics)
        Log.info("Using GOSS")
        if config.top_rate + config.other_rate >= 1.0:
            Log.warning("top_rate + other_rate >= 1.0; GOSS degenerates to GBDT")
        self._goss_key = threefry.PRNGKey(config.bagging_seed)

    def _adjust_gradients(self, grad, hess):
        """The mask grower's GOSS sampling (goss.hpp:126-198): sets the
        row select and returns the rest's up-weighted (K, N) gradients."""
        cfg, n = self.config, self.num_data
        if self.iter < int(1.0 / cfg.learning_rate):
            self.select = torch.ones(n, dtype=torch.float32, device=self.device)
            return grad, hess
        top_k = max(1, int(n * cfg.top_rate))
        other_k = max(1, int(n * cfg.other_rate))
        # sum over classes in class order, as XLA reduces the (K, N) axis
        prod = torch.abs(grad * hess)
        score = prod[0]
        for k in range(1, prod.shape[0]):
            score = score + prod[k]
        self._goss_key, sub = threefry.split(self._goss_key)
        self.select, mul = goss_select(score, top_k, other_k / max(n - top_k, 1),
                                       (n - top_k) / other_k, sub)
        return grad * mul[None, :], hess * mul[None, :]

    def _bagging(self, iter_: int) -> None:
        """GOSS replaces bagging (its select comes from _adjust_gradients)."""

    def export_train_state(self):
        """The mask grower's GOSS key is chained (split each sampled
        iteration), so a checkpoint carries it (goss.py:74-86), as the
        uint32 pair a JAX key is; the partitioned trainer's GOSS keeps no
        state (its key folds the iteration)."""
        arrays, py = super().export_train_state()
        arrays["goss_key"] = np.asarray(self._goss_key, np.uint32)
        return arrays, py

    def import_train_state(self, arrays, py) -> None:
        super().import_train_state(arrays, py)
        self._goss_key = tuple(int(v) for v in np.asarray(arrays["goss_key"], np.uint32))
