"""GOSS (Gradient-based One-Side Sampling) — PyTorch counterpart of
lightgbm_tpu/boosting/goss.py (src/boosting/goss.hpp) for the fused
trainer.

The sampling itself runs inside ``PartitionedTrainer`` (|g*h| ranking,
exact top rows, a Bernoulli sample of the rest, up-weighted): this class
checks the configuration; the model is named "tree", as GBDT's is.  The mask grower's
``_adjust_gradients`` hook waits for the mask grower.
"""

from __future__ import annotations

from ..utils.log import Log
from .gbdt import GBDT


class GOSS(GBDT):
    def init(self, config, train_set, objective, training_metrics=()):
        if config.bagging_freq > 0 and config.bagging_fraction != 1.0:
            Log.fatal("Cannot use bagging in GOSS")
        super().init(config, train_set, objective, training_metrics)
        Log.info("Using GOSS")
        if config.top_rate + config.other_rate >= 1.0:
            Log.warning("top_rate + other_rate >= 1.0; GOSS degenerates to GBDT")
