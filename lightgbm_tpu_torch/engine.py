"""``train`` — PyTorch counterpart of lightgbm_tpu/engine.py (engine.py:17-199)
for the fused path: no validation sets, callbacks or early stopping."""

from __future__ import annotations

from typing import Any, Dict

from .basic import Booster, Dataset
from .config import canonicalize_params

_NOT_YET = ("valid_sets", "valid_names", "fobj", "feval", "init_model", "callbacks",
            "early_stopping_rounds", "evals_result", "learning_rates", "checkpoint_dir",
            "checkpoint_manager")


def train(params: Dict[str, Any], train_set: Dataset, num_boost_round: int = 100,
          device=None, **kwargs) -> Booster:
    """Train a booster on ``device`` (``None``: the CUDA card; raises when
    none is present; ``"cpu"`` runs the kernels' plain PyTorch versions).

    Validation sets, custom objectives/metrics, callbacks, early stopping,
    init models and checkpoints are not ported yet and raise
    NotImplementedError; ``verbose_eval`` is accepted and ignored."""
    kwargs.pop("verbose_eval", None)
    for name in _NOT_YET:
        if kwargs.pop(name, None) is not None:
            raise NotImplementedError(f"lightgbm_tpu_torch does not support {name} yet")
    if kwargs:
        raise TypeError(f"train() got unexpected arguments {sorted(kwargs)}")
    params = dict(params or {})
    canon = canonicalize_params(params)
    num_boost_round = int(canon.pop("num_iterations", num_boost_round))
    if "early_stopping_round" in canon:
        raise NotImplementedError("lightgbm_tpu_torch does not support early stopping yet")
    for alias in ("num_iterations", "num_iteration", "num_tree", "num_trees", "num_round",
                  "num_rounds", "num_boost_round"):
        params.pop(alias, None)
    booster = Booster(params=params, train_set=train_set, device=device)
    booster.boosting.train_iters_partitioned(num_boost_round)
    booster.best_iteration = booster.current_iteration()
    return booster
