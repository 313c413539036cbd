"""Objective functions — counterpart of lightgbm_tpu/objective (factory
at objective_function.cpp:9-56), binary logloss and L2 regression."""

from .base import ObjectiveFunction
from .binary import BinaryLogloss
from .regression import RegressionL2Loss

_FACTORY = {
    "regression": RegressionL2Loss,
    "regression_l2": RegressionL2Loss,
    "mean_squared_error": RegressionL2Loss,
    "mse": RegressionL2Loss,
    "l2": RegressionL2Loss,
    "binary": BinaryLogloss,
}

# objectives the JAX package has and this port does not run yet
_NOT_YET = ("regression_l1", "mean_absolute_error", "mae", "l1", "huber", "fair", "poisson",
            "lambdarank", "multiclass", "softmax", "multiclassova", "multiclass_ova", "ova",
            "ovr")


def create_objective(config) -> ObjectiveFunction:
    """ObjectiveFunction::CreateObjectiveFunction."""
    from ..utils.log import Log

    name = config.objective.lower()
    if name in ("none", "null", "custom", ""):
        return None
    if name in _NOT_YET:
        raise NotImplementedError(f"lightgbm_tpu_torch does not support objective={name} yet")
    if name not in _FACTORY:
        Log.fatal("Unknown objective type name: %s", name)
    return _FACTORY[name](config)


def objective_from_string(obj_str: str):
    """Rebuild an objective from its model-file line (``name key:value``)."""
    if not obj_str:
        return None
    from ..config import Config

    toks = obj_str.split()
    params = {"objective": toks[0]}
    for t in toks[1:]:
        if ":" in t:
            k, _, v = t.partition(":")
            params[k] = v
    return create_objective(Config.from_params(params))


__all__ = ["ObjectiveFunction", "BinaryLogloss", "RegressionL2Loss", "create_objective",
           "objective_from_string"]
