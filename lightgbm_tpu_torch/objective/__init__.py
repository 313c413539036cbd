"""Objective functions — counterpart of lightgbm_tpu/objective (factory
at objective_function.cpp:9-56): every objective the JAX package trains
with.  The row-local ones (binary, the regression family, multiclass)
run inside the CUDA update kernels on the fused path; lambdarank's
query-grouped gradients are PyTorch tensor code on the mask grower."""

from .base import ObjectiveFunction
from .binary import BinaryLogloss
from .multiclass import MulticlassOVA, MulticlassSoftmax
from .rank import LambdarankNDCG
from .regression import (
    RegressionFairLoss,
    RegressionHuberLoss,
    RegressionL1Loss,
    RegressionL2Loss,
    RegressionPoissonLoss,
)

_FACTORY = {
    "regression": RegressionL2Loss,
    "regression_l2": RegressionL2Loss,
    "mean_squared_error": RegressionL2Loss,
    "mse": RegressionL2Loss,
    "l2": RegressionL2Loss,
    "regression_l1": RegressionL1Loss,
    "mean_absolute_error": RegressionL1Loss,
    "mae": RegressionL1Loss,
    "l1": RegressionL1Loss,
    "huber": RegressionHuberLoss,
    "fair": RegressionFairLoss,
    "poisson": RegressionPoissonLoss,
    "binary": BinaryLogloss,
    "lambdarank": LambdarankNDCG,
    "multiclass": MulticlassSoftmax,
    "softmax": MulticlassSoftmax,
    "multiclassova": MulticlassOVA,
    "multiclass_ova": MulticlassOVA,
    "ova": MulticlassOVA,
    "ovr": MulticlassOVA,
}


def create_objective(config) -> ObjectiveFunction:
    """ObjectiveFunction::CreateObjectiveFunction; None for a custom
    objective (``none``)."""
    from ..utils.log import Log

    name = config.objective.lower()
    if name in ("none", "null", "custom", ""):
        return None
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


__all__ = ["ObjectiveFunction", "BinaryLogloss", "LambdarankNDCG", "MulticlassSoftmax",
           "MulticlassOVA", "RegressionFairLoss", "RegressionHuberLoss", "RegressionL1Loss",
           "RegressionL2Loss", "RegressionPoissonLoss", "create_objective",
           "objective_from_string"]
