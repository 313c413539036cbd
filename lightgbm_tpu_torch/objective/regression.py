"""L2 regression objective — parity with lightgbm_tpu/objective/regression.py
RegressionL2Loss (src/objective/regression_objective.hpp:29-44)."""

from __future__ import annotations

import torch

from .base import ObjectiveFunction

KIND_L2 = 1  # csrc/common.cuh ObjKind


class RegressionL2Loss(ObjectiveFunction):
    """grad = score - label, hess = 1, both times the row weight."""

    name = "regression"
    rowwise = True

    def __init__(self, config):
        pass

    def gradients_rowwise(self, score, label, weight):
        grad = score - label
        hess = torch.ones_like(score)
        if weight is not None:
            return grad * weight, hess * weight
        return grad, hess

    def kernel_params(self):
        return (KIND_L2, 1.0, 1.0, 1.0)

    @property
    def boost_from_average(self) -> bool:
        return True
