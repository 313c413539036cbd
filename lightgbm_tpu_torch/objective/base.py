"""Abstract objective interface (include/LightGBM/objective_function.h) —
PyTorch counterpart of lightgbm_tpu/objective/base.py."""

from __future__ import annotations

import numpy as np
import torch


def exp_f32(x: torch.Tensor) -> torch.Tensor:
    """exp of a float32 tensor, taken in float64 and rounded once — the
    correctly rounded value, as the CUDA kernels take it (csrc/common.cuh
    exp_f32), so gradients agree bit for bit between the card and the CPU."""
    return torch.exp(x.double()).float()


class ObjectiveFunction:
    """``gradients_rowwise(score, label, weight) -> (grad, hess)`` is
    float32 elementwise torch math on the row's own values, in any row
    order (the partitioned trainer's channels).  ``kernel_params()`` hands
    the same math to the CUDA update kernels as (kind, p0, p1, p2): the
    kind of csrc/common.cuh ``ObjKind`` and three float32 constants
    (binary: sigmoid, w_pos, w_neg; the regression objectives:
    objective/regression.py).  An objective that is not row-local
    (lambdarank) has ``get_gradients(score)`` over all rows instead."""

    name = "none"
    # gradients depend only on the row's own (score, label, weight)
    rowwise = False

    def init(self, metadata, num_data: int) -> None:
        """Bind label/weight (ObjectiveFunction::Init)."""
        self.num_data = num_data
        self.label = np.asarray(metadata.label, np.float32)
        self.weights = (np.asarray(metadata.weights, np.float32)
                        if metadata.weights is not None else None)

    def gradients_rowwise(self, score, label, weight):
        raise NotImplementedError

    def kernel_params(self):
        raise NotImplementedError

    def convert_output(self, score):
        """Raw score -> prediction space (ConvertOutput); identity default."""
        return score

    @property
    def num_tree_per_iteration(self) -> int:
        return 1

    @property
    def boost_from_average(self) -> bool:
        return False

    def to_string(self) -> str:
        """Objective line of the model file (ToString)."""
        return self.name
