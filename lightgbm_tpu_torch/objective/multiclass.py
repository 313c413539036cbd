"""Multiclass objectives — parity with lightgbm_tpu/objective/multiclass.py
(src/objective/multiclass_objective.hpp: softmax :16-136, OVA :139-225).

Scores are ``(K, N)``: the reference's flat ``num_data*k + i`` indexing
reshaped.  ``gradients_rowwise_all`` is the partitioned trainer's entry:
all K (g, h) planes from the K score channels of each row, in any row
order.  ``kernel_params()`` hands the same math to the CUDA kernel
``update_multi_and_hists`` (csrc/update_multi_hist.cu).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.log import Log
from .base import ObjectiveFunction, exp_f32
from .binary import BinaryLogloss

KIND_SOFTMAX = 0  # csrc/update_multi_hist.cu MultiKind
KIND_OVA = 1


def _onehot(label, num_class: int) -> torch.Tensor:
    """(K, n) float32 indicator of label == k; the label is the float class
    index, compared as float like the JAX package."""
    classes = torch.arange(num_class, dtype=torch.float32, device=label.device)
    return (label.reshape(1, -1) == classes[:, None]).to(torch.float32)


class MulticlassSoftmax(ObjectiveFunction):
    name = "multiclass"
    rowwise_multi = True

    def __init__(self, config):
        self.num_class = int(config.num_class)

    def init(self, metadata, num_data: int) -> None:
        super().init(metadata, num_data)
        lab = np.asarray(metadata.label, np.int32)
        if lab.size and (lab.min() < 0 or lab.max() >= self.num_class):
            Log.fatal("Label must be in [0, %d), but found %d in label", self.num_class,
                      int(lab.min() if lab.min() < 0 else lab.max()))

    def gradients_rowwise_all(self, scores, label, weight):
        """scores (K, n), label the class index: softmax across the K
        scores of each row (subtract the max, exp, sum in class order,
        divide), then grad = p - 1[y=k], hess = 2p(1-p)."""
        e = exp_f32(scores - torch.max(scores, dim=0, keepdim=True).values)
        total = e[0]
        for k in range(1, e.shape[0]):
            total = total + e[k]
        p = e / total
        grad = p - _onehot(label, self.num_class)
        hess = 2.0 * p * (1.0 - p)
        if weight is not None:
            grad = grad * weight
            hess = hess * weight
        return grad, hess

    def kernel_params(self):
        """(kind, K, sigmoid, w_pos (K,), w_neg (K,))."""
        ones = np.ones(self.num_class, np.float32)
        return KIND_SOFTMAX, self.num_class, 1.0, ones, ones

    def convert_output(self, score):
        p = torch.exp(score - torch.max(score, dim=0, keepdim=True).values)
        return p / torch.sum(p, dim=0, keepdim=True)

    @property
    def num_tree_per_iteration(self) -> int:
        return self.num_class

    def to_string(self) -> str:
        return f"{self.name} num_class:{self.num_class}"


class MulticlassOVA(ObjectiveFunction):
    """K independent BinaryLogloss objectives, class k's positives being
    ``label == k`` (multiclass_objective.hpp:139-225)."""

    name = "multiclassova"
    rowwise_multi = True

    def __init__(self, config):
        self.num_class = int(config.num_class)
        self.sigmoid = float(config.sigmoid)
        self._config = config

    def init(self, metadata, num_data: int) -> None:
        super().init(metadata, num_data)
        self.binary = []
        for k in range(self.num_class):
            b = BinaryLogloss(self._config, is_pos=lambda lab, kk=k: lab == kk)
            b.init(metadata, num_data)
            self.binary.append(b)

    def gradients_rowwise_all(self, scores, label, weight):
        outs = [self.binary[k].gradients_rowwise(scores[k], label, weight)
                for k in range(self.num_class)]
        return torch.stack([g for g, _ in outs]), torch.stack([h for _, h in outs])

    def kernel_params(self):
        """(kind, K, sigmoid, w_pos (K,), w_neg (K,)): class k's own
        is_unbalance / scale_pos_weight label weights."""
        w_pos = np.asarray([b._weight_pos for b in self.binary], np.float32)
        w_neg = np.asarray([b._weight_neg for b in self.binary], np.float32)
        return KIND_OVA, self.num_class, float(np.float32(self.sigmoid)), w_pos, w_neg

    def convert_output(self, score):
        return 1.0 / (1.0 + torch.exp(-self.sigmoid * score))

    @property
    def num_tree_per_iteration(self) -> int:
        return self.num_class

    def to_string(self) -> str:
        return f"{self.name} num_class:{self.num_class} sigmoid:{self.sigmoid:g}"
