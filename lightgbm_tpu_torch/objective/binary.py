"""Binary logloss objective — parity with lightgbm_tpu/objective/binary.py
(src/objective/binary_objective.hpp:13-154)."""

from __future__ import annotations

import numpy as np
import torch

from ..utils.log import Log
from .base import ObjectiveFunction

KIND_BINARY = 0  # csrc/update_hist.cu ObjKind


class BinaryLogloss(ObjectiveFunction):
    name = "binary"
    rowwise = True

    def __init__(self, config):
        self.is_unbalance = bool(config.is_unbalance)
        self.sigmoid = float(config.sigmoid)
        if self.sigmoid <= 0.0:
            Log.fatal("Sigmoid parameter %f should be greater than zero", self.sigmoid)
        self.scale_pos_weight = float(config.scale_pos_weight)

    def init(self, metadata, num_data: int) -> None:
        super().init(metadata, num_data)
        pos_mask = self.label > 0
        cnt_positive = int(np.sum(pos_mask))
        cnt_negative = num_data - cnt_positive
        if cnt_positive == 0 or cnt_negative == 0:
            Log.warning("Only contain one class.")
            self.num_data = 0  # "not need to boost" (hpp:61-64)
        Log.info("Number of positive: %d, number of negative: %d", cnt_positive, cnt_negative)
        # per-class weights (hpp:67-84)
        weight_pos, weight_neg = 1.0, 1.0
        if self.is_unbalance and cnt_positive > 0 and cnt_negative > 0:
            if cnt_positive > cnt_negative:
                weight_neg = cnt_positive / cnt_negative
            else:
                weight_pos = cnt_negative / cnt_positive
        weight_pos *= self.scale_pos_weight
        self._weight_pos = float(weight_pos)
        self._weight_neg = float(weight_neg)

    def gradients_rowwise(self, score, label, weight):
        """response = -y*sig / (1 + exp(y*sig*score)) (hpp:95-99), with the
        sign and class weight recomputed from the label channel."""
        pos = label > 0
        sign = torch.where(pos, 1.0, -1.0).to(torch.float32)
        lw = torch.where(pos, self._weight_pos, self._weight_neg).to(torch.float32)
        sig = self.sigmoid
        response = -sign * sig / (1.0 + torch.exp(sign * sig * score))
        abs_response = torch.abs(response)
        grad = response * lw
        hess = abs_response * (sig - abs_response) * lw
        if weight is not None:
            grad = grad * weight
            hess = hess * weight
        return grad, hess

    def kernel_params(self):
        return (KIND_BINARY, float(np.float32(self.sigmoid)),
                float(np.float32(self._weight_pos)), float(np.float32(self._weight_neg)))

    def convert_output(self, score):
        return 1.0 / (1.0 + torch.exp(-self.sigmoid * score))

    def to_string(self) -> str:
        return f"{self.name} sigmoid:{self.sigmoid:g}"
