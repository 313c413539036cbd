"""Abstract metric interface (include/LightGBM/metric.h) — PyTorch
counterpart of lightgbm_tpu/metric/base.py."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch


class Metric:
    """``eval(score, objective)`` returns [(name, value), ...]; ``score``
    is an (N,) or, for multiclass, (K, N) tensor on any device.  The label
    and weights move to the scores' device at the first evaluation there;
    every sum is taken in float64."""

    name = "none"
    bigger_is_better = False  # factor_to_bigger_better sign

    def init(self, metadata, num_data: int) -> None:
        self.num_data = num_data
        self._label = np.asarray(metadata.label, np.float64)
        self._weights = (np.asarray(metadata.weights, np.float64)
                         if metadata.weights is not None else None)
        self.sum_weights = (float(np.sum(self._weights)) if self._weights is not None
                            else float(num_data))
        self._on = {}

    def _data(self, device):
        """(label, weights or None) float64 tensors on ``device``."""
        key = str(device)
        if key not in self._on:
            w = self._weights
            self._on[key] = (torch.from_numpy(self._label).to(device),
                             None if w is None else torch.from_numpy(w).to(device))
        return self._on[key]

    def _mean(self, pt: torch.Tensor, weights) -> float:
        """sum(pt * weights) / sum_weights, in float64."""
        if weights is not None:
            pt = pt * weights
        return float(pt.sum()) / self.sum_weights

    def eval(self, score: torch.Tensor, objective=None) -> List[Tuple[str, float]]:
        raise NotImplementedError


def convert_scores(score: torch.Tensor, objective) -> torch.Tensor:
    """The objective's ConvertOutput (sigmoid, softmax) on float64 scores."""
    score = score.double()
    return score if objective is None else objective.convert_output(score)
