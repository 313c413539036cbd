"""Multiclass metrics — PyTorch counterpart of
lightgbm_tpu/metric/multiclass.py (src/metric/multiclass_metric.hpp
error:132, logloss:152).  Scores are (K, N)."""

from __future__ import annotations

import torch

from .base import Metric, convert_scores

_EPS = 1e-15


class _MulticlassMetric(Metric):
    bigger_is_better = False

    def __init__(self, config):
        self.num_class = int(config.num_class)

    def eval(self, score, objective=None):
        label, w = self._data(score.device)
        if score.dim() == 1:
            score = score.reshape(self.num_class, -1)
        prob = convert_scores(score, objective)
        k = label.long()
        true_p = prob.gather(0, k[None, :])[0]
        return [(self.name, self._mean(self.loss(prob, k, true_p), w))]


class MultiErrorMetric(_MulticlassMetric):
    """1 when another class's probability is >= the true class's
    (multiclass_metric.hpp:136-144): ties count as errors."""

    name = "multi_error"

    def loss(self, prob, k, true_p):
        n_ge = (prob >= true_p[None, :]).sum(dim=0)  # counts the true class once
        return (n_ge > 1).double()


class MultiLoglossMetric(_MulticlassMetric):
    name = "multi_logloss"

    def loss(self, prob, k, true_p):
        return -torch.log(true_p.clamp(min=_EPS))
