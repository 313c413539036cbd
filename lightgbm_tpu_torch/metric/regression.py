"""Regression metrics — PyTorch counterpart of
lightgbm_tpu/metric/regression.py (src/metric/regression_metric.hpp
RMSE:115, L2:134, L1:153, Huber:166, Fair:188, Poisson:205)."""

from __future__ import annotations

import math

import torch

from .base import Metric, convert_scores


class _RegressionMetric(Metric):
    bigger_is_better = False

    def __init__(self, config):
        self.huber_delta = float(config.huber_delta)
        self.fair_c = float(config.fair_c)

    def loss(self, label, score):
        raise NotImplementedError

    def average(self, sum_loss: float, sum_weights: float) -> float:
        return sum_loss / sum_weights

    def eval(self, score, objective=None):
        label, w = self._data(score.device)
        pt = self.loss(label, convert_scores(score, objective))
        if w is not None:
            pt = pt * w
        return [(self.name, float(self.average(float(pt.sum()), self.sum_weights)))]


class L2Metric(_RegressionMetric):
    name = "l2"

    def loss(self, label, score):
        d = score - label
        return d * d


class RMSEMetric(L2Metric):
    name = "rmse"

    def average(self, sum_loss, sum_weights):
        return math.sqrt(sum_loss / sum_weights)


class L1Metric(_RegressionMetric):
    name = "l1"

    def loss(self, label, score):
        return (score - label).abs()


class HuberMetric(_RegressionMetric):
    """0.5 d^2 inside delta, delta (|d| - delta / 2) outside
    (regression_metric.hpp:166-185)."""

    name = "huber"

    def loss(self, label, score):
        d = score - label
        ad = d.abs()
        return torch.where(ad <= self.huber_delta, 0.5 * d * d,
                           self.huber_delta * (ad - 0.5 * self.huber_delta))


class FairMetric(_RegressionMetric):
    """c |d| - c^2 log(1 + |d| / c) (regression_metric.hpp:188-202)."""

    name = "fair"

    def loss(self, label, score):
        x = (score - label).abs()
        c = self.fair_c
        return c * x - c * c * torch.log1p(x / c)


class PoissonMetric(_RegressionMetric):
    """score - label log(score), score floored at 1e-10
    (regression_metric.hpp:205-226)."""

    name = "poisson"

    def loss(self, label, score):
        s = score.clamp(min=1e-10)
        return s - label * torch.log(s)
