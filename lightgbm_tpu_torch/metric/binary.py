"""Binary metrics and AUC — PyTorch counterpart of
lightgbm_tpu/metric/binary.py (src/metric/binary_metric.hpp logloss:113,
error:137, AUC:157-262)."""

from __future__ import annotations

import torch

from .base import Metric, convert_scores

_EPS = 1e-15


class BinaryLoglossMetric(Metric):
    name = "binary_logloss"
    bigger_is_better = False

    def __init__(self, config):
        pass

    def eval(self, score, objective=None):
        label, w = self._data(score.device)
        prob = convert_scores(score, objective)
        p = torch.where(label > 0, prob, 1.0 - prob)
        return [(self.name, self._mean(-torch.log(p.clamp(min=_EPS)), w))]


class BinaryErrorMetric(Metric):
    name = "binary_error"
    bigger_is_better = False

    def __init__(self, config):
        pass

    def eval(self, score, objective=None):
        label, w = self._data(score.device)
        prob = convert_scores(score, objective)
        # LossOnPoint (binary_metric.hpp:141-147): prob <= 0.5 predicts negative
        err = torch.where(prob <= 0.5, label > 0, label <= 0).double()
        return [(self.name, self._mean(err, w))]


class AUCMetric(Metric):
    """Threshold-sweep AUC with tied scores grouped
    (binary_metric.hpp:193-259), on raw scores (the sigmoid is monotone)."""

    name = "auc"
    bigger_is_better = True

    def __init__(self, config):
        pass

    def eval(self, score, objective=None):
        label, w = self._data(score.device)
        s = score.double()
        order = torch.sort(-s, stable=True).indices
        s, lab = s[order], label[order]
        wt = w[order] if w is not None else torch.ones_like(lab)
        pos = (lab > 0).double() * wt
        neg = (lab <= 0).double() * wt
        if s.numel() == 0:
            return [(self.name, 1.0)]
        new_thr = torch.ones_like(s, dtype=torch.bool)
        new_thr[1:] = s[1:] != s[:-1]
        seg = torch.cumsum(new_thr.long(), 0) - 1  # tie group of each row
        nseg = int(seg[-1]) + 1
        pos_per = torch.zeros(nseg, dtype=torch.float64, device=s.device).index_add_(0, seg, pos)
        neg_per = torch.zeros(nseg, dtype=torch.float64, device=s.device).index_add_(0, seg, neg)
        before = torch.cumsum(pos_per, 0) - pos_per
        # accum += cur_neg * (cur_pos * 0.5 + sum_pos_before)
        accum = float((neg_per * (pos_per * 0.5 + before)).sum())
        sum_pos = float(pos_per.sum())
        auc = 1.0
        if sum_pos > 0.0 and sum_pos != self.sum_weights:
            auc = accum / (sum_pos * (self.sum_weights - sum_pos))
        return [(self.name, auc)]
