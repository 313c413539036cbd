"""Prediction early stopping — PyTorch counterpart of
lightgbm_tpu/boosting/pred_early_stop.py (src/boosting/prediction_early_stop.cpp):
a row's prediction stops adding trees once its margin passes a threshold,
tested every ``round_period`` iterations.

The JAX package walks the rows one at a time on the host.  Here every row
moves at once on the device: the trees' leaf of each row comes from one
traversal (ops/predict.py ``predict_leaf``), then the iterations are added
in blocks of ``round_period`` to the rows still active, and after each
full block the rows whose margin passes the test retire.  Each tree's
float64 output (a linear leaf's model at the float64 row) is added in
tree order, as the JAX package's loop adds them, so both compute the
same numbers.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils.log import Log


class PredictionEarlyStopInstance(NamedTuple):
    """The margin test's kind ("none", "binary" or "multiclass"), the
    iterations between two tests and the margin a row must pass."""

    kind: str
    round_period: int
    margin_threshold: float


def create_prediction_early_stop_instance(type_: str, round_period: int = 10,
                                          margin_threshold: float = 10.0
                                          ) -> PredictionEarlyStopInstance:
    """CreatePredictionEarlyStopInstance (prediction_early_stop.cpp:74-89)."""
    if type_ == "none":
        return PredictionEarlyStopInstance("none", 1 << 30, margin_threshold)
    if type_ not in ("binary", "multiclass"):
        Log.fatal("Unknown early stopping type: %s", type_)
    return PredictionEarlyStopInstance(type_, int(round_period), float(margin_threshold))


def _passes(kind: str, pred: torch.Tensor, margin: float) -> torch.Tensor:
    """(N,) bool: the rows of the (K, N) float64 ``pred`` whose margin
    passes — binary 2|score| > margin, multiclass the gap between the two
    largest scores > margin."""
    if kind == "binary":
        if pred.shape[0] != 1:
            Log.fatal("Binary early stopping needs predictions to be of length one")
        return 2.0 * pred[0].abs() > margin
    if pred.shape[0] < 2:
        Log.fatal("Multiclass early stopping needs predictions to be of length two or larger")
    top2 = torch.topk(pred, 2, dim=0).values
    return top2[0] - top2[1] > margin


def predict_with_early_stop(vals: torch.Tensor, k: int,
                            early_stop: PredictionEarlyStopInstance) -> torch.Tensor:
    """(K, N) float64 raw scores with the margin exit.  ``vals`` is the
    (T, N) float64 output of each row in each tree (``tree_outputs``), the
    trees in model order (iteration i's class k at i * K + k, a
    boost-from-average tree counting as iteration 0)."""
    T, n = vals.shape
    pred = torch.zeros((k, n), dtype=torch.float64, device=vals.device)
    active = torch.ones(n, dtype=torch.bool, device=vals.device)
    period = early_stop.round_period
    n_iter = T // k
    for b0 in range(0, n_iter, period):
        b1 = min(b0 + period, n_iter)
        for it in range(b0, b1):
            for kk in range(k):
                pred[kk] = torch.where(active, pred[kk] + vals[it * k + kk], pred[kk])
        if b1 - b0 == period and early_stop.kind != "none":
            active &= ~_passes(early_stop.kind, pred, early_stop.margin_threshold)
    return pred


def early_stop_type(num_tree_per_iteration: int, objective) -> str:
    """The margin test a model takes (application/predictor.hpp): the
    top-2 gap for K > 1, 2|score| for the binary objective, none else."""
    if num_tree_per_iteration > 1:
        return "multiclass"
    if objective is not None and objective.name == "binary":
        return "binary"
    return "none"


def tree_outputs(leaves: torch.Tensor, models, data: np.ndarray) -> torch.Tensor:
    """(T, N) float64 output of each raw row in each tree, as the JAX
    package's row loop takes it from ``Tree.predict``: the float64 leaf
    value at the row's leaf ``leaves`` (T, N), or a linear leaf's intercept
    plus its coefficients times the row's float64 path features, the
    constant where that is not finite (a NaN path feature)."""
    dev = leaves.device
    L = max(max((t.num_leaves for t in models), default=1), 1)
    table = np.zeros((len(models), L), np.float64)
    for i, t in enumerate(models):
        table[i, :max(t.num_leaves, 1)] = t.leaf_value[:max(t.num_leaves, 1)]
    vals = torch.gather(torch.from_numpy(table).to(dev), 1, leaves)
    if not any(t.is_linear for t in models):
        return vals
    x_all = torch.from_numpy(np.ascontiguousarray(data, np.float64)).to(dev)
    rows = torch.arange(x_all.shape[0], device=dev)[:, None]
    for i, t in enumerate(models):
        if not t.is_linear:
            continue
        k = max([1] + [len(fs) for fs in t.leaf_features])
        feat = np.zeros((L, k), np.int64)
        coeff = np.zeros((L, k), np.float64)
        valid = np.zeros((L, k), bool)
        const = np.zeros(L, np.float64)
        is_lin = np.zeros(L, bool)
        for li in np.nonzero(t.leaf_is_linear[:t.num_leaves])[0]:
            n_f = len(t.leaf_features[li])
            feat[li, :n_f], coeff[li, :n_f], valid[li, :n_f] = (t.leaf_features[li],
                                                                t.leaf_coeff[li], True)
            const[li], is_lin[li] = t.leaf_const[li], True
        lv = leaves[i]
        feat_t, coeff_t, valid_t = (torch.from_numpy(a).to(dev)[lv] for a in (feat, coeff, valid))
        x = torch.where(valid_t, x_all[rows, feat_t], 0.0)
        lin = torch.from_numpy(const).to(dev)[lv] + (coeff_t * x).sum(dim=1)
        use = torch.from_numpy(is_lin).to(dev)[lv] & torch.isfinite(lin)
        vals[i] = torch.where(use, lin, vals[i])
    return vals
