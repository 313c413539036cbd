"""LambdarankNDCG objective — parity with lightgbm_tpu/objective/rank.py
(src/objective/rank_objective.hpp:19-244, the pair loop at :115-160).

Per query, the documents are sorted by score (stable, descending) and an
(S, S) matrix of pair lambdas is formed over the sorted positions,
masked to the pairs whose first label is the higher, and row- and
column-summed; each document's sums are written back to it once.  The
JAX package pads every query to the largest query's size and runs all
queries as one (Q, S, S) program; here the queries are taken in
buckets of similar size, each padded to its own largest query and held
to ``pair_budget`` elements a pair matrix (a query larger than that is a
bucket of its own).  A query's lambdas depend on that query alone, so
bucketing changes only the float order of the pair sums (over more or
fewer zero pads).  The JAX gradients reach no Pallas kernel; these are
PyTorch tensor code on the scores' device.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..utils.log import Log
from .base import ObjectiveFunction, exp_f32

# elements of one bucket's (Q_b, S_b, S_b) pair matrices: ~10 float32
# temporaries of this size are alive at once (~1.3 GB)
PAIR_BUDGET = 1 << 25


def default_label_gain(max_label: int = 31) -> np.ndarray:
    """label_gain = 2^i - 1 (config.cpp:271-277)."""
    g = [0.0] + [float((1 << i) - 1) for i in range(1, max_label)]
    return np.asarray(g, dtype=np.float64)


def dcg_discounts(max_position: int) -> np.ndarray:
    """discount[i] = 1/log2(2+i) (dcg_calculator.cpp:23-26)."""
    return 1.0 / np.log2(2.0 + np.arange(max_position, dtype=np.float64))


def max_dcg_at_k(k: int, labels: np.ndarray, label_gain: np.ndarray) -> float:
    """DCGCalculator::CalMaxDCGAtK (dcg_calculator.cpp:28-50): ideal DCG
    from the sorted label gains."""
    k = min(k, len(labels))
    gains = np.sort(label_gain[labels.astype(np.int64)])[::-1][:k]
    return float(np.sum(gains * dcg_discounts(k)[: len(gains)]))


def pad_queries(starts: np.ndarray, sizes: np.ndarray, pad_to: int = 0):
    """(Q, S) document indices of the queries [start, start + size), each
    padded to the largest (S), or to ``pad_to`` when larger, and their
    (Q, S) valid mask; pads point at document 0.  The queries need not be
    adjacent (a bucket's are not)."""
    pos = np.arange(max(int(sizes.max(initial=1)), int(pad_to), 1), dtype=np.int64)
    valid = pos[None, :] < sizes[:, None]
    return np.where(valid, starts[:, None] + pos[None, :], 0), valid


def size_buckets(sizes: np.ndarray, budget: int, pad_to: int = 0) -> List[np.ndarray]:
    """The query indices in buckets: ascending size, a bucket closed when
    one more query would take its (count, S, S) pair matrix past
    ``budget`` elements (S at least ``pad_to``)."""
    order = np.argsort(sizes, kind="stable")
    buckets, cur = [], []
    for qi in order:
        s = max(int(sizes[qi]), int(pad_to), 1)
        if cur and (len(cur) + 1) * s * s > budget:
            buckets.append(np.asarray(cur, np.int64))
            cur = []
        cur.append(qi)
    if cur:
        buckets.append(np.asarray(cur, np.int64))
    return buckets


class _Bucket:
    """One bucket's queries padded to its largest, as tensors on a device."""

    def __init__(self, qb, queries, label, gain, inv_max_dcg, device, pad_to=0):
        doc_idx, valid = pad_queries(qb[queries], qb[queries + 1] - qb[queries], pad_to)
        flat = valid.reshape(-1)
        self.valid = torch.from_numpy(valid).to(device)
        self.label = torch.from_numpy(label[doc_idx]).to(device)
        self.gain = torch.from_numpy(gain[doc_idx]).to(device)
        self.doc_idx = torch.from_numpy(doc_idx).to(device)
        self.inv_max_dcg = torch.from_numpy(inv_max_dcg[queries]).to(device)
        # the valid slots of the flattened (Q_b, S_b) matrix and their documents
        self.slots = torch.from_numpy(np.flatnonzero(flat)).to(device)
        self.docs = torch.from_numpy(doc_idx.reshape(-1)[flat]).to(device)


class LambdarankNDCG(ObjectiveFunction):
    name = "lambdarank"

    def __init__(self, config):
        self.sigmoid = float(config.sigmoid)
        if self.sigmoid <= 0.0:
            Log.fatal("Sigmoid param %f should be greater than zero", self.sigmoid)
        self.optimize_pos_at = int(config.max_position)
        lg = config.label_gain
        self.label_gain = np.asarray(lg, np.float64) if lg else default_label_gain()
        self.pair_budget = PAIR_BUDGET

    def init(self, metadata, num_data: int) -> None:
        super().init(metadata, num_data)
        if metadata.query_boundaries is None:
            Log.fatal("Lambdarank tasks require query information")
        self.qb = np.asarray(metadata.query_boundaries, np.int64)
        self.num_queries = len(self.qb) - 1
        self.sizes = np.diff(self.qb)
        inv = np.zeros(self.num_queries, np.float64)
        for i in range(self.num_queries):
            m = max_dcg_at_k(self.optimize_pos_at, self.label[self.qb[i]: self.qb[i + 1]],
                             self.label_gain)
            inv[i] = 1.0 / m if m > 0.0 else 0.0
        self.inverse_max_dcg = inv.astype(np.float32)  # (hpp:58-69)
        self.gain_of_doc = self.label_gain[self.label.astype(np.int64)].astype(np.float32)
        # over several processes every query pads to the global largest
        # group (boosting/gbdt.py sets it), so a query's lambdas add in the
        # same order whatever rank holds it (JAX objective/rank.py:95-96)
        self.pad_to = int(getattr(metadata, "pad_group_size", None) or 0)
        s = max(int(self.sizes.max()) if self.num_queries else 1, self.pad_to)
        self.discount = dcg_discounts(s).astype(np.float32)
        self._on = {}

    def _state(self, device):
        """(buckets, discount, weights) on ``device``, built at the first
        call there (and again when ``pair_budget`` changed)."""
        key = (str(device), self.pair_budget)
        if key not in self._on:
            buckets = [_Bucket(self.qb, q, self.label, self.gain_of_doc, self.inverse_max_dcg,
                               device, self.pad_to)
                       for q in size_buckets(self.sizes, self.pair_budget, self.pad_to)]
            w = None if self.weights is None else torch.from_numpy(self.weights).to(device)
            self._on[key] = (buckets, torch.from_numpy(self.discount).to(device), w)
        return self._on[key]

    def _bucket(self, score, b: _Bucket, discount):
        """(lambdas, hessians) of a bucket's queries, (Q_b, S_b) in each
        query's padded document order: GetGradientsForOneQuery
        (hpp:85-170) with the pair loop as a matrix, [i] indexing the
        sorted position, the higher label along the rows."""
        s = b.valid.shape[1]
        key = torch.where(b.valid, score[b.doc_idx], float("-inf"))
        order = torch.argsort(-key, dim=1, stable=True)  # score descending, pads last
        sc = torch.gather(key, 1, order)
        lb = torch.gather(b.label, 1, order)
        gains = torch.gather(b.gain, 1, order)
        vd = torch.gather(b.valid, 1, order)
        disc = discount[:s]
        cnt = vd.sum(1)
        worst = torch.gather(sc, 1, torch.clamp_min(cnt - 1, 0)[:, None])[:, 0]
        spread = (sc[:, 0] != worst)[:, None, None]

        delta_score = sc[:, :, None] - sc[:, None, :]
        dcg_gap = gains[:, :, None] - gains[:, None, :]
        paired_discount = torch.abs(disc[:, None] - disc[None, :])
        delta_ndcg = dcg_gap * paired_discount * b.inv_max_dcg[:, None, None]
        # regularize by score distance (hpp:145-147)
        delta_ndcg = torch.where(spread, delta_ndcg / (0.01 + torch.abs(delta_score)),
                                 delta_ndcg)
        # GetSigmoid(delta) = 2/(1+exp(2*sigmoid*delta)) (hpp:197-200)
        p_lambda = 2.0 / (1.0 + exp_f32(float(np.float32(2.0 * self.sigmoid)) * delta_score))
        p_hessian = p_lambda * (2.0 - p_lambda)
        lam = -delta_ndcg * p_lambda
        hes = 2.0 * delta_ndcg * p_hessian
        # pads' pairs hold NaN (-inf - -inf): masked before any sum
        mask = (lb[:, :, None] > lb[:, None, :]) & vd[:, :, None] & vd[:, None, :]
        zero = torch.zeros((), dtype=lam.dtype, device=lam.device)
        lam = torch.where(mask, lam, zero)
        hes = torch.where(mask, hes, zero)
        lam_sorted = torch.sum(lam, dim=2) - torch.sum(lam, dim=1)
        hes_sorted = torch.sum(hes, dim=2) + torch.sum(hes, dim=1)
        # back from sorted positions to the padded document order (each
        # slot written once)
        lam_doc = torch.empty_like(lam_sorted).scatter_(1, order, lam_sorted)
        hes_doc = torch.empty_like(hes_sorted).scatter_(1, order, hes_sorted)
        return lam_doc, hes_doc

    def get_gradients(self, score):
        """(N,) lambdas and hessians of the (N,) float32 scores, times the
        row weights."""
        buckets, discount, w = self._state(score.device)
        grad = torch.zeros_like(score)
        hess = torch.zeros_like(score)
        for b in buckets:
            lam, hes = self._bucket(score, b, discount)
            grad.index_copy_(0, b.docs, lam.reshape(-1).index_select(0, b.slots))
            hess.index_copy_(0, b.docs, hes.reshape(-1).index_select(0, b.slots))
        if w is not None:
            grad = grad * w
            hess = hess * w
        return grad, hess
