"""Ranking metrics NDCG@k and MAP@k — parity with lightgbm_tpu/metric/rank.py
(src/metric/rank_metric.hpp:16, map_metric.hpp:16 and DCGCalculator,
src/metric/dcg_calculator.cpp).

Both evaluate on the host in float64 numpy, query by query, as the JAX
package does: the scores come off the device once an evaluation.  Each
returns one value a cut-off, ``ndcg@k`` / ``map@k`` for each k of
``ndcg_eval_at``.
"""

from __future__ import annotations

import numpy as np

from ..objective.rank import dcg_discounts, default_label_gain
from ..utils.log import Log
from .base import Metric


class _RankMetric(Metric):
    """The query layout and weights both ranking metrics share."""

    def __init__(self, config):
        self.eval_at = [int(k) for k in (config.ndcg_eval_at or [1, 2, 3, 4, 5])]

    def init(self, metadata, num_data: int) -> None:
        super().init(metadata, num_data)
        if metadata.query_boundaries is None:
            Log.fatal("For %s metric, there should be query information", self.name.upper())
        self.qb = np.asarray(metadata.query_boundaries, np.int64)
        self.num_queries = len(self.qb) - 1
        self.query_weights = metadata.query_weights
        self.sum_query_weights = (float(np.sum(self.query_weights))
                                  if self.query_weights is not None
                                  else float(self.num_queries))

    def _queries(self, score):
        """(index, query weight, labels, scores) of each query, the scores
        (a tensor on any device) in float64."""
        score = score.double().cpu().numpy()
        for i in range(self.num_queries):
            lo, hi = self.qb[i], self.qb[i + 1]
            qw = float(self.query_weights[i]) if self.query_weights is not None else 1.0
            yield i, qw, self._label[lo:hi], score[lo:hi]


class NDCGMetric(_RankMetric):
    name = "ndcg"
    bigger_is_better = True

    def __init__(self, config):
        super().__init__(config)
        lg = config.label_gain
        self.label_gain = np.asarray(lg, np.float64) if lg else default_label_gain()

    def init(self, metadata, num_data: int) -> None:
        super().init(metadata, num_data)
        # each query's ideal DCG at each k (CalMaxDCG, dcg_calculator.cpp:53-84)
        self.inv_max_dcg = np.zeros((self.num_queries, len(self.eval_at)))
        for i in range(self.num_queries):
            lab = self._label[self.qb[i]: self.qb[i + 1]]
            gains = np.sort(self.label_gain[lab.astype(np.int64)])[::-1]
            cum = np.cumsum(gains * dcg_discounts(len(lab)))
            for j, k in enumerate(self.eval_at):
                kk = min(k, len(lab))
                m = cum[kk - 1] if kk > 0 else 0.0
                self.inv_max_dcg[i, j] = 1.0 / m if m > 0.0 else -1.0

    def eval(self, score, objective=None):
        sums = np.zeros(len(self.eval_at))
        for i, qw, lab, sc in self._queries(score):
            if self.inv_max_dcg[i, 0] <= 0.0:
                # a query of zero labels counts as NDCG 1 (rank_metric.hpp:95-99)
                sums += qw
                continue
            order = np.argsort(-sc, kind="mergesort")
            cum = np.cumsum(self.label_gain[lab[order].astype(np.int64)]
                            * dcg_discounts(len(lab)))
            for j, k in enumerate(self.eval_at):
                kk = min(k, len(lab))
                dcg = cum[kk - 1] if kk > 0 else 0.0
                sums[j] += qw * dcg * self.inv_max_dcg[i, j]
        return [(f"ndcg@{k}", float(sums[j] / self.sum_query_weights))
                for j, k in enumerate(self.eval_at)]


class MapMetric(_RankMetric):
    name = "map"
    bigger_is_better = True

    def eval(self, score, objective=None):
        """CalMapAtK (map_metric.hpp:69-95) per query, averaged."""
        sums = np.zeros(len(self.eval_at))
        for _, qw, lab, sc in self._queries(score):
            hits = lab[np.argsort(-sc, kind="mergesort")] > 0.5
            num_hit, sum_ap, cur_left = 0, 0.0, 0
            for j, k in enumerate(self.eval_at):
                kk = min(k, len(lab))
                for pos in range(cur_left, kk):
                    if hits[pos]:
                        num_hit += 1
                        # the reference divides by the cut-off's index + 1,
                        # not the rank position (map_metric.hpp:88)
                        sum_ap += num_hit / (j + 1.0)
                sums[j] += qw * (sum_ap / kk if kk > 0 else 0.0)
                cur_left = kk
        return [(f"map@{k}", float(sums[j] / self.sum_query_weights))
                for j, k in enumerate(self.eval_at)]
