"""DART (Dropouts meet Multiple Additive Regression Trees) — PyTorch
counterpart of lightgbm_tpu/boosting/dart.py (src/boosting/dart.hpp
TrainOneIter:49-63, DroppingTrees:84-120, Normalize:122-170).

DART runs on the mask grower, as in the JAX package: before an
iteration's gradients it drops trees, taking them off the training scores
by a traversal of the training set's packed bin words (ops/predict.py
``predict_words``); the new tree trains on those scores at a reduced
shrinkage, then the dropped trees are re-normalized into the training and
validation scores.  The drops come from the ``Random(drop_seed)`` LCG of
utils/random.py, so they equal the JAX package's.
"""

from __future__ import annotations

from ..utils.random import Random
from .gbdt import GBDT


class DART(GBDT):
    supports_partitioned = False  # the drops and normalization run between iterations
    supports_ooc = False  # the drops walk the whole matrix every iteration

    def init(self, config, train_set, objective, training_metrics=()):
        super().init(config, train_set, objective, training_metrics)
        self.random_for_drop = Random(config.drop_seed)
        self.tree_weight = []
        self.sum_weight = 0.0
        self.drop_index = []
        self.is_update_score_cur_iter = False
        self.shrinkage_rate = config.learning_rate

    def _train_one_iter_mask(self, grad=None, hess=None) -> bool:
        """dart.hpp:49-63: train, then normalize the dropped trees and
        record the new tree's weight."""
        self.is_update_score_cur_iter = False
        if super()._train_one_iter_mask(grad, hess):
            return True
        self._normalize()
        if not self.config.uniform_drop:
            self.tree_weight.append(self.shrinkage_rate)
            self.sum_weight += self.shrinkage_rate
        return False

    def get_training_score(self):
        """GetTrainingScore (dart.hpp:66-76): drop trees once an iteration,
        before its gradients."""
        if not self.is_update_score_cur_iter:
            self._dropping_trees()
            self.is_update_score_cur_iter = True
        return self.scores

    def _model_offset(self) -> int:
        """Trees before iteration 0: an initial model's (which are never
        dropped), else the boost-from-average tree."""
        return self.num_init_trees or (1 if self.boost_from_average_ else 0)

    def _dropping_trees(self) -> None:
        """DroppingTrees (dart.hpp:84-120): pick the iterations to drop,
        take their trees off the training scores, set the shrinkage."""
        cfg = self.config
        self.drop_index = []
        is_skip = self.random_for_drop.next_float() < cfg.skip_drop
        if not is_skip and self.iter > 0:
            drop_rate = cfg.drop_rate
            if not cfg.uniform_drop:
                inv_avg = len(self.tree_weight) / self.sum_weight if self.sum_weight else 0.0
                if cfg.max_drop > 0:
                    drop_rate = min(drop_rate,
                                    cfg.max_drop * inv_avg / max(self.sum_weight, 1e-30))
                for i in range(self.iter):
                    if (self.random_for_drop.next_float()
                            < drop_rate * self.tree_weight[i] * inv_avg):
                        self.drop_index.append(i)
            else:
                if cfg.max_drop > 0:
                    drop_rate = min(drop_rate, cfg.max_drop / float(self.iter))
                for i in range(self.iter):
                    if self.random_for_drop.next_float() < drop_rate:
                        self.drop_index.append(i)
        K, off = self.num_tree_per_iteration, self._model_offset()
        for i in self.drop_index:
            for k in range(K):
                tree = self.models[off + i * K + k]
                tree.shrinkage(-1.0)
                self._add_tree_to_train_scores(tree, k)
        ndrop = len(self.drop_index)
        if not cfg.xgboost_dart_mode:
            self.shrinkage_rate = cfg.learning_rate / (1.0 + ndrop)
        elif ndrop == 0:
            self.shrinkage_rate = cfg.learning_rate
        else:
            self.shrinkage_rate = cfg.learning_rate / (cfg.learning_rate + ndrop)

    def _normalize(self) -> None:
        """Normalize (dart.hpp:122-170): each dropped tree is scaled by
        1 / (k + 1) (xgboost mode: the shrinkage) into the validation
        scores and put back on the training scores at that scale."""
        cfg = self.config
        k_drop = float(len(self.drop_index))
        K, off = self.num_tree_per_iteration, self._model_offset()
        for i in self.drop_index:
            for k in range(K):
                tree = self.models[off + i * K + k]
                if not cfg.xgboost_dart_mode:
                    tree.shrinkage(1.0 / (k_drop + 1.0))
                    self._add_to_valid_scores([tree], k)
                    tree.shrinkage(-k_drop)
                else:
                    tree.shrinkage(self.shrinkage_rate)
                    self._add_to_valid_scores([tree], k)
                    tree.shrinkage(-k_drop / cfg.learning_rate)
                self._add_tree_to_train_scores(tree, k)
            if not cfg.uniform_drop:
                if not cfg.xgboost_dart_mode:
                    self.sum_weight -= self.tree_weight[i] * (1.0 / (k_drop + 1.0))
                    self.tree_weight[i] *= k_drop / (k_drop + 1.0)
                else:
                    self.sum_weight -= self.tree_weight[i] * (1.0 / (k_drop + cfg.learning_rate))
                    self.tree_weight[i] *= k_drop / (k_drop + cfg.learning_rate)

    def export_train_state(self):
        """DART's drop stream and tree-weight ledger, which model text
        cannot carry (dart.py:130-146)."""
        arrays, py = super().export_train_state()
        py["dart"] = {"drop_rng": self.random_for_drop.get_state(),
                      "tree_weight": [float(w) for w in self.tree_weight],
                      "sum_weight": float(self.sum_weight)}
        return arrays, py

    def import_train_state(self, arrays, py) -> None:
        super().import_train_state(arrays, py)
        st = py["dart"]
        self.random_for_drop.set_state(st["drop_rng"])
        self.tree_weight = [float(w) for w in st["tree_weight"]]
        self.sum_weight = float(st["sum_weight"])
        self.drop_index = []
        self.is_update_score_cur_iter = False
