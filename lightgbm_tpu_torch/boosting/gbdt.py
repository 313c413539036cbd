"""GBDT boosting loop — PyTorch counterpart of lightgbm_tpu/boosting/gbdt.py,
serial core only: init and routing onto the partitioned trainer,
boost-from-average, ``train_iters_partitioned``, validation sets and their
scores, metrics and the early-stopping bookkeeping, model text and predict
(src/boosting/gbdt.cpp TrainOneIter :381-495, AddValidDataset :220-250,
OutputMetric :516-622, model save/load :854-1008).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..model.ensemble import stack_trees
from ..model.tree import Tree
from ..ops.predict import TreeArrays, predict_binned, predict_raw
from ..ops.split import FeatureMeta, SplitHyper
from ..utils.log import Log


def unsupported_feature(config):
    """The first configured feature this slice of the port does not run
    yet, or None."""
    if config.boosting_type.lower() not in ("gbdt", "goss"):
        return f"boosting={config.boosting_type}"
    if config.quantized_training:
        return "quantized training"
    if config.linear_tree:
        return "linear trees"
    if config._monotone_active():
        return "monotone constraints"
    if config.tree_learner.lower() != "serial":
        return f"tree_learner={config.tree_learner}"
    if str(config.out_of_core).lower() in ("true", "1", "on", "yes"):
        return "out-of-core training"
    return None


class GBDT:
    """The gradient-boosting loop (class GBDT, gbdt.h:24-258)."""

    def __init__(self, device="cpu"):
        self.device = torch.device(device)
        self.models: List[Tree] = []
        self.iter = 0
        self.num_init_iteration = 0
        self.boost_from_average_ = False
        self.train_set = None
        self.objective = None
        self.config = None
        self.max_feature_idx = 0
        self.label_idx = 0
        self.num_class = 1
        self.num_tree_per_iteration = 1
        self.feature_names: List[str] = []
        self.ptrainer = None
        self.training_metrics = []
        self.valid_bins = []  # (N_i, F) bins of each validation set, on the device
        self.valid_scores = []  # (K, N_i) float32 scores of each validation set
        self.valid_metrics = []
        self.valid_names = []
        self.best_iter = []
        self.best_score = []
        self.best_msg = []

    # ------------------------------------------------------------------
    def init(self, config, train_set, objective, training_metrics=()):
        """GBDT::Init + ResetTrainingData, routed onto the partitioned
        trainer (the port's only tree learner)."""
        from .ptrainer import PartitionedTrainer, eligible

        num_tree = objective.num_tree_per_iteration if objective is not None else max(
            config.num_class, 1)
        why = unsupported_feature(config) or eligible(config, train_set, objective, num_tree)
        if why:
            raise NotImplementedError(f"lightgbm_tpu_torch does not support {why} yet")
        self.config = config
        self.train_set = train_set
        self.objective = objective
        self.num_data = train_set.num_data
        self.num_class = config.num_class
        self.num_tree_per_iteration = num_tree
        self.max_feature_idx = train_set.num_total_features - 1
        self.label_idx = getattr(train_set, "label_idx", 0)
        self.feature_names = train_set.feature_names
        self.training_metrics = list(training_metrics)
        self.shrinkage_rate = config.learning_rate
        objective.init(train_set.metadata, self.num_data)
        self.has_init_score = train_set.metadata.init_score is not None
        self.meta = FeatureMeta.from_dataset(train_set, device=self.device)
        self.hyper = SplitHyper.from_config(config)
        self.ptrainer = PartitionedTrainer(train_set, config, objective, self.meta, self.hyper,
                                           self.device)
        if self.has_init_score:
            # (K, N) or the flat class-major K*N layout of the reference
            init = np.asarray(train_set.metadata.init_score, np.float32).reshape(num_tree, -1)
            for k in range(num_tree):
                self.ptrainer.add_score(init[k], k)
        self.scores = self.ptrainer._scores()
        Log.info("Using partitioned tree learner on %s", self.device)

    def add_valid(self, valid_set, valid_metrics, name: str):
        """GBDT::AddValidDataset (gbdt.cpp:220-250): the set's (unbundled)
        bins go to the device, its scores start from its init score and
        replay the trees already trained."""
        vb = torch.from_numpy(np.ascontiguousarray(valid_set.binned)).to(self.device)
        k = self.num_tree_per_iteration
        vs = torch.zeros((k, valid_set.num_data), dtype=torch.float32, device=self.device)
        init_score = valid_set.metadata.init_score
        if init_score is not None:
            vs += torch.from_numpy(np.asarray(init_score, np.float32).reshape(k, -1)).to(
                self.device)
        if self.models:
            for kk in range(k):
                vs[kk] += predict_binned(vb, stack_trees(self.models[kk::k]))
        self.valid_bins.append(vb)
        self.valid_scores.append(vs)
        self.valid_metrics.append(list(valid_metrics))
        self.valid_names.append(name)
        self.best_iter.append([0] * len(valid_metrics))
        self.best_score.append([-np.inf] * len(valid_metrics))
        self.best_msg.append([""] * len(valid_metrics))

    def refresh_config(self) -> None:
        """Re-derive the config-dependent state after a parameter reset
        (callback.reset_parameter; the reference's ResetConfig)."""
        self.hyper = SplitHyper.from_config(self.config)
        self.ptrainer.hyper = self.hyper
        self.ptrainer.config = self.config
        self.shrinkage_rate = self.config.learning_rate

    # ------------------------------------------------------------------
    def _boost_from_average(self):
        """gbdt.cpp:381-399 + LabelAverage (:349-379)."""
        if (not self.models and self.config.boost_from_average and not self.has_init_score
                and self.num_class <= 1 and self.objective.boost_from_average):
            init_score = float(np.mean(np.asarray(self.train_set.metadata.label)))
            self.ptrainer.add_score(np.float32(init_score))
            self.valid_scores = [vs + np.float32(init_score) for vs in self.valid_scores]
            self.models.append(Tree.constant(init_score))
            self.boost_from_average_ = True
            Log.info("Start training from score %f", init_score)

    def train_iters_partitioned(self, num_iters: int, is_eval: bool = False) -> bool:
        """Run ``num_iters`` boosting iterations.  Returns True when
        training should stop: a tree found no split, or (with
        ``is_eval``) the config's ``early_stopping_round`` fired.
        ``engine.train`` evaluates through its callbacks instead;
        ``is_eval`` is the reference CLI's loop (application.cpp), which
        the port does not have yet."""
        if num_iters <= 0:
            return False
        self._boost_from_average()
        K = self.num_tree_per_iteration
        trees, self.scores, n_done = self.ptrainer.train_chunk(num_iters, self.shrinkage_rate,
                                                               self.iter)
        chunk_trees = [[] for _ in range(K)]
        for iter_trees in trees:
            for k, res in enumerate(iter_trees):
                if res.num_splits > 0:
                    tree = Tree.from_grow_result(res, self.train_set)
                    tree.shrinkage(self.shrinkage_rate)
                    chunk_trees[k].append(tree)
                else:
                    tree = Tree(2)  # a class with no split: an empty tree keeps alignment
                self.models.append(tree)
        # the validation scores advance once per chunk and class, by one
        # traversal of the chunk's stacked trees
        for k in range(K):
            if chunk_trees[k]:
                arrays = stack_trees(chunk_trees[k])
                for vb, vs in zip(self.valid_bins, self.valid_scores):
                    vs[k] += predict_binned(vb, arrays)
        self.iter += n_done
        if n_done < num_iters:
            Log.warning("Stopped training because there are no more leaves that meet "
                        "the split requirements.")
            return True
        if is_eval:
            return self.eval_and_check_early_stopping()
        return False

    # ------------------------------------------------------------------
    def eval_and_check_early_stopping(self) -> bool:
        """EvalAndCheckEarlyStopping + OutputMetric (gbdt.cpp:516-622):
        with ``early_stopping_round`` set, drops the trees after the best
        iteration and returns True once no validation metric improved
        for that many iterations."""
        best_msg = self._output_metric(self.iter)
        if not best_msg:
            return False
        es_round = self.config.early_stopping_round
        Log.info("Early stopping at iteration %d, the best iteration round is %d", self.iter,
                 self.iter - es_round)
        Log.info("Output of best iteration round:\n%s", best_msg)
        del self.models[len(self.models) - es_round * self.num_tree_per_iteration:]
        return True

    def _eval_metric(self, m, score: torch.Tensor):
        """One metric on the device-resident (K, N) scores, given as (N,)
        when single-class; an error raises."""
        return m.eval(score[0] if score.shape[0] == 1 else score, self.objective)

    def _output_metric(self, iter_: int) -> str:
        """OutputMetric (gbdt.cpp:577-622): logs the training and
        validation metrics every ``output_freq`` iterations and keeps each
        validation metric's best score and iteration; returns the best
        iteration's message once one metric has not improved for
        ``early_stopping_round`` iterations, else ""."""
        es_round = self.config.early_stopping_round
        need_output = (iter_ % self.config.output_freq) == 0
        msg_parts = []
        ret = ""
        if need_output:
            for m in self.training_metrics:
                for name, val in self._eval_metric(m, self.scores):
                    line = f"Iteration:{iter_}, training {name} : {val:g}"
                    Log.info("%s", line)
                    if es_round > 0:
                        msg_parts.append(line)
        meet = []
        if need_output or es_round > 0:
            for i, metrics in enumerate(self.valid_metrics):
                for j, m in enumerate(metrics):
                    results = self._eval_metric(m, self.valid_scores[i])
                    for name, val in results:
                        line = f"Iteration:{iter_}, valid_{i + 1} {name} : {val:g}"
                        if need_output:
                            Log.info("%s", line)
                        if es_round > 0:
                            msg_parts.append(line)
                    if not ret and es_round > 0:
                        cur = (1.0 if m.bigger_is_better else -1.0) * results[-1][1]
                        if cur > self.best_score[i][j]:
                            self.best_score[i][j] = cur
                            self.best_iter[i][j] = iter_
                            meet.append((i, j))
                        elif iter_ - self.best_iter[i][j] >= es_round:
                            ret = self.best_msg[i][j]
        msg = "\n".join(msg_parts)
        for i, j in meet:
            self.best_msg[i][j] = msg
        return ret

    def get_eval_at(self, data_idx: int):
        """GBDT::GetEvalAt: [(name, value, bigger_is_better), ...] of the
        training set (0) or validation set ``data_idx - 1``."""
        if data_idx == 0:
            score, metrics = self.scores, self.training_metrics
        else:
            score, metrics = self.valid_scores[data_idx - 1], self.valid_metrics[data_idx - 1]
        return [(name, val, m.bigger_is_better)
                for m in metrics for name, val in self._eval_metric(m, score)]

    # ------------------------------------------------------------------
    @property
    def num_trees(self) -> int:
        return len(self.models)

    def current_iteration(self) -> int:
        return self.iter + self.num_init_iteration

    def _used_models(self, num_iteration: int = -1):
        num_used = len(self.models)
        if num_iteration > 0:
            ni = num_iteration + (1 if self.boost_from_average_ else 0)
            num_used = min(ni * self.num_tree_per_iteration, num_used)
        return self.models[:num_used]

    def predict_raw_scores(self, data: np.ndarray, num_iteration: int = -1) -> np.ndarray:
        """(K, N) raw scores over raw (unbinned) features; class k sums the
        trees i with i % K == k."""
        models = self._used_models(num_iteration)
        k = self.num_tree_per_iteration
        if not models:
            return np.zeros((k, data.shape[0]))
        arrays = TreeArrays.from_stacked(stack_trees(models), self.device)
        return predict_raw(data, arrays, num_class=k)

    def predict(self, data: np.ndarray, num_iteration: int = -1,
                raw_score: bool = False) -> np.ndarray:
        """(N,) or, for K > 1, (N, K) predictions."""
        raw = self.predict_raw_scores(np.asarray(data, np.float64), num_iteration)
        if not raw_score and self.objective is not None:
            score = torch.as_tensor(raw, dtype=torch.float32, device=self.device)
            raw = self.objective.convert_output(score).double().cpu().numpy()
        return raw[0] if raw.shape[0] == 1 else raw.T

    def sub_model_name(self) -> str:
        return "tree"

    # ------------------------------------------------------------------
    def save_model_to_string(self, num_iteration: int = -1) -> str:
        """GBDT::SaveModelToString (gbdt.cpp:854-898) — the JAX package's
        text, byte for byte."""
        parts = [self.sub_model_name(), f"num_class={self.num_class}",
                 f"num_tree_per_iteration={self.num_tree_per_iteration}",
                 f"label_index={self.label_idx}", f"max_feature_idx={self.max_feature_idx}"]
        if self.objective is not None:
            parts.append(f"objective={self.objective.to_string()}")
        if self.boost_from_average_:
            parts.append("boost_from_average")
        parts.append("feature_names=" + " ".join(self.feature_names))
        if self.train_set is not None:
            parts.append("feature_infos=" + " ".join(self.train_set.feature_infos()))
        parts.append("")
        for i, tree in enumerate(self._used_models(num_iteration)):
            parts.append(f"Tree={i}")
            parts.append(tree.to_string())
        parts.append("")
        parts.append("feature importances:")
        for name, cnt in self.feature_importance_pairs():
            parts.append(f"{name}={cnt}")
        return "\n".join(parts) + "\n"

    def load_model_from_string(self, model_str: str) -> None:
        """GBDT::LoadModelFromString (gbdt.cpp:912-1008)."""
        self.models = []
        header, _, rest = model_str.partition("Tree=")
        kv = {}
        for line in header.splitlines():
            if "=" in line:
                k, _, v = line.partition("=")
                kv[k.strip()] = v.strip()
        for key in ("num_class", "label_index", "max_feature_idx"):
            if key not in kv:
                Log.fatal("Model file doesn't specify %s", key)
        self.num_class = int(kv["num_class"])
        self.num_tree_per_iteration = int(kv.get("num_tree_per_iteration", self.num_class))
        self.label_idx = int(kv["label_index"])
        self.max_feature_idx = int(kv["max_feature_idx"])
        self.boost_from_average_ = "boost_from_average" in header.splitlines()
        self.objective_name_loaded = kv.get("objective", "")
        self.feature_names = kv.get("feature_names", "").split()
        if rest:
            for blk in ("Tree=" + rest).split("Tree="):
                blk = blk.strip()
                if not blk or blk.startswith("feature importances"):
                    continue
                body = blk.partition("\n")[2].split("\nfeature importances:")[0]
                self.models.append(Tree.from_string(body))
        self.num_init_iteration = len(self.models) // max(self.num_tree_per_iteration, 1)
        self.iter = 0

    def feature_importance_pairs(self):
        """Split-count importance (GBDT::FeatureImportance), sorted
        descending, nonzero only."""
        imp = np.zeros(self.max_feature_idx + 1, np.int64)
        for tree in self.models:
            for s in range(tree.num_leaves - 1):
                if tree.split_gain[s] > 0:
                    imp[tree.split_feature[s]] += 1
        names = self.feature_names or [f"Column_{i}" for i in range(self.max_feature_idx + 1)]
        pairs = [(names[i], int(imp[i])) for i in range(len(imp)) if imp[i] > 0]
        pairs.sort(key=lambda p: -p[1])
        return pairs
