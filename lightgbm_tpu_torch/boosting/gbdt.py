"""GBDT boosting loop — PyTorch counterpart of lightgbm_tpu/boosting/gbdt.py,
serial core only: init and routing onto the partitioned trainer,
boost-from-average, ``train_iters_partitioned``, model text and predict
(src/boosting/gbdt.cpp TrainOneIter :381-495, model save/load
:854-1008).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..model.ensemble import stack_trees
from ..model.tree import Tree
from ..ops.predict import TreeArrays, predict_raw
from ..ops.split import FeatureMeta, SplitHyper
from ..utils.log import Log


def unsupported_feature(config, train_set=None):
    """The first configured feature this slice of the port does not run
    yet, or None."""
    if config.boosting_type.lower() != "gbdt":
        return f"boosting={config.boosting_type}"
    if config.bagging_fraction < 1.0 and config.bagging_freq > 0:
        return "bagging"
    if config.feature_fraction < 1.0:
        return "feature_fraction<1"
    if config.num_class > 1:
        return "multiclass"
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
    if train_set is not None:
        train_set.ensure_bundles(config)
        if train_set.bundle is not None:
            return "EFB bundles"
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

    # ------------------------------------------------------------------
    def init(self, config, train_set, objective):
        """GBDT::Init + ResetTrainingData, routed onto the partitioned
        trainer (the port's only tree learner)."""
        from .ptrainer import PartitionedTrainer, eligible

        why = unsupported_feature(config, train_set) or eligible(
            config, train_set, objective, 1)
        if why:
            raise NotImplementedError(f"lightgbm_tpu_torch does not support {why} yet")
        self.config = config
        self.train_set = train_set
        self.objective = objective
        self.num_data = train_set.num_data
        self.num_class = config.num_class
        self.max_feature_idx = train_set.num_total_features - 1
        self.label_idx = getattr(train_set, "label_idx", 0)
        self.feature_names = train_set.feature_names
        self.shrinkage_rate = config.learning_rate
        objective.init(train_set.metadata, self.num_data)
        self.has_init_score = train_set.metadata.init_score is not None
        self.meta = FeatureMeta.from_dataset(train_set, device=self.device)
        self.hyper = SplitHyper.from_config(config)
        self.ptrainer = PartitionedTrainer(train_set, config, objective, self.meta, self.hyper,
                                           self.device)
        if self.has_init_score:
            self.ptrainer.add_score(np.asarray(train_set.metadata.init_score, np.float32))
        Log.info("Using partitioned tree learner on %s", self.device)

    # ------------------------------------------------------------------
    def _boost_from_average(self):
        """gbdt.cpp:381-399 + LabelAverage (:349-379)."""
        if (not self.models and self.config.boost_from_average and not self.has_init_score
                and self.num_class <= 1 and self.objective.boost_from_average):
            init_score = float(np.mean(np.asarray(self.train_set.metadata.label)))
            self.ptrainer.add_score(np.float32(init_score))
            self.models.append(Tree.constant(init_score))
            self.boost_from_average_ = True
            Log.info("Start training from score %f", init_score)

    def train_iters_partitioned(self, num_iters: int) -> bool:
        """Run ``num_iters`` boosting iterations.  Returns True when
        training stopped early (a tree found no split)."""
        if num_iters <= 0:
            return False
        self._boost_from_average()
        trees, self.scores, n_done = self.ptrainer.train_chunk(num_iters, self.shrinkage_rate)
        for res in trees:
            tree = Tree.from_grow_result(res, self.train_set)
            tree.shrinkage(self.shrinkage_rate)
            self.models.append(tree)
        self.iter += n_done
        if n_done < num_iters:
            Log.warning("Stopped training because there are no more leaves that meet "
                        "the split requirements.")
            return True
        return False

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
        """(1, N) raw scores over raw (unbinned) features."""
        models = self._used_models(num_iteration)
        n = data.shape[0]
        if not models:
            return np.zeros((1, n))
        arrays = TreeArrays.from_stacked(stack_trees(models), self.device)
        return predict_raw(data, arrays)[None, :]

    def predict(self, data: np.ndarray, num_iteration: int = -1,
                raw_score: bool = False) -> np.ndarray:
        raw = self.predict_raw_scores(np.asarray(data, np.float64), num_iteration)
        if raw_score or self.objective is None:
            return raw[0]
        score = torch.as_tensor(raw, dtype=torch.float32, device=self.device)
        return self.objective.convert_output(score).double().cpu().numpy()[0]

    # ------------------------------------------------------------------
    def save_model_to_string(self, num_iteration: int = -1) -> str:
        """GBDT::SaveModelToString (gbdt.cpp:854-898) — the JAX package's
        text, byte for byte."""
        parts = ["tree", f"num_class={self.num_class}",
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
        if self.num_tree_per_iteration != 1:
            raise NotImplementedError("lightgbm_tpu_torch does not support multiclass yet")
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
        self.num_init_iteration = len(self.models)
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
