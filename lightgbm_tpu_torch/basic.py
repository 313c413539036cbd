"""User-facing Dataset and Booster — PyTorch counterpart of
lightgbm_tpu/basic.py (python-package/lightgbm/basic.py Dataset:551,
Booster:1176) for in-memory arrays.  A validation Dataset built with
``reference=`` bins with the training set's mappers and is evaluated on
its unbundled bins."""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from .boosting import create_boosting
from .config import Config
from .io.dataset import BinnedDataset
from .metric import create_metric, metric_names_for_objective
from .objective import create_objective, objective_from_string
from .utils.device import resolve_device
from .utils.log import Log


def _to_2d_float(data) -> np.ndarray:
    arr = np.asarray(data, dtype=np.float64)
    return arr.reshape(-1, 1) if arr.ndim == 1 else arr


class Dataset:
    """Lazily-constructed binned dataset over a dense float matrix."""

    def __init__(self, data, label=None, max_bin: Optional[int] = None,
                 reference: Optional["Dataset"] = None, weight=None, group=None,
                 init_score=None, feature_name="auto", categorical_feature="auto",
                 params: Optional[Dict[str, Any]] = None):
        if isinstance(data, str):
            raise NotImplementedError("lightgbm_tpu_torch does not load data files yet")
        self.data = _to_2d_float(data)
        self.label = label
        self.reference = reference
        self.weight = weight
        self.group = group  # per-query sizes of a ranking task
        self.init_score = init_score
        self.params = dict(params) if params else {}
        if max_bin is not None:
            self.params.setdefault("max_bin", max_bin)
        self.feature_name = feature_name
        self.categorical_feature = categorical_feature
        self._constructed: Optional[BinnedDataset] = None

    def construct(self, extra_params: Optional[Dict[str, Any]] = None) -> BinnedDataset:
        """Build (or return) the binned dataset; ``extra_params`` (booster
        params) fill gaps, the Dataset's own params win."""
        if self._constructed is not None:
            return self._constructed
        merged = dict(extra_params) if extra_params else {}
        merged.update(self.params)
        cfg = Config.from_params({k: v for k, v in merged.items() if k != "categorical_feature"})
        names = None
        if self.feature_name != "auto" and self.feature_name is not None:
            names = list(self.feature_name)
        cats: Optional[Sequence[int]] = None
        if self.categorical_feature != "auto" and self.categorical_feature:
            cats = []
            for c in self.categorical_feature:
                if isinstance(c, str):
                    if names and c in names:
                        cats.append(names.index(c))
                    else:
                        Log.fatal("Unknown categorical feature %s", c)
                else:
                    cats.append(int(c))
        ref = self.reference.construct() if self.reference is not None else None
        self._constructed = BinnedDataset.from_raw(
            self.data, cfg, label=self.label, weight=self.weight, group=self.group,
            init_score=self.init_score, feature_names=names, categorical_features=cats,
            reference=ref)
        return self._constructed

    def set_group(self, group) -> "Dataset":
        """Per-query sizes of a ranking task (Metadata::SetQuery)."""
        self.group = group
        if self._constructed is not None:
            self._constructed.metadata.set_query(group)
        return self

    def get_group(self):
        return None if self.group is None else np.asarray(self.group)

    def get_label(self):
        if self._constructed is not None:
            return np.asarray(self._constructed.metadata.label)
        return None if self.label is None else np.asarray(self.label)

    def get_weight(self):
        if self._constructed is not None:
            w = self._constructed.metadata.weights
        else:
            w = self.weight
        return None if w is None else np.asarray(w)

    @classmethod
    def _of_binned(cls, binned: BinnedDataset) -> "Dataset":
        """A constructed Dataset over ``binned`` (no raw data): what a
        custom metric receives for a validation set."""
        ds = cls.__new__(cls)
        ds.data = None
        ds._constructed = binned
        qb = binned.metadata.query_boundaries
        ds.group = None if qb is None else np.diff(qb)
        return ds

    def num_data(self) -> int:
        if self._constructed is not None:
            return self._constructed.num_data
        return self.data.shape[0]

    def num_feature(self) -> int:
        return self.data.shape[1]


class Booster:
    """Training/prediction handle (basic.py:1176 Booster)."""

    def __init__(self, params: Optional[Dict[str, Any]] = None,
                 train_set: Optional[Dataset] = None, model_file: Optional[str] = None,
                 model_str: Optional[str] = None, device=None):
        self.params = dict(params) if params else {}
        self.device = resolve_device(device)
        self.config = Config.from_params(self.params)
        self.best_iteration = -1
        self.best_score: Dict[str, Dict[str, float]] = {}
        self._name_to_index: Dict[str, int] = {}
        if train_set is not None:
            binned = train_set.construct(extra_params=self.params)
            self.train_dataset = train_set
            self.objective = create_objective(self.config)
            self.boosting = create_boosting(self.config.boosting_type, self.device)
            # training metrics only when asked (is_provide_training_metric);
            # the engine evaluates "training" as a validation set instead
            training_metrics = (self._make_metrics(binned) if self.config.is_training_metric
                                else [])
            self.boosting.init(self.config, binned, self.objective, training_metrics)
            self._num_datasets = 1
        elif model_file is not None or model_str is not None:
            self.boosting = create_boosting("gbdt", self.device)
            if model_file is not None:
                with open(model_file) as f:
                    model_str = f.read()
            self.boosting.config = self.config
            self.boosting.load_model_from_string(model_str)
            self.objective = objective_from_string(self.boosting.objective_name_loaded)
            self.boosting.objective = self.objective
            self.train_dataset = None
            self._num_datasets = 0
        else:
            Log.fatal("Booster needs a train_set, model_file or model_str")

    def _make_metrics(self, binned):
        """The configured metrics (the objective's name when none is set),
        bound to ``binned``'s labels and weights; unknown names warn."""
        names = self.config.metric or metric_names_for_objective(self.config.objective)
        metrics = []
        for name in names:
            if name.lower() in ("none", "null", ""):
                continue
            m = create_metric(name, self.config)
            if m is None:
                Log.warning("Unknown metric %s", name)
                continue
            m.init(binned.metadata, binned.num_data)
            metrics.append(m)
        return metrics

    def add_valid(self, data: Dataset, name: str) -> "Booster":
        """Evaluate ``data`` (built with ``reference=`` the training
        Dataset) under ``name`` after every iteration."""
        binned = data.construct()
        self.boosting.add_valid(binned, self._make_metrics(binned), name)
        self._name_to_index[name] = self._num_datasets
        self._num_datasets += 1
        return self

    def update(self, train_set: Optional[Dataset] = None, fobj=None) -> bool:
        """One boosting iteration; True when training should stop.  With
        a custom objective ``fobj(preds, train_set) -> (grad, hess)``
        (LGBM_BoosterUpdateOneIterCustom), ``preds`` are the raw training
        scores, (N,) or class-major (K*N,), and the iteration trains on
        the gradients it returns."""
        if fobj is None:
            return self.boosting.train_iters(1)
        grad, hess = fobj(self._raw_train_scores(), self.train_dataset)
        return self.boosting.train_one_iter_custom(grad, hess)

    def _raw_train_scores(self) -> np.ndarray:
        sc = self.boosting.train_score_host()
        return sc[0] if sc.shape[0] == 1 else sc.reshape(-1)

    def current_iteration(self) -> int:
        return self.boosting.current_iteration()

    @property
    def num_trees(self) -> int:
        return self.boosting.num_trees

    # ------------------------------------------------------------------
    def eval_train(self, feval=None):
        """[(data name, metric name, value, bigger_is_better), ...] of the
        training set's metrics, then of ``feval``'s."""
        return self._inner_eval("training", 0, feval)

    def eval_valid(self, feval=None):
        """The same for every validation set, in the order added."""
        out = []
        for name, idx in self._name_to_index.items():
            out.extend(self._inner_eval(name, idx, feval))
        return out

    def eval(self, data: Dataset, name: str, feval=None):
        """The metrics of the validation set added as ``name``."""
        if name not in self._name_to_index:
            Log.fatal("Dataset %s was not added with add_valid", name)
        return self._inner_eval(name, self._name_to_index[name], feval)

    def _inner_eval(self, data_name: str, data_idx: int, feval=None):
        """The configured metrics, then a custom ``feval(preds, data) ->
        (name, value, bigger_is_better)`` (or a list of them) on the raw
        scores, (N,) or class-major (K*N,)."""
        results = [(data_name, name, val, bigger)
                   for name, val, bigger in self.boosting.get_eval_at(data_idx)]
        if feval is not None:
            if data_idx == 0:
                preds, fdata = self._raw_train_scores(), self.train_dataset
            else:
                sc = self.boosting.valid_score_host(data_idx - 1)
                preds = sc[0] if sc.shape[0] == 1 else sc.reshape(-1)
                fdata = Dataset._of_binned(self.boosting.valid_sets[data_idx - 1])
            ret = feval(preds, fdata)
            for name, val, bigger in [ret] if isinstance(ret, tuple) else ret:
                results.append((data_name, name, val, bigger))
        return results

    # ------------------------------------------------------------------
    def predict(self, data, num_iteration: int = -1,
                raw_score: bool = False) -> np.ndarray:
        """Predictions of the first ``num_iteration`` iterations; -1 (the
        default) takes every tree the booster holds, also after early
        stopping, as the JAX package's ``Booster.predict`` does; pass
        ``num_iteration=bst.best_iteration`` for the best iteration's."""
        return self.boosting.predict(_to_2d_float(data), num_iteration=num_iteration,
                                     raw_score=raw_score)

    def save_model(self, filename: str, num_iteration: int = -1) -> "Booster":
        with open(filename, "w") as f:
            f.write(self.model_to_string(num_iteration))
        return self

    def model_to_string(self, num_iteration: int = -1) -> str:
        return self.boosting.save_model_to_string(num_iteration)

    def feature_name(self) -> List[str]:
        return list(self.boosting.feature_names)
