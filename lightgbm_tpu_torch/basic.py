"""User-facing Dataset and Booster — PyTorch counterpart of
lightgbm_tpu/basic.py (python-package/lightgbm/basic.py Dataset:551,
Booster:1176) for in-memory arrays."""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from .boosting import GBDT
from .config import Config
from .io.dataset import BinnedDataset
from .objective import create_objective, objective_from_string
from .utils.device import resolve_device
from .utils.log import Log


def _to_2d_float(data) -> np.ndarray:
    arr = np.asarray(data, dtype=np.float64)
    return arr.reshape(-1, 1) if arr.ndim == 1 else arr


class Dataset:
    """Lazily-constructed binned dataset over a dense float matrix."""

    def __init__(self, data, label=None, max_bin: Optional[int] = None,
                 reference: Optional["Dataset"] = None, weight=None, init_score=None,
                 feature_name="auto", categorical_feature="auto",
                 params: Optional[Dict[str, Any]] = None):
        if isinstance(data, str):
            raise NotImplementedError("lightgbm_tpu_torch does not load data files yet")
        self.data = _to_2d_float(data)
        self.label = label
        self.reference = reference
        self.weight = weight
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
            self.data, cfg, label=self.label, weight=self.weight, init_score=self.init_score,
            feature_names=names, categorical_features=cats, reference=ref)
        return self._constructed

    def num_data(self) -> int:
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
        self.boosting = GBDT(self.device)
        if train_set is not None:
            binned = train_set.construct(extra_params=self.params)
            self.train_dataset = train_set
            self.objective = create_objective(self.config)
            self.boosting.init(self.config, binned, self.objective)
        elif model_file is not None or model_str is not None:
            if model_file is not None:
                with open(model_file) as f:
                    model_str = f.read()
            self.boosting.config = self.config
            self.boosting.load_model_from_string(model_str)
            self.objective = objective_from_string(self.boosting.objective_name_loaded)
            self.boosting.objective = self.objective
            self.train_dataset = None
        else:
            Log.fatal("Booster needs a train_set, model_file or model_str")
        self.best_iteration = -1

    def update(self) -> bool:
        """One boosting iteration; True when training should stop."""
        return self.boosting.train_iters_partitioned(1)

    def current_iteration(self) -> int:
        return self.boosting.current_iteration()

    @property
    def num_trees(self) -> int:
        return self.boosting.num_trees

    def predict(self, data, num_iteration: int = -1, raw_score: bool = False) -> np.ndarray:
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
