"""scikit-learn API wrappers — PyTorch counterpart of lightgbm_tpu/sklearn.py
(python-package/lightgbm/sklearn.py LGBMModel:123, LGBMRegressor:468,
LGBMClassifier:491, LGBMRanker:582), including the custom-objective and
custom-metric adapters (sklearn.py:15-121).

The estimators follow scikit-learn's conventions (``get_params``,
``set_params``, ``fit``, ``predict``) without importing scikit-learn.
``device`` (``None``: the CUDA card) is a constructor argument that
``fit`` passes to ``train``; it never enters the booster's params.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np

from .basic import Booster, Dataset
from .engine import train
from .utils.log import Log


def _objective_function_wrapper(func: Callable):
    """Wrap sklearn-style fobj(y_true, y_pred[, group]) -> (grad, hess)
    into the engine's fobj(preds, dataset) (sklearn.py:15-80)."""

    def inner(preds, dataset):
        labels = dataset.get_label()
        argc = func.__code__.co_argcount
        if argc == 2:
            grad, hess = func(labels, preds)
        elif argc == 3:
            grad, hess = func(labels, preds, dataset.get_group())
        else:
            raise TypeError(f"Self-defined objective should have 2 or 3 arguments, got {argc}")
        return grad, hess

    return inner


def _eval_function_wrapper(func: Callable):
    """Wrap feval(y_true, y_pred[, weight[, group]]) ->
    (name, value, is_bigger_better) (sklearn.py:82-121)."""

    def inner(preds, dataset):
        labels = dataset.get_label()
        argc = func.__code__.co_argcount
        if argc == 2:
            return func(labels, preds)
        if argc == 3:
            return func(labels, preds, dataset.get_weight())
        if argc == 4:
            return func(labels, preds, dataset.get_weight(), dataset.get_group())
        raise TypeError(f"Self-defined eval function should have 2, 3 or 4 arguments, got {argc}")

    return inner


class LGBMModel:
    """Base sklearn-style estimator (sklearn.py:123-466)."""

    def __init__(
        self,
        boosting_type: str = "gbdt",
        num_leaves: int = 31,
        max_depth: int = -1,
        learning_rate: float = 0.1,
        n_estimators: int = 100,
        max_bin: int = 255,
        subsample_for_bin: int = 200000,
        objective: Optional[str] = None,
        min_split_gain: float = 0.0,
        min_child_weight: float = 1e-3,
        min_child_samples: int = 20,
        subsample: float = 1.0,
        subsample_freq: int = 0,
        colsample_bytree: float = 1.0,
        reg_alpha: float = 0.0,
        reg_lambda: float = 0.0,
        random_state: int = 0,
        n_jobs: int = -1,
        silent: bool = True,
        device=None,
        **kwargs,
    ):
        self.boosting_type = boosting_type
        self.num_leaves = num_leaves
        self.max_depth = max_depth
        self.learning_rate = learning_rate
        self.n_estimators = n_estimators
        self.max_bin = max_bin
        self.subsample_for_bin = subsample_for_bin
        self.objective = objective
        self.min_split_gain = min_split_gain
        self.min_child_weight = min_child_weight
        self.min_child_samples = min_child_samples
        self.subsample = subsample
        self.subsample_freq = subsample_freq
        self.colsample_bytree = colsample_bytree
        self.reg_alpha = reg_alpha
        self.reg_lambda = reg_lambda
        self.random_state = random_state
        self.n_jobs = n_jobs
        self.silent = silent
        self.device = device
        self._other_params: Dict[str, Any] = dict(kwargs)
        self._Booster: Optional[Booster] = None
        self._evals_result: Optional[dict] = None
        self._best_iteration = -1
        self._classes = None
        self._n_classes = -1

    _default_objective = "regression"

    # -- sklearn plumbing ------------------------------------------------
    def get_params(self, deep: bool = True) -> Dict[str, Any]:
        params = {
            "boosting_type": self.boosting_type,
            "num_leaves": self.num_leaves,
            "max_depth": self.max_depth,
            "learning_rate": self.learning_rate,
            "n_estimators": self.n_estimators,
            "max_bin": self.max_bin,
            "subsample_for_bin": self.subsample_for_bin,
            "objective": self.objective,
            "min_split_gain": self.min_split_gain,
            "min_child_weight": self.min_child_weight,
            "min_child_samples": self.min_child_samples,
            "subsample": self.subsample,
            "subsample_freq": self.subsample_freq,
            "colsample_bytree": self.colsample_bytree,
            "reg_alpha": self.reg_alpha,
            "reg_lambda": self.reg_lambda,
            "random_state": self.random_state,
            "n_jobs": self.n_jobs,
            "silent": self.silent,
            "device": self.device,
        }
        params.update(self._other_params)
        return params

    def set_params(self, **params) -> "LGBMModel":
        for key, value in params.items():
            if hasattr(self, key):
                setattr(self, key, value)
            else:
                self._other_params[key] = value
        return self

    def _booster_params(self, objective_override: Optional[str] = None):
        objective = objective_override if objective_override else self.objective
        fobj = None
        if callable(objective):
            fobj = _objective_function_wrapper(objective)
            objective = "none"
        elif objective is None:
            objective = self._default_objective
        params = {
            "boosting_type": self.boosting_type,
            "objective": objective,
            "num_leaves": self.num_leaves,
            "max_depth": self.max_depth,
            "learning_rate": self.learning_rate,
            "max_bin": self.max_bin,
            "bin_construct_sample_cnt": self.subsample_for_bin,
            "min_gain_to_split": self.min_split_gain,
            "min_sum_hessian_in_leaf": self.min_child_weight,
            "min_data_in_leaf": self.min_child_samples,
            "bagging_fraction": self.subsample,
            "bagging_freq": self.subsample_freq,
            "feature_fraction": self.colsample_bytree,
            "lambda_l1": self.reg_alpha,
            "lambda_l2": self.reg_lambda,
            "seed": self.random_state if self.random_state is not None else 0,
            "verbose": 0 if self.silent else 1,
        }
        params.update(self._other_params)
        return params, fobj

    # -- core fit --------------------------------------------------------
    def fit(
        self,
        X,
        y,
        sample_weight=None,
        init_score=None,
        group=None,
        eval_set=None,
        eval_names=None,
        eval_sample_weight=None,
        eval_init_score=None,
        eval_group=None,
        eval_metric=None,
        early_stopping_rounds=None,
        verbose=False,
        feature_name="auto",
        categorical_feature="auto",
        callbacks=None,
        _objective_override=None,
        _extra_params=None,
    ) -> "LGBMModel":
        params, fobj = self._booster_params(_objective_override)
        if _extra_params:
            params.update(_extra_params)
        feval = _eval_function_wrapper(eval_metric) if callable(eval_metric) else None
        if eval_metric is not None and not callable(eval_metric):
            params["metric"] = eval_metric

        train_ds = Dataset(
            X, label=y, weight=sample_weight, group=group, init_score=init_score,
            params=params, feature_name=feature_name,
            categorical_feature=categorical_feature,
        )
        valid_sets = []
        valid_names = []
        if eval_set is not None:
            if isinstance(eval_set, tuple):
                eval_set = [eval_set]
            for i, (vx, vy) in enumerate(eval_set):
                if vx is X and vy is y:
                    valid_sets.append(train_ds)
                else:
                    vw = eval_sample_weight[i] if eval_sample_weight else None
                    vg = eval_group[i] if eval_group else None
                    vi = eval_init_score[i] if eval_init_score else None
                    valid_sets.append(
                        Dataset(vx, label=vy, weight=vw, group=vg, init_score=vi,
                                reference=train_ds, params=params)
                    )
                valid_names.append(
                    eval_names[i] if eval_names and i < len(eval_names) else f"valid_{i}"
                )
        self._evals_result = {}
        self._Booster = train(
            params,
            train_ds,
            num_boost_round=self.n_estimators,
            valid_sets=valid_sets or None,
            valid_names=valid_names or None,
            fobj=fobj,
            feval=feval,
            early_stopping_rounds=early_stopping_rounds,
            evals_result=self._evals_result,
            verbose_eval=verbose,
            callbacks=callbacks,
            device=self.device,
        )
        self._best_iteration = self._Booster.best_iteration
        return self

    def predict(self, X, raw_score: bool = False, num_iteration: int = -1):
        if self._Booster is None:
            Log.fatal("Estimator not fitted, call fit before predict")
        return self._Booster.predict(X, raw_score=raw_score, num_iteration=num_iteration)

    @property
    def booster_(self) -> Booster:
        return self._Booster

    @property
    def best_iteration_(self) -> int:
        return self._best_iteration

    @property
    def evals_result_(self) -> dict:
        return self._evals_result

    @property
    def feature_importances_(self) -> np.ndarray:
        return self._Booster.feature_importance()

    @property
    def n_features_(self) -> int:
        return self._Booster.boosting.max_feature_idx + 1


class LGBMRegressor(LGBMModel):
    _default_objective = "regression"


class LGBMClassifier(LGBMModel):
    _default_objective = "binary"

    def fit(self, X, y, **kwargs):
        y = np.asarray(y)
        self._classes, y_enc = np.unique(y, return_inverse=True)
        self._n_classes = len(self._classes)
        # fit-local overrides only — constructor params stay untouched so
        # refitting on different data / sklearn clone() behave correctly
        if self._n_classes > 2:
            override = None
            if self.objective is None or self.objective == "binary":
                override = "multiclass"
            super().fit(X, y_enc, _objective_override=override,
                        _extra_params={"num_class": self._n_classes}, **kwargs)
        else:
            super().fit(X, y_enc, **kwargs)
        return self

    def predict(self, X, raw_score: bool = False, num_iteration: int = -1):
        prob = self.predict_proba(X, raw_score=raw_score, num_iteration=num_iteration)
        if raw_score:
            return prob
        if prob.ndim == 1:
            idx = (prob > 0.5).astype(np.int64)
        else:
            idx = np.argmax(prob, axis=1)
        return self._classes[idx]

    def predict_proba(self, X, raw_score: bool = False, num_iteration: int = -1):
        out = self._Booster.predict(X, raw_score=raw_score, num_iteration=num_iteration)
        if not raw_score and out.ndim == 1:
            # binary: (N, 2) column convention (sklearn.py predict_proba)
            return np.vstack([1.0 - out, out]).T
        return out

    @property
    def classes_(self):
        return self._classes

    @property
    def n_classes_(self) -> int:
        return self._n_classes


class LGBMRanker(LGBMModel):
    _default_objective = "lambdarank"

    def fit(self, X, y, group=None, **kwargs):
        if group is None:
            Log.fatal("Should set group for ranking task")
        super().fit(X, y, group=group, **kwargs)
        return self
