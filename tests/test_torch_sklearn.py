"""The port's scikit-learn-style estimators against the JAX package's, on
the CPU: ``get_params`` / ``set_params``, ``LGBMRegressor``,
``LGBMClassifier`` (binary, 3 classes, string labels), ``LGBMRanker``,
the custom objective and metric adapters, ``eval_set`` with early
stopping, and GOSS and DART through ``boosting_type``.

Both packages train on the same seeded numpy data, on the mask grower
(LIGHTGBM_TPU_PGROW=0) unless a test names the fused path ("force").
Split lines identical and predictions within 3e-3, as for ``train``.
"""

import os

import numpy as np
import pytest

import jax
import jax._src.core

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt

KW = dict(n_estimators=4, num_leaves=15, learning_rate=0.3, max_bin=31, verbose=-1)


@pytest.fixture(scope="module", autouse=True)
def jax_mask_grower():
    """LIGHTGBM_TPU_PGROW=0 for both packages, and the jax 0.9
    ``trace_state_clean`` shim the JAX package's compile watch needs."""
    had = hasattr(jax.core, "trace_state_clean")
    if not had:
        jax.core.trace_state_clean = jax._src.core.trace_state_clean
    old = os.environ.get("LIGHTGBM_TPU_PGROW")
    os.environ["LIGHTGBM_TPU_PGROW"] = "0"
    yield
    if old is None:
        del os.environ["LIGHTGBM_TPU_PGROW"]
    else:
        os.environ["LIGHTGBM_TPU_PGROW"] = old
    if not had:
        del jax.core.trace_state_clean


def _data(seed=0, n=2000, classes=2):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, 8))
    if classes == 2:
        y = (rng.random(n) < 1 / (1 + np.exp(-(X @ rng.standard_normal(8))))).astype(np.int64)
    else:
        y = np.argmax(X[:, :classes] + 0.3 * rng.standard_normal((n, classes)), axis=1)
    return X, y


def _split_lines(text):
    return [ln for ln in text.splitlines()
            if ln.startswith(("Tree=", "num_leaves=", "split_feature=", "threshold=",
                              "decision_type=", "left_child=", "right_child="))]


def _same_model(tm, jm):
    assert (_split_lines(tm.booster_.model_to_string())
            == _split_lines(jm.booster_.model_to_string()))


@pytest.mark.parametrize("name", ["LGBMModel", "LGBMRegressor", "LGBMClassifier",
                                  "LGBMRanker"])
def test_get_set_params_match_jax(name):
    tm = getattr(lgt, name)(num_leaves=7, extra_param=3, device="cpu")
    jm = getattr(lgb, name)(num_leaves=7, extra_param=3)
    tp = tm.get_params()
    assert tp.pop("device") == "cpu"
    assert tp == jm.get_params()
    tm.set_params(learning_rate=0.5, other=1, device="cuda")
    jm.set_params(learning_rate=0.5, other=1)
    tp = tm.get_params()
    assert tp.pop("device") == "cuda" and tm.device == "cuda"
    assert tp == jm.get_params()
    # the device never enters the booster's params
    params, _ = tm._booster_params()
    assert "device" not in params and params == jm._booster_params()[0]


@pytest.mark.parametrize("pgrow", ["0", "force"], ids=["mask", "fused"])
def test_regressor_matches_jax(pgrow, monkeypatch):
    monkeypatch.setenv("LIGHTGBM_TPU_PGROW", pgrow)
    X, _ = _data(1)
    y = X[:, 0] - 0.5 * X[:, 1] + 0.1 * np.random.default_rng(1).standard_normal(len(X))
    tm = lgt.LGBMRegressor(device="cpu", **KW).fit(X, y)
    jm = lgb.LGBMRegressor(**KW).fit(X, y)
    assert (tm.booster_.boosting.ptrainer is not None) == (pgrow == "force")
    _same_model(tm, jm)
    np.testing.assert_allclose(tm.predict(X), jm.predict(X), rtol=3e-3, atol=3e-4)
    np.testing.assert_array_equal(tm.feature_importances_, jm.feature_importances_)
    assert tm.n_features_ == jm.n_features_ == 8


@pytest.mark.parametrize("labels", ["binary", "multiclass", "strings"])
def test_classifier_matches_jax(labels):
    X, y = _data(2, classes=2 if labels == "binary" else 3)
    if labels == "strings":
        y = np.asarray(["cat", "dog", "emu"])[y]
    tm = lgt.LGBMClassifier(device="cpu", **KW).fit(X, y)
    jm = lgb.LGBMClassifier(**KW).fit(X, y)
    _same_model(tm, jm)
    np.testing.assert_array_equal(tm.classes_, jm.classes_)
    assert tm.n_classes_ == jm.n_classes_
    tp, jp = tm.predict_proba(X), jm.predict_proba(X)
    assert tp.shape == jp.shape == (len(X), tm.n_classes_)
    np.testing.assert_allclose(tp, jp, rtol=3e-3, atol=3e-4)
    np.testing.assert_allclose(tm.predict(X, raw_score=True), jm.predict(X, raw_score=True),
                               rtol=3e-3, atol=3e-4)
    assert np.mean(tm.predict(X) == jm.predict(X)) > 0.99
    assert set(np.unique(tm.predict(X))) <= set(tm.classes_)


def test_ranker_matches_jax():
    rng = np.random.default_rng(3)
    X = rng.standard_normal((1500, 6))
    y = np.clip((X[:, 0] + 0.5 * rng.standard_normal(1500)).round() + 1, 0, 3)
    group = np.full(30, 50)
    tm = lgt.LGBMRanker(device="cpu", **KW).fit(X, y, group=group)
    jm = lgb.LGBMRanker(**KW).fit(X, y, group=group)
    _same_model(tm, jm)
    np.testing.assert_allclose(tm.predict(X), jm.predict(X), rtol=3e-3, atol=3e-4)
    with pytest.raises(lgt.LightGBMError, match="group"):
        lgt.LGBMRanker(device="cpu", **KW).fit(X, y)


def _obj2(y_true, y_pred):
    return y_pred - y_true, np.ones_like(y_pred)


def _obj3(y_true, y_pred, group):
    assert group is None
    return 2.0 * (y_pred - y_true), np.full_like(y_pred, 2.0)


def _eval2(y_true, y_pred):
    return "mae2", float(np.mean(np.abs(y_pred - y_true))), False


def _eval3(y_true, y_pred, weight):
    return "wmae3", float(np.average(np.abs(y_pred - y_true), weights=weight)), False


def _eval4(y_true, y_pred, weight, group):
    assert group is None
    return "max4", float(np.max(np.abs(y_pred - y_true))), False


@pytest.mark.parametrize("fobj,feval", [(_obj2, _eval2), (_obj3, _eval3), (_obj2, _eval4)],
                         ids=["2-args", "3-args", "4-args"])
def test_custom_objective_and_metric_adapters(fobj, feval):
    X, _ = _data(4)
    y = X[:, 0] + 0.5 * X[:, 2]
    w = np.random.default_rng(4).random(len(X)) + 0.5
    kw = dict(eval_set=[(X[:500], y[:500])], eval_sample_weight=[w[:500]],
              eval_metric=feval)
    tm = lgt.LGBMRegressor(objective=fobj, device="cpu", **KW).fit(X, y, **kw)
    jm = lgb.LGBMRegressor(objective=fobj, **KW).fit(X, y, **kw)
    _same_model(tm, jm)
    np.testing.assert_allclose(tm.predict(X), jm.predict(X), rtol=3e-3, atol=3e-4)
    name = feval(y[:2], y[:2], *([w[:2]] if feval is not _eval2 else []),
                 *([None] if feval is _eval4 else []))[0]
    np.testing.assert_allclose(tm.evals_result_["valid_0"][name],
                               jm.evals_result_["valid_0"][name], rtol=3e-3, atol=3e-4)


def test_eval_set_early_stopping_matches_jax():
    X, y = _data(5)
    Xv, yv = _data(6, n=600)
    kw = dict(eval_set=[(Xv, yv), (X, y)], eval_names=["held", "train"],
              eval_metric="binary_logloss", early_stopping_rounds=2)
    params = dict(KW, n_estimators=40, learning_rate=0.8, num_leaves=31, min_child_samples=2)
    tm = lgt.LGBMClassifier(device="cpu", **params).fit(X, y, **kw)
    jm = lgb.LGBMClassifier(**params).fit(X, y, **kw)
    assert 0 < tm.best_iteration_ == jm.best_iteration_ < 40
    assert sorted(tm.evals_result_) == sorted(jm.evals_result_) == ["held", "train"]
    for name in ("held", "train"):
        t, j = tm.evals_result_[name], jm.evals_result_[name]
        assert sorted(t) == sorted(j)
        for metric in j:
            np.testing.assert_allclose(t[metric], j[metric], rtol=3e-3, atol=3e-4)
    np.testing.assert_allclose(tm.predict_proba(Xv, num_iteration=tm.best_iteration_),
                               jm.predict_proba(Xv, num_iteration=jm.best_iteration_),
                               rtol=3e-3, atol=3e-4)


@pytest.mark.parametrize("boosting", ["goss", "dart"])
def test_boosting_types_match_jax(boosting):
    X, y = _data(7)
    params = dict(KW, boosting_type=boosting, n_estimators=6)
    tm = lgt.LGBMClassifier(device="cpu", **params).fit(X, y)
    jm = lgb.LGBMClassifier(**params).fit(X, y)
    assert type(tm.booster_.boosting).__name__ == boosting.upper()
    _same_model(tm, jm)
    np.testing.assert_allclose(tm.predict_proba(X), jm.predict_proba(X), rtol=3e-3, atol=3e-4)
