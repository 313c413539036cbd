"""The port's training slice against the JAX package's fused trainer.

Both packages train on the same seeded numpy data: the JAX package with
LIGHTGBM_TPU_PGROW=force (the partitioned trainer, its Pallas kernels in
interpret mode on the CPU), the port on ``device="cpu"`` (the kernels'
plain PyTorch versions).  Binary logloss and weighted L2, 7 and 31 leaves.

- split features and thresholds in the model text: identical;
- predictions: rtol 3e-3 / atol 3e-4 (tests/test_pgrow.py:441 — the
  interpret-mode histograms are bf16 3-term sums, the port's exact f32);
- the port's level grower on and off: byte-identical model text;
- a JAX-written model loaded into the port predicts within 1e-6 of JAX.

The features the slice does not take yet raise NotImplementedError,
naming themselves.
"""

import os

import numpy as np
import pytest

import jax
import jax._src.core

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.convert import booster_from_model_string

ROUNDS = 4
CASES = [("binary", 7), ("binary", 31), ("l2_weighted", 7), ("l2_weighted", 31)]
IDS = [f"{o}-{L}" for o, L in CASES]


@pytest.fixture(scope="module", autouse=True)
def jax_trace_state_shim():
    """jax 0.9 moved ``trace_state_clean`` out of ``jax.core``, where the
    JAX package's compile watch imports it from; put it back for the
    duration of this module."""
    had = hasattr(jax.core, "trace_state_clean")
    if not had:
        jax.core.trace_state_clean = jax._src.core.trace_state_clean
    yield
    if not had:
        del jax.core.trace_state_clean


def _data(objective):
    if objective == "binary":
        rng = np.random.default_rng(0)
        X = rng.standard_normal((3000, 8)).astype(np.float32)
        w = rng.standard_normal(8)
        y = (rng.random(3000) < 1 / (1 + np.exp(-(X @ w)))).astype(np.float32)
        return X, y, None
    rng = np.random.default_rng(1)
    X = rng.standard_normal((2000, 6)).astype(np.float32)
    y = (X[:, 0] - 0.5 * X[:, 1] + 0.1 * rng.standard_normal(2000)).astype(np.float32)
    return X, y, (rng.random(2000) + 0.5).astype(np.float32)


def _params(objective, leaves):
    return dict(objective="binary" if objective == "binary" else "regression",
                num_leaves=leaves, learning_rate=0.2, max_bin=31, min_data_in_leaf=20,
                verbose=-1)


def _with_env(name, value, fn):
    old = os.environ.get(name)
    os.environ[name] = value
    try:
        return fn()
    finally:
        if old is None:
            del os.environ[name]
        else:
            os.environ[name] = old


@pytest.fixture(scope="module")
def trained():
    """{case: (X, jax booster, port booster, port booster, level grower off)},
    each case trained once for the module."""
    cache = {}

    def get(case):
        if case not in cache:
            objective, leaves = case
            X, y, w = _data(objective)
            params = _params(objective, leaves)
            jb = _with_env("LIGHTGBM_TPU_PGROW", "force", lambda: lgb.train(
                params, lgb.Dataset(X, label=y, weight=w), num_boost_round=ROUNDS))
            assert jb.boosting.ptrainer is not None, "the JAX reference left the fused path"
            tb = lgt.train(params, lgt.Dataset(X, label=y, weight=w), ROUNDS, device="cpu")
            tb0 = _with_env("LIGHTGBM_TPU_LEVELGROW", "0", lambda: lgt.train(
                params, lgt.Dataset(X, label=y, weight=w), ROUNDS, device="cpu"))
            cache[case] = (X, jb, tb, tb0)
        return cache[case]

    return get


def _split_lines(text):
    return [line for line in text.splitlines()
            if line.startswith(("Tree=", "num_leaves=", "split_feature=", "threshold=",
                                "decision_type=", "left_child=", "right_child="))]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_split_structure_matches_jax(trained, case):
    _, jb, tb, _ = trained(case)
    assert _split_lines(tb.model_to_string()) == _split_lines(jb.model_to_string())
    assert tb.num_trees == jb.num_trees


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_model_header_matches_jax(trained, case):
    _, jb, tb, _ = trained(case)
    head = [t.model_to_string().split("Tree=0")[0] for t in (jb, tb)]
    assert head[1] == head[0]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_predictions_match_jax(trained, case):
    X, jb, tb, _ = trained(case)
    np.testing.assert_allclose(tb.predict(X), jb.predict(X), rtol=3e-3, atol=3e-4)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_level_grower_on_off_byte_identical(trained, case):
    _, _, tb, tb0 = trained(case)
    assert tb.boosting.ptrainer.params.levelwise
    assert not tb0.boosting.ptrainer.params.levelwise
    assert tb0.model_to_string() == tb.model_to_string()


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_jax_model_loads_into_port(trained, case):
    X, jb, _, _ = trained(case)
    loaded = booster_from_model_string(jb.model_to_string(), device="cpu")
    np.testing.assert_allclose(loaded.predict(X), jb.predict(X), rtol=1e-6, atol=1e-6)
    # the text round-trips; feature_infos is written from a training set
    # only, by both packages
    def lines(text):
        return [ln for ln in text.splitlines() if not ln.startswith("feature_infos=")]

    assert lines(loaded.model_to_string()) == lines(jb.model_to_string())


DECLINED = [
    ("bagging", dict(bagging_fraction=0.5, bagging_freq=1), {}),
    ("feature_fraction<1", dict(feature_fraction=0.5), {}),
    ("boosting=goss", dict(boosting="goss"), {}),
    ("multiclass", dict(objective="multiclass", num_class=3), {}),
    ("quantized training", dict(use_quantized_grad=True), {}),
    ("linear trees", dict(linear_tree=True), {}),
    ("monotone constraints", dict(monotone_constraints=[1, 0, 0, 0]), {}),
    ("tree_learner=data", dict(tree_learner="data"), {}),
    ("out-of-core training", dict(out_of_core=True), {}),
    ("valid_sets", {}, dict(valid_sets="self")),
    ("callbacks", {}, dict(callbacks=[])),
]


@pytest.mark.parametrize("what,params,kwargs", DECLINED, ids=[d[0] for d in DECLINED])
def test_declined_feature_raises(what, params, kwargs):
    rng = np.random.default_rng(3)
    X = rng.standard_normal((500, 4))
    y = (rng.random(500) < 0.5).astype(np.float32)
    ds = lgt.Dataset(X, label=y)
    if kwargs.get("valid_sets") == "self":
        kwargs = dict(valid_sets=[ds])
    with pytest.raises(NotImplementedError, match=what):
        lgt.train(dict(dict(objective="binary", verbose=-1), **params), ds, 2, device="cpu",
                  **kwargs)


def test_efb_bundles_raise():
    """Mutually exclusive sparse columns bundle under EFB, which the slice
    declines."""
    rng = np.random.default_rng(4)
    cat = rng.integers(0, 12, 2000)
    X = np.zeros((2000, 12))
    X[np.arange(2000), cat] = rng.random(2000) + 1.0
    y = (cat < 6).astype(np.float32)
    with pytest.raises(NotImplementedError, match="EFB bundles"):
        lgt.train(dict(objective="binary", verbose=-1), lgt.Dataset(X, label=y), 2,
                  device="cpu")
