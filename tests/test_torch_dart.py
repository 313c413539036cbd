"""DART and prediction early stopping in the port against the JAX package,
on the CPU.

DART runs on the mask grower in both packages (LIGHTGBM_TPU_PGROW=0 here
as well).  Per iteration the drop indices must be identical (both draw
from the reference's LCG seeded with drop_seed), the tree weights equal
within float rounding, the split lines identical and the predictions
within 3e-3; in the default mode, ``uniform_drop`` and
``xgboost_dart_mode``, with a validation set whose scores follow the
normalization.  ``pred_early_stop`` reads the same model text in both
packages and must give the JAX package's ``predict_with_early_stop``
raw numbers exactly (the converted ones within 1e-6, the objectives'
float32 conversion), for binary, multiclass and a model whose test is
"none".  A DART model's text loads across the packages.
"""

import os

import numpy as np
import pytest

import jax
import jax._src.core

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.boosting import pred_early_stop as jpes
from lightgbm_tpu_torch.boosting import pred_early_stop as tpes

ROUNDS = 6
PARAMS = dict(objective="binary", boosting="dart", num_leaves=15, learning_rate=0.3,
              max_bin=31, min_data_in_leaf=20, drop_rate=0.5, skip_drop=0.2, verbose=-1)
MODES = {"default": {}, "uniform_drop": dict(uniform_drop=True),
         "xgboost_dart_mode": dict(xgboost_dart_mode=True),
         "multiclass": dict(objective="multiclass", num_class=3)}


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


def _data(multiclass=False, seed=0, n=2000):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, 8))
    if multiclass:
        y = np.argmax(X[:, :3] + 0.3 * rng.standard_normal((n, 3)), axis=1)
    else:
        y = rng.random(n) < 1 / (1 + np.exp(-(X @ rng.standard_normal(8))))
    return X, y.astype(np.float32)


def _split_lines(text):
    return [ln for ln in text.splitlines()
            if ln.startswith(("Tree=", "num_leaves=", "split_feature=", "threshold=",
                              "decision_type=", "left_child=", "right_child="))]


def _train_by_iteration(mod, params, X, y, **kw):
    """Train ROUNDS iterations one update at a time with a validation set;
    returns (booster, the drop indices of each iteration, the validation
    scores after the last)."""
    ds = mod.Dataset(X, label=y)
    b = mod.Booster(params=params, train_set=ds, **kw)
    b.add_valid(mod.Dataset(X[:600], label=y[:600], reference=ds), "valid")
    drops = []
    for _ in range(ROUNDS):
        b.update()
        drops.append(list(b.boosting.drop_index))
    return b, drops, np.array(b.boosting.valid_scores[0])


@pytest.fixture(scope="module")
def trained():
    cache = {}

    def get(mode):
        if mode not in cache:
            params = dict(PARAMS, **MODES[mode])
            X, y = _data(multiclass=mode == "multiclass")
            cache[mode] = (X, _train_by_iteration(lgb, params, X, y),
                           _train_by_iteration(lgt, params, X, y, device="cpu"))
        return cache[mode]

    return get


@pytest.mark.parametrize("mode", list(MODES))
def test_drop_indices_equal_jax(trained, mode):
    _, (jb, jdrops, _), (tb, tdrops, _) = trained(mode)
    assert tb.boosting.ptrainer is None
    assert tdrops == jdrops
    assert sum(len(d) for d in tdrops) > 0, "no tree was dropped"
    np.testing.assert_allclose(tb.boosting.tree_weight, jb.boosting.tree_weight,
                               rtol=1e-12, atol=0)
    assert tb.boosting.sum_weight == pytest.approx(jb.boosting.sum_weight, rel=1e-12)


@pytest.mark.parametrize("mode", list(MODES))
def test_dart_model_matches_jax(trained, mode):
    X, (jb, _, jvalid), (tb, _, tvalid) = trained(mode)
    assert _split_lines(tb.model_to_string()) == _split_lines(jb.model_to_string())
    np.testing.assert_allclose(tb.predict(X), jb.predict(X), rtol=3e-3, atol=3e-4)
    np.testing.assert_allclose(tvalid, jvalid, rtol=3e-3, atol=3e-4)
    # the training scores follow the normalized trees
    np.testing.assert_allclose(tb.boosting.scores.numpy(), np.asarray(jb.boosting.scores),
                               rtol=3e-3, atol=3e-4)
    # the normalization leaves the validation scores equal to a fresh
    # prediction of the validation rows
    raw = tb.predict(X[:600], raw_score=True)
    np.testing.assert_allclose(tvalid, raw.reshape(len(raw), -1).T, rtol=1e-5, atol=1e-5)


def test_dart_model_text_crosses_packages(trained):
    X, (jb, _, _), (tb, _, _) = trained("default")
    from_jax = lgt.Booster(model_str=jb.model_to_string(), device="cpu")
    np.testing.assert_allclose(from_jax.predict(X), jb.predict(X), rtol=1e-6, atol=1e-6)
    from_port = lgb.Booster(model_str=tb.model_to_string())
    np.testing.assert_allclose(from_port.predict(X), tb.predict(X), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# prediction early stopping on the same model text
@pytest.fixture(scope="module")
def models():
    X, y = _data(seed=3)
    Xm, ym = _data(multiclass=True, seed=4)
    base = dict(num_leaves=15, learning_rate=0.3, max_bin=31, verbose=-1)
    return {
        "binary": (lgb.train(dict(base, objective="binary"), lgb.Dataset(X, label=y),
                             12).model_to_string(), X),
        "multiclass": (lgb.train(dict(base, objective="multiclass", num_class=3),
                                 lgb.Dataset(Xm, label=ym), 8).model_to_string(), Xm),
        "none": (lgb.train(dict(base, objective="regression"),
                           lgb.Dataset(X, label=X[:, 0] + y), 6).model_to_string(), X),
    }


PES_CASES = [("binary", 1, 0.5), ("binary", 5, 1.0), ("binary", 3, 100.0),
             ("multiclass", 2, 0.5), ("multiclass", 4, 1.0), ("none", 2, 0.1)]


@pytest.mark.parametrize("kind,freq,margin", PES_CASES,
                         ids=[f"{k}-{f}-{m}" for k, f, m in PES_CASES])
def test_pred_early_stop_equals_jax(models, kind, freq, margin):
    text, X = models[kind]
    Xn = X.copy()
    Xn[::17, 2] = np.nan
    params = dict(pred_early_stop=True, pred_early_stop_freq=freq,
                  pred_early_stop_margin=margin)
    jb = lgb.Booster(params=params, model_str=text)
    tb = lgt.Booster(model_str=text, device="cpu")
    np.testing.assert_array_equal(tb.predict(Xn[:400], raw_score=True, **params),
                                  jb.predict(Xn[:400], raw_score=True))
    # the objective's float32 conversion (XLA's exp against torch's): 1e-6
    np.testing.assert_allclose(tb.predict(Xn[:400], **params), jb.predict(Xn[:400]),
                               rtol=1e-6, atol=1e-6)
    # the JAX package's host loop, row by row, on its booster
    inst = jpes.create_prediction_early_stop_instance(
        tpes.early_stop_type(tb.boosting.num_tree_per_iteration, tb.boosting.objective),
        freq, margin)
    ref = jpes.predict_with_early_stop(jb.boosting, Xn[:400], inst)
    got = tb.predict(Xn[:400], raw_score=True, **params)
    np.testing.assert_array_equal(got, ref[:, 0] if ref.shape[1] == 1 else ref)
    full = tb.predict(Xn[:400], raw_score=True)
    stopped = np.any(np.abs(np.atleast_2d(got.T) - np.atleast_2d(full.T)) > 1e-6, axis=0)
    if kind == "none" or margin >= 100.0:
        assert not stopped.any()
    else:
        assert stopped.any()


def test_pred_early_stop_from_booster_params(models):
    """The booster's own params switch the early stop on, as in the JAX
    package; a call's keyword overrides them."""
    text, X = models["binary"]
    params = dict(pred_early_stop=True, pred_early_stop_freq=1, pred_early_stop_margin=0.5)
    tb = lgt.Booster(params=params, model_str=text, device="cpu")
    jb = lgb.Booster(params=params, model_str=text)
    np.testing.assert_array_equal(tb.predict(X[:300], raw_score=True),
                                  jb.predict(X[:300], raw_score=True))
    np.testing.assert_array_equal(tb.predict(X[:300], pred_early_stop=False),
                                  lgt.Booster(model_str=text, device="cpu").predict(X[:300]))
