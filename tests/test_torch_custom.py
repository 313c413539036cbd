"""Custom objectives and metrics (``fobj``, ``feval``) in lightgbm_tpu_torch
against the JAX package's.

Both packages train the same seeded numpy data with the same ``fobj``
and ``feval``; with ``fobj`` the objective defaults to ``none`` and both
train on the mask grower.  Held:

- gradients on a dyadic grid (multiples of 1/64, so every histogram sum
  is exact in both packages): the same model text and the same
  ``evals_result`` of ``feval`` (training and a validation set), bit
  for bit;
- the unrounded logistic gradients with ``feval`` beside a configured
  metric (l2): the same split lines, and ``evals_result`` within 1e-6
  (the JAX mask grower's float32 histogram sums against the port's
  correctly rounded ones; the JAX l2 sums in float32 on the device, the
  port's in float64, tests/test_torch_valid.py);
- three classes from a class-major (K*N,) ``fobj``: the same model text;
- ``Booster.update(fobj=...)``, ``eval_train`` / ``eval_valid`` /
  ``eval`` with ``feval`` (one tuple or a list), and the raw
  predictions of an ``objective=none`` model against the JAX booster's.
"""

import numpy as np
import pytest

import jax
import jax._src.core

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt

ROUNDS = 4
PARAMS = dict(num_leaves=7, learning_rate=0.3, max_bin=31, min_data_in_leaf=20, verbose=-1)


@pytest.fixture(scope="module", autouse=True)
def jax_trace_state_shim():
    had = hasattr(jax.core, "trace_state_clean")
    if not had:
        jax.core.trace_state_clean = jax._src.core.trace_state_clean
    yield
    if not had:
        del jax.core.trace_state_clean


def _data(seed=5, n=2000):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, 6)).astype(np.float32)
    y = (X[:, 0] - 0.5 * X[:, 1] + 0.3 * rng.standard_normal(n) > 0).astype(np.float32)
    return X, y


def _sigmoid(preds):
    return 1.0 / (1.0 + np.exp(-np.asarray(preds, np.float64)))


def logistic_fobj(preds, data):
    p = _sigmoid(preds)
    return p - data.get_label(), p * (1.0 - p)


def dyadic_fobj(preds, data):
    g, h = logistic_fobj(preds, data)
    return np.round(g * 64) / 64, np.round(h * 64) / 64 + 1 / 64


def logloss_feval(preds, data):
    y, p = data.get_label(), _sigmoid(preds)
    return "my_logloss", float(-np.mean(y * np.log(p) + (1 - y) * np.log(1 - p))), False


def two_fevals(preds, data):
    y = data.get_label()
    return [logloss_feval(preds, data),
            ("my_error", float(np.mean((preds > 0) != (y > 0.5))), False)]


def _train_both(fobj, feval, params=PARAMS, valid=True):
    X, y = _data()
    out = []
    for mod, kw in ((lgb, {}), (lgt, {"device": "cpu"})):
        tr = mod.Dataset(X, label=y)
        sets = [tr, mod.Dataset(X[:500], label=y[:500], reference=tr)] if valid else None
        er = {}
        b = mod.train(params, tr, ROUNDS, valid_sets=sets, fobj=fobj, feval=feval,
                      evals_result=er, verbose_eval=False, **kw)
        out.append((b, er))
    return X, out


def _split_lines(text):
    return [line for line in text.splitlines()
            if line.startswith(("Tree=", "num_leaves=", "split_feature=", "threshold=",
                                "decision_type=", "left_child=", "right_child="))]


def test_dyadic_fobj_feval_byte_identical():
    X, ((jb, jer), (tb, ter)) = _train_both(dyadic_fobj, two_fevals)
    assert jb.boosting.ptrainer is None and tb.boosting.ptrainer is None
    assert tb.objective is None
    assert tb.model_to_string() == jb.model_to_string()
    assert ter == jer
    assert list(ter["valid_1"]) == ["my_logloss", "my_error"]
    np.testing.assert_array_equal(tb.predict(X), np.asarray(jb.predict(X)))


def test_logistic_fobj_matches_jax():
    X, ((jb, jer), (tb, ter)) = _train_both(logistic_fobj, logloss_feval,
                                            dict(PARAMS, metric="l2"))
    assert _split_lines(tb.model_to_string()) == _split_lines(jb.model_to_string())
    assert list(ter) == list(jer) == ["training", "valid_1"]
    # training metrics are off (is_training_metric), so "training" has feval's alone
    assert list(ter["valid_1"]) == list(jer["valid_1"]) == ["l2", "my_logloss"]
    for data in ter:
        assert list(ter[data]) == list(jer[data])
        for name in ter[data]:
            np.testing.assert_allclose(ter[data][name], jer[data][name], rtol=0, atol=1e-6)
    np.testing.assert_allclose(tb.predict(X), np.asarray(jb.predict(X)), rtol=3e-3,
                               atol=3e-4)


def test_multiclass_fobj_class_major_matches_jax():
    """num_class=3 with objective=none: preds and gradients are the
    class-major (K*N,) layout, three trees an iteration."""
    X, y2 = _data(seed=6)
    y = (y2 + (X[:, 2] > 0.5)).astype(np.float32)

    def softmax_fobj(preds, data):
        k, n = 3, len(data.get_label())
        s = np.asarray(preds, np.float64).reshape(k, n)
        p = np.exp(s - s.max(0))
        p /= p.sum(0)
        onehot = (data.get_label()[None, :] == np.arange(k)[:, None])
        g, h = p - onehot, 2.0 * p * (1.0 - p)
        return (np.round(g * 64) / 64).reshape(-1), (np.round(h * 64) / 64 + 1 / 64).reshape(-1)

    params = dict(PARAMS, num_class=3)
    jb = lgb.train(params, lgb.Dataset(X, label=y), ROUNDS, fobj=softmax_fobj)
    tb = lgt.train(params, lgt.Dataset(X, label=y), ROUNDS, fobj=softmax_fobj, device="cpu")
    assert tb.boosting.num_tree_per_iteration == 3 and tb.num_trees == 3 * ROUNDS
    assert tb.model_to_string() == jb.model_to_string()
    np.testing.assert_array_equal(tb.predict(X), np.asarray(jb.predict(X)))


def test_update_and_eval_with_feval():
    X, y = _data()
    params = dict(PARAMS, objective="none")
    out = []
    for mod, kw in ((lgb, {}), (lgt, {"device": "cpu"})):
        tr = mod.Dataset(X, label=y)
        va = mod.Dataset(X[:500], label=y[:500], reference=tr)
        b = mod.Booster(params, tr, **kw)
        b.add_valid(va, "held")
        for _ in range(3):
            assert not b.update(fobj=dyadic_fobj)
        out.append((b, va))
    (jb, jva), (tb, tva) = out
    assert tb.current_iteration() == jb.current_iteration() == 3
    assert tb.eval_train(logloss_feval) == jb.eval_train(logloss_feval)
    assert tb.eval_valid(two_fevals) == jb.eval_valid(two_fevals)
    assert tb.eval(tva, "held", logloss_feval) == jb.eval(jva, "held", logloss_feval)
    assert tb.eval_valid() == jb.eval_valid() == []
    assert tb.model_to_string() == jb.model_to_string()


def test_update_fobj_on_fused_booster(monkeypatch):
    """``Booster.update(fobj=)`` on a booster the partitioned trainer
    started (3 binary iterations on it; the JAX package with
    LIGHTGBM_TPU_PGROW=force): both take the mask grower from the band's
    scores for a 4th and 5th tree.  The ``preds`` each ``fobj`` gets
    agree within 1e-5 (the fused trees' sums differ in their last bits,
    tests/test_torch_train.py), the trees' split lines are equal and the
    raw predictions within 3e-3.  Then a fused iteration starts from the
    band rewritten from the scores (B5), and two rollbacks take the
    fused and a custom tree off again: the training scores stay within
    1e-5 of ``predict(raw_score=True)`` throughout."""
    monkeypatch.setenv("LIGHTGBM_TPU_PGROW", "force")
    X, y = _data(n=1000)
    params = dict(PARAMS, objective="binary")
    seen = {}

    def recording(tag):
        def fobj(preds, data):
            seen.setdefault(tag, []).append(np.array(preds, np.float64))
            return logistic_fobj(preds, data)
        return fobj

    boosters = []
    for mod, kw, tag in ((lgb, {}, "jax"), (lgt, {"device": "cpu"}, "port")):
        b = mod.train(params, mod.Dataset(X, label=y), 3, keep_training_booster=True, **kw)
        assert b.boosting.ptrainer is not None
        for _ in range(2):
            assert not b.update(fobj=recording(tag))
        boosters.append(b)
    jb, tb = boosters
    assert tb.current_iteration() == jb.current_iteration() == 5
    for a, b in zip(seen["jax"], seen["port"]):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-5)
    assert _split_lines(tb.model_to_string()) == _split_lines(jb.model_to_string())
    np.testing.assert_allclose(tb.predict(X, raw_score=True), jb.predict(X, raw_score=True),
                               rtol=3e-3, atol=3e-3)

    def drift():
        return np.abs(tb.boosting.scores[0].numpy() - tb.predict(X, raw_score=True)).max()

    assert drift() <= 1e-5
    assert tb.boosting.ptrainer.score_dirty
    tb.update()  # the chunk rewrites the band from the scores first
    assert not tb.boosting.ptrainer.score_dirty and drift() <= 1e-5
    tb.rollback_one_iter()
    tb.rollback_one_iter()
    assert tb.current_iteration() == 4 and drift() <= 1e-5
