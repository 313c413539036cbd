"""Validation sets, metrics, callbacks and early stopping in the port
against the JAX package.

- Each ported metric (metric/binary.py, regression.py, multiclass.py)
  within 1e-9 relative of the JAX metric's host ``eval`` on equal
  scores, with and without weights.  With an objective's output
  conversion (sigmoid, softmax) in between, 1e-6: the JAX host path
  converts through ``jnp``, which computes in float32 with jax_enable_x64
  off, where the port converts in float64.
- ``lgt.train`` with ``valid_sets`` against ``lgb.train`` (the JAX engine
  on its fused trainer, LIGHTGBM_TPU_PGROW=force), for the per-iteration
  loop and the ``output_freq`` chunks, with early stopping that fires,
  ``record_evaluation`` and ``reset_parameter``: ``evals_result`` within
  1e-6, the same ``best_iteration`` and ``best_score`` keys (values
  within 1e-6), the same trees.  The JAX engine evaluates with its
  device metrics, in float32 for these sizes.  AUC is a rank statistic:
  the two packages' leaf values differ in the last bits (interpret mode's
  bf16 histogram sums, the reason for the 3e-3 prediction tolerance), so
  two validation scores a few ulps apart can swap places, which moves
  the AUC by 1 / (positives x negatives), 4.0e-6 here; AUC is held to two
  such swaps.
- The validation scores: an EFB-bundled training set's validation set is
  scored on its unbundled bins; ``add_valid`` after training replays the
  trees; ``predict(X)`` uses every tree after an early stop, as the JAX
  ``Booster.predict`` does; a
  metric that fails fails the run.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax._src.core
import jax.numpy as jnp

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.io.dataset import Metadata as JMeta
from lightgbm_tpu.metric import create_metric as jmetric
from lightgbm_tpu.objective import create_objective as jobjective
from lightgbm_tpu_torch import callback
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.io.dataset import Metadata as TMeta
from lightgbm_tpu_torch.metric import create_metric as tmetric
from lightgbm_tpu_torch.objective import create_objective as tobjective


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


# ----------------------------------------------------------------------
# metrics
# ----------------------------------------------------------------------
N = 3000
# (metric, objective, label kind)
METRICS = [
    ("binary_logloss", "binary", "binary"),
    ("binary_error", "binary", "binary"),
    ("auc", "binary", "binary"),
    ("l2", "regression", "real"),
    ("l1", "regression", "real"),
    ("rmse", "regression", "real"),
    ("huber", "regression", "real"),
    ("fair", "regression", "real"),
    ("poisson", "regression", "count"),
    ("multi_logloss", "multiclass", "class"),
    ("multi_error", "multiclass", "class"),
]


def _metric_inputs(kind, seed=0):
    """(label, raw scores, 'probability' scores for a conversion-free
    evaluation) with ties in the scores."""
    rng = np.random.default_rng(seed)
    if kind == "class":
        label = rng.integers(0, 3, N).astype(np.float32)
        raw = np.round(rng.standard_normal((3, N)), 1).astype(np.float32)
        prob = rng.random((3, N))
        prob = (prob / prob.sum(0)).astype(np.float32)
        prob[:, :50] = 1.0 / 3.0  # ties on the true class
        return label, raw, prob
    if kind == "binary":
        label = (rng.random(N) < 0.4).astype(np.float32)
    elif kind == "count":
        label = rng.poisson(2.0, N).astype(np.float32)
    else:
        label = rng.standard_normal(N).astype(np.float32)
    raw = np.round(rng.standard_normal(N), 2).astype(np.float32)  # tied scores
    prob = np.clip(np.round(rng.random(N), 2), 0.0, 1.0).astype(np.float32)
    if kind == "count":
        prob = (prob * 4).astype(np.float32)
    return label, raw, prob


def _bound(create, Config, Meta, name, objective, label, weight):
    params = {"objective": objective, "num_class": 3 if objective == "multiclass" else 1}
    cfg = Config.from_params(params)
    m = create(name, cfg)
    md = Meta(len(label))
    md.set_label(label)
    md.set_weights(weight)
    m.init(md, len(label))
    return m, cfg


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
@pytest.mark.parametrize("name,objective,kind", METRICS, ids=[m[0] for m in METRICS])
def test_metric_matches_jax_eval(name, objective, kind, weighted):
    label, raw, prob = _metric_inputs(kind)
    weight = (np.random.default_rng(1).random(N) + 0.5).astype(np.float32) if weighted else None
    jm, _ = _bound(jmetric, JConfig, JMeta, name, objective, label, weight)
    tm, _ = _bound(tmetric, TConfig, TMeta, name, objective, label, weight)
    assert tm.name == jm.name and tm.bigger_is_better == jm.bigger_is_better
    scores = prob if name != "auc" else raw
    (jn, jv), = jm.eval(np.asarray(scores, np.float64), None)
    (tn, tv), = tm.eval(torch.from_numpy(scores), None)
    assert tn == jn
    assert abs(tv - jv) <= 1e-9 * max(abs(jv), 1e-12), (tv, jv)


@pytest.mark.parametrize("name,objective,kind",
                         [m for m in METRICS if m[1] != "regression"],
                         ids=[m[0] for m in METRICS if m[1] != "regression"])
def test_metric_with_objective_conversion(name, objective, kind):
    label, raw, _ = _metric_inputs(kind, seed=3)
    jm, jcfg = _bound(jmetric, JConfig, JMeta, name, objective, label, None)
    tm, tcfg = _bound(tmetric, TConfig, TMeta, name, objective, label, None)
    jobj, tobj = jobjective(jcfg), tobjective(tcfg)
    for obj, meta in ((jobj, JMeta), (tobj, TMeta)):
        md = meta(N)
        md.set_label(label)
        obj.init(md, N)
    (_, jv), = jm.eval(np.asarray(raw, np.float64), jobj)
    (_, tv), = tm.eval(torch.from_numpy(raw), tobj)
    assert abs(tv - jv) <= 1e-6 * max(abs(jv), 1e-12), (tv, jv)


def test_unknown_metric_warns_and_is_skipped():
    X, y = _binary(600)
    ev = {}
    tr = lgt.Dataset(X, label=y)
    lgt.train(dict(PARAMS, metric=["no_such_metric", "auc"]), tr, 2,
              valid_sets=[lgt.Dataset(X, label=y, reference=tr)], evals_result=ev,
              verbose_eval=False, device="cpu")
    assert list(ev["valid_0"]) == ["auc"]


# ----------------------------------------------------------------------
# training with validation sets against the JAX engine
# ----------------------------------------------------------------------
PARAMS = dict(objective="binary", num_leaves=15, learning_rate=0.5, max_bin=31,
              min_data_in_leaf=20, verbose=-1)


def _binary(n=3000, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, 8)).astype(np.float32)
    w = rng.standard_normal(8)
    y = (rng.random(n) < 1 / (1 + np.exp(-(X @ w)))).astype(np.float32)
    return X, y


def _multiclass(n=3000, seed=2):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, 6)).astype(np.float32)
    y = np.where(X[:, 0] > 0.6, 2, np.where(X[:, 1] > 0.0, 1, 0))
    y = np.where(rng.random(n) < 0.2, rng.integers(0, 3, n), y).astype(np.float32)
    return X, y


def _train_both(params, data, rounds, **kw):
    """The same run in both packages: (jax booster, jax evals, port
    booster, port evals); train on the first 2/3, validate on the rest."""
    X, y = data
    cut = 2 * len(y) // 3
    out = []
    for mod, extra in ((lgb, {}), (lgt, dict(device="cpu"))):
        tr = mod.Dataset(X[:cut], label=y[:cut])
        va = mod.Dataset(X[cut:], label=y[cut:], reference=tr)
        sets = [tr, va] if kw.get("with_train") else [va]
        names = ["training", "val"] if kw.get("with_train") else ["val"]
        ev = {}
        cbs = kw.get("callbacks_of", lambda m: None)(mod.callback if mod is lgb else callback)
        old = os.environ.get("LIGHTGBM_TPU_PGROW")
        os.environ["LIGHTGBM_TPU_PGROW"] = "force"
        try:
            bst = mod.train(params, tr, rounds, valid_sets=sets, valid_names=names,
                            evals_result=ev, verbose_eval=False,
                            early_stopping_rounds=kw.get("early_stopping_rounds"),
                            callbacks=cbs, **extra)
        finally:
            if old is None:
                del os.environ["LIGHTGBM_TPU_PGROW"]
            else:
                os.environ["LIGHTGBM_TPU_PGROW"] = old
        out += [bst, ev]
    return out


AUC_SWAP = 1.0 / (511 * 489)  # one pair of the validation rows' 511 positives, 489 negatives


def _assert_evals_match(je, te):
    assert list(te) == list(je)
    for d in je:
        assert list(te[d]) == list(je[d])
        for m in je[d]:
            a, b = np.asarray(je[d][m]), np.asarray(te[d][m])
            assert a.shape == b.shape, (d, m, a.shape, b.shape)
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=2 * AUC_SWAP if m == "auc" else 1e-9)


def _assert_best_match(jb, tb):
    assert tb.best_iteration == jb.best_iteration
    assert list(tb.best_score) == list(jb.best_score)
    for d in jb.best_score:
        assert list(tb.best_score[d]) == list(jb.best_score[d])
        for m, v in jb.best_score[d].items():
            assert abs(tb.best_score[d][m] - v) <= 1e-6 * max(abs(v), 1.0)


def _split_lines(text):
    return [line for line in text.splitlines()
            if line.startswith(("Tree=", "split_feature=", "threshold=", "left_child="))]


RUNS = {
    # sampled, both loops, early stopping firing
    "per-iteration-early-stop": (
        dict(PARAMS, metric=["auc", "binary_logloss"], bagging_fraction=0.8, bagging_freq=5,
             feature_fraction=0.9), _binary, 40, dict(early_stopping_rounds=3)),
    "output_freq-3-early-stop": (
        dict(PARAMS, metric=["binary_logloss", "auc"], output_freq=3), _binary, 60,
        dict(early_stopping_rounds=2)),
    "training-and-valid": (
        dict(PARAMS, metric="binary_error", is_training_metric=True, learning_rate=0.2),
        _binary, 5, dict(with_train=True)),
    "multiclass": (
        dict(PARAMS, objective="multiclass", num_class=3, metric=["multi_logloss", "multi_error"],
             bagging_fraction=0.8, bagging_freq=1), _multiclass, 5, {}),
    "record-and-reset-lr": (
        dict(PARAMS, objective="regression", metric=["l2", "l1"]), _binary, 6,
        dict(callbacks_of=lambda cb: [cb.reset_parameter(
            learning_rate=[0.5, 0.4, 0.3, 0.2, 0.1, 0.05])])),
}


@pytest.fixture(scope="module")
def runs():
    cache = {}

    def get(name):
        if name not in cache:
            params, data, rounds, kw = RUNS[name]
            cache[name] = _train_both(params, data(), rounds, **kw)
        return cache[name]

    return get


@pytest.mark.parametrize("name", list(RUNS))
def test_evals_result_matches_jax(runs, name):
    _, je, _, te = runs(name)
    _assert_evals_match(je, te)


@pytest.mark.parametrize("name", list(RUNS))
def test_best_iteration_and_trees_match_jax(runs, name):
    jb, _, tb, _ = runs(name)
    _assert_best_match(jb, tb)
    assert tb.current_iteration() == jb.current_iteration()
    assert _split_lines(tb.model_to_string()) == _split_lines(jb.model_to_string())


@pytest.mark.parametrize("name", ["per-iteration-early-stop", "output_freq-3-early-stop"])
def test_early_stopping_fired(runs, name):
    _, je, tb, te = runs(name)
    rounds = RUNS[name][2]
    assert tb.current_iteration() < rounds
    assert 0 < tb.best_iteration < tb.current_iteration()
    assert "val" in tb.best_score


def test_output_freq_evaluates_at_chunk_ends(runs):
    """output_freq=3: one evaluation per 3-iteration chunk."""
    _, _, tb, te = runs("output_freq-3-early-stop")
    assert len(te["val"]["auc"]) == tb.current_iteration() // 3


def test_reset_parameter_reaches_the_trees(runs):
    """The learning rates of reset_parameter scale each tree: iteration
    i's shrinkage is the list's i-th rate."""
    _, _, tb, _ = runs("record-and-reset-lr")
    rates = [0.5, 0.4, 0.3, 0.2, 0.1, 0.05]
    shrink = [float(line.split("=")[1]) for line in tb.model_to_string().splitlines()
              if line.startswith("shrinkage=")]
    assert shrink[1:] == pytest.approx(rates)  # tree 0 is the boost-from-average constant


def test_predict_defaults_to_best_iteration(runs):
    """After an early stop, ``predict(X)`` uses every tree, as the JAX
    ``Booster.predict(X)`` does (its default num_iteration=-1), and
    agrees with it; ``num_iteration=best_iteration`` still cuts the trees
    to the best iteration's."""
    jb, _, tb, _ = runs("per-iteration-early-stop")
    X, _ = _binary()
    assert tb.best_iteration < tb.current_iteration()
    np.testing.assert_allclose(tb.predict(X), jb.predict(X), rtol=0, atol=3e-3)
    np.testing.assert_array_equal(tb.predict(X), tb.predict(X, num_iteration=-1))
    best = tb.predict(X, num_iteration=tb.best_iteration)
    assert not np.array_equal(tb.predict(X), best)
    np.testing.assert_allclose(best, jb.predict(X, num_iteration=jb.best_iteration), rtol=0,
                               atol=3e-3)


def test_record_evaluation_history_per_iteration(runs):
    _, _, tb, te = runs("per-iteration-early-stop")
    assert len(te["val"]["auc"]) == tb.current_iteration()
    assert set(te["val"]) == {"auc", "binary_logloss"}


# ----------------------------------------------------------------------
# validation scores
# ----------------------------------------------------------------------
def test_bundled_training_set_scores_valid_unbundled():
    """EFB bundles the training matrix; the validation set (same rows,
    built with reference=) is scored on its own unbundled bins and its
    scores equal the training scores, tree for tree."""
    rng = np.random.default_rng(4)
    cat = rng.integers(0, 12, 2000)
    X = np.zeros((2000, 14))
    X[np.arange(2000), cat] = rng.random(2000) + 1.0
    X[:, 12:] = rng.standard_normal((2000, 2))
    y = ((cat < 6) ^ (X[:, 12] > 0.8)).astype(np.float32)
    tr = lgt.Dataset(X, label=y)
    bst = lgt.Booster(dict(PARAMS, metric="auc"), tr, device="cpu")
    va = lgt.Dataset(X, label=y, reference=tr)
    bst.add_valid(va, "same_rows")
    assert bst.boosting.train_set.bundle is not None
    assert va.construct().bundle is None
    bst.boosting.train_iters_partitioned(4)
    np.testing.assert_allclose(bst.boosting.valid_scores[0].numpy(),
                               bst.boosting.scores.numpy(), rtol=0, atol=1e-5)
    (d, m, v, bigger), = bst.eval(va, "same_rows")
    assert (d, m, bigger) == ("same_rows", "auc", True) and v > 0.9


def test_add_valid_after_training_replays_the_trees():
    X, y = _binary(2000, seed=5)
    tr = lgt.Dataset(X[:1500], label=y[:1500])
    late = lgt.Booster(dict(PARAMS, metric="binary_logloss"), tr, device="cpu")
    late.boosting.train_iters_partitioned(3)
    late.add_valid(lgt.Dataset(X[1500:], label=y[1500:], reference=tr), "v")
    early = lgt.Booster(dict(PARAMS, metric="binary_logloss"), lgt.Dataset(X[:1500], label=y[:1500]),
                        device="cpu")
    early.add_valid(lgt.Dataset(X[1500:], label=y[1500:], reference=tr), "v")
    early.boosting.train_iters_partitioned(3)
    (_, _, a, _), = late.eval_valid()
    (_, _, b, _), = early.eval_valid()
    assert a == pytest.approx(b, rel=1e-6)
    raw = late.predict(X[1500:], raw_score=True)
    np.testing.assert_allclose(late.boosting.valid_scores[0][0].numpy(), raw, atol=1e-5)


def test_gbdt_early_stopping_round_matches_jax():
    """GBDT's own bookkeeping (early_stopping_round in the config,
    evaluated by train_iters_partitioned(is_eval=True), as the reference
    CLI drives it): stops at the same iteration and drops the same
    trees as the JAX package."""
    X, y = _binary(3000, seed=7)
    params = dict(PARAMS, metric=["binary_logloss"], early_stopping_round=2, learning_rate=0.9)
    out = []
    for mod, kw in ((lgb, {}), (lgt, dict(device="cpu"))):
        tr = mod.Dataset(X[:2000], label=y[:2000])
        old = os.environ.get("LIGHTGBM_TPU_PGROW")
        os.environ["LIGHTGBM_TPU_PGROW"] = "force"
        try:
            bst = mod.Booster(params, tr, **kw)
            bst.add_valid(mod.Dataset(X[2000:], label=y[2000:], reference=tr), "v")
            for i in range(40):
                if bst.boosting.train_iters_partitioned(1, is_eval=True):
                    break
        finally:
            if old is None:
                del os.environ["LIGHTGBM_TPU_PGROW"]
            else:
                os.environ["LIGHTGBM_TPU_PGROW"] = old
        out.append((i, bst.num_trees, bst.boosting.best_iter, _split_lines(bst.model_to_string())))
    assert out[0][0] < 39
    assert out[1] == out[0]


def test_failing_metric_fails_the_run(monkeypatch):
    """No metric error is caught and ignored."""
    from lightgbm_tpu_torch.metric import binary

    def boom(self, score, objective=None):
        raise RuntimeError("metric failed")

    monkeypatch.setattr(binary.AUCMetric, "eval", boom)
    X, y = _binary(600)
    tr = lgt.Dataset(X, label=y)
    with pytest.raises(RuntimeError, match="metric failed"):
        lgt.train(dict(PARAMS, metric="auc"), tr, 2, device="cpu", verbose_eval=False,
                  valid_sets=[lgt.Dataset(X, label=y, reference=tr)])


def test_callback_env_and_print_evaluation(capsys):
    """print_evaluation logs every period; a user callback sees each
    iteration's results."""
    X, y = _binary(900)
    tr = lgt.Dataset(X, label=y)
    seen = []
    lgt.train(dict(PARAMS, metric="auc", verbose=1), tr, 4, device="cpu", verbose_eval=2,
              valid_sets=[lgt.Dataset(X, label=y, reference=tr)],
              callbacks=[lambda env: seen.append((env.iteration, env.evaluation_result_list))])
    assert [i for i, _ in seen] == [0, 1, 2, 3]
    assert all(r[0][:2] == ("valid_0", "auc") for _, r in seen)
    text = capsys.readouterr()
    logged = text.out + text.err
    assert "[2]\tvalid_0's auc" in logged and "[4]\tvalid_0's auc" in logged
    assert "[1]\tvalid_0's auc" not in logged
