"""The port's public API beyond ``train`` against the JAX package's, on the
CPU: dataset subsets and setters, pandas frames and sparse input,
continued training (``init_model``), ``rollback_one_iter``, ``cv``,
``dump_model``, ``feature_importance``, ``pred_leaf``, pickling, and
pandas-categorical models across the two packages.

Both packages get the same seeded numpy data.  LIGHTGBM_TPU_PGROW=force
puts both on the fused path (the JAX package's Pallas kernels in
interpret mode, the port's plain PyTorch versions), 0 on the mask
grower.  Tolerances:

- split lines identical and predictions within 3e-3 for models each
  package trained;
- exact equality where both read the same model text (``dump_model``,
  ``feature_importance``, ``pred_leaf``, the pandas remap, cross-loading),
  for fold indices and for the binned arrays of a subset;
- 1e-6 for the training and validation scores after
  ``rollback_one_iter``;
- 3e-3 for ``cv``'s means and deviations.
"""

import copy
import os
import pickle

import numpy as np
import pytest

import jax
import jax._src.core

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.io.dataset import BinnedDataset as JBinned
from lightgbm_tpu_torch import LightGBMError
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.io.dataset import BinnedDataset as TBinned

pd = pytest.importorskip("pandas")
sp = pytest.importorskip("scipy.sparse")

PARAMS = dict(objective="binary", num_leaves=15, learning_rate=0.2, max_bin=31,
              min_data_in_leaf=20, verbose=-1)
MULTI = dict(PARAMS, objective="multiclass", num_class=3)


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


@pytest.fixture(params=["force", "0"], ids=["fused", "mask"])
def grower(request, monkeypatch):
    """Both packages on the fused path ("force") or the mask grower ("0")."""
    monkeypatch.setenv("LIGHTGBM_TPU_PGROW", request.param)
    return request.param


def _data(seed=0, n=2000, f=8):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, f))
    w = rng.standard_normal(f)
    y = (rng.random(n) < 1 / (1 + np.exp(-(X @ w)))).astype(np.float32)
    return X, y


def _multi_data(seed=6, n=2000, k=3):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, 6))
    y = np.argmax(X[:, :k] + 0.3 * rng.standard_normal((n, k)), axis=1).astype(np.float32)
    return X, y


def _split_lines(text):
    return [ln for ln in text.splitlines()
            if ln.startswith(("Tree=", "num_leaves=", "split_feature=", "threshold=",
                              "decision_type=", "left_child=", "right_child="))]


def _trees(text):
    return text.split("feature importances:")[0]


def _no_infos(text):
    """A model's text without feature_infos, which both packages write
    from a training set only (not from a loaded model)."""
    return "\n".join(ln for ln in text.splitlines() if not ln.startswith("feature_infos="))


# ---------------------------------------------------------------------------
# datasets
@pytest.mark.parametrize("ranking", [False, True], ids=["plain", "ranking"])
def test_binned_subset_matches_jax(ranking):
    rng = np.random.default_rng(2)
    X, y = _data(2, n=600)
    w = (rng.random(600) + 0.5).astype(np.float32)
    init = rng.standard_normal(600)
    group = np.full(30, 20) if ranking else None
    cfg = dict(max_bin=31, verbose=-1)
    from lightgbm_tpu.config import Config as JConfig

    kw = dict(label=y, weight=w, group=group, init_score=init)
    jb = JBinned.from_raw(X, JConfig.from_params(cfg), **kw)
    tb = TBinned.from_raw(X, Config.from_params(cfg), **kw)
    idx = np.sort(rng.choice(600, 250, replace=False))
    idx = idx[(idx < 40) | (idx >= 60)]  # one query loses every row
    js, ts = jb.subset(idx), tb.subset(idx)
    np.testing.assert_array_equal(ts.binned, js.binned)
    assert ts.bin_mappers is tb.bin_mappers
    for field in ("label", "weights", "init_score", "query_boundaries"):
        a, b = getattr(ts.metadata, field), getattr(js.metadata, field)
        assert (a is None) == (b is None), field
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=field)
    if ranking:
        assert ts.metadata.num_queries == 29
    # validation sets take the training mappers
    Xv, _ = _data(3, n=100)
    np.testing.assert_array_equal(tb.create_valid(Xv).binned, jb.create_valid(Xv).binned)


def test_dataset_setters_and_getters():
    X, y = _data(4, n=300)
    rng = np.random.default_rng(4)
    w, init = rng.random(300) + 0.5, rng.standard_normal(300)
    out = {}
    for name, mod in (("jax", lgb), ("port", lgt)):
        ds = mod.Dataset(X, label=np.zeros(300), free_raw_data=True, silent=True)
        before = ds.num_feature()
        ds.construct({"max_bin": 15, "verbose": -1})
        ds.set_label(y).set_weight(w).set_init_score(init).set_group([100, 200])
        valid = ds.create_valid(X[:50], label=y[:50])
        sub = ds.subset(np.arange(0, 300, 3))
        out[name] = (before, ds.num_feature(), ds.num_data(), ds.get_label(), ds.get_weight(),
                     ds.get_init_score(), ds.get_group(), ds.data is None,
                     valid.reference is ds, valid.construct().binned, sub.num_data(),
                     sub.get_label(), sub.get_group())
    for a, b in zip(out["port"], out["jax"]):
        np.testing.assert_array_equal(a, b)


def _frame(seed, levels=("x", "y", "z"), n=600):
    rng = np.random.default_rng(seed)
    df = pd.DataFrame({"a": rng.standard_normal(n), "b": rng.standard_normal(n),
                       "c": pd.Categorical(rng.choice(list(levels), n), categories=levels)})
    df.loc[df.index[::37], "c"] = np.nan
    y = ((df["a"] > 0) ^ (df["c"] == levels[1])).astype(np.float32).to_numpy()
    return df, y


def test_pandas_categorical_codes_match_jax():
    """A frame's category column becomes its codes and an auto-detected
    categorical feature; a validation frame whose levels come in another
    order (and with a level unseen in training) is re-coded through the
    training levels, exactly as the JAX package codes it."""
    df, y = _frame(0)
    dv, yv = _frame(1, levels=("z", "w", "x", "y"), n=200)
    out = {}
    for name, mod in (("jax", lgb), ("port", lgt)):
        ds = mod.Dataset(df, label=y)
        valid = mod.Dataset(dv, label=yv, reference=ds)
        b = ds.construct({"max_bin": 31, "verbose": -1})
        vb = valid.construct()
        out[name] = (ds.data, ds._auto_categorical, ds.pandas_categorical, b.binned,
                     b.feature_names, [m.bin_type for m in b.bin_mappers], valid.data,
                     valid.pandas_categorical, vb.binned)
    for a, b in zip(out["port"], out["jax"]):
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)  # NaN equals NaN
        else:
            assert a == b
    with pytest.raises(LightGBMError, match="categorical_feature do not match"):
        lgt.Dataset(dv.drop(columns="c"), reference=lgt.Dataset(df, label=y)).construct()


def test_sparse_input_is_densified():
    X, y = _data(5, n=400)
    X[np.abs(X) < 1.0] = 0.0
    csr = sp.csr_matrix(X)
    jb = lgb.Dataset(csr, label=y).construct({"max_bin": 31, "verbose": -1})
    tb = lgt.Dataset(csr, label=y).construct({"max_bin": 31, "verbose": -1})
    np.testing.assert_array_equal(tb.binned, jb.binned)
    np.testing.assert_array_equal(tb.binned,
                                  lgt.Dataset(X, label=y).construct({"max_bin": 31}).binned)


# ---------------------------------------------------------------------------
# continued training
@pytest.mark.parametrize("source", ["booster", "file"])
def test_init_model_matches_jax(grower, source, tmp_path):
    """A JAX-trained model continued for 3 bagged iterations by each
    package: the same split lines (the bagging draws take the new
    booster's iterations from 0, as in the JAX package) and predictions
    within 3e-3."""
    X, y = _data(0)
    params = dict(PARAMS, bagging_fraction=0.7, bagging_freq=1, feature_fraction=0.8)
    init = lgb.train(PARAMS, lgb.Dataset(X, label=y), 3)
    path = tmp_path / "init.txt"
    init.save_model(str(path))
    jb = lgb.train(params, lgb.Dataset(X, label=y), 3, init_model=init)
    port_init = (lgt.Booster(model_str=init.model_to_string(), device="cpu")
                 if source == "booster" else str(path))
    tb = lgt.train(params, lgt.Dataset(X, label=y), 3, init_model=port_init, device="cpu")
    assert (tb.boosting.ptrainer is not None) == (grower == "force")
    assert tb.current_iteration() == jb.current_iteration() == 6
    assert _split_lines(tb.model_to_string()) == _split_lines(jb.model_to_string())
    np.testing.assert_allclose(tb.predict(X), jb.predict(X), rtol=3e-3, atol=3e-4)
    # the first trees are the initial model's, unchanged
    assert _trees(tb.model_to_string(3)) == _trees(init.model_to_string())


@pytest.mark.parametrize("pgrow", ["force", "0"], ids=["fused", "mask"])
def test_init_model_validation_scores(pgrow, monkeypatch):
    """A validation set of continued training starts from the initial
    model's predictions of its raw rows (the reference's predictor on
    every Dataset).  The JAX package walks the initial model's trees over
    the validation bins instead, but trees read from model text carry no
    bin thresholds there, so its validation scores are off (by 2.2 on
    these rows); the port's equal a fresh prediction."""
    monkeypatch.setenv("LIGHTGBM_TPU_PGROW", pgrow)
    X, y = _data(9, n=1200)
    init = lgb.train(PARAMS, lgb.Dataset(X[:800], label=y[:800]), 4)
    tds = lgt.Dataset(X[:800], label=y[:800])
    tdv = lgt.Dataset(X[800:], label=y[800:], reference=tds)
    ev = {}
    tb = lgt.train(PARAMS, tds, 2, init_model=lgt.Booster(model_str=init.model_to_string(),
                                                          device="cpu"),
                   valid_sets=[tdv], evals_result=ev, verbose_eval=False, device="cpu")
    np.testing.assert_allclose(tb.boosting.valid_scores[0][0].numpy(),
                               tb.predict(X[800:], raw_score=True), rtol=0, atol=1e-6)
    # the first evaluation already carries the initial model's 4 iterations
    assert ev["valid_0"]["binary_logloss"][0] < 0.6


@pytest.mark.parametrize("what", ["features", "trees_per_iteration"])
def test_init_model_schema_guards(what):
    X, y = _data(1, n=300)
    if what == "features":
        init = lgt.train(PARAMS, lgt.Dataset(X[:, :5], label=y), 2, device="cpu")
        params, match = PARAMS, "trained on 5 features"
    else:
        y3 = y + (X[:, 0] > 1)  # three classes
        init = lgt.train(dict(MULTI, min_data_in_leaf=5), lgt.Dataset(X, label=y3), 2,
                         device="cpu")
        params, match = PARAMS, "boosts 3 tree"
    with pytest.raises(LightGBMError, match=match):
        lgt.train(params, lgt.Dataset(X, label=y), 2, init_model=init, device="cpu")


# ---------------------------------------------------------------------------
# rollback
ROLLBACK_CASES = [("fused", "force", 1), ("fused", "force", 3), ("mask", "0", 1)]


@pytest.mark.parametrize("route,pgrow,K", ROLLBACK_CASES,
                         ids=[f"{r}-K{k}" for r, _, k in ROLLBACK_CASES])
def test_rollback_matches_jax(route, pgrow, K, monkeypatch):
    """Two iterations with a validation set, then rollback_one_iter: the
    training and validation scores within 1e-6 of the JAX package's; on
    the fused path K = 1 takes the delta off the band in place, K > 1
    marks it for a rewrite; one more iteration then grows the same split
    lines as the JAX package's."""
    monkeypatch.setenv("LIGHTGBM_TPU_PGROW", pgrow)
    X, y = _data(0) if K == 1 else _multi_data()
    params = PARAMS if K == 1 else MULTI
    out = {}
    for name, mod, kw in (("jax", lgb, {}), ("port", lgt, dict(device="cpu"))):
        ds = mod.Dataset(X, label=y)
        dv = mod.Dataset(X[:500], label=y[:500], reference=ds)
        b = mod.train(params, ds, 2, valid_sets=[dv], verbose_eval=False, **kw)
        b.rollback_one_iter()
        sc = [np.array(b.boosting.scores), np.array(b.boosting.valid_scores[0])]
        n_after = b.num_trees
        if mod is lgt and route == "fused":
            assert b.boosting.ptrainer.score_dirty == (K > 1)
        b.update()
        out[name] = (b, sc, n_after)
    (jb, jsc, jn), (tb, tsc, tn) = out["jax"], out["port"]
    assert (tb.boosting.ptrainer is not None) == (route == "fused")
    assert tn == jn == K
    for a, b in zip(tsc, jsc):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    assert tb.current_iteration() == jb.current_iteration() == 2
    assert _split_lines(tb.model_to_string()) == _split_lines(jb.model_to_string())
    np.testing.assert_allclose(np.asarray(tb.boosting.scores), np.asarray(jb.boosting.scores),
                               rtol=0, atol=1e-5)


def test_rollback_restores_scores_and_band():
    """On the fused path (K = 1) a rollback subtracts the last tree's
    delta from the band in place: the scores return to those before the
    iteration within float32 rounding, and the next chunk trains from the
    band as if the iteration had not happened."""
    X, y = _data(0)
    a = lgt.train(PARAMS, lgt.Dataset(X, label=y), 2, device="cpu")
    before = a.boosting.scores.clone()
    a.update()
    a.rollback_one_iter()
    assert a.boosting.ptrainer._last_delta is None
    np.testing.assert_allclose(a.boosting.scores.numpy(), before.numpy(), rtol=0, atol=1e-6)
    a.rollback_one_iter()  # no delta held: walks the training bins
    assert a.boosting.ptrainer.score_dirty
    a.update()
    a.update()
    b = lgt.train(PARAMS, lgt.Dataset(X, label=y), 3, device="cpu")
    assert _split_lines(a.model_to_string()) == _split_lines(b.model_to_string())


# ---------------------------------------------------------------------------
# cv
CV_CASES = ["seed", "folds", "stratified", "early_stopping", "fpreproc"]


@pytest.mark.parametrize("case", CV_CASES)
def test_cv_matches_jax(case, monkeypatch):
    monkeypatch.setenv("LIGHTGBM_TPU_PGROW", "0")
    X, y = _data(7, n=1500)
    params = dict(PARAMS, metric=["binary_logloss", "auc"])
    kw = dict(nfold=3, seed=3)
    rounds = 4
    if case == "folds":
        idx = np.random.default_rng(8).permutation(1500)
        kw = dict(folds=[(idx[500:], idx[:500]), (idx[:1000], idx[1000:])])
    elif case == "stratified":
        kw.update(stratified=True)
    elif case == "early_stopping":
        params = dict(params, learning_rate=0.9, num_leaves=31, min_data_in_leaf=2)
        kw.update(early_stopping_rounds=2)
        rounds = 12
    elif case == "fpreproc":
        def fpreproc(tr, te, p):
            return tr, te, dict(p, learning_rate=0.05)
        kw.update(fpreproc=fpreproc)
    jr = lgb.cv(params, lgb.Dataset(X, label=y, params={"max_bin": 31}), rounds, **kw)
    tr = lgt.cv(params, lgt.Dataset(X, label=y, params={"max_bin": 31}), rounds,
                device="cpu", **kw)
    assert sorted(tr) == sorted(jr)
    for key in jr:
        assert len(tr[key]) == len(jr[key]), key
        np.testing.assert_allclose(tr[key], jr[key], rtol=3e-3, atol=3e-4, err_msg=key)
    if case == "early_stopping":
        assert len(tr["binary_logloss-mean"]) < rounds
    if case == "fpreproc":
        plain = lgt.cv(params, lgt.Dataset(X, label=y, params={"max_bin": 31}), rounds,
                       device="cpu", nfold=3, seed=3)
        assert tr["binary_logloss-mean"][0] > plain["binary_logloss-mean"][0]


def test_cv_folds_equal_jax():
    """The folds of a seed are the JAX package's RandomState permutation
    split into nfold parts."""
    from lightgbm_tpu_torch.engine import _make_n_folds

    y = np.arange(100) % 2
    for stratified, shuffle in ((False, True), (False, False), (True, True)):
        folds = _make_n_folds(100, y, 4, stratified, shuffle, seed=11)
        if stratified:
            from sklearn.model_selection import StratifiedKFold

            ref = list(StratifiedKFold(4, shuffle=True, random_state=11).split(np.zeros(100), y))
        else:
            idx = np.random.RandomState(11).permutation(100) if shuffle else np.arange(100)
            parts = np.array_split(idx, 4)
            ref = [(np.concatenate([parts[j] for j in range(4) if j != i]), parts[i])
                   for i in range(4)]
        for (a, b), (c, d) in zip(folds, ref):
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(b, d)


def test_cv_init_model_and_callbacks():
    """Every fold continues from ``init_model`` (its first mean is below a
    fresh cv's), and an early-stopping callback cuts the results at its
    best iteration."""
    X, y = _data(9, n=1200)
    ds = lgt.Dataset(X, label=y)
    init = lgt.train(PARAMS, ds, 4, device="cpu")
    fresh = lgt.cv(PARAMS, lgt.Dataset(X, label=y), 2, nfold=3, device="cpu")
    cont = lgt.cv(PARAMS, lgt.Dataset(X, label=y), 2, nfold=3, init_model=init, device="cpu")
    assert cont["binary_logloss-mean"][0] < fresh["binary_logloss-mean"][0]
    seen = []

    def stop_at_2(env):
        seen.append(env.evaluation_result_list[0][:2])
        if env.iteration == 2:
            raise lgt.callback.EarlyStopException(1, env.evaluation_result_list)

    res = lgt.cv(PARAMS, lgt.Dataset(X, label=y), 6, nfold=3, callbacks=[stop_at_2],
                 device="cpu")
    assert len(res["binary_logloss-mean"]) == 2 and len(seen) == 3
    assert seen[0] == ("cv_agg", "binary_logloss")


# ---------------------------------------------------------------------------
# the same model text in both packages
@pytest.fixture(scope="module")
def shared_models():
    """Model texts the JAX package trained: binary with a boost-from-average
    tree, multiclass, and one with a categorical feature."""
    os.environ["LIGHTGBM_TPU_PGROW"] = "0"
    try:
        X, y = _data(0)
        bin_txt = lgb.train(dict(PARAMS, objective="regression"), lgb.Dataset(X, label=y),
                            5).model_to_string()
        Xm, ym = _multi_data()
        multi_txt = lgb.train(MULTI, lgb.Dataset(Xm, label=ym), 4).model_to_string()
        Xc = X.copy()
        Xc[:, 0] = np.random.default_rng(1).integers(0, 6, len(X))
        yc = ((Xc[:, 0] % 2 == 0) ^ (Xc[:, 1] > 0)).astype(np.float32)
        cat_txt = lgb.train(PARAMS, lgb.Dataset(Xc, label=yc, categorical_feature=[0]),
                            4).model_to_string()
    finally:
        del os.environ["LIGHTGBM_TPU_PGROW"]
    return {"regression": (bin_txt, X), "multiclass": (multi_txt, Xm), "categorical":
            (cat_txt, Xc)}


@pytest.mark.parametrize("kind", ["regression", "multiclass", "categorical"])
def test_same_text_dump_importance_leaves(shared_models, kind):
    text, X = shared_models[kind]
    jb = lgb.Booster(model_str=text)
    tb = lgt.Booster(model_str=text, device="cpu")
    assert tb.dump_model() == jb.dump_model()
    assert tb.dump_model(num_iteration=2) == jb.dump_model(num_iteration=2)
    for imp in ("split", "gain"):
        np.testing.assert_array_equal(tb.feature_importance(imp), jb.feature_importance(imp))
    Xn = X.copy()
    Xn[::11, 1] = np.nan
    Xn[::13, 2] = 0.0
    leaves = tb.predict(Xn, pred_leaf=True)
    assert leaves.dtype == np.int32 and leaves.shape == (len(X), tb.num_trees)
    np.testing.assert_array_equal(leaves, jb.predict(Xn, pred_leaf=True))
    np.testing.assert_array_equal(tb.predict(Xn, pred_leaf=True, num_iteration=2),
                                  jb.predict(Xn, pred_leaf=True, num_iteration=2))
    # a row's leaves give its raw score
    values = [t.leaf_value for t in tb.boosting.models]
    K = tb.boosting.num_tree_per_iteration
    raw = np.zeros((K, len(X)))
    for i, v in enumerate(values):
        raw[i % K] += v[leaves[:, i]]
    np.testing.assert_allclose(raw[0] if K == 1 else raw.T, tb.predict(Xn, raw_score=True),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("how", ["pickle", "copy", "deepcopy"])
def test_booster_round_trips(how):
    X, y = _data(3, n=500)
    b = lgt.train(PARAMS, lgt.Dataset(X, label=y), 3, device="cpu")
    b.best_iteration = 2
    c = {"pickle": lambda: pickle.loads(pickle.dumps(b)), "copy": lambda: copy.copy(b),
         "deepcopy": lambda: copy.deepcopy(b)}[how]()
    assert c is not b and c.device == b.device
    assert _no_infos(c.model_to_string()) == _no_infos(b.model_to_string())
    np.testing.assert_array_equal(c.predict(X), b.predict(X))
    if how == "pickle":
        assert c.best_iteration == 2 and c.params == b.params


def test_unpickle_needs_the_device(monkeypatch):
    import torch

    X, y = _data(3, n=300)
    state = lgt.train(PARAMS, lgt.Dataset(X, label=y), 2, device="cpu").__getstate__()
    assert state["device"] == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lgt.Booster.__new__(lgt.Booster).__setstate__(dict(state, device="cuda"))


# ---------------------------------------------------------------------------
# pandas-categorical models across packages
def test_pandas_categorical_model_crosses_packages(tmp_path):
    """A JAX model trained on a frame with a category column loads in the
    port (its pandas_categorical line parsed and stripped, CRLF endings
    too) and predicts the frame within 1e-6 of the JAX package; a port
    model trained on the same frame loads in the JAX package and
    predicts the same."""
    df, y = _frame(0)
    params = dict(PARAMS, objective="binary")
    jb = lgb.train(params, lgb.Dataset(df, label=y), 4)
    text = jb.model_to_string()
    assert text.rstrip().endswith('pandas_categorical:[["x", "y", "z"]]')
    # the frame to predict orders its levels differently
    dp = df.copy()
    dp["c"] = dp["c"].cat.reorder_categories(["z", "x", "y"])
    for t in (text, text.replace("\n", "\r\n")):
        tb = lgt.Booster(model_str=t, device="cpu")
        assert tb.pandas_categorical == [["x", "y", "z"]]
        np.testing.assert_allclose(tb.predict(dp), jb.predict(dp), rtol=1e-6, atol=1e-6)
    assert (lgt.Booster(model_str=text, device="cpu").model_to_string()
            == lgb.Booster(model_str=text).model_to_string())
    tb = lgt.train(params, lgt.Dataset(df, label=y), 4, device="cpu")
    path = tmp_path / "port.txt"
    tb.save_model(str(path))
    loaded = lgb.Booster(model_file=str(path))
    assert loaded.pandas_categorical == [["x", "y", "z"]]
    np.testing.assert_allclose(loaded.predict(dp), tb.predict(dp), rtol=1e-6, atol=1e-6)
