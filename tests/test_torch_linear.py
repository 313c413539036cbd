"""Linear trees in lightgbm_tpu_torch (tree/linear.py, the linear fields of
model/tree.py, ops/predict.py's linear leaves and GBDT's fit) against
the JAX package.

Both packages train on their mask growers (the partitioned trainer
declines linear trees in both), the port on ``device="cpu"``.  Held:

- the pieces on the same seeded inputs: the value table and the leaf
  paths equal; ``linear_fit_stats`` A and b within 1e-4 relative (the JAX
  package sums in float32, the port in float64 rounded once);
  ``solve_linear_leaves`` w within 1e-4 with the same ``ok``, on random
  leaves and on the JAX test's degenerate ones; the train-score update
  and the binned walk within 1e-5;
- trained models (L2 and binary, 7 leaves): the same split lines tree by
  tree (or a near-tie first), the same linear leaves, raw predictions
  within 3e-3;
- model text: a port linear model round-trips byte for byte (its tree
  blocks; ``feature_infos`` is not kept by either package on a load),
  with equal predictions; models cross-load both ways with predictions
  within 1e-6, NaN path features included; ``Tree.predict`` and
  ``dump_model`` of one text equal the JAX package's;
- the rest of the API on linear models: the prediction early stop
  against the JAX row loop, ``rollback_one_iter`` (the scores back to
  the previous iteration's, the regrown tree identical), ``init_model``
  against the JAX package's continuation, ``LGBMRegressor(linear_tree=
  True)`` against ``lgt.train``, ``dump_model``, and training with GOSS
  and with bagging.
"""

import numpy as np
import pytest
import torch

import jax
import jax._src.core
import jax.numpy as jnp

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.boosting import pred_early_stop as jpes
from lightgbm_tpu.model.ensemble import stack_trees as jstack
from lightgbm_tpu.tree import linear as jlin
from lightgbm_tpu_torch.model.ensemble import stack_trees as tstack
from lightgbm_tpu_torch.ops.predict import bins_column, predict_binned
from lightgbm_tpu_torch.tree import linear as tlin

ROUNDS = 4
BASE = dict(num_leaves=7, learning_rate=0.3, verbose=-1, linear_tree=True, linear_lambda=0.01,
            min_data_in_leaf=20)
CELLS = {"l2": dict(BASE, objective="regression"), "binary": dict(BASE, objective="binary")}


@pytest.fixture(scope="module", autouse=True)
def jax_shim():
    had = hasattr(jax.core, "trace_state_clean")
    if not had:
        jax.core.trace_state_clean = jax._src.core.trace_state_clean
    yield
    if not had:
        del jax.core.trace_state_clean


def _problem(seed=0, n=1000, f=4):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f)
    y = 1.0 * X[:, 0] - 0.7 * X[:, 1] + 0.3 * X[:, 2] + 0.05 * rng.randn(n)
    return X, y


def _label(cell, y):
    return (y > 0).astype(np.float64) if cell == "binary" else y


@pytest.fixture(scope="module")
def models(jax_shim):
    """Each cell trained once by each package, and a JAX continuation of
    the port's L2 model by 2 iterations (init_model)."""
    X, y = _problem()
    out = {}
    for cell, params in CELLS.items():
        yl = _label(cell, y)
        jb = lgb.train(params, lgb.Dataset(X, label=yl), ROUNDS)
        tb = lgt.train(params, lgt.Dataset(X, label=yl), ROUNDS, device="cpu",
                       keep_training_booster=True)
        assert tb.boosting.ptrainer is None
        out[cell] = (jb, tb)
    jinit = lgb.Booster(model_str=out["l2"][1].model_to_string())
    out["init"] = lgb.train(CELLS["l2"], lgb.Dataset(X, label=y), 2, init_model=jinit)
    return X, y, out


def _model_splits(text):
    trees, cur = [], {}
    for line in text.splitlines():
        for key in ("split_feature", "threshold", "split_gain"):
            if line.startswith(key + "="):
                cur[key] = line.split("=", 1)[1].split()
        if line.startswith("shrinkage=") and cur:
            trees.append(cur)
            cur = {}
    return trees


def _tree_blocks(text):
    return ("Tree=" + text.split("Tree=", 1)[1]).split("\nfeature importances:")[0]


def assert_same_splits(jtext, ttext):
    """The same split features and thresholds tree by tree, or the first
    differing split a near-tie (gains within 1e-3 relative)."""
    jt, tt = _model_splits(jtext), _model_splits(ttext)
    assert len(jt) == len(tt)
    for a, b in zip(jt, tt):
        if a["split_feature"] == b["split_feature"] and a["threshold"] == b["threshold"]:
            continue
        i = next(i for i, (fa, fb, ta, tb) in enumerate(zip(
            a["split_feature"], b["split_feature"], a["threshold"], b["threshold"]))
            if fa != fb or ta != tb)
        ga, gb = float(a["split_gain"][i]), float(b["split_gain"][i])
        assert abs(ga - gb) <= 1e-3 * max(abs(ga), abs(gb)), (i, ga, gb)
        return


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-12)


# ----------------------------------------------------------------------
# the pieces
# ----------------------------------------------------------------------
def test_value_lut_matches_jax():
    rng = np.random.default_rng(1)
    X = rng.standard_normal((500, 4))
    X[:, 2] = rng.integers(0, 5, 500)
    kw = dict(label=X[:, 0], categorical_feature=[2])
    params = dict(max_bin=31, verbose=-1)
    jd = lgb.Dataset(X, **kw).construct(params)
    td = lgt.Dataset(X, **kw).construct(params)
    for nb in (int(td.max_num_bin), 40):
        np.testing.assert_array_equal(tlin.build_value_lut(td, nb), jlin.build_value_lut(jd, nb))


class _Rec:
    """A grow result's split records."""

    def __init__(self, num_splits, rec_leaf, rec_feat):
        self.num_splits, self.rec_leaf, self.rec_feat = num_splits, rec_leaf, rec_feat


def test_leaf_paths_match_jax():
    rec = _Rec(6, np.array([0, 1, 0, 2, 3, 1]), np.array([2, 0, 2, 1, 3, 3]))
    is_cat = np.array([False, False, False, True])
    tp, jp = tlin.leaf_path_features(rec, is_cat), jlin.leaf_path_features(rec, is_cat)
    assert tp == jp
    for k_max in (0, 5):
        for a, b in zip(tlin.pack_path_features(tp, 7, k_max),
                        jlin.pack_path_features(jp, 7, k_max)):
            np.testing.assert_array_equal(a, b)


def _fit_case(seed, n=3000, F=5, B=16, L=6, k=3):
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, B, (n, F)).astype(np.uint8)
    g = rng.standard_normal(n).astype(np.float32)
    h = (rng.random(n) + 0.1).astype(np.float32)
    sel = (rng.random(n) < 0.8).astype(np.float32)
    leaf = rng.integers(0, L, n).astype(np.int32)
    paths = [tuple(rng.choice(F, rng.integers(0, k + 1), replace=False)) for _ in range(L)]
    fi, fv = jlin.pack_path_features(paths, L, k)
    lut = np.sort(rng.standard_normal((F, B)).astype(np.float32), axis=1)
    return bins, g, h, sel, leaf, fi, fv, lut, L


@pytest.mark.parametrize("seed", [0, 1])
def test_fit_stats_match_jax(seed):
    bins, g, h, sel, leaf, fi, fv, lut, L = _fit_case(seed)
    ja, jb = jlin.linear_fit_stats(jnp.asarray(bins), jnp.asarray(g), jnp.asarray(h),
                                   jnp.asarray(sel), jnp.asarray(leaf), jnp.asarray(fi),
                                   jnp.asarray(fv), jnp.asarray(lut), L, row_block=1024)
    ta, tb = tlin.linear_fit_stats(bins_column(torch.from_numpy(bins)), torch.from_numpy(g),
                                   torch.from_numpy(h), torch.from_numpy(sel),
                                   torch.from_numpy(leaf), fi, fv, torch.from_numpy(lut), L)
    assert _rel(ta.numpy(), np.asarray(ja)) <= 1e-4
    assert _rel(tb.numpy(), np.asarray(jb)) <= 1e-4


def _solve_both(a, b, fv, cnt, lam=0.0, l2=0.0):
    jw, jok = jlin.solve_linear_leaves(jnp.asarray(a), jnp.asarray(b), jnp.asarray(fv),
                                       jnp.asarray(cnt), jnp.float32(lam), jnp.float32(l2))
    tw, tok = tlin.solve_linear_leaves(torch.from_numpy(a), torch.from_numpy(b), fv, cnt, lam,
                                       l2)
    return np.asarray(jw), np.asarray(jok), tw.numpy(), tok.numpy()


@pytest.mark.parametrize("seed", [0, 1])
def test_solve_matches_jax(seed):
    bins, g, h, sel, leaf, fi, fv, lut, L = _fit_case(seed)
    a, b = tlin.linear_fit_stats(bins_column(torch.from_numpy(bins)), torch.from_numpy(g),
                                 torch.from_numpy(h), torch.from_numpy(sel),
                                 torch.from_numpy(leaf), fi, fv, torch.from_numpy(lut), L)
    cnt = np.bincount(leaf, weights=sel, minlength=L).astype(np.float32)
    cnt[0] = 2.0  # one leaf too small for its coefficients
    jw, jok, tw, tok = _solve_both(a.numpy(), b.numpy(), fv, cnt, 0.5, 1.0)
    np.testing.assert_array_equal(tok, jok)
    assert tok.sum() >= 2
    np.testing.assert_allclose(tw, jw, rtol=1e-4, atol=1e-6)


def test_solve_degenerate_leaves_fall_back():
    """The JAX test's leaves: a healthy fit, no valid feature, too few
    rows, and a zero matrix (not positive definite)."""
    L, k1 = 4, 3
    a = np.zeros((L, k1, k1), np.float32)
    b = np.zeros((L, k1), np.float32)
    fv = np.zeros((L, k1 - 1), np.float32)
    fv[0, 0] = 1.0
    a[0] = np.diag([50.0, 10.0, 0.0]).astype(np.float32)
    b[0] = [5.0, -2.0, 0.0]
    fv[2, :] = 1.0
    fv[3, 0] = 1.0
    cnt = np.asarray([50.0, 50.0, 2.0, 50.0], np.float32)
    jw, jok, tw, tok = _solve_both(a, b, fv, cnt)
    np.testing.assert_array_equal(tok, jok)
    assert list(tok) == [True, False, False, False]
    np.testing.assert_allclose(tw[0, :2], [-0.1, 0.2], atol=1e-6)
    np.testing.assert_allclose(tw, jw, rtol=1e-4, atol=1e-6)


def test_leaf_scores_match_jax():
    bins, g, h, sel, leaf, fi, fv, lut, L = _fit_case(3)
    rng = np.random.default_rng(3)
    coeff = (rng.standard_normal(fi.shape) * fv).astype(np.float32)
    const = rng.standard_normal(L).astype(np.float32)
    fallback = rng.standard_normal(L).astype(np.float32)
    is_lin = fv.sum(1) > 0
    is_lin[1] = False
    want = np.asarray(jlin.linear_leaf_scores(
        jnp.asarray(bins), jnp.asarray(leaf), jnp.asarray(fi), jnp.asarray(fv),
        jnp.asarray(coeff), jnp.asarray(const), jnp.asarray(fallback), jnp.asarray(is_lin),
        jnp.asarray(lut)))
    got = tlin.linear_leaf_scores(
        bins_column(torch.from_numpy(bins)), torch.from_numpy(leaf),
        torch.from_numpy(fi.astype(np.int64)), torch.from_numpy(fv), torch.from_numpy(coeff),
        torch.from_numpy(const), torch.from_numpy(fallback), torch.from_numpy(is_lin),
        torch.from_numpy(lut)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_predict_binned_matches_jax(models):
    """The port's trees walked over the training bins by both packages'
    binned predictors (the JAX one through predict_linear_binned)."""
    X, y, out = models
    g = out["l2"][1].boosting
    trees = g.models[1:]
    bins = np.asarray(g.train_set.binned)
    lut = tlin.build_value_lut(g.train_set, int(g.train_set.max_num_bin))
    ja = jstack(trees)
    want = np.asarray(jlin.predict_linear_binned(
        jnp.asarray(bins), ja["split_feature_inner"], ja["threshold_bin"], ja["zero_bin"],
        ja["default_bin_for_zero"], ja["is_categorical"], ja["left_child"], ja["right_child"],
        ja["leaf_value"], ja["leaf_feat_inner"], ja["leaf_feat_valid"], ja["leaf_coeff"],
        ja["leaf_const"], ja["leaf_is_linear"], jnp.asarray(lut)))
    got = predict_binned(torch.from_numpy(bins), tstack(trees), torch.from_numpy(lut)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # the training scores are the same walk plus the boost-from-average tree
    np.testing.assert_allclose(g.scores[0].numpy(), got + g.models[0].leaf_value[0], rtol=1e-5,
                               atol=1e-5)


# ----------------------------------------------------------------------
# trained models and model text
# ----------------------------------------------------------------------
@pytest.mark.parametrize("cell", list(CELLS))
def test_trained_model_matches_jax(models, cell):
    X, y, out = models
    jb, tb = out[cell]
    jt, tt = jb.model_to_string(), tb.model_to_string()
    assert "is_linear=1" in tt
    assert_same_splits(jt, tt)
    for a, b in zip(jb.boosting.models, tb.boosting.models):
        np.testing.assert_array_equal(a.leaf_is_linear[:a.num_leaves],
                                      b.leaf_is_linear[:b.num_leaves])
    assert any(t.leaf_is_linear[:t.num_leaves].any() for t in tb.boosting.models)
    np.testing.assert_allclose(tb.predict(X, raw_score=True), jb.predict(X, raw_score=True),
                               rtol=3e-3, atol=3e-3)


def test_text_round_trip(models):
    X, y, out = models
    tb = out["l2"][1]
    text = tb.model_to_string()
    back = lgt.Booster(model_str=text, device="cpu")
    assert _tree_blocks(back.model_to_string()) == _tree_blocks(text)
    np.testing.assert_array_equal(back.predict(X), tb.predict(X))


@pytest.mark.parametrize("cell", list(CELLS))
def test_models_cross_load(models, cell):
    """§C 1: each package loads the other's linear model; NaN path
    features keep the leaf constant in both."""
    X, y, out = models
    jb, tb = out[cell]
    Xn = X.copy()
    Xn[::7, 0] = np.nan
    Xn[::11, 1] = np.nan
    for Z in (X, Xn):
        t_from_j = lgt.Booster(model_str=jb.model_to_string(), device="cpu")
        np.testing.assert_allclose(t_from_j.predict(Z, raw_score=True),
                                   jb.predict(Z, raw_score=True), rtol=0, atol=1e-6)
        j_from_t = lgb.Booster(model_str=tb.model_to_string())
        np.testing.assert_allclose(j_from_t.predict(Z, raw_score=True),
                                   tb.predict(Z, raw_score=True), rtol=0, atol=1e-6)


def test_tree_predict_matches_jax(models):
    """``Tree.predict`` (the host walk) of each linear tree of one model
    text, NaN path features keeping the constant, in float64: equal to
    the JAX package's ``Tree.predict`` within 1e-12."""
    X, y, out = models
    text = out["binary"][1].model_to_string()
    Xn = X[:200].copy()
    Xn[::5, 0] = np.nan
    tt = lgt.Booster(model_str=text, device="cpu").boosting.models
    jt = lgb.Booster(model_str=text).boosting.models
    assert any(t.is_linear for t in tt)
    for a, b in zip(tt, jt):
        np.testing.assert_allclose(a.predict(Xn), b.predict(Xn), rtol=1e-12, atol=1e-12)


def test_dump_model_matches_jax(models):
    """Both packages' JSON of the same linear model text (its leaves'
    intercepts, features and coefficients)."""
    X, y, out = models
    text = out["l2"][1].model_to_string()
    tj = lgt.Booster(model_str=text, device="cpu").dump_model()["tree_info"]
    jj = lgb.Booster(model_str=text).dump_model()["tree_info"]
    assert len(tj) == len(jj)
    for a, b in zip(tj, jj):
        assert a.get("is_linear") == b.get("is_linear")
        assert a["tree_structure"] == b["tree_structure"]
    assert "leaf_coeff=" in text and '"leaf_coeff"' in str(tj).replace("'", '"')


# ----------------------------------------------------------------------
# the rest of the API
# ----------------------------------------------------------------------
def test_pred_early_stop_matches_jax(models):
    X, y, out = models
    tb = out["binary"][1]
    jb = lgb.Booster(model_str=tb.model_to_string())
    inst = jpes.create_prediction_early_stop_instance("binary", 2, 0.5)
    want = jpes.predict_with_early_stop(jb.boosting, X[:300], inst)[:, 0]
    got = tb.predict(X[:300], raw_score=True, pred_early_stop=True, pred_early_stop_freq=2,
                     pred_early_stop_margin=0.5)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    assert np.abs(got - tb.predict(X[:300], raw_score=True)).max() > 1e-3  # rows exited early


def test_rollback_and_update():
    """Rollback takes the last linear tree's outputs back off the scores
    (within 1e-6: float32 (s + d) - d); the tree regrown on them has the
    same splits and linear leaves, its coefficients within 1e-5 (the
    scores, hence the gradients, may differ in their last bits)."""
    X, y = _problem(seed=4, n=600)
    tb = lgt.train(CELLS["l2"], lgt.Dataset(X, label=y), 3, device="cpu",
                   keep_training_booster=True)
    before = tb.boosting.scores.clone()
    text = tb.model_to_string()
    tb.update()
    popped = tb.model_to_string()
    tb.rollback_one_iter()
    assert float((tb.boosting.scores - before).abs().max()) <= 1e-6
    assert tb.model_to_string() == text
    tb.update()
    regrown = tb.model_to_string()
    assert ([(t["split_feature"], t["threshold"]) for t in _model_splits(regrown)]
            == [(t["split_feature"], t["threshold"]) for t in _model_splits(popped)])
    a, b = lgt.Booster(model_str=popped, device="cpu"), tb
    np.testing.assert_allclose(b.predict(X, raw_score=True), a.predict(X, raw_score=True),
                               rtol=1e-5, atol=1e-6)


def test_init_model_matches_jax(models):
    X, y, out = models
    tb = out["l2"][1]
    cont = lgt.train(CELLS["l2"], lgt.Dataset(X, label=y), 2, init_model=tb, device="cpu")
    jt, tt = out["init"].model_to_string(), cont.model_to_string()
    assert _tree_blocks(tt).startswith(_tree_blocks(tb.model_to_string()).rstrip("\n"))
    assert_same_splits(jt, tt)
    np.testing.assert_allclose(cont.predict(X, raw_score=True),
                               out["init"].predict(X, raw_score=True), rtol=3e-3, atol=3e-3)


def test_sklearn_regressor_linear():
    X, y = _problem(seed=5, n=600)
    params = dict(num_leaves=7, learning_rate=0.3, linear_lambda=0.01, min_child_samples=20)
    reg = lgt.LGBMRegressor(n_estimators=3, linear_tree=True, device="cpu", verbose=-1,
                            **params)
    reg.fit(X, y)
    ref = lgt.train(dict(objective="regression", linear_tree=True, verbose=-1,
                         min_data_in_leaf=20, num_leaves=7, learning_rate=0.3,
                         linear_lambda=0.01), lgt.Dataset(X, label=y), 3, device="cpu")
    assert _tree_blocks(reg.booster_.model_to_string()) == _tree_blocks(ref.model_to_string())
    np.testing.assert_array_equal(reg.predict(X), ref.predict(X))


@pytest.mark.parametrize("sampling", [dict(boosting="goss", top_rate=0.3, other_rate=0.2),
                                      dict(bagging_fraction=0.6, bagging_freq=1)],
                         ids=["goss", "bagging"])
def test_linear_trains_with_sampling(sampling):
    X, y = _problem(seed=6, n=800)
    tb = lgt.train(dict(CELLS["l2"], learning_rate=0.5, **sampling), lgt.Dataset(X, label=y), 4,
                   device="cpu")
    trees = tb.boosting.models[1:]
    assert len(trees) == 4 and all(t.is_linear for t in trees)
    assert any(t.leaf_is_linear[:t.num_leaves].any() for t in trees)
    p = tb.predict(X)
    assert np.all(np.isfinite(p)) and np.mean((p - y) ** 2) < np.var(y)
