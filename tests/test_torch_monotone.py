"""Monotone constraints in lightgbm_tpu_torch against the JAX package.

Both packages train on their mask growers here (the partitioned trainer
declines monotone constraints in both), the port on ``device="cpu"``.
Held:

- the grower alone (ops/grow.py) on dyadic gradients, whose histogram
  sums are exact in both packages: the same split records, leaf outputs
  and bounds-clipped values bit for bit, gains within 1e-5 relative,
  the same partition;
- trained models, binary on float32 and quantized gradients and L2
  (4 of 6 features constrained): the same split lines tree by tree, or a
  first differing split that is a near-tie (gains within 1e-3 relative),
  and raw predictions within 3e-3 (ROADMAP §C: the JAX mask grower's
  float32 histogram sums against the port's correctly rounded ones);
- the property tests/test_monotone.py holds, on the port's own
  predictions: sweeping a constrained feature over its range moves no
  prediction against its direction by more than 1e-6;
- all-zero constraints train the unconstrained model byte for byte;
- monotone models cross-load both ways with predictions within 1e-6.
"""

import numpy as np
import pytest
import torch

import jax
import jax._src.core
import jax.numpy as jnp

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.ops import grow as jgrow
from lightgbm_tpu.ops import split as jsplit
from lightgbm_tpu.tree.strategy import SplitGainStrategy, TreeStrategy
from lightgbm_tpu_torch.ops import grow as tgrow
from lightgbm_tpu_torch.ops import split as tsplit
from lightgbm_tpu_torch.ops.histogram import pack_bin_words

ROUNDS = 4
MONO = "1,-1,0,1,-1,0"
BASE = dict(num_leaves=15, min_data_in_leaf=20, learning_rate=0.3, verbose=-1, seed=3,
            max_bin=63, monotone_constraints=MONO)
CELLS = {
    "binary": dict(BASE, objective="binary"),
    "binary_quantized": dict(BASE, objective="binary", use_quantized_grad=True),
    "l2": dict(BASE, objective="regression"),
}


@pytest.fixture(scope="module", autouse=True)
def jax_shim():
    """The jax 0.9 ``trace_state_clean`` shim the JAX package's compile
    watch needs."""
    had = hasattr(jax.core, "trace_state_clean")
    if not had:
        jax.core.trace_state_clean = jax._src.core.trace_state_clean
    yield
    if not had:
        del jax.core.trace_state_clean


def _problem(seed=0, n=1500, f=6):
    rng = np.random.RandomState(seed)
    X = rng.uniform(-2.0, 2.0, size=(n, f))
    y = 1.2 * X[:, 0] - 0.8 * X[:, 1] + 0.4 * np.sin(3 * X[:, 2]) + 0.2 * rng.randn(n)
    return X, y


def _label(cell, y):
    return (y > 0).astype(np.float64) if CELLS[cell]["objective"] == "binary" else y


@pytest.fixture(scope="module")
def models(jax_shim):
    """Each cell trained once by each package: {cell: (jax text, port booster)}."""
    X, y = _problem()
    out = {}
    for cell, params in CELLS.items():
        yl = _label(cell, y)
        jb = lgb.train(params, lgb.Dataset(X, label=yl), ROUNDS)
        tb = lgt.train(params, lgt.Dataset(X, label=yl), ROUNDS, device="cpu")
        assert tb.boosting.ptrainer is None
        out[cell] = (jb.model_to_string(), tb, jb.predict(X, raw_score=True))
    return X, out


def _model_splits(text):
    """Per tree: (split_feature, threshold, split_gain) string lists."""
    trees, cur = [], {}
    for line in text.splitlines():
        for key in ("split_feature", "threshold", "split_gain"):
            if line.startswith(key + "="):
                cur[key] = line.split("=", 1)[1].split()
        if line.startswith("shrinkage=") and cur:
            trees.append(cur)
            cur = {}
    return trees


def assert_same_splits(jtext, ttext):
    """The same split features and thresholds tree by tree, or the first
    differing split a near-tie: its gain and the other's within 1e-3
    relative (the trees after it may then differ)."""
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


def worst_step(predict, f, feat, sign, rng, grid_n=48, rows=40):
    """The least signed step of the predictions when ``feat`` sweeps its
    range for random base rows (tests/test_monotone.py)."""
    base = rng.uniform(-2.0, 2.0, size=(rows, f))
    preds = []
    for v in np.linspace(-2.2, 2.2, grid_n):
        Z = base.copy()
        Z[:, feat] = v
        preds.append(predict(Z))
    return float((np.diff(np.stack(preds), axis=0) * sign).min())


@pytest.mark.parametrize("cell", list(CELLS))
def test_trained_model_matches_jax(models, cell):
    X, out = models
    jtext, tb, jpred = out[cell]
    assert_same_splits(jtext, tb.model_to_string())
    np.testing.assert_allclose(tb.predict(X, raw_score=True), jpred, rtol=3e-3, atol=3e-3)


@pytest.mark.parametrize("cell", list(CELLS))
def test_sweep_is_monotone(models, cell):
    X, out = models
    tb = out[cell][1]
    rng = np.random.RandomState(7)
    for feat, sign in enumerate(int(c) for c in MONO.split(",")):
        if sign:
            assert worst_step(lambda Z: tb.predict(Z, raw_score=True), X.shape[1], feat, sign,
                              rng) >= -1e-6, feat


@pytest.mark.parametrize("cell", ["binary", "l2"])
def test_models_cross_load(models, cell):
    X, out = models
    jtext, tb, jpred = out[cell]
    t_from_j = lgt.Booster(model_str=jtext, device="cpu")
    np.testing.assert_allclose(t_from_j.predict(X, raw_score=True), jpred, rtol=0, atol=1e-6)
    j_from_t = lgb.Booster(model_str=tb.model_to_string())
    np.testing.assert_allclose(j_from_t.predict(X, raw_score=True), tb.predict(X, raw_score=True),
                               rtol=0, atol=1e-6)


def test_all_zero_constraints_byte_identical():
    X, y = _problem(seed=9, n=800)
    base = dict(objective="regression", num_leaves=15, min_data_in_leaf=20, verbose=-1)
    t0 = lgt.train(base, lgt.Dataset(X, label=y), 5, device="cpu")
    t1 = lgt.train(dict(base, monotone_constraints="0,0,0,0,0,0"), lgt.Dataset(X, label=y), 5,
                   device="cpu")
    t2 = lgt.train(dict(base, monotone_constraints={}), lgt.Dataset(X, label=y), 5,
                   device="cpu")
    assert t0.model_to_string() == t1.model_to_string() == t2.model_to_string()


def test_lambdarank_declines_like_jax():
    X, y = _problem(n=200)
    params = dict(objective="lambdarank", monotone_constraints=MONO, verbose=-1)
    grp = [100, 100]
    with pytest.raises(lgb.LightGBMError) as je:
        lgb.train(params, lgb.Dataset(X, label=(y > 0).astype(float), group=grp), 1)
    with pytest.raises(lgt.LightGBMError) as te:
        lgt.train(params, lgt.Dataset(X, label=(y > 0).astype(float), group=grp), 1,
                  device="cpu")
    assert str(te.value) == str(je.value)


# ----------------------------------------------------------------------
# the grower alone
# ----------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("max_depth", [-1, 3])
def test_grower_matches_jax(seed, max_depth):
    """One tree of each grower on the same bins and dyadic gradients,
    with random directions (a categorical column unconstrained): every
    record equal, the clipped leaf outputs bit for bit."""
    rng = np.random.default_rng(seed)
    n, F, B, L = 3000, 6, 32, 15
    bins = rng.integers(0, B, (n, F)).astype(np.uint8)
    nb = np.full(F, B, np.int32)
    db = rng.integers(0, B, F).astype(np.int32)
    is_cat = np.zeros(F, bool)
    is_cat[5] = True
    bins[:, 5] %= 6
    nb[5], db[5] = 6, 0
    mono = tuple(int(c) for c in rng.integers(-1, 2, F))
    mono = mono[:5] + (0,)
    # dyadic gradients correlated with two columns, so constraints bind
    g = np.round((bins[:, 0] / B - bins[:, 1] / B + rng.standard_normal(n) * 0.3) * 64) / 64
    g = g.astype(np.float32)
    h = (np.round(rng.random(n) * 16) / 64 + 1 / 64).astype(np.float32)
    sel = np.ones(n, np.float32)
    fmask = np.ones(F, np.float32)
    hyper = (0.0, 1.0, 10.0, 1e-3, 0.0)

    jmeta = jsplit.FeatureMeta(jnp.asarray(nb), jnp.asarray(db), jnp.asarray(is_cat))
    jhyp = jsplit.SplitHyper(*(jnp.float32(v) for v in hyper))
    jparams = jgrow.GrowParams(num_leaves=L, num_bins=B, max_depth=max_depth,
                               strategy=TreeStrategy(split_gain=SplitGainStrategy(mono)))
    jr = jgrow.grow_tree(jnp.asarray(bins), jnp.asarray(g), jnp.asarray(h), jnp.asarray(sel),
                         jnp.asarray(fmask), jmeta, jhyp, jparams)

    tmeta = tsplit.FeatureMeta(torch.from_numpy(nb.astype(np.int64)),
                               torch.from_numpy(db.astype(np.int64)), torch.from_numpy(is_cat))
    thyp = tsplit.SplitHyper(*(np.float32(v) for v in hyper))
    tparams = tgrow.GrowParams(num_leaves=L, num_bins=B, max_depth=max_depth, monotone=mono)
    words = pack_bin_words(torch.from_numpy(bins), 4, 8)
    tr = tgrow.grow_tree(words, torch.from_numpy(g), torch.from_numpy(h), torch.from_numpy(sel),
                         torch.from_numpy(fmask), tmeta, thyp, tparams)

    s = int(jr.num_splits)
    assert tr.num_splits == s and s > 3
    for name in ("rec_leaf", "rec_feat", "rec_thr", "rec_dbz", "rec_lval", "rec_rval",
                 "rec_lcnt", "rec_rcnt", "rec_internal_value"):
        np.testing.assert_array_equal(getattr(tr, name)[:s], np.asarray(getattr(jr, name))[:s],
                                      err_msg=name)
    np.testing.assert_allclose(tr.rec_gain[:s], np.asarray(jr.rec_gain)[:s], rtol=1e-5)
    np.testing.assert_array_equal(tr.leaf_id.numpy(), np.asarray(jr.leaf_id))
    np.testing.assert_array_equal(tr.leaf_value, np.asarray(jr.leaf_value))
    # some split was clipped or scored at its bounds: the constraint bound
    assert any(mono[f] for f in tr.rec_feat[:s])
