"""The mask grower of lightgbm_tpu_torch (ops/grow.py, float32 branch)
against the JAX package's.

Both packages get the same seeded numpy inputs; the JAX package runs on
the CPU on its mask grower (LIGHTGBM_TPU_PGROW=0; off a TPU it takes
that learner anyway), the port on ``device="cpu"``.  Held:

- ``hist_segment_ref`` (B8's plain version) against the Pallas
  ``hist_segment`` in interpret mode: counts exact, sums within 2e-3 of
  the largest bin (the tolerance of tests/test_torch_kernels.py: interpret
  mode emulates the TPU's bf16 three-term sums, the port sums in float64
  and rounds once);
- the float32 mask grower under LIGHTGBM_TPU_PGROW=0, binary and weighted
  L2 at 7 and 31 leaves, with bagging (RandomState permutations) and
  feature_fraction (the LCG of utils/random.py): the same split lines,
  the same draws, predictions within rtol 3e-3 / atol 3e-4 (the JAX
  histograms are float32 matmul sums, the port's correctly rounded);
- multiclass GOSS on the mask grower: ``threefry.split`` bit-equal to
  ``jax.random.split``, the same selection and up-weighted gradients,
  the same split lines and predictions; where a split is a near-tie
  (gains equal to six digits) the first differing split is held to the
  1e-3 relative-gain rule of tests/test_torch_multiclass.py;
- the routes the partitioned trainer declines (17 classes, 511 bins on
  uint16 bins, 600 columns) train on the mask grower and match the JAX
  package's split lines and predictions.
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
from lightgbm_tpu.ops import histogram_pallas as jhp
from lightgbm_tpu_torch.boosting.ptrainer import eligible
from lightgbm_tpu_torch.ops import histogram as thist
from lightgbm_tpu_torch.utils import threefry

ROUNDS = 4
HIST_TOL = 2e-3


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


def _split_lines(text):
    return [line for line in text.splitlines()
            if line.startswith(("Tree=", "num_leaves=", "split_feature=", "threshold=",
                                "decision_type=", "left_child=", "right_child="))]


def _model_splits(text):
    """Per tree: (split_feature, threshold, split_gain) lists."""
    trees, cur = [], {}
    for line in text.splitlines():
        for key in ("split_feature", "threshold", "split_gain"):
            if line.startswith(key + "="):
                cur[key] = line.split("=", 1)[1].split()
        if line.startswith("shrinkage=") and cur:
            trees.append(cur)
            cur = {}
    return trees


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1.0)


# ----------------------------------------------------------------------
# B8's plain version
# ----------------------------------------------------------------------
@pytest.mark.parametrize("per,bits,B", [(4, 8, 32), (2, 16, 300)], ids=["8bit", "16bit"])
def test_hist_segment_ref_matches_pallas(per, bits, B):
    n, f = 3072, 7
    rng = np.random.default_rng(bits)
    bins = rng.integers(0, B, (n, f)).astype(np.uint8 if B <= 256 else np.uint16)
    g = rng.standard_normal(n).astype(np.float32)
    h = np.abs(rng.standard_normal(n)).astype(np.float32)
    sel = (rng.random(n) < 0.7).astype(np.float32)
    pj = jhp.pack_columns(jnp.asarray(bins), jnp.asarray(g), jnp.asarray(h), jnp.asarray(sel),
                          per=per, bits=bits)
    tb = torch.from_numpy(bins if B <= 256 else bins.astype(np.int32))
    pt = thist.pack_columns(tb, torch.from_numpy(g), torch.from_numpy(h), torch.from_numpy(sel),
                            per=per, bits=bits)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    for lo, hi in ((0, n), (100, 2900), (517, 518)):
        want = np.asarray(jhp.hist_segment(pj, jnp.int32(lo), jnp.int32(hi), f, B, per=per,
                                           bits=bits, interpret=True))
        got = thist.hist_segment(pt, lo, hi, f, B, per, bits).numpy()  # the plain version
        np.testing.assert_array_equal(got[..., 2], want[..., 2])
        assert _rel(got, want) < HIST_TOL
    assert float(thist.hist_segment(pt, 40, 40, f, B, per, bits).abs().sum()) == 0.0


def test_build_histogram_float_matches_jax():
    """The float32 branch against the JAX ``build_histogram`` (an f32
    one-hot matmul at HIGHEST precision): counts exact, sums within
    1e-5 of the largest bin."""
    from lightgbm_tpu.ops import histogram as jhist

    rng = np.random.default_rng(5)
    bins = rng.integers(0, 32, (2500, 5)).astype(np.uint8)
    g = rng.standard_normal(2500).astype(np.float32)
    h = np.abs(rng.standard_normal(2500)).astype(np.float32)
    sel = (rng.random(2500) < 0.6).astype(np.float32)
    want = np.asarray(jhist.build_histogram(jnp.asarray(bins), jnp.asarray(g), jnp.asarray(h),
                                            jnp.asarray(sel), 32))
    got = thist.build_histogram(torch.from_numpy(bins), torch.from_numpy(g), torch.from_numpy(h),
                                torch.from_numpy(sel), 32).numpy()
    np.testing.assert_array_equal(got[..., 2], want[..., 2])
    assert _rel(got, want) < 1e-5


# ----------------------------------------------------------------------
# the float32 mask grower with bagging and feature_fraction
# ----------------------------------------------------------------------
CASES = [("binary", 7), ("binary", 31), ("l2_weighted", 7), ("l2_weighted", 31)]


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


@pytest.mark.parametrize("objective,leaves", CASES, ids=[f"{o}-{L}" for o, L in CASES])
def test_sampled_mask_grower_matches_jax(objective, leaves):
    X, y, w = _data(objective)
    params = dict(objective="binary" if objective == "binary" else "regression",
                  num_leaves=leaves, learning_rate=0.2, max_bin=31, min_data_in_leaf=20,
                  bagging_fraction=0.7, bagging_freq=2, feature_fraction=0.7, verbose=-1)
    jb = lgb.train(params, lgb.Dataset(X, label=y, weight=w), num_boost_round=ROUNDS)
    tb = lgt.train(params, lgt.Dataset(X, label=y, weight=w), ROUNDS, device="cpu")
    jg, tg = jb.boosting, tb.boosting
    assert jg.ptrainer is None and tg.ptrainer is None
    assert _split_lines(tb.model_to_string()) == _split_lines(jb.model_to_string())
    # the draws: the last bagging select and the feature LCG's state
    np.testing.assert_array_equal(tg.select.numpy(), np.asarray(jg.select))
    assert tg.feature_rng.get_state() == jg.feature_rng.get_state()
    np.testing.assert_allclose(tb.predict(X), np.asarray(jb.predict(X)), rtol=3e-3, atol=3e-4)


# ----------------------------------------------------------------------
# multiclass GOSS
# ----------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 3, 2 ** 31 - 1])
def test_threefry_split_matches_jax(seed):
    key, tkey = jax.random.PRNGKey(seed), threefry.PRNGKey(seed)
    for _ in range(3):  # the chain GOSS walks, one split per sampled iteration
        key, sub = jax.random.split(key)
        tkey, tsub = threefry.split(tkey)
        assert tkey == tuple(int(v) for v in np.asarray(key))
        assert tsub == tuple(int(v) for v in np.asarray(sub))
        np.testing.assert_array_equal(threefry.uniform(tsub, 1000).numpy(),
                                      np.asarray(jax.random.uniform(sub, (1000,))))


def _multi_data(seed, n=2000, k=4):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, 6)).astype(np.float32)
    z = X[:, 0] + 0.7 * rng.standard_normal(n)
    y = np.clip(np.floor((z + 1.5) * k / 3.0), 0, k - 1).astype(np.float32)
    return X, y


GOSS_PARAMS = dict(objective="multiclass", num_class=4, boosting="goss", learning_rate=0.5,
                   num_leaves=15, max_bin=31, min_data_in_leaf=20, verbose=-1)


def test_goss_selection_matches_jax():
    """The hooks alone, fed the same (K, N) gradients: select, the
    up-weighted gradients and the key chain, at a warm-up and three
    sampled iterations."""
    X, y = _multi_data(0)
    jb = lgb.Booster(GOSS_PARAMS, lgb.Dataset(X, label=y))
    tb = lgt.Booster(GOSS_PARAMS, lgt.Dataset(X, label=y), device="cpu")
    rng = np.random.default_rng(9)
    for it in (1, 2, 3, 4):
        g = rng.standard_normal((4, len(y))).astype(np.float32)
        h = np.abs(rng.standard_normal((4, len(y)))).astype(np.float32)
        g[:, :50] = g[:, :1]  # tied |g*h| scores: lower index first, as top_k
        h[:, :50] = h[:, :1]
        jb.boosting.iter = tb.boosting.iter = it
        jg, jh = jb.boosting._adjust_gradients(jnp.asarray(g), jnp.asarray(h))
        tg, th = tb.boosting._adjust_gradients(torch.from_numpy(g), torch.from_numpy(h))
        np.testing.assert_array_equal(tb.boosting.select.numpy(), np.asarray(jb.boosting.select))
        np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
        np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
        assert tb.boosting._goss_key == tuple(int(v) for v in np.asarray(jb.boosting._goss_key))
        if it >= 2:
            assert 0 < float(tb.boosting.select.sum()) < len(y)


def test_multiclass_goss_matches_jax():
    X, y = _multi_data(0)
    jb = lgb.train(GOSS_PARAMS, lgb.Dataset(X, label=y), num_boost_round=ROUNDS)
    tb = lgt.train(GOSS_PARAMS, lgt.Dataset(X, label=y), ROUNDS, device="cpu")
    assert tb.boosting.ptrainer is None and type(tb.boosting).__name__ == "GOSS"
    assert _split_lines(tb.model_to_string()) == _split_lines(jb.model_to_string())
    np.testing.assert_allclose(tb.predict(X), np.asarray(jb.predict(X)), rtol=3e-3, atol=3e-4)


def test_multiclass_goss_near_tie():
    """At seed 2 the first sampled iteration holds a split whose gain the
    JAX float32 matmul sums and the port's float64-rounded sums put
    within 1e-6 of each other: the trees up to it agree and the first
    differing split is a near-tie (1e-3 relative gain); GOSS then samples
    from different scores, so the models are not compared further."""
    X, y = _multi_data(2)
    jt = lgb.train(GOSS_PARAMS, lgb.Dataset(X, label=y), num_boost_round=ROUNDS)
    tt = lgt.train(GOSS_PARAMS, lgt.Dataset(X, label=y), ROUNDS, device="cpu")
    ja, ta = _model_splits(jt.model_to_string()), _model_splits(tt.model_to_string())
    assert len(ja) == len(ta)
    first = next(((t, i) for t, (a, b) in enumerate(zip(ja, ta))
                  for i in range(min(len(a["split_feature"]), len(b["split_feature"])))
                  if (a["split_feature"][i], a["threshold"][i])
                  != (b["split_feature"][i], b["threshold"][i])), None)
    assert first is not None and first[0] >= 2 * 4  # in the first sampled iteration or later
    t, i = first
    ga, gb = float(ja[t]["split_gain"][i]), float(ta[t]["split_gain"][i])
    assert abs(ga - gb) <= 1e-3 * max(abs(ga), abs(gb)), (first, ga, gb)


# ----------------------------------------------------------------------
# the routes the partitioned trainer declines
# ----------------------------------------------------------------------
def _route(name):
    rng = np.random.default_rng(7)
    base = dict(learning_rate=0.2, min_data_in_leaf=20, verbose=-1, num_leaves=7)
    if name == "17-classes":
        X = rng.standard_normal((3400, 5)).astype(np.float32)
        z = X[:, 0] + 0.5 * X[:, 1] + 0.5 * rng.standard_normal(3400)
        y = np.clip(np.floor((z + 3) * 17 / 6), 0, 16).astype(np.float32)
        return X, y, dict(base, objective="multiclass", num_class=17, max_bin=31), 2
    if name == "511-bins":
        X = rng.standard_normal((3000, 4)).astype(np.float32)
        y = (X[:, 0] + 0.5 * X[:, 1] + 0.3 * rng.standard_normal(3000)).astype(np.float32)
        return X, y, dict(base, objective="regression", max_bin=511, num_leaves=15), 3
    X = rng.standard_normal((1500, 600)).astype(np.float32)
    y = (X[:, :5].sum(axis=1) + rng.standard_normal(1500) > 0).astype(np.float32)
    return X, y, dict(base, objective="binary", max_bin=31), 2


ROUTES = {"17-classes": "more than 16 classes", "511-bins": "more than 256 bins per feature",
          "600-columns": "more than 512 feature columns"}


@pytest.mark.parametrize("name", sorted(ROUTES))
def test_declined_routes_match_jax(name, monkeypatch):
    X, y, params, rounds = _route(name)
    jb = lgb.train(params, lgb.Dataset(X, label=y), num_boost_round=rounds)
    monkeypatch.delenv("LIGHTGBM_TPU_PGROW")  # the port routes by eligible alone
    tb = lgt.train(params, lgt.Dataset(X, label=y), rounds, device="cpu")
    g = tb.boosting
    assert g.ptrainer is None
    assert eligible(g.config, g.train_set, g.objective, g.num_tree_per_iteration) == ROUTES[name]
    if name == "511-bins":
        assert g.train_set.binned.dtype == np.uint16 and g.grow_params.bits == 16
    assert _split_lines(tb.model_to_string()) == _split_lines(jb.model_to_string())
    np.testing.assert_allclose(tb.predict(X), np.asarray(jb.predict(X)), rtol=3e-3, atol=3e-4)


def test_pgrow_switch(monkeypatch):
    """LIGHTGBM_TPU_PGROW=0 sends a configuration the partitioned trainer
    takes to the mask grower; without it the partitioned trainer runs."""
    X, y, _ = _data("binary")
    params = dict(objective="binary", num_leaves=7, verbose=-1)
    assert lgt.train(params, lgt.Dataset(X, label=y), 1, device="cpu").boosting.ptrainer is None
    monkeypatch.delenv("LIGHTGBM_TPU_PGROW")
    assert lgt.train(params, lgt.Dataset(X, label=y), 1,
                     device="cpu").boosting.ptrainer is not None
