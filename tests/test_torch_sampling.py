"""Sampled training in the port against the JAX package.

- ``lightgbm_tpu_torch.utils.threefry`` gives ``jax.random``'s bits
  exactly: ``PRNGKey``, ``fold_in`` chains, ``uniform`` and ``bernoulli``.
- The fused trainer's draws (ptrainer.py:349-404): the bagging select,
  the feature_fraction mask (``jax.lax.top_k``'s selection and tie
  order) and GOSS's (select, multiplier) on tied |g*h| scores, each equal
  to the JAX expression on the same key.
- ``update_channels_ref`` against the Pallas ``update_channels`` in
  interpret mode over columns [0, n): select and score bit-equal, L2
  gradients bit-equal, binary gradients within 1e-6 relative (XLA's
  float32 exp and the port's float64-rounded exp differ by an ulp, as in
  tests/test_torch_kernels.py).  ``update_and_root_hist_ref``'s ``mul``
  against the Pallas kernel the same way, its histogram within 2e-3
  (interpret mode's bf16 three-term sums).
- Models with bagging plus feature_fraction (binary, L2, multiclass K=3)
  and with GOSS (binary) against the JAX fused trainer
  (LIGHTGBM_TPU_PGROW=force): the same split lines, predictions within
  3e-3 / 3e-4 (tests/test_torch_train.py).

The JAX fused trainer reads ``config.boosting`` to switch GOSS on
(ptrainer.py:296, :1546), but its Config names the field
``boosting_type`` and has no ``boosting``, so that branch never runs and
``boosting="goss"`` trains plain GBDT there.  The module fixture adds a
``boosting`` alias to the JAX Config while these tests run, so the
reference runs the GOSS branch it was written with.
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
from lightgbm_tpu.ops import pkernels as jpk
from lightgbm_tpu_torch.boosting import ptrainer as tpt
from lightgbm_tpu_torch.ops import pkernels as tpk
from lightgbm_tpu_torch.utils import threefry

from test_torch_kernels import _make_packed, _objectives, _rel

ROUNDS = 6
NS = [1, 7, 1000, 100003]


@pytest.fixture(scope="module", autouse=True)
def jax_reference_shims():
    """jax 0.9 moved ``trace_state_clean`` out of ``jax.core``, where the
    JAX package's compile watch imports it from; and the JAX Config has no
    ``boosting`` field for the fused trainer's GOSS switch.  Both are
    added for this module and removed afterwards."""
    had = hasattr(jax.core, "trace_state_clean")
    if not had:
        jax.core.trace_state_clean = jax._src.core.trace_state_clean
    JConfig.boosting = property(lambda self: self.boosting_type)
    yield
    del JConfig.boosting
    if not had:
        del jax.core.trace_state_clean


def _jkey_words(key):
    return tuple(int(x) for x in np.asarray(jax.random.key_data(key)))


# ----------------------------------------------------------------------
# threefry bits
# ----------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 4, 2**31 - 1, -7])
def test_prngkey_and_fold_in_chain(seed):
    jk, tk = jax.random.PRNGKey(seed), threefry.PRNGKey(seed)
    assert _jkey_words(jk) == tk
    for data in (0, 1, 2, 13, 2**31 + 5):
        jk, tk = jax.random.fold_in(jk, data), threefry.fold_in(tk, data)
        assert _jkey_words(jk) == tk


@pytest.mark.parametrize("n", NS)
def test_uniform_bits_equal(n):
    jk = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(4), 2), 9)
    tk = threefry.fold_in(threefry.fold_in(threefry.PRNGKey(4), 2), 9)
    np.testing.assert_array_equal(np.asarray(jax.random.bits(jk, (n,))).astype(np.int64),
                                  threefry.random_bits(tk, n).numpy())
    u = threefry.uniform(tk, n)
    assert u.dtype == torch.float32
    np.testing.assert_array_equal(np.asarray(jax.random.uniform(jk, (n,))).view(np.int32),
                                  u.numpy().view(np.int32))


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("p", [0.8, 0.1])
def test_bernoulli_equal(n, p):
    jk = jax.random.fold_in(jax.random.PRNGKey(11), n)
    tk = threefry.fold_in(threefry.PRNGKey(11), n)
    np.testing.assert_array_equal(np.asarray(jax.random.bernoulli(jk, p, (n,))),
                                  threefry.bernoulli(tk, p, n).numpy())


def test_prngkey_rejects_64_bit_seed():
    with pytest.raises(OverflowError):
        threefry.PRNGKey(2**31)


# ----------------------------------------------------------------------
# the fused trainer's draws
# ----------------------------------------------------------------------
KEY_SEED = (3 << 1) ^ 2  # (bagging_seed << 1) ^ feature_fraction_seed, the defaults


@pytest.mark.parametrize("it,freq", [(0, 1), (7, 5), (12, 5)])
def test_bagging_select_equals_jax(it, freq):
    n = 5000
    jk = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(KEY_SEED), 0), it // freq)
    want = np.asarray(jax.random.bernoulli(jk, 0.8, (n,)).astype(jnp.float32))
    got = tpt.bagging_select(threefry.PRNGKey(KEY_SEED), it, freq, 0.8, n, "cpu")
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("F,frac", [(8, 0.7), (28, 0.9), (100, 0.35), (3, 0.1)])
@pytest.mark.parametrize("it", [0, 5])
def test_feature_mask_equals_top_k(F, frac, it):
    used = max(1, int(F * frac))
    jk = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(KEY_SEED), 1), it)
    _, idx = jax.lax.top_k(jax.random.uniform(jk, (F,)), used)
    want = np.zeros(F, np.float32)
    want[np.asarray(idx)] = 1.0
    got = tpt.feature_mask(threefry.PRNGKey(KEY_SEED), it, F, used)
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got.sum()) == used


def test_top_k_tie_order_is_stable_descending():
    """``jax.lax.top_k`` keeps the lower index first among equal values;
    the port's stable descending sort does the same."""
    v = np.random.default_rng(0).integers(0, 5, 20000).astype(np.float32)
    _, idx = jax.lax.top_k(jnp.asarray(v), 7000)
    got = torch.sort(torch.from_numpy(v), descending=True, stable=True).indices[:7000]
    np.testing.assert_array_equal(got.numpy(), np.asarray(idx))


@pytest.mark.parametrize("it", [2, 9])
def test_goss_select_equals_jax_on_ties(it):
    """ptrainer.py:385-397 on |g*h| with heavy ties (six distinct
    values), the top set cut inside a tie group."""
    n, top_rate, other_rate = 6000, 0.2, 0.1
    rng = np.random.default_rng(it)
    g = rng.choice([-0.5, -0.25, 0.25, 0.5], n).astype(np.float32)
    h = rng.choice([0.25, 0.5, 0.75], n).astype(np.float32)
    top_cnt = max(1, int(n * top_rate))
    other_cnt = max(1, int(n * other_rate))
    mult = float((n - top_cnt) / other_cnt)
    prob = float(other_cnt / max(n - top_cnt, 1))
    # the JAX expressions, verbatim
    gscore = jnp.abs(jnp.asarray(g) * jnp.asarray(h))
    _, top_idx = jax.lax.top_k(gscore, top_cnt)
    is_top = jnp.zeros((n,), bool).at[top_idx].set(True)
    key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(KEY_SEED), 2), it)
    sampled = (~is_top) & (jax.random.uniform(key, (n,)) < prob)
    selv = (is_top | sampled).astype(jnp.float32)
    mulv = jnp.where(~sampled, 1.0, mult)
    tkey = threefry.fold_in(threefry.fold_in(threefry.PRNGKey(KEY_SEED), 2), it)
    sel, mul = tpt.goss_select((torch.from_numpy(g) * torch.from_numpy(h)).abs(), top_cnt,
                               prob, mult, tkey)
    np.testing.assert_array_equal(sel.numpy(), np.asarray(selv))
    np.testing.assert_array_equal(mul.numpy(), np.asarray(mulv, np.float32))
    assert int(sel.sum()) > top_cnt


# ----------------------------------------------------------------------
# B10 update_channels and B1's mul against the Pallas kernels
# ----------------------------------------------------------------------
def _l2_objectives(label, weight):
    from lightgbm_tpu.config import Config as JC
    from lightgbm_tpu.io.dataset import Metadata as JMeta
    from lightgbm_tpu.objective import create_objective as jcreate
    from lightgbm_tpu_torch.config import Config as TC
    from lightgbm_tpu_torch.io.dataset import Metadata as TMeta
    from lightgbm_tpu_torch.objective import create_objective as tcreate

    out = []
    for create, Config, Meta in ((jcreate, JC, JMeta), (tcreate, TC, TMeta)):
        obj = create(Config.from_params({"objective": "regression"}))
        md = Meta(len(label))
        md.set_label(label)
        md.set_weights(weight)
        obj.init(md, len(label))
        out.append(obj)
    return out


def _check_channels(Pt, Pj, P, lay, n, exact_gh):
    for r in (lay.G, lay.H):
        a, b = Pt[r, :n].view(np.float32), Pj[r, :n].view(np.float32)
        if exact_gh:
            np.testing.assert_array_equal(a, b)
        else:
            assert _rel(a, b) < 1e-6
    for r in (lay.SCORE, lay.SEL):
        np.testing.assert_array_equal(Pt[r, :n], Pj[r, :n])
    other = [r for r in range(lay.C) if r not in (lay.G, lay.H, lay.SCORE, lay.SEL)]
    np.testing.assert_array_equal(Pt[other], P[other])
    # the port writes no column past the real rows
    np.testing.assert_array_equal(Pt[:, n:], P[:, n:])


@pytest.mark.parametrize("objective", ["binary", "l2"])
@pytest.mark.parametrize("with_sel", [False, True])
def test_update_channels_matches_pallas(objective, with_sel):
    n = 5000
    P, lay, label, weight = _make_packed(n=n, seed=21)
    jobj, tobj = (_objectives if objective == "binary" else _l2_objectives)(label, weight)
    rng = np.random.default_rng(4)
    delta = rng.standard_normal(n).astype(np.float32)
    sel = (rng.random(n) < 0.5).astype(np.float32) if with_sel else None
    Pj = np.asarray(jpk.update_channels(jnp.asarray(P), lay, jobj.gradients_rowwise,
                                        delta=delta, sel=sel, interpret=True))
    Pt = tpk.update_channels(torch.from_numpy(P.copy()), tpk.PLayout(lay.F), tobj,
                             delta=delta, sel=sel, num_rows=n).numpy()
    _check_channels(Pt, Pj, P, lay, n, exact_gh=objective == "l2")


def test_update_channels_equals_update_and_root_hist_without_hist():
    """The GOSS prep pass: update_channels writes what
    update_and_root_hist(with_hist=False) writes, bit for bit."""
    n = 4000
    P, lay, label, weight = _make_packed(n=n, seed=5)
    _, tobj = _objectives(label, weight)
    delta = np.random.default_rng(1).standard_normal(n).astype(np.float32)
    tlay = tpk.PLayout(lay.F)
    a = tpk.update_channels(torch.from_numpy(P.copy()), tlay, tobj, delta=delta, num_rows=n)
    b, hist = tpk.update_and_root_hist(torch.from_numpy(P.copy()), tlay, tobj, delta=delta,
                                       num_rows=n, num_features=lay.F, num_bins=32,
                                       with_hist=False)
    assert hist is None
    assert torch.equal(a, b)


@pytest.mark.parametrize("objective", ["binary", "l2"])
def test_update_and_root_hist_mul_matches_pallas(objective):
    n, B = 6000, 32
    P, lay, label, weight = _make_packed(n=n, seed=8)
    jobj, tobj = (_objectives if objective == "binary" else _l2_objectives)(label, weight)
    rng = np.random.default_rng(6)
    sel = (rng.random(n) < 0.4).astype(np.float32)
    mul = np.where(rng.random(n) < 0.3, np.float32(7.0), np.float32(1.0)).astype(np.float32)
    Pj, hj = jpk.update_and_root_hist(jnp.asarray(P), lay, jobj.gradients_rowwise, sel=sel,
                                      mul=mul, num_rows=n, num_features=lay.F, num_bins=B,
                                      interpret=True)
    Pt, ht = tpk.update_and_root_hist(torch.from_numpy(P.copy()), tpk.PLayout(lay.F), tobj,
                                      sel=sel, mul=mul, num_rows=n, num_features=lay.F,
                                      num_bins=B)
    _check_channels(Pt.numpy(), np.asarray(Pj), P, lay, n, exact_gh=objective == "l2")
    assert _rel(ht.numpy(), np.asarray(hj)) < 2e-3
    # the select channel is not scaled: the count plane counts rows
    np.testing.assert_array_equal(ht.numpy()[..., 2], np.asarray(hj)[..., 2])


# ----------------------------------------------------------------------
# models against the JAX fused trainer
# ----------------------------------------------------------------------
def _data():
    rng = np.random.default_rng(0)
    X = rng.standard_normal((2000, 8)).astype(np.float32)
    w = rng.standard_normal(8)
    yb = (rng.random(2000) < 1 / (1 + np.exp(-(X @ w)))).astype(np.float32)
    yr = (X[:, 0] - 0.5 * X[:, 1] + 0.1 * rng.standard_normal(2000)).astype(np.float32)
    ym = np.where(X[:, 0] > 0.5, 2, rng.integers(0, 3, 2000)).astype(np.float32)
    return X, {"binary": yb, "regression": yr, "multiclass": ym}


BASE = dict(num_leaves=15, learning_rate=0.5, max_bin=31, min_data_in_leaf=20, verbose=-1)
BAG = dict(bagging_fraction=0.8, bagging_freq=2, feature_fraction=0.7)
MODELS = {
    "bagging-binary": dict(BASE, objective="binary", **BAG),
    "bagging-l2": dict(BASE, objective="regression", **BAG),
    "bagging-multiclass": dict(BASE, objective="multiclass", num_class=3, **BAG),
    # learning_rate 0.5: GOSS samples from iteration int(1 / 0.5) = 2 on
    "goss-binary": dict(BASE, objective="binary", boosting="goss"),
}


@pytest.fixture(scope="module")
def trained():
    cache = {}

    def get(name):
        if name not in cache:
            params = MODELS[name]
            X, ys = _data()
            y = ys[params["objective"]]
            old = os.environ.get("LIGHTGBM_TPU_PGROW")
            os.environ["LIGHTGBM_TPU_PGROW"] = "force"
            try:
                jb = lgb.train(params, lgb.Dataset(X, label=y), num_boost_round=ROUNDS)
            finally:
                if old is None:
                    del os.environ["LIGHTGBM_TPU_PGROW"]
                else:
                    os.environ["LIGHTGBM_TPU_PGROW"] = old
            assert jb.boosting.ptrainer is not None, "the JAX reference left the fused path"
            tb = lgt.train(params, lgt.Dataset(X, label=y), ROUNDS, device="cpu")
            cache[name] = (X, jb, tb)
        return cache[name]

    return get


def _split_lines(text):
    return [line for line in text.splitlines()
            if line.startswith(("Tree=", "num_leaves=", "split_feature=", "threshold=",
                                "decision_type=", "left_child=", "right_child="))]


@pytest.mark.parametrize("name", list(MODELS))
def test_sampled_split_structure_matches_jax(trained, name):
    _, jb, tb = trained(name)
    assert _split_lines(tb.model_to_string()) == _split_lines(jb.model_to_string())
    assert tb.num_trees == jb.num_trees


@pytest.mark.parametrize("name", list(MODELS))
def test_sampled_predictions_match_jax(trained, name):
    X, jb, tb = trained(name)
    np.testing.assert_allclose(tb.predict(X), jb.predict(X), rtol=3e-3, atol=3e-4)


def test_goss_back_to_warm_up_matches_jax():
    """A learning-rate schedule that falls from 0.5 to 0.05 leads GOSS
    back into warm-up (int(1 / 0.05) = 20) after sampled iterations 2 and
    3: the warm-up trees train on every row again, not on the last GOSS
    selection, as the JAX fused trainer writes select = 1 there."""
    X, ys = _data()
    params = MODELS["goss-binary"]
    rates = [0.5] * 4 + [0.05] * (ROUNDS - 4)
    old = os.environ.get("LIGHTGBM_TPU_PGROW")
    os.environ["LIGHTGBM_TPU_PGROW"] = "force"
    try:
        jb = lgb.train(params, lgb.Dataset(X, label=ys["binary"]), ROUNDS,
                       learning_rates=rates, verbose_eval=False)
    finally:
        if old is None:
            del os.environ["LIGHTGBM_TPU_PGROW"]
        else:
            os.environ["LIGHTGBM_TPU_PGROW"] = old
    assert jb.boosting.ptrainer is not None, "the JAX reference left the fused path"
    tb = lgt.train(params, lgt.Dataset(X, label=ys["binary"]), ROUNDS, learning_rates=rates,
                   verbose_eval=False, device="cpu")
    assert _split_lines(tb.model_to_string()) == _split_lines(jb.model_to_string())
    np.testing.assert_allclose(tb.predict(X), jb.predict(X), rtol=3e-3, atol=3e-4)
    pt = tb.boosting.ptrainer
    assert pt.goss_constants()[3] == 20
    np.testing.assert_array_equal(tpk.f32_row(pt.p, pt.layout.SEL, pt.num_rows).numpy(), 1.0)


@pytest.mark.parametrize("name", ["bagging-binary", "goss-binary"])
def test_sampling_changes_the_model(trained, name):
    """The draws reach the trees: the same run without sampling grows
    another model."""
    X, _, tb = trained(name)
    params = dict(BASE, objective="binary")
    plain = lgt.train(params, lgt.Dataset(X, label=_data()[1]["binary"]), ROUNDS, device="cpu")
    assert _split_lines(plain.model_to_string()) != _split_lines(tb.model_to_string())


def test_goss_runs_update_channels_after_warm_up():
    """GOSS at learning_rate 0.5 warms up for int(1 / 0.5) = 2 iterations,
    then runs the prep pass (update_channels) once per iteration; each
    sampled tree's root sees top_cnt rows plus the rest's sample."""
    X, ys = _data()
    tpk.reset_launch_counts()
    bst = lgt.Booster(MODELS["goss-binary"], lgt.Dataset(X, label=ys["binary"]), device="cpu")
    pt = bst.boosting.ptrainer
    seen = []
    orig = tpk.update_channels_ref

    def spy(*a, **k):
        seen.append(True)
        return orig(*a, **k)

    tpk.update_channels_ref = spy
    try:
        bst.boosting.train_iters_partitioned(5)
    finally:
        tpk.update_channels_ref = orig
    assert len(seen) == 3
    top, _, _, warm = pt.goss_constants()
    assert warm == 2 and top == 400
    sel = tpk.f32_row(pt.p, pt.layout.SEL, pt.num_rows)
    assert top < int(sel.sum()) < pt.num_rows
