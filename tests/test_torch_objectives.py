"""The regression objectives of lightgbm_tpu_torch (L1, Huber, Fair,
Poisson) against the JAX package's.

Both packages get the same seeded numpy inputs.  Held:

- ``gradients_rowwise`` against the JAX ``gradients_rowwise``, with and
  without weights, on rows on both sides of ``huber_delta``: Fair and
  Poisson bit-equal; L1 and Huber bit-equal when the port takes XLA's
  float32 exp in place of its correctly rounded ``exp_f32``, and with its
  own each hessian within 1e-6 of the JAX one relative (the exp's ulp,
  as tests/test_torch_kernels.py states it for binary gradients; the
  products after it carry it on, to 2-4 ulps);
- B1's and B10's plain versions (``update_and_root_hist_ref``, also
  with a select and GOSS's multiplier, and ``update_channels_ref``)
  against the Pallas kernels in interpret mode: score and select
  channels bit-equal, gradients as above, histograms within 2e-3
  (interpret mode's bf16 three-term sums, tests/test_torch_kernels.py);
- models of each objective, weighted and not, on the fused path
  (LIGHTGBM_TPU_PGROW=force) and on the mask grower
  (LIGHTGBM_TPU_PGROW=0), and Huber with GOSS, against the JAX package:
  the same split lines and model header, predictions within rtol 3e-3 /
  atol 3e-4 (tests/test_torch_train.py).  The model text is not
  byte-identical: the JAX package's histograms (bf16 three-term sums in
  interpret mode, float32 sums on its mask grower) differ from the
  port's correctly rounded ones in the sixth digit of a gain;
- each package loads the other's model file of every new objective name
  and predicts within 1e-5 relative;
- ``create_objective`` takes every name of the JAX factory.

The CUDA kernels of the new objectives run only on the card:
tests/test_torch_cuda.py and chip_smoke.py hold them against these plain
versions there.
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
from lightgbm_tpu.objective import _FACTORY as JFACTORY
from lightgbm_tpu.objective import create_objective as jcreate
from lightgbm_tpu.ops import pkernels as jpk
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.io.dataset import Metadata as TMeta
from lightgbm_tpu_torch.objective import create_objective as tcreate
from lightgbm_tpu_torch.objective.binary import KIND_BINARY
from lightgbm_tpu_torch.objective import regression as treg
from lightgbm_tpu_torch.ops import pkernels as tpk

from test_torch_kernels import _make_packed

OBJECTIVES = ["regression_l1", "huber", "fair", "poisson"]
EXTRA = {"huber": {"huber_delta": 0.3}, "fair": {"fair_c": 0.7},
         "poisson": {"poisson_max_delta_step": 0.5}, "regression_l1": {"gaussian_eta": 0.8}}
ROUNDS = 4
EXP_RTOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def jax_reference_shims():
    """jax 0.9's ``trace_state_clean`` for the JAX package's compile
    watch, and a ``boosting`` alias on the JAX Config, whose fused
    trainer reads that name for GOSS (tests/test_torch_sampling.py)."""
    had = hasattr(jax.core, "trace_state_clean")
    if not had:
        jax.core.trace_state_clean = jax._src.core.trace_state_clean
    JConfig.boosting = property(lambda self: self.boosting_type)
    yield
    del JConfig.boosting
    if not had:
        del jax.core.trace_state_clean


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


def _pair(name, label, weight):
    """The objective in both packages, bound to the same labels."""
    params = dict(EXTRA[name], objective=name)
    out = []
    for create, Config, Meta in ((jcreate, JConfig, JMeta), (tcreate, TConfig, TMeta)):
        obj = create(Config.from_params(params))
        md = Meta(len(label))
        md.set_label(label)
        md.set_weights(weight)
        obj.init(md, len(label))
        out.append(obj)
    return out


def _rows(n=20000, seed=0):
    rng = np.random.default_rng(seed)
    label = (2.0 * rng.standard_normal(n)).astype(np.float32)
    score = (label + 0.5 * rng.standard_normal(n)).astype(np.float32)
    weight = (rng.random(n) + 0.5).astype(np.float32)
    return score, label, weight


def _rel_each(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float((np.abs(a - b) / np.maximum(np.abs(b), np.finfo(np.float32).tiny)).max())


def _xla_exp(t):
    return torch.from_numpy(np.array(jnp.exp(jnp.asarray(t.numpy()))))


# ----------------------------------------------------------------------
# gradients
# ----------------------------------------------------------------------
@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
@pytest.mark.parametrize("name", OBJECTIVES)
def test_gradients_match_jax(name, weighted, monkeypatch):
    score, label, weight = _rows()
    w = weight if weighted else None
    jobj, tobj = _pair(name, label, w)
    jg, jh = (np.asarray(v) for v in jobj.gradients_rowwise(
        jnp.asarray(score), jnp.asarray(label), None if w is None else jnp.asarray(w)))

    def port():
        return [v.numpy() for v in tobj.gradients_rowwise(
            torch.from_numpy(score), torch.from_numpy(label),
            None if w is None else torch.from_numpy(w))]

    tg, th = port()
    if name in ("fair", "poisson"):
        np.testing.assert_array_equal(tg, jg)
        np.testing.assert_array_equal(th, jh)
        return
    if name == "huber":
        inside = np.abs(score - label) <= np.float32(EXTRA["huber"]["huber_delta"])
        assert 0 < inside.sum() < len(score)
    np.testing.assert_array_equal(tg, jg)
    assert _rel_each(th, jh) <= EXP_RTOL
    # the hessians differ only through exp: with XLA's exp, bit-equal
    monkeypatch.setattr(treg, "exp_f32", _xla_exp)
    tg, th = port()
    np.testing.assert_array_equal(tg, jg)
    np.testing.assert_array_equal(th, jh)


def test_poisson_hessian_can_be_negative():
    """hess = score + poisson_max_delta_step in raw-score space, ported
    as it is: a score below -max_delta_step gives a negative hessian."""
    score = np.asarray([-2.0, 0.0, 1.0], np.float32)
    label = np.asarray([1.0, 1.0, 3.0], np.float32)
    _, tobj = _pair("poisson", label, None)
    g, h = tobj.gradients_rowwise(torch.from_numpy(score), torch.from_numpy(label), None)
    np.testing.assert_array_equal(g.numpy(), score - label)
    np.testing.assert_array_equal(h.numpy(), score + np.float32(0.5))
    assert float(h[0]) < 0


def test_factory_takes_every_jax_name():
    for name in JFACTORY:
        obj = tcreate(TConfig.from_params({"objective": name, "num_class": 3}))
        assert type(obj).__name__ == JFACTORY[name].__name__
    assert tcreate(TConfig.from_params({"objective": "none"})) is None
    kinds = [tcreate(TConfig.from_params({"objective": n})).kernel_params()[0]
             for n in ("regression", *OBJECTIVES)]
    assert [KIND_BINARY] + kinds == list(range(6))  # csrc/common.cuh ObjKind, in order


# ----------------------------------------------------------------------
# B1 and B10 plain versions against the Pallas kernels (interpret mode)
# ----------------------------------------------------------------------
def _check_channels(Pt, Pj, P, lay, n, name):
    g_t, g_j = Pt[lay.G, :n].view(np.float32), Pj[lay.G, :n].view(np.float32)
    h_t, h_j = Pt[lay.H, :n].view(np.float32), Pj[lay.H, :n].view(np.float32)
    np.testing.assert_array_equal(g_t, g_j)
    if name in ("fair", "poisson"):
        np.testing.assert_array_equal(h_t, h_j)
    else:
        assert _rel_each(h_t, h_j) <= EXP_RTOL
    for r in (lay.SCORE, lay.SEL):
        np.testing.assert_array_equal(Pt[r, :n], Pj[r, :n])
    other = [r for r in range(lay.C) if r not in (lay.G, lay.H, lay.SCORE, lay.SEL)]
    np.testing.assert_array_equal(Pt[other], P[other])
    np.testing.assert_array_equal(Pt[:, n:], P[:, n:])


def _regression_packed(n, seed):
    """The packed matrix of test_torch_kernels with real-valued labels."""
    P, lay, _, weight = _make_packed(n=n, seed=seed)
    rng = np.random.default_rng(seed + 100)
    label = rng.poisson(1.5, n).astype(np.float32)
    P[lay.LABEL, :n] = label.view(np.int32)
    return P, lay, label, weight


@pytest.mark.parametrize("form", ["delta-sel", "sel-mul"])
@pytest.mark.parametrize("name", OBJECTIVES)
def test_update_and_root_hist_matches_pallas(name, form):
    n, B = 6000, 32
    P, lay, label, weight = _regression_packed(n, seed=8)
    jobj, tobj = _pair(name, label, weight)
    rng = np.random.default_rng(6)
    sel = (rng.random(n) < 0.6).astype(np.float32)
    kw = dict(sel=sel)
    if form == "delta-sel":
        kw["delta"] = rng.standard_normal(n).astype(np.float32)
    else:
        kw["mul"] = np.where(rng.random(n) < 0.3, np.float32(7.0),
                             np.float32(1.0)).astype(np.float32)
    Pj, hj = jpk.update_and_root_hist(jnp.asarray(P), lay, jobj.gradients_rowwise,
                                      num_rows=n, num_features=lay.F, num_bins=B,
                                      interpret=True, **kw)
    Pt, ht = tpk.update_and_root_hist(torch.from_numpy(P.copy()), tpk.PLayout(lay.F), tobj,
                                      num_rows=n, num_features=lay.F, num_bins=B, **kw)
    _check_channels(Pt.numpy(), np.asarray(Pj), P, lay, n, name)
    hj = np.asarray(hj, np.float64)
    err = np.abs(ht.numpy() - hj).max() / max(np.abs(hj).max(), 1.0)
    assert err < 2e-3
    np.testing.assert_array_equal(ht.numpy()[..., 2], hj[..., 2])


@pytest.mark.parametrize("name", OBJECTIVES)
def test_update_channels_matches_pallas(name):
    n = 5000
    P, lay, label, weight = _regression_packed(n, seed=21)
    jobj, tobj = _pair(name, label, weight)
    rng = np.random.default_rng(4)
    delta = rng.standard_normal(n).astype(np.float32)
    sel = (rng.random(n) < 0.5).astype(np.float32)
    Pj = np.asarray(jpk.update_channels(jnp.asarray(P), lay, jobj.gradients_rowwise,
                                        delta=delta, sel=sel, interpret=True))
    Pt = tpk.update_channels(torch.from_numpy(P.copy()), tpk.PLayout(lay.F), tobj,
                             delta=delta, sel=sel, num_rows=n).numpy()
    _check_channels(Pt, Pj, P, lay, n, name)


# ----------------------------------------------------------------------
# models
# ----------------------------------------------------------------------
def _data(name, n=3000, seed=1):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, 6)).astype(np.float32)
    if name == "poisson":
        y = rng.poisson(np.exp(0.5 * X[:, 0])).astype(np.float32)
    else:
        y = (X[:, 0] - 0.5 * X[:, 1] + 0.3 * rng.standard_normal(n)).astype(np.float32)
    return X, y, (rng.random(n) + 0.5).astype(np.float32)


def _params(name, **extra):
    return dict(dict(EXTRA[name], objective=name, num_leaves=15, learning_rate=0.2, max_bin=31,
                     min_data_in_leaf=20, verbose=-1), **extra)


def _split_lines(text):
    return [line for line in text.splitlines()
            if line.startswith(("Tree=", "num_leaves=", "split_feature=", "threshold=",
                                "decision_type=", "left_child=", "right_child="))]


def _train_both(name, weighted, route, **extra):
    X, y, w = _data(name)
    w = w if weighted else None
    params = _params(name, **extra)
    jb = _with_env("LIGHTGBM_TPU_PGROW", route, lambda: lgb.train(
        params, lgb.Dataset(X, label=y, weight=w), ROUNDS))
    tb = _with_env("LIGHTGBM_TPU_PGROW", route, lambda: lgt.train(
        params, lgt.Dataset(X, label=y, weight=w), ROUNDS, device="cpu"))
    fused = route == "force"
    assert (jb.boosting.ptrainer is not None) == fused
    assert (tb.boosting.ptrainer is not None) == fused
    return X, jb, tb


def _assert_same_model(X, jb, tb):
    jt, tt = jb.model_to_string(), tb.model_to_string()
    assert _split_lines(tt) == _split_lines(jt)
    assert tt.split("Tree=0")[0] == jt.split("Tree=0")[0]
    assert tb.num_trees == jb.num_trees
    np.testing.assert_allclose(tb.predict(X), np.asarray(jb.predict(X)), rtol=3e-3, atol=3e-4)


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
@pytest.mark.parametrize("name", OBJECTIVES)
def test_fused_model_matches_jax(name, weighted):
    X, jb, tb = _train_both(name, weighted, "force")
    _assert_same_model(X, jb, tb)
    # boost_from_average: the first tree is the label mean, as in JAX
    assert tb.boosting.boost_from_average_ and jb.boosting.boost_from_average_


@pytest.mark.parametrize("name", OBJECTIVES)
def test_mask_grower_model_matches_jax(name):
    X, jb, tb = _train_both(name, True, "0")
    _assert_same_model(X, jb, tb)


def test_huber_goss_matches_jax():
    """GOSS at learning_rate 0.5 samples from iteration 2 on, through
    update_channels (B10's plain version) with the Huber objective."""
    X, jb, tb = _train_both("huber", False, "force", boosting="goss", learning_rate=0.5)
    _assert_same_model(X, jb, tb)
    assert tb.boosting.ptrainer.goss_constants()[3] == 2


@pytest.mark.parametrize("name", OBJECTIVES + ["mae", "l1"])
def test_models_load_across_packages(name, tmp_path):
    base = "regression_l1" if name in ("mae", "l1") else name
    X, y, _ = _data(base)
    params = dict(_params(base), objective=name)
    jb = lgb.train(params, lgb.Dataset(X, label=y), 3)
    tb = lgt.train(params, lgt.Dataset(X, label=y), 3, device="cpu")
    assert f"objective={base}" in tb.model_to_string().splitlines()
    jb.save_model(str(tmp_path / "jax.txt"))
    tb.save_model(str(tmp_path / "port.txt"))
    in_port = lgt.Booster(model_file=str(tmp_path / "jax.txt"), device="cpu")
    in_jax = lgb.Booster(model_file=str(tmp_path / "port.txt"))
    assert in_port.objective.name == base and in_jax.objective.name == base
    np.testing.assert_allclose(in_port.predict(X), np.asarray(jb.predict(X)), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(in_jax.predict(X)), tb.predict(X), rtol=1e-5,
                               atol=1e-6)
