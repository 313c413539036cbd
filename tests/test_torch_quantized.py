"""Quantized training in lightgbm_tpu_torch against the JAX package.

Both packages get the same seeded numpy inputs; the JAX package runs on
the CPU with LIGHTGBM_TPU_PGROW=0 (its mask grower; the Pallas kernels in
interpret mode), the port on ``device="cpu"`` (the kernels' plain
versions).  What is held, and how:

- ``ops/qhist.py`` (scales, the value-keyed stochastic rounding,
  dequantization): bit-equal, zeros, -0.0, huge and tiny values, an
  all-zero channel and tied values included;
- ``hist_segment_q_ref`` (B9's plain version) against the Pallas kernel
  in interpret mode, and the port's integer ``build_histogram`` against
  the JAX one: bit-equal (integer sums);
- the port's ``grow_tree`` fed the JAX package's own int16 levels and
  scales: the same records, gains and leaf values bit for bit (the
  quantized split scan takes XLA's float32 prefix-sum order);
- quantized L2 through ``lgt.train``: the JAX package's model text, byte
  for byte (its gradients are ``score - label``, exact on both sides);
- quantized binary and multiclass: the port's exp (float64, rounded
  once) and XLA's float32 exp differ by an ulp on some inputs, and the
  rounding is keyed by the gradient's bits, so a one-ulp gradient
  rounds to an unrelated level about one time in three.  These are held
  in three parts: the quantizer and grower fed the JAX gradients,
  bit-equal at every iteration; the port's gradients of the JAX scores,
  the count of ulp-different rows reported and each within 2 ulps; end
  to end, identical trees up to the first iteration whose gradients
  differ, and the training loss within 2 % of the JAX model's.
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
from lightgbm_tpu.ops import grow as jgrow
from lightgbm_tpu.ops import histogram as jhist
from lightgbm_tpu.ops import histogram_pallas as jhp
from lightgbm_tpu.ops import qhist as jq
from lightgbm_tpu_torch.ops import grow as tgrow
from lightgbm_tpu_torch.ops import histogram as thist
from lightgbm_tpu_torch.ops import qhist as tq

ROUNDS = 4


@pytest.fixture(scope="module", autouse=True)
def jax_mask_grower():
    """The JAX package on its mask grower (LIGHTGBM_TPU_PGROW=0), and the
    jax 0.9 ``trace_state_clean`` shim its compile watch needs."""
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


def _t(a):
    return torch.from_numpy(np.array(a))


# ----------------------------------------------------------------------
# ops/qhist.py
# ----------------------------------------------------------------------
def _grad_hess(n=4096, seed=0):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal(n).astype(np.float32)
    h = np.abs(rng.standard_normal(n)).astype(np.float32)
    g[:8] = [0.0, -0.0, 1e-30, -1e-30, 3.4e38, -3.4e38, 1e-45, -1e-45]
    h[:4] = [0.0, -0.0, 3.4e38, 1e-30]
    g[100:200] = g[10]  # ties: equal values round alike
    h[100:200] = h[10]
    return g, h


@pytest.mark.parametrize("bits", [2, 5, 15])
def test_qhist_matches_jax(bits):
    assert tq.qmax_for(bits) == jq.qmax_for(bits)
    assert tq.max_rows_for(bits) == jq.max_rows_for(bits)
    g, h = _grad_hess(seed=bits)
    sel = (np.random.default_rng(bits).random(g.size) < 0.7).astype(np.float32)
    ja = np.asarray(jq.local_absmax(jnp.asarray(g), jnp.asarray(h), jnp.asarray(sel)))
    ta = tq.local_absmax(_t(g), _t(h), _t(sel)).numpy()
    np.testing.assert_array_equal(ta, ja)
    for gm, hm in ((1.7, 2.3), (0.0, 4.5), (ja[0], ja[1])):  # a zero channel scales 1.0
        np.testing.assert_array_equal(tq.scales_from_max(gm, hm, bits),
                                      jq.scales_from_max(gm, hm, bits))
    assert tq.scales_from_max(0.0, 0.0, bits).tolist() == [1.0, 1.0]
    sc = tq.scales_from_max(1.7, 2.3, bits)
    for seed in (0, 12345, 0xFFFFFFFF):
        jg, jh = jq.quantize_rows(jnp.asarray(g), jnp.asarray(h), jnp.asarray(sc),
                                  np.uint32(seed), bits)
        tg, th = tq.quantize_rows(_t(g), _t(h), sc, seed, bits)
        assert tg.dtype == torch.int16 and th.dtype == torch.int16
        np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
        np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
        assert len(set(tg[100:200].tolist())) == 1
    hq = np.random.default_rng(1).integers(-5000, 5000, (5, 7, 3)).astype(np.int32)
    np.testing.assert_array_equal(tq.dequantize_hist(_t(hq), sc).numpy(),
                                  np.asarray(jq.dequantize_hist(jnp.asarray(hq), jnp.asarray(sc))))
    sums = np.asarray([-123456, 987654, 4096], np.int32)
    np.testing.assert_array_equal(tq.dequantize_sums(sums, sc),
                                  np.asarray(jq.dequantize_sums(jnp.asarray(sums),
                                                                jnp.asarray(sc))))


# ----------------------------------------------------------------------
# B9's plain version and the integer build_histogram
# ----------------------------------------------------------------------
def _binned(n, f, b, seed):
    rng = np.random.default_rng(seed)
    dtype = np.uint8 if b <= 256 else np.uint16
    bins = rng.integers(0, b, (n, f)).astype(dtype)
    qg = rng.integers(-15, 16, n).astype(np.int16)
    qh = rng.integers(0, 16, n).astype(np.int16)
    sel = (rng.random(n) < 0.7).astype(np.float32)
    tb = torch.from_numpy(bins.astype(np.int32) if dtype == np.uint16 else bins)
    return bins, tb, qg, qh, sel


LAYOUTS = [(4, 8, 32), (2, 16, 300)]  # (per, bits, B): uint8 and uint16 bins


@pytest.mark.parametrize("per,bits,B", LAYOUTS, ids=["8bit", "16bit"])
def test_hist_segment_q_ref_matches_pallas(per, bits, B):
    n, f = 3072, 7
    bins, tb, qg, qh, sel = _binned(n, f, B, seed=bits)
    pj = jhp.pack_columns_q(jnp.asarray(bins), jnp.asarray(qg), jnp.asarray(qh),
                            jnp.asarray(sel), per=per, bits=bits)
    pt = thist.pack_columns_q(tb, _t(qg), _t(qh), _t(sel), per=per, bits=bits)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    for lo, hi in ((0, n), (100, 2900), (517, 518), (40, 40)):
        want = np.asarray(jhp.hist_segment_q(pj, jnp.int32(lo), jnp.int32(hi), f, B, per=per,
                                             bits=bits, interpret=True))
        got = thist.hist_segment_q(pt, lo, hi, f, B, per, bits)  # the CPU runs the plain version
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("per,bits,B", LAYOUTS, ids=["8bit", "16bit"])
def test_build_histogram_int_matches_jax(per, bits, B):
    bins, tb, qg, qh, sel = _binned(2500, 5, B, seed=per)
    want = np.asarray(jhist.build_histogram(jnp.asarray(bins), jnp.asarray(qg), jnp.asarray(qh),
                                            jnp.asarray(sel), B))
    got = thist.build_histogram(tb, _t(qg), _t(qh), _t(sel), B)
    assert want.dtype == np.int32 and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # the subtraction trick is exact on integer histograms
    half = sel * (np.arange(sel.size) % 2)
    child = thist.build_histogram(tb, _t(qg), _t(qh), _t(half), B)
    rest = thist.build_histogram(tb, _t(qg), _t(qh), _t(sel - half), B)
    np.testing.assert_array_equal(thist.histogram_from_parent(got, child).numpy(), rest.numpy())


# ----------------------------------------------------------------------
# the grower fed the JAX package's levels
# ----------------------------------------------------------------------
RECORDS = ("rec_leaf", "rec_feat", "rec_thr", "rec_dbz", "rec_gain", "rec_lval", "rec_rval",
           "rec_lcnt", "rec_rcnt", "rec_internal_value", "leaf_id")


def _assert_same_tree(jr, tr):
    assert tr.num_splits == int(jr.num_splits) > 0
    for k in RECORDS:
        got = getattr(tr, k)
        got = got.numpy() if isinstance(got, torch.Tensor) else got
        np.testing.assert_array_equal(got, np.asarray(getattr(jr, k)), err_msg=k)


def _booster_pair(params, X, y):
    """A JAX and a port booster on the same data and parameters, before
    their first iteration."""
    jb = lgb.Booster(params, lgb.Dataset(X, label=y))
    tb = lgt.Booster(params, lgt.Dataset(X, label=y), device="cpu")
    assert jb.boosting.ptrainer is None and tb.boosting.ptrainer is None
    return jb, tb


def _binary_data(n=2000, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, 6)).astype(np.float32)
    y = (rng.random(n) < 1 / (1 + np.exp(-(X[:, 0] - X[:, 2] + 0.5 * X[:, 3])))).astype(
        np.float32)
    return X, y


def _params(objective, leaves, **kw):
    return dict(objective=objective, num_leaves=leaves, learning_rate=0.3, max_bin=31,
                min_data_in_leaf=20, use_quantized_grad=True, verbose=-1, **kw)


@pytest.mark.parametrize("leaves", [7, 31])
def test_grow_tree_fed_jax_levels(leaves):
    """Every iteration of a JAX quantized binary run: the JAX scores'
    gradients, quantized by the JAX package and by the port (the port's
    _quantize_class at the same iteration, select and seed), grow the
    same tree in both growers; and the port's own gradients of the same
    scores differ from the JAX ones by at most 2 ulps."""
    X, y = _binary_data()
    jb, tb = _booster_pair(_params("binary", leaves), X, y)
    jg_, tg_ = jb.boosting, tb.boosting
    ulp_rows = []
    for it in range(ROUNDS):
        jg_._boost_from_average()
        grad, hess = jg_._get_gradients()
        gq, hq, qscale = jg_._quantize_class(grad[0], hess[0], 0)
        tg_.iter = it
        tg_.select = _t(np.asarray(jg_.select))
        g0, h0 = _t(np.asarray(grad[0])), _t(np.asarray(hess[0]))
        tgq, thq, tqs = tg_._quantize_class(g0, h0, 0)
        np.testing.assert_array_equal(tqs, np.asarray(qscale))
        np.testing.assert_array_equal(tgq.numpy(), np.asarray(gq))
        np.testing.assert_array_equal(thq.numpy(), np.asarray(hq))
        fmask = jnp.ones(X.shape[1], jnp.float32)
        jr = jgrow.grow_tree(jg_.bins, gq, hq, jg_.select, fmask, jg_.meta, jg_.hyper,
                             jg_.grow_params, qscale=qscale)
        tr = tgrow.grow_tree(tg_.words, tgq, thq, tg_.select, torch.ones(X.shape[1]), tg_.meta,
                             tg_.hyper, tg_.grow_params, qscale=tqs)
        _assert_same_tree(jr, tr)
        # the port's gradients of the JAX scores
        score = _t(np.asarray(jg_.scores[0]))
        pg, ph = tg_.objective.gradients_rowwise(score, tg_.label_t, None)
        for mine, theirs in ((pg, grad[0]), (ph, hess[0])):
            theirs = np.asarray(theirs)
            ulps = np.abs(mine.numpy() - theirs) / np.spacing(np.abs(theirs))
            assert ulps.max() <= 2.0, f"iteration {it}: a gradient differs by {ulps.max()} ulps"
        ulp_rows.append(int(np.sum((pg.numpy() != np.asarray(grad[0]))
                                   | (ph.numpy() != np.asarray(hess[0])))))
        jb.update()
    print(f"rows whose port gradients differ from the JAX ones by an ulp, per iteration: "
          f"{ulp_rows} of {len(y)}")


def _split_lines(text):
    return [line for line in text.splitlines()
            if line.startswith(("Tree=", "num_leaves=", "split_feature=", "threshold=",
                                "decision_type=", "left_child=", "right_child="))]


@pytest.mark.parametrize("weighted", [False, True], ids=["l2", "l2_weighted"])
def test_quantized_l2_matches_jax(weighted):
    """Quantized L2: the JAX package's model, byte for byte (its split
    lines, gains and leaf values), and its predictions within 1e-6 (the
    two predictors sum the trees' outputs in different orders, as
    tests/test_torch_train.py holds a JAX-written model)."""
    rng = np.random.default_rng(1)
    X = rng.standard_normal((2000, 6)).astype(np.float32)
    y = (X[:, 0] - 0.5 * X[:, 1] + 0.1 * rng.standard_normal(2000)).astype(np.float32)
    w = (rng.random(2000) + 0.5).astype(np.float32) if weighted else None
    params = _params("regression", 15)
    jb = lgb.train(params, lgb.Dataset(X, label=y, weight=w), num_boost_round=ROUNDS)
    tb = lgt.train(params, lgt.Dataset(X, label=y, weight=w), ROUNDS, device="cpu")
    assert tb.boosting.ptrainer is None
    jt, tt = jb.model_to_string(), tb.model_to_string()
    assert _split_lines(tt) == _split_lines(jt)
    assert tt == jt
    np.testing.assert_allclose(tb.predict(X), np.asarray(jb.predict(X)), rtol=0, atol=1e-6)


def _first_differing_tree(text_a, text_b):
    trees_a, trees_b = text_a.split("Tree=")[1:], text_b.split("Tree=")[1:]
    for i, (a, b) in enumerate(zip(trees_a, trees_b)):
        if _split_lines("Tree=" + a) != _split_lines("Tree=" + b):
            return i
    return None


def _logloss(y, p):
    p = np.clip(p, 1e-15, 1 - 1e-15)
    return float(-np.mean(y * np.log(p) + (1 - y) * np.log(1 - p)))


def _multi_logloss(y, p):
    return float(-np.mean(np.log(np.clip(p[np.arange(len(y)), y.astype(int)], 1e-15, 1))))


@pytest.mark.parametrize("objective", ["binary", "multiclass"])
def test_quantized_end_to_end_against_jax(objective):
    """lgt.train against lgb.train, quantized binary and softmax: the
    trees agree up to the first iteration whose gradients (of identical
    scores) differ by an ulp in some row; from there the rounding keyed
    by those bits moves rows to other levels and the trees may differ
    for real, so the models are held to their training loss, within 2 %
    of the JAX model's."""
    X, y = _binary_data(seed=3)
    kw = {}
    if objective == "multiclass":
        noise = np.random.default_rng(4).standard_normal(len(y))
        y = np.clip(np.floor(X[:, 0] + 0.5 * X[:, 1] + 0.5 * noise + 2.0), 0, 3).astype(
            np.float32)
        kw = dict(num_class=4)
    params = _params(objective, 15, **kw)
    K = kw.get("num_class", 1)
    # the first iteration at which the port's gradients of the JAX
    # package's own scores differ from its gradients
    jb = lgb.Booster(params, lgb.Dataset(X, label=y))
    tb = lgt.Booster(params, lgt.Dataset(X, label=y), device="cpu")
    first_ulp, counts = None, []
    for it in range(ROUNDS):
        jb.boosting._boost_from_average()
        grad, hess = (np.asarray(a) for a in jb.boosting._get_gradients())
        tb.boosting.scores = _t(np.asarray(jb.boosting.scores))
        pg, ph = (a.numpy() for a in tb.boosting._get_gradients())
        counts.append(int(np.sum((pg != grad) | (ph != hess))))
        if counts[-1] and first_ulp is None:
            first_ulp = it
        jb.update()
    jt = jb.model_to_string()
    tt = lgt.train(params, lgt.Dataset(X, label=y), ROUNDS, device="cpu")
    first = _first_differing_tree(jt, tt.model_to_string())
    print(f"{objective}: (row, class) gradients differing by an ulp per iteration {counts}; "
          f"first differing tree {first}")
    if first is not None:
        assert first_ulp is not None and first // K >= first_ulp, (
            "the trees differ before the gradients do")
    jp, tp = np.asarray(jb.predict(X)), tt.predict(X)
    if objective == "binary":
        lj, lt_ = _logloss(y, jp), _logloss(y, tp)
    else:
        lj, lt_ = _multi_logloss(y, jp), _multi_logloss(y, tp)
    assert abs(lt_ - lj) <= 0.02 * lj, (lt_, lj)


def test_headroom_falls_back_to_float(monkeypatch):
    """Above max_rows_for(bits) rows the int32 accumulators could wrap:
    training warns and runs on float32 gradients (gbdt.py:195-228), the
    model of use_quantized_grad=False."""
    from lightgbm_tpu_torch.boosting import gbdt as tgbdt

    monkeypatch.setattr(tgbdt, "max_rows_for", lambda bits: 100)
    X, y = _binary_data(n=600)
    params = _params("binary", 7)
    tb = lgt.train(params, lgt.Dataset(X, label=y), 2, device="cpu")
    assert not tb.boosting.config.quantized_training
    plain = lgt.train(dict(params, use_quantized_grad=False), lgt.Dataset(X, label=y), 2,
                      device="cpu")
    assert tb.model_to_string() == plain.model_to_string()


def test_quantized_l2_validation_matches_jax():
    """The mask grower's per-iteration path through the engine: a
    validation set, evals_result and early stopping on quantized L2, whose
    trees are the JAX package's byte for byte; the metric values within
    1e-6 (the two score the validation rows in different orders)."""
    rng = np.random.default_rng(2)
    X = rng.standard_normal((3000, 6)).astype(np.float32)
    y = (X[:, 0] - 0.5 * X[:, 1] + 0.5 * rng.standard_normal(3000)).astype(np.float32)
    params = dict(_params("regression", 15), metric=["l2", "l1"])
    out = []
    for mod, extra in ((lgb, {}), (lgt, dict(device="cpu"))):
        tr = mod.Dataset(X[:2000], label=y[:2000])
        va = mod.Dataset(X[2000:], label=y[2000:], reference=tr)
        ev = {}
        bst = mod.train(params, tr, 12, valid_sets=[va], valid_names=["val"], evals_result=ev,
                        verbose_eval=False, early_stopping_rounds=3, **extra)
        out += [bst, ev]
    jb, jev, tb, tev = out
    assert tb.boosting.ptrainer is None
    assert tb.best_iteration == jb.best_iteration
    assert tb.model_to_string() == jb.model_to_string()
    for name in ("l2", "l1"):
        np.testing.assert_allclose(tev["val"][name], jev["val"][name], rtol=0, atol=1e-6)
