"""The quantized walk of lightgbm_tpu_torch (ops/qpredict.py, the fixed-step
raw walk of ops/predict.py and ``LIGHTGBM_TPU_QUANT_PREDICT`` on
``Booster.predict``) against the JAX package, on models the JAX package
trained (tests/torch_serve_models.py) and loaded by both packages from
one model text.

Held:
- ``quantize_tree_arrays`` (float16 and bfloat16 leaves) and
  ``quantize_data`` equal the JAX functions' outputs array by array;
  ``drift_bound`` equals JAX's;
- the quantized walk's leaves equal JAX ``qpredict_leaf``'s and the exact
  walk's; its raw scores are within 1e-5 relative of JAX ``qpredict_raw``
  and within ``drift_bound`` of the exact scores;
- the raw walk with a static step count (``walk_levels``, padded up
  ``tree_shape_bucket``) equals the stepping walk bit for bit;
- ``qpredict_scores`` walks row chunks with the one-chunk scores bit for
  bit; ``LIGHTGBM_TPU_QUANT_PREDICT=1`` on ``Booster.predict`` matches the JAX
  package's quantized prediction (1e-5 relative) and stays exact, with a
  warning, on a linear model; bfloat16 rounding equals ml_dtypes'.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import ml_dtypes

import lightgbm_tpu as lgb
from lightgbm_tpu.ops import qpredict as jqp
from lightgbm_tpu.serve.artifact import stacked_tree_arrays as jstacked
from torch_serve_models import data, jax_trace_state_shim, model_text

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.model.ensemble import split_hi_lo
from lightgbm_tpu_torch.ops import qpredict as tqp
from lightgbm_tpu_torch.ops.predict import PackedTreeArrays, _leaves_raw, walk_levels
from lightgbm_tpu_torch.serve.artifact import stacked_tree_arrays as tstacked
from lightgbm_tpu_torch.serve.compilecache import tree_shape_bucket

RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def jax_shim():
    with jax_trace_state_shim():
        yield


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _boosters(name):
    text = model_text(name)
    return lgb.Booster(model_str=text), lgt.Booster(model_str=text, device="cpu")


def _rows(seed=5, n=600):
    """Fresh rows, rows on the split thresholds (training rows), zeros,
    NaN and values just off the zero range."""
    X, _ = data(seed, n)
    T, _ = data(0, 200)
    rows = np.concatenate([X, T])
    rows[3, 0] = 0.0
    rows[5, 1] = np.nan
    rows[7] = 0.0
    rows[9, 2] = 1e-36
    rows[11, 2] = -1e-36
    return rows


def _stacks(name):
    jb, tb = _boosters(name)
    return jstacked(jb.boosting._used_models()), tstacked(tb.boosting._used_models()), jb, tb


@pytest.mark.parametrize("leaf_dtype", ["float16", "bfloat16"])
@pytest.mark.parametrize("name", ["binary", "multiclass"])
def test_quantize_tree_arrays_equal_jax(name, leaf_dtype):
    ja, ta, jb, tb = _stacks(name)
    nf = tb.boosting.max_feature_idx + 1
    jq = jqp.quantize_tree_arrays(ja, leaf_dtype=leaf_dtype, num_features=nf)
    tq = tqp.quantize_tree_arrays(ta, leaf_dtype=leaf_dtype, num_features=nf)
    assert jq.levels == tq.levels and jq.leaf_dtype == tq.leaf_dtype
    for f in tqp.QTreeArrays.FIELDS:
        a, b = np.asarray(getattr(jq, f)), np.asarray(getattr(tq, f))
        if f == "leaf_value" and leaf_dtype == "bfloat16":
            a = a.view(np.uint16)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    if name == "binary":
        assert tq.feature_flags[7] == 1  # the categorical column


def test_quantize_data_equal_jax():
    ja, ta, _, tb = _stacks("binary")
    q = tqp.quantize_tree_arrays(ta, num_features=tb.boosting.max_feature_idx + 1)
    rows = _rows()
    got = tqp.quantize_data(rows, q.qbin_edges, q.qbin_offsets, q.feature_flags)
    want = jqp.quantize_data(rows, q.qbin_edges, q.qbin_offsets, q.feature_flags)
    assert got.dtype == np.int16
    np.testing.assert_array_equal(got, want)
    assert (got[7] == tqp.ZERO_CODE).all() and got[5, 1] == tqp.ZERO_CODE


@pytest.mark.parametrize("leaf_dtype", ["float16", "bfloat16"])
def test_drift_bound_equal_jax(leaf_dtype):
    ja, _, _, _ = _stacks("multiclass")
    leaf = np.asarray(ja.leaf_value)
    for k in range(3):
        assert tqp.drift_bound(leaf[k::3], leaf_dtype) == jqp.drift_bound(leaf[k::3], leaf_dtype)


@pytest.mark.parametrize("name", ["binary", "multiclass"])
def test_quantized_walk_matches_jax_and_exact(name):
    ja, ta, jb, tb = _stacks(name)
    K = tb.boosting.num_tree_per_iteration
    q = tqp.quantize_tree_arrays(ta, num_features=tb.boosting.max_feature_idx + 1)
    rows = _rows()
    codes = tqp.quantize_data(rows, q.qbin_edges, q.qbin_offsets, q.feature_flags)
    trees = tqp.QTrees(q, "cpu")
    leaves = tqp.qpredict_leaf(torch.from_numpy(codes), trees, q.levels).numpy()
    raw = tqp.qpredict_raw(torch.from_numpy(codes), trees, q.levels, K).numpy()
    node = [jnp.asarray(np.asarray(getattr(q, f))) for f in tqp.QTreeArrays.NODE_FIELDS]
    jleaves = np.asarray(jqp.qpredict_leaf(jnp.asarray(codes), *node[:-1], levels=q.levels))
    np.testing.assert_array_equal(leaves, jleaves)
    for k in range(K):
        sel = [jnp.asarray(np.asarray(a)[k::K]) for a in node]
        jraw = np.asarray(jqp.qpredict_raw(jnp.asarray(codes), *sel, levels=q.levels))
        np.testing.assert_allclose(raw[k], jraw, rtol=RTOL, atol=RTOL * np.abs(jraw).max())
    # routing is exact: the exact walk's leaves are the quantized walk's
    # (level packing renumbers nodes, not leaves)
    np.testing.assert_array_equal(leaves, tb.predict(rows, pred_leaf=True).T)
    exact = tb.predict(rows, raw_score=True).reshape(len(rows), K).T
    for k in range(K):
        bound = tqp.drift_bound(np.asarray(ta.leaf_value)[k::K])
        assert np.abs(raw[k] - exact[k]).max() <= bound


def test_fixed_step_walk_equals_stepping_walk():
    _, ta, _, tb = _stacks("binary")
    levels = walk_levels(ta.left_child, ta.right_child)
    for i in range(ta.left_child.shape[0]):
        assert levels >= jqp._bfs_order(np.asarray(ta.left_child[i]),
                                        np.asarray(ta.right_child[i]))[1]
    assert levels == max(jqp._bfs_order(np.asarray(ta.left_child[i]),
                                        np.asarray(ta.right_child[i]))[1]
                         for i in range(ta.left_child.shape[0]))
    trees = ta.to_device("cpu")
    planes = [torch.from_numpy(p) for p in split_hi_lo(_rows())]
    free = _leaves_raw(planes, trees)
    for steps in (levels, tree_shape_bucket(levels), tree_shape_bucket(levels) + 3):
        assert torch.equal(_leaves_raw(planes, trees, levels=steps), free)
    # too few steps leave some rows inside the trees (negative leaves)
    assert not torch.equal(_leaves_raw(planes, trees, levels=levels - 1), free)


def test_walk_levels_of_one_leaf_trees():
    left = np.array([[-1, 0], [1, -1]], np.int32)
    right = np.array([[-1, 0], [-2, -3]], np.int32)
    assert walk_levels(left, right) == 2  # tree 1: node 0 -> node 1 -> leaf


@pytest.mark.parametrize("name", ["binary", "multiclass"])
def test_quant_predict_pin_on_booster_matches_jax(name, monkeypatch):
    jb, tb = _boosters(name)
    rows = _rows()
    exact = tb.predict(rows, raw_score=True)
    monkeypatch.setenv("LIGHTGBM_TPU_QUANT_PREDICT", "1")
    for raw_score in (True, False):
        got = tb.predict(rows, raw_score=raw_score)
        want = np.asarray(jb.predict(rows, raw_score=raw_score))
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * np.abs(want).max())
    got = tb.predict(rows, raw_score=True)
    assert not np.array_equal(got, exact)  # float16 leaves: not the exact path
    K = tb.boosting.num_tree_per_iteration
    leaf = np.asarray(tstacked(tb.boosting._used_models()).leaf_value)
    bound = max(tqp.drift_bound(leaf[k::K]) for k in range(K))
    assert np.abs(got - exact).max() <= bound
    # the quantized trees are cached per model
    trees = tb.boosting._qtrees[1]
    tb.predict(rows[:10])
    assert tb.boosting._qtrees[1] is trees
    monkeypatch.setenv("LIGHTGBM_TPU_QUANT_PREDICT", "0")
    np.testing.assert_array_equal(tb.predict(rows, raw_score=True), exact)


def test_quant_predict_pin_keeps_linear_models_exact(monkeypatch, capsys):
    _, tb = _boosters("linear")
    rows = _rows()
    exact = tb.predict(rows)
    monkeypatch.setenv("LIGHTGBM_TPU_QUANT_PREDICT", "1")
    np.testing.assert_array_equal(tb.predict(rows), exact)
    assert "LIGHTGBM_TPU_QUANT_PREDICT=1 ignored" in capsys.readouterr().out


@pytest.mark.parametrize("value,default,want", [
    (None, False, False), (None, True, True), ("1", False, True), ("0", True, False),
    ("off", True, False), ("true", False, True)])
def test_quant_predict_enabled(value, default, want, monkeypatch):
    if value is None:
        monkeypatch.delenv("LIGHTGBM_TPU_QUANT_PREDICT", raising=False)
    else:
        monkeypatch.setenv("LIGHTGBM_TPU_QUANT_PREDICT", value)
    assert tqp.quant_predict_enabled(default) is want
    assert jqp.quant_predict_enabled(default) is want


def test_bfloat16_rounding_equals_ml_dtypes():
    rng = np.random.default_rng(3)
    x = np.concatenate([
        rng.standard_normal(4000).astype(np.float32) * 10.0 ** rng.integers(-30, 30, 4000),
        np.array([0.0, -0.0, 1.0, np.inf, -np.inf, 3.0e38, 1e-40, -1e-42], np.float32),
        # exact ties: the low 16 bits 0x8000 with even and odd kept bits
        np.array([0x3F808000, 0x3F818000, 0xBF808000], np.uint32).view(np.float32)])
    want = x.astype(ml_dtypes.bfloat16).view(np.uint16)
    np.testing.assert_array_equal(tqp.to_bfloat16_bits(x), want)
    np.testing.assert_array_equal(tqp.bfloat16_bits_to_float32(want),
                                  want.view(ml_dtypes.bfloat16).astype(np.float32))
    assert np.isnan(tqp.bfloat16_bits_to_float32(tqp.to_bfloat16_bits(np.float32(np.nan))))


def test_oversized_tables_refused():
    t, m = 1, 3
    arrays = PackedTreeArrays(**{f: np.zeros((t, m), np.int32)
                                 for f in PackedTreeArrays.FIELDS})
    arrays.leaf_value = np.zeros((t, 4), np.float32)
    arrays.split_feature_real = np.full((t, m), 40000, np.int32)
    with pytest.raises(lgt.LightGBMError, match="at most 32767 features"):
        tqp.quantize_tree_arrays(arrays)
    with pytest.raises(lgt.LightGBMError, match="Unsupported quantized leaf dtype"):
        tqp.narrow_leaves(np.zeros(3, np.float32), "float8")


def test_qpredict_scores_in_row_chunks(monkeypatch):
    """``qpredict_scores`` (the quantized ``Booster.predict``) walks row
    chunks of at most ``_CHUNK_ELEMS`` (T, rows) elements: chunks of 7
    rows give the one-chunk scores bit for bit, and both are JAX
    ``qpredict_raw``'s within 1e-5 relative."""
    from lightgbm_tpu_torch.ops import predict as tpredict

    jb, tb = _boosters("multiclass")
    rows = _rows()
    q = tqp.quantize_tree_arrays(tstacked(tb.boosting._used_models()))
    trees = tqp.QTrees(q, "cpu")
    whole = tqp.qpredict_scores(rows, q, trees, num_class=3)
    monkeypatch.setattr(tpredict, "_CHUNK_ELEMS", 7 * q.split_feature.shape[0])
    np.testing.assert_array_equal(tqp.qpredict_scores(rows, q, trees, num_class=3), whole)
    monkeypatch.setenv("LIGHTGBM_TPU_QUANT_PREDICT", "1")
    want = np.asarray(jb.predict(rows, raw_score=True)).T
    np.testing.assert_allclose(whole, want, rtol=RTOL, atol=RTOL * np.abs(want).max())
