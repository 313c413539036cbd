"""The fused grower with its tables on the device
(lightgbm_tpu_torch/ops/pgrow.py ``grow_tree_partitioned``: unrolled
levels of static shape, L-1 fixed phase-2 steps, one CUDA graph a tree on
the card) against the JAX grower, field by field, on the CPU.

The same seeded numpy matrix goes to both: bins from each package's own
Dataset (their binning and EFB bundles agree), gradients, hessians and a
bagging select drawn with numpy.  The JAX grower runs its Pallas kernels
in interpret mode, the port the kernels' plain versions.  Tolerances: the
split count, the leaf segments (starts and counts), the records' leaf,
feature, threshold bin and default bin for zero, and every count exact;
gains, g/h sums and leaf values within 1e-5 relative.  The gradients and
hessians are multiples of 1/64, so every histogram sum is exact in both
packages (the interpret-mode histograms are bf16 3-term sums added in
another order than the port's float64 sums; with arbitrary float32
gradients they differ by an ulp, which a gain's cancellation makes
~1e-4 relative).  The chunk test holds the port's trainer
against the JAX fused trainer (LIGHTGBM_TPU_PGROW=force) where the second
iteration finds no split.  The card's tests of the same code (graph
replay against eager, no host sync inside a tree, B3/B4 given device
tables) are in tests/test_torch_cuda.py, which imports no JAX.
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
from lightgbm_tpu.boosting.ptrainer import _build_bundle_meta
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.ops.pgrow import PGrowParams as JParams
from lightgbm_tpu.ops.split import FeatureMeta as JMeta, SplitHyper as JHyper
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.ops import pgrow as tpg
from lightgbm_tpu_torch.ops import pkernels as tpk
from lightgbm_tpu_torch.ops.split import FeatureMeta as TMeta, SplitHyper as THyper

RTOL = 1e-5


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


def _features(kind, n, seed):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, 6)).astype(np.float32)
    if kind == "efb":  # a one-hot over 4 and one over 6 columns: 10 columns bundle
        a, b = rng.integers(0, 4, n), rng.integers(0, 6, n)
        X = np.concatenate([X, np.eye(4, dtype=np.float32)[a], np.eye(6, dtype=np.float32)[b]],
                           axis=1)
    return X


def _case(kind="plain", n=3000, leaves=31, max_bin=31, K=1, seed=3, **extra):
    """Both packages' grower arguments over one packed matrix: (port
    matrix, port kwargs, JAX kwargs, layout)."""
    X = _features(kind, n, seed)
    params = dict(objective="regression", num_leaves=leaves, max_bin=max_bin,
                  min_data_in_leaf=extra.pop("min_data_in_leaf", 5), verbose=-1, **extra)
    tds = lgt.Dataset(X, label=X[:, 0], params=params).construct()
    jds = lgb.Dataset(X, label=X[:, 0], params=params).construct()
    tcfg, jcfg = TConfig.from_params(params), JConfig.from_params(params)
    tds.ensure_bundles(tcfg)
    jds.ensure_bundles(jcfg)
    assert (tds.bundle is None) == (jds.bundle is None) == (kind != "efb")
    B = int(tds.max_num_bin)
    if tds.bundle is not None:
        matrix, cols, bh = tds.bundled, tds.bundle.num_cols, int(tds.bundle.max_col_bin)
    else:
        matrix, cols, bh = tds.binned, 0, 0
    bits = 4 if (bh or B) <= 16 else 8
    lay = tpk.PLayout(matrix.shape[1], num_score=K, bits=bits)
    rng = np.random.default_rng(seed + 100)
    P = tpk.pack_matrix(matrix, lay).numpy()
    # dyadic gradients and hessians (multiples of 1/64): every histogram
    # sum is exact in float32, in the JAX interpret mode's bf16 3-term sums
    # as in the port's float64 ones, so the two growers see the same
    # histograms and the comparison holds the growth logic
    for k in range(K):
        g = np.clip(np.round(rng.standard_normal(n) * 32), -64, 64) / 64
        h = rng.integers(32, 97, n) / 64
        P[lay.g_row(k), :n] = g.astype(np.float32).view(np.int32)
        P[lay.h_row(k), :n] = h.astype(np.float32).view(np.int32)
    P[lay.SEL, :n] = (rng.random(n) < 0.9).astype(np.float32).view(np.int32)
    tmeta = TMeta.from_dataset(tds)
    grow = dict(num_leaves=leaves, num_bins=B, num_features=tds.num_features, num_rows=n,
                max_depth=int(tcfg.max_depth), use_missing=True,
                has_categorical=bool(tmeta.is_categorical.any()), num_cols=cols,
                num_bins_hist=bh, bits=bits)
    fmask = np.ones(tds.num_features, np.float32)
    hyper = [getattr(tcfg, f) for f in THyper._fields]
    tkw = dict(feature_mask=torch.from_numpy(fmask), meta=tmeta,
               hyper=THyper(*(np.float32(v) for v in hyper)), params=tpg.PGrowParams(**grow),
               bmeta=None if tds.bundle is None else tpg.BundleMeta.build(tds.bundle, tds, B))
    jkw = dict(feature_mask=jnp.asarray(fmask), meta=JMeta.from_dataset(jds),
               hyper=JHyper(*(jnp.float32(v) for v in hyper)), params=JParams(**grow),
               bmeta=None if jds.bundle is None else _build_bundle_meta(jds.bundle, jds, B))
    return P, tkw, jkw, lay


def _grow_both(P, tkw, jkw, rows=None, **params):
    """(port tree on the host, JAX tree as numpy, the port's partitioned
    matrix, the JAX one)."""
    from lightgbm_tpu.ops.pgrow import grow_tree_partitioned as jgrow

    tkw = dict(tkw, params=tkw["params"]._replace(**params))
    jkw = dict(jkw, params=jkw["params"]._replace(**params))
    tp = torch.from_numpy(P.copy())
    tres, tp = tpg.grow_tree_partitioned(tp, rows=rows, **tkw)
    jres, jp = jgrow(jnp.asarray(P), interpret=True, rows=rows, **jkw)
    return tres.to_host(), jax.tree_util.tree_map(np.asarray, jres), tp.numpy(), np.asarray(jp)


def _assert_same_tree(t, j):
    ns = int(t.num_splits)
    assert ns == int(j.num_splits)
    np.testing.assert_array_equal(t.recs_raw[:ns, :4], j.recs_raw[:ns, :4])
    np.testing.assert_array_equal(t.recs_raw[:ns, 7:9], j.recs_raw[:ns, 7:9])
    for c in (4, 5, 6, 9):  # gain, left/right value, parent value
        np.testing.assert_allclose(t.recs_raw[:ns, c], j.recs_raw[:ns, c], rtol=RTOL, atol=1e-7)
    leaves = ns + 1
    np.testing.assert_array_equal(t.starts[:leaves], j.starts[:leaves])
    np.testing.assert_array_equal(t.cnts[:leaves], j.cnts[:leaves])
    np.testing.assert_array_equal(t.leaf_cnt[:leaves], j.leaf_cnt[:leaves])
    np.testing.assert_allclose(t.leaf_value[:leaves], j.leaf_value[:leaves], rtol=RTOL,
                               atol=1e-7)
    return ns


def _assert_same_rows(tp, jp, t, lay, n):
    """Each leaf's segment holds the same rows in both matrices (the
    order within a leaf is unspecified)."""
    for s, c in zip(t.starts[:int(t.num_splits) + 1], t.cnts[:int(t.num_splits) + 1]):
        a = np.sort(tp[lay.ROWID, s:s + c])
        np.testing.assert_array_equal(a, np.sort(jp[lay.ROWID, s:s + c]))
    np.testing.assert_array_equal(np.sort(tp[lay.ROWID, :n]), np.arange(n))


@pytest.mark.parametrize("levelwise", [True, False], ids=["levels", "level-grower-off"])
def test_tree_matches_jax(levelwise):
    P, tkw, jkw, lay = _case()
    t, j, tp, jp = _grow_both(P, tkw, jkw, levelwise=levelwise)
    assert _assert_same_tree(t, j) == 30
    _assert_same_rows(tp, jp, t, lay, 3000)


def test_deep_tree_takes_fallback_splits(monkeypatch):
    """255 leaves on data deep enough that the best-first order wants
    nodes past the expanded levels: phase 2's fallback split_stream runs
    with a non-empty segment at some steps, and the tree is JAX's."""
    taken = []

    def counting(p, start, cnt, *args, **kw):
        taken.append(int(cnt))
        return tpk.split_stream(p, start, cnt, *args, **kw)

    monkeypatch.setattr(tpg, "split_stream", counting)
    P, tkw, jkw, lay = _case(n=8000, leaves=255, max_bin=63, min_data_in_leaf=3)
    t, j, tp, jp = _grow_both(P, tkw, jkw)
    assert _assert_same_tree(t, j) == 254
    assert len(taken) == 254  # every phase-2 step launches the fallback
    assert sum(c > 0 for c in taken) > 0
    _assert_same_rows(tp, jp, t, lay, 8000)


def test_max_depth():
    P, tkw, jkw, lay = _case(leaves=31, max_depth=4)
    t, j, _, _ = _grow_both(P, tkw, jkw, max_depth=4)
    assert _assert_same_tree(t, j) == 15  # a full tree of depth 4


def test_tree_stops_before_its_leaves():
    """min_data_in_leaf leaves no split for most leaves: the tree ends
    after fewer than L-1 splits, and the steps after the last change
    nothing."""
    P, tkw, jkw, lay = _case(n=2000, leaves=63, min_data_in_leaf=300)
    t, j, _, _ = _grow_both(P, tkw, jkw)
    ns = _assert_same_tree(t, j)
    assert 0 < ns < 62
    assert not t.recs_raw[ns:].any()


def test_bundled_tree_matches_jax():
    P, tkw, jkw, lay = _case("efb")
    assert tkw["bmeta"] is not None and tkw["params"].num_cols == 8
    t, j, tp, jp = _grow_both(P, tkw, jkw)
    assert _assert_same_tree(t, j) == 30
    _assert_same_rows(tp, jp, t, lay, 3000)


@pytest.mark.parametrize("k", [0, 2])
def test_softmax_class_rows(k):
    """K = 3 score channels: tree k reads its own g/h rows."""
    P, tkw, jkw, lay = _case(K=3)
    t, j, tp, jp = _grow_both(P, tkw, jkw, rows=lay.class_rows(k))
    assert _assert_same_tree(t, j) == 30
    _assert_same_rows(tp, jp, t, lay, 3000)


def test_segment_values_match_jax():
    """The score delta from the device tables: every row of leaf l's
    segment gets values[l], bit for bit as the JAX lookup gives it."""
    from lightgbm_tpu.ops.pgrow import segment_values as jsv

    P, tkw, jkw, lay = _case()
    t, j, _, _ = _grow_both(P, tkw, jkw)
    tp = torch.from_numpy(P.copy())
    dev_tree, _ = tpg.grow_tree_partitioned(tp, **tkw)
    vals = np.random.default_rng(0).standard_normal(31).astype(np.float32)
    got = tpg.segment_values(dev_tree, 3000, torch.from_numpy(vals)).numpy()
    want = np.asarray(jsv(j, 3000, jnp.asarray(vals)))
    np.testing.assert_array_equal(got, want)


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


def test_chunk_stops_where_jax_stops():
    """A label set exactly by a binary feature, half the rows each way
    (the mean, the residuals and the leaf values are exact): at learning
    rate 1 the first tree fits it with one split, so the second iteration
    finds no split.  One chunk of 3 iterations: the port's trainer stops
    on the card (the later iterations record nothing) with JAX's n_done,
    and the trees are equal."""
    rng = np.random.default_rng(8)
    X = rng.standard_normal((2000, 4)).astype(np.float32)
    X[:, 0] = rng.permutation(np.repeat([0.0, 1.0], 1000))
    y = X[:, 0] * 2.0
    params = dict(objective="regression", num_leaves=4, learning_rate=1.0, max_bin=15,
                  min_data_in_leaf=5, lambda_l2=0.0, verbose=-1)
    jb = _with_env("LIGHTGBM_TPU_PGROW", "force",
                   lambda: lgb.train(params, lgb.Dataset(X, label=y), num_boost_round=3))
    assert jb.boosting.ptrainer is not None
    tb = lgt.train(params, lgt.Dataset(X, label=y), 3, device="cpu")
    pt = tb.boosting.ptrainer
    assert tb.num_trees == jb.num_trees == 2  # boost from average, one tree
    assert len(pt.iter_seconds) == 1 and pt.chunk_seconds[-1][1] == 1
    text = [b.model_to_string().split("feature importances:")[0] for b in (tb, jb)]
    assert text[0] == text[1]
    np.testing.assert_array_equal(tb.predict(X), jb.predict(X))
