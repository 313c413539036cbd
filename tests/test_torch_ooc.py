"""Out-of-core training of lightgbm_tpu_torch (boosting/ooc.py,
data/prefetch.py, data/chunksource.py, ops/ooc.py, the carry mode of
ops/histogram.py) on the CPU.

The port against itself: a streamed run gives the model text of the
resident mask grower (``LIGHTGBM_TPU_PGROW=0``) byte for byte, for every
chunk grid of the JAX package's own cases (``ooc_chunk_rows`` 1, 1000,
2048, 2500 and 9999 on 2,500 rows: the plan rounds each up to
``ROW_BLOCK``), for real multi-chunk grids (12,000 rows: three chunks)
with GOSS, quantized training, linear trees, bagging and monotone
constraints, for training from the binary cache (CRC-checked reads), and
through a kill and resume.  Below the model, the grower streamed over
grids not aligned to ``ROW_BLOCK`` equals the resident grower, and the
plain version's carry mode folded over a grid equals one plain call.

The port against the JAX package's out-of-core run: the same split lines
and predictions within 3e-3 (ROADMAP §C: the JAX package's float32
histograms are not correctly rounded), quantized L2 byte-identical, the
same ``ChunkPlan`` fingerprint, and checkpoints of out-of-core runs
resuming across the packages in both directions.

Also the prefetch ring's units (order, the depth bound, a producer's
error, the overlap bounds), the routing (off by default, ``auto`` past
``LIGHTGBM_TPU_DEVICE_BUDGET``, the ``LIGHTGBM_TPU_OOC`` override, an
unknown mode, DART forced and under ``auto``) and the stream's residency
accounting.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax._src.core

import lightgbm_tpu as lgb
from lightgbm_tpu.boosting import ooc as jooc
from lightgbm_tpu.data import prefetch as jprefetch

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.boosting.ooc import resolve_chunk_rows
from lightgbm_tpu_torch.ckpt import CheckpointMismatch, CheckpointStore, capture, restore
from lightgbm_tpu_torch.data.chunksource import ChunkFolder, ChunkStream
from lightgbm_tpu_torch.data.prefetch import (ArrayChunkSource, ChunkPlan, ChunkPrefetcher,
                                               PrefetchStats)
from lightgbm_tpu_torch.ops import histogram as th
from lightgbm_tpu_torch.ops import ooc as tooc
from lightgbm_tpu_torch.ops.grow import GrowParams, grow_tree
from lightgbm_tpu_torch.ops.histogram import ROW_BLOCK
from lightgbm_tpu_torch.ops.split import FeatureMeta, SplitHyper
from lightgbm_tpu_torch.utils.log import LightGBMError

PARAMS = {"objective": "binary", "num_leaves": 15, "verbose": -1, "min_data_in_leaf": 20}


@pytest.fixture(scope="module", autouse=True)
def mask_grower_and_shim():
    """LIGHTGBM_TPU_PGROW=0 (both packages on their mask growers), the
    jax 0.9 ``trace_state_clean`` shim, and one torch intra-op thread."""
    had = hasattr(jax.core, "trace_state_clean")
    if not had:
        jax.core.trace_state_clean = jax._src.core.trace_state_clean
    old = os.environ.get("LIGHTGBM_TPU_PGROW")
    os.environ["LIGHTGBM_TPU_PGROW"] = "0"
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    if old is None:
        del os.environ["LIGHTGBM_TPU_PGROW"]
    else:
        os.environ["LIGHTGBM_TPU_PGROW"] = old
    if not had:
        del jax.core.trace_state_clean


def _xy(n, seed=3, f=10):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f)
    y = (X[:, 0] + X[:, 1] * X[:, 2] + 0.2 * rng.randn(n) > 0)
    return X, y.astype(float)


@pytest.fixture(scope="module")
def xy():
    return _xy(2500)


@pytest.fixture(scope="module")
def xy_big():
    return _xy(12_000, seed=5)


def _train(X, y, extra=None, rounds=4, **kw):
    p = dict(PARAMS, **(extra or {}))
    return lgt.train(dict(p), lgt.Dataset(X, label=y, params=dict(p)), rounds, device="cpu",
                     **kw)


def _jtrain(X, y, extra=None, rounds=4):
    p = dict(PARAMS, **(extra or {}))
    return lgb.train(dict(p), lgb.Dataset(X, label=y, params=dict(p)), num_boost_round=rounds,
                     verbose_eval=False)


OOC = {"out_of_core": "true", "ooc_chunk_rows": 4096}


# ======================================================================
# chunk plan / prefetch ring units
# ======================================================================
@pytest.mark.parametrize("rows,chunk", [(10_000, 4096), (100, 4096), (2500, 12288),
                                        (8192, 4096)])
def test_plan_bounds_and_fingerprint_equal_jax(rows, chunk):
    plan, jplan = ChunkPlan(rows, chunk), jprefetch.ChunkPlan(rows, chunk)
    assert plan.bounds == jplan.bounds and plan.num_chunks == jplan.num_chunks
    assert plan.fingerprint() == jplan.fingerprint()


def test_plan_rejects_nonpositive_chunk():
    with pytest.raises(ValueError):
        ChunkPlan(100, 0)


@pytest.mark.parametrize("asked,features,itemsize", [(1, 10, 1), (ROW_BLOCK + 1, 10, 1),
                                                     (0, 28, 1), (0, 600, 2), (9999, 3, 1)])
def test_chunk_rows_round_up_as_jax(asked, features, itemsize):
    class C:
        ooc_chunk_rows = asked

    got = resolve_chunk_rows(C(), features, itemsize)
    assert got % ROW_BLOCK == 0 and got >= max(asked, 1)
    assert got == jooc.resolve_chunk_rows(C(), features, itemsize)


@pytest.mark.parametrize("dtype,cols", [(np.uint8, 3), (np.uint8, 8), (np.uint16, 5)])
def test_prefetcher_streams_every_chunk_in_order(dtype, cols):
    binned = (np.arange(5000 * cols) % 251).astype(dtype).reshape(5000, cols)
    plan = ChunkPlan(5000, 1024)
    stats = PrefetchStats()
    pf = ChunkPrefetcher(ArrayChunkSource(binned), plan, 2, stats)
    seen = []
    for i, start, stop, chunk in pf.stream():
        got = chunk.numpy()
        assert got.shape[1] % (4 // binned.itemsize) == 0 and not got[:, cols:].any()
        assert np.array_equal(got[:, :cols].view(dtype), binned[start:stop])
        seen.append((i, start, stop))
    assert seen == [(i, s, e) for i, (s, e) in enumerate(plan.bounds)]
    assert stats.chunks == plan.num_chunks and stats.passes == 1
    assert stats.bytes >= binned.nbytes


def test_ring_is_bounded_by_depth():
    import time

    binned = np.zeros((20_000, 4), np.uint8)
    stats = PrefetchStats()
    pf = ChunkPrefetcher(ArrayChunkSource(binned), ChunkPlan(20_000, 1024), 2, stats)
    for _ in pf.stream():
        time.sleep(0.002)  # a slow consumer: the producer must block
    assert stats.peak_inflight <= 2


def test_prefetch_depth_must_be_positive():
    with pytest.raises(ValueError):
        ChunkPrefetcher(ArrayChunkSource(np.zeros((8, 2), np.uint8)), ChunkPlan(8, 4), depth=0)


def test_producer_error_surfaces_in_consumer():
    class Bad:
        num_rows, num_cols, dtype = 100, 2, np.dtype(np.uint8)

        def read(self, start, stop):
            raise IOError("disk gone")

        def describe(self):
            return "bad"

    with pytest.raises(IOError, match="disk gone"):
        list(ChunkPrefetcher(Bad(), ChunkPlan(100, 64), 2).stream())


def test_consumer_leaving_early_stops_the_producer():
    import threading

    before = threading.active_count()
    pf = ChunkPrefetcher(ArrayChunkSource(np.zeros((10_000, 4), np.uint8)),
                         ChunkPlan(10_000, 100), 2)
    gen = pf.stream()
    next(gen)
    gen.close()
    assert threading.active_count() == before


def test_overlap_pct_bounds():
    s = PrefetchStats()
    assert s.overlap_pct() == 100.0  # nothing fetched yet
    s.fetch_s, s.stall_s = 1.0, 0.25
    assert s.overlap_pct() == 75.0
    s.stall_s = 5.0
    assert s.overlap_pct() == 0.0


# ======================================================================
# the carry mode's plain version and the streamed grower
# ======================================================================
@pytest.mark.parametrize("quantized", [False, True], ids=["hist_segment", "hist_segment_q"])
@pytest.mark.parametrize("edges", [(0, 3000), (0, 1, 777, 1500, 2999, 3000), (5, 1234, 2990)],
                         ids=["one", "uneven", "sub-range"])
def test_carry_fold_equals_one_call(quantized, edges):
    rng = np.random.default_rng(11)
    n, nf, nb = 3000, 9, 40
    bins = torch.from_numpy(rng.integers(0, nb, (n, nf)).astype(np.uint8))
    sel = torch.from_numpy((rng.random(n) < 0.6).astype(np.float32))
    if quantized:
        g = torch.from_numpy(rng.integers(-15, 16, n).astype(np.int16))
        h = torch.from_numpy(rng.integers(0, 16, n).astype(np.int16))
        P, ref = th.pack_columns_q(bins, g, h, sel), th.hist_segment_q_ref
    else:
        g = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
        h = torch.from_numpy(np.abs(rng.standard_normal(n)).astype(np.float32))
        P, ref = th.pack_columns(bins, g, h, sel), th.hist_segment_ref
    carry = th.new_carry(nf, nb, quantized, "cpu")
    for lo, hi in zip(edges[:-1], edges[1:]):
        assert th.accumulate_histogram(carry, P, lo, hi, nf, nb) is carry
    assert carry.dtype == (torch.int32 if quantized else torch.float64)
    assert torch.equal(th.finalize_histogram(carry), ref(P, edges[0], edges[-1], nf, nb))


def test_carry_refuses_a_wrong_carry():
    P = th.pack_columns(torch.zeros((10, 3), dtype=torch.uint8), torch.ones(10), torch.ones(10),
                        torch.ones(10))
    with pytest.raises(ValueError, match="float64 or int32"):
        th.accumulate_histogram(torch.zeros((3, 4, 3)), P, 0, 10, 3, 4)
    with pytest.raises(ValueError, match="contiguous"):
        th.accumulate_histogram(th.new_carry(3, 5, False, "cpu"), P, 0, 10, 3, 4)


@pytest.mark.parametrize("case", ["float", "quantized", "monotone", "16bit"])
@pytest.mark.parametrize("chunk", [777, 1500])
def test_streamed_grower_equals_resident(case, chunk):
    """``grow_tree`` over chunks cut anywhere (not ROW_BLOCK multiples)
    gives the resident tree: every record and the partition."""
    rng = np.random.default_rng(2)
    n, F = 3000, 6
    nb = 300 if case == "16bit" else 32
    X = rng.standard_normal((n, F))
    y = (X[:, 0] - X[:, 1] * X[:, 2] + 0.3 * rng.standard_normal(n) > 0).astype(np.float32)
    ds = lgt.Dataset(X, label=y, params={"max_bin": nb, "verbose": -1}).construct()
    meta = FeatureMeta.from_dataset(ds)
    cfg = lgt.config.Config.from_params(dict(PARAMS, min_data_in_leaf=5))
    bits = 8 if ds.binned.dtype == np.uint8 else 16
    mono = (1, -1, 0, 0, 0, 0) if case == "monotone" else ()
    params = GrowParams(num_leaves=15, num_bins=int(ds.max_num_bin), bits=bits, monotone=mono)
    hyper = SplitHyper.from_config(cfg)
    grad = torch.from_numpy((0.5 - y) * rng.random(n).astype(np.float32))
    hess = torch.from_numpy(0.1 + rng.random(n).astype(np.float32))
    sel = torch.from_numpy((rng.random(n) < 0.8).astype(np.float32))
    qscale = None
    if case == "quantized":
        grad = torch.from_numpy(rng.integers(-15, 16, n).astype(np.int16))
        hess = torch.from_numpy(rng.integers(1, 16, n).astype(np.int16))
        qscale = np.asarray([0.01, 0.02], np.float32)
    fmask = torch.ones(F)
    binned = np.asarray(ds.binned)
    words = th.pack_bin_words(torch.from_numpy(binned.astype(np.int32)), 32 // bits, bits)
    want = grow_tree(words, grad, hess, sel, fmask, meta, hyper, params, qscale=qscale)
    stream = ChunkStream(ArrayChunkSource(binned), ChunkPlan(n, chunk), 2)
    folder = ChunkFolder(stream, F, params.num_bins, bits)
    got = grow_tree(None, grad, hess, sel, fmask, meta, hyper, params, qscale=qscale,
                    stream=folder)
    assert got.num_splits == want.num_splits > 3
    assert torch.equal(got.leaf_id, want.leaf_id)
    for a, b in zip(got[2:], want[2:]):
        np.testing.assert_array_equal(a, b)
    assert stream.stats.passes == want.num_splits + 1


def test_find_best_split_matches_jax(xy):
    """ops/ooc.py ``find_best_split`` against the JAX package's on one
    dyadic root histogram of the same dataset: the same feature and
    threshold bin, the same gain and left sums (float32 sums of dyadic
    values are exact in either order), and -inf past the depth gate."""
    from lightgbm_tpu.ops import ooc as jops
    from lightgbm_tpu.ops import split as jsplit

    import jax.numpy as jnp

    X, y = xy
    p = dict(PARAMS, min_data_in_leaf=5)
    tds = lgt.Dataset(X, label=y, params=dict(p)).construct()
    jds = lgb.Dataset(X, label=y, params=dict(p)).construct()
    g = (np.round(np.random.default_rng(1).standard_normal(len(y)) * 16) / 16).astype(np.float32)
    h = np.full(len(y), 0.25, np.float32)
    s = np.ones(len(y), np.float32)
    hist = th.build_histogram(torch.from_numpy(np.asarray(tds.binned)), torch.from_numpy(g),
                              torch.from_numpy(h), torch.from_numpy(s), int(tds.max_num_bin))
    sums = np.float32([g.sum(), h.sum(), len(y)])
    cfg = lgt.config.Config.from_params(dict(p))
    fmask = np.ones(tds.num_features, np.float32)
    params = GrowParams(num_leaves=15, num_bins=int(tds.max_num_bin))
    got = tooc.find_best_split(hist, sums, torch.from_numpy(fmask), True,
                               FeatureMeta.from_dataset(tds), SplitHyper.from_config(cfg), params)
    want = jops.find_best_split(jnp.asarray(hist.numpy()), jnp.asarray(sums), jnp.asarray(fmask),
                                True, jsplit.FeatureMeta.from_dataset(jds),
                                jsplit.SplitHyper.from_config(lgb.config.Config.from_params(
                                    dict(p))))
    assert (int(got[1]), int(got[2]), int(got[3])) == (
        int(want.feature), int(want.threshold_bin), int(want.default_bin_for_zero))
    np.testing.assert_allclose(got[[0, 4, 5, 6]], [float(want.gain), float(want.left_sum_g),
                                                   float(want.left_sum_h), float(want.left_cnt)],
                               rtol=1e-6)
    assert tooc.find_best_split(hist, sums, torch.from_numpy(fmask), False,
                                FeatureMeta.from_dataset(tds), SplitHyper.from_config(cfg),
                                params)[0] == -np.inf


def test_chunk_helpers_match_jax():
    """root_totals, child_leaf_values, subtract_sibling and scatter_add_slice
    against the JAX package's ops/ooc.py."""
    from lightgbm_tpu.ops import ooc as jops

    rng = np.random.default_rng(4)
    g = rng.standard_normal(1000).astype(np.float32)
    h = (rng.random(1000) + 0.1).astype(np.float32)
    s = (rng.random(1000) < 0.7).astype(np.float32)
    np.testing.assert_allclose(tooc.root_totals(torch.from_numpy(g), torch.from_numpy(h),
                                                torch.from_numpy(s)),
                               np.asarray(jops.root_totals(g, h, s)), rtol=1e-6)
    left, right = np.float32([-3.5, 7.25, 40]), np.float32([2.0, 5.5, 60])
    want = [float(v) for v in jops.child_leaf_values(left, right, 0.5, 1.0)]
    assert [float(v) for v in tooc.child_leaf_values(left, right, 0.5, 1.0)] == want
    parent, small = rng.standard_normal((3, 4, 3)).astype(np.float32), \
        rng.standard_normal((3, 4, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        tooc.subtract_sibling(torch.from_numpy(parent), torch.from_numpy(small)).numpy(),
        np.asarray(jops.subtract_sibling(parent, small)))
    vec, delta = np.arange(10, dtype=np.float32), np.float32([1, 2, 3])
    np.testing.assert_array_equal(
        tooc.scatter_add_slice(torch.from_numpy(vec.copy()), torch.from_numpy(delta), 4).numpy(),
        np.asarray(jops.scatter_add_slice(vec, delta, 4)))


# ======================================================================
# streamed against resident: the model text
# ======================================================================
@pytest.mark.parametrize("chunk_rows", [1, 1000, 2048, 2500, 9999])
def test_chunk_boundary_cases(xy, chunk_rows):
    X, y = xy
    want = _train(X, y, rounds=3).model_to_string()
    bst = _train(X, y, {"out_of_core": "true", "ooc_chunk_rows": chunk_rows}, rounds=3)
    assert bst.boosting.ooc is not None and bst.boosting.ptrainer is None
    assert bst.model_to_string() == want


VARIANTS = {
    "plain": {},
    "goss": {"boosting": "goss", "top_rate": 0.3, "other_rate": 0.2, "learning_rate": 0.5},
    "quantized": {"use_quantized_grad": True},
    "linear": {"linear_tree": True},
    "bagging": {"bagging_fraction": 0.7, "bagging_freq": 2, "feature_fraction": 0.8},
    "monotone": {"monotone_constraints": [1, 0, -1, 0, 0, 0, 0, 0, 0, 0]},
}


@pytest.mark.parametrize("name", list(VARIANTS))
def test_multi_chunk_byte_identical(xy_big, name):
    X, y = xy_big
    want = _train(X, y, VARIANTS[name]).model_to_string()
    bst = _train(X, y, dict(VARIANTS[name], **OOC))
    assert bst.boosting.ooc.plan.num_chunks == 3
    assert bst.model_to_string() == want


def test_train_from_binary_cache_streams_checksummed(tmp_path, xy_big):
    X, y = xy_big
    path = str(tmp_path / "train.bin")
    lgt.Dataset(X, label=y, params=dict(PARAMS)).construct(dict(PARAMS)).save_binary(path)
    p = dict(PARAMS, **OOC)
    bst = lgt.train(dict(p), lgt.Dataset(path, params=dict(p)), 4, device="cpu")
    assert "cache(" in bst.boosting.ooc.source.describe()
    assert bst.model_to_string() == _train(X, y).model_to_string()


def test_corrupt_cache_refused_while_streaming(tmp_path, xy_big):
    """A block whose bytes changed after the cache was written fails the
    streamed read's CRC check: training stops, it never trains the
    corrupt rows."""
    from lightgbm_tpu_torch.data.cache import CacheReader

    X, y = xy_big
    path = str(tmp_path / "train.bin")
    lgt.Dataset(X, label=y, params=dict(PARAMS)).construct(dict(PARAMS)).save_binary(path)
    with CacheReader(path) as r:
        off = r.data_offset + 5000 * r.num_cols  # a byte of row 5000
    ds = lgt.Dataset(path, params=dict(PARAMS, **OOC))
    ds.construct(dict(PARAMS, **OOC))
    with open(path, "r+b") as f:
        f.seek(off)
        b = f.read(1)
        f.seek(off)
        f.write(bytes([b[0] ^ 0xFF]))
    with pytest.raises(IOError, match="CRC mismatch"):
        lgt.train(dict(PARAMS, **OOC), ds, 2, device="cpu")


def test_predictions_and_rollback_match(xy_big):
    """Predictions are equal, and ``rollback_one_iter`` (the training
    scores walked back over the streamed chunks) gives the resident
    run's scores."""
    X, y = xy_big
    a, b = _train(X, y), _train(X, y, OOC)
    np.testing.assert_array_equal(a.predict(X), b.predict(X))
    a.rollback_one_iter()
    b.rollback_one_iter()
    np.testing.assert_array_equal(a.boosting.scores.numpy(), b.boosting.scores.numpy())


# ======================================================================
# against the JAX package's out-of-core run
# ======================================================================
def _split_lines(text):
    keys = ("split_feature=", "threshold=", "decision_type=", "left_child=", "right_child=",
            "num_leaves=")
    return [ln for ln in text.splitlines() if ln.startswith(keys)]


def test_split_lines_match_jax_ooc(xy_big):
    X, y = xy_big
    jb, tb = _jtrain(X, y, OOC, rounds=3), _train(X, y, OOC, rounds=3)
    assert jb.boosting.ooc is not None
    assert _split_lines(tb.model_to_string()) == _split_lines(jb.model_to_string())
    np.testing.assert_allclose(tb.predict(X), jb.predict(X), atol=3e-3)
    assert tb.boosting.ooc.schedule_fingerprint() == jb.boosting.ooc.schedule_fingerprint()


QL2 = {"objective": "regression", "use_quantized_grad": True, "out_of_core": "true",
       "ooc_chunk_rows": 4096}


@pytest.fixture(scope="module")
def ql2_texts(xy_big):
    """The 4-round quantized L2 out-of-core model text of each package."""
    X, y = xy_big
    return {"port": _train(X, y, QL2).model_to_string(),
            "jax": _jtrain(X, y, QL2).model_to_string()}


def test_quantized_l2_byte_identical_to_jax_ooc(ql2_texts):
    assert ql2_texts["port"] == ql2_texts["jax"]


# ======================================================================
# routing
# ======================================================================
def test_off_by_default(xy, monkeypatch):
    monkeypatch.delenv("LIGHTGBM_TPU_OOC", raising=False)
    monkeypatch.setenv("LIGHTGBM_TPU_DEVICE_BUDGET", str(1 << 40))
    X, y = xy
    assert _train(X, y, rounds=1).boosting.ooc is None
    monkeypatch.delenv("LIGHTGBM_TPU_DEVICE_BUDGET")
    assert _train(X, y, rounds=1).boosting.ooc is None  # no budget known on the CPU


def test_auto_engages_past_device_budget(xy, monkeypatch):
    monkeypatch.delenv("LIGHTGBM_TPU_OOC", raising=False)
    monkeypatch.setenv("LIGHTGBM_TPU_DEVICE_BUDGET", "1024")
    X, y = xy
    bst = _train(X, y, rounds=2)
    assert bst.boosting.ooc is not None
    monkeypatch.delenv("LIGHTGBM_TPU_DEVICE_BUDGET")
    assert bst.model_to_string() == _train(X, y, rounds=2).model_to_string()


def test_env_var_overrides_config(xy, monkeypatch):
    monkeypatch.setenv("LIGHTGBM_TPU_OOC", "false")
    X, y = xy
    assert _train(X, y, {"out_of_core": "true"}, rounds=1).boosting.ooc is None
    monkeypatch.setenv("LIGHTGBM_TPU_OOC", "true")
    assert _train(X, y, rounds=1).boosting.ooc is not None


def test_unknown_mode_is_refused(xy):
    X, y = xy
    with pytest.raises(LightGBMError, match="out_of_core"):
        _train(X, y, {"out_of_core": "sideways"}, rounds=1)


def test_dart_forced_is_refused(xy):
    X, y = xy
    with pytest.raises(LightGBMError, match="not supported"):
        _train(X, y, {"boosting": "dart", "out_of_core": "true"}, rounds=1)


def test_dart_auto_falls_back_to_memory(xy, monkeypatch):
    monkeypatch.delenv("LIGHTGBM_TPU_OOC", raising=False)
    monkeypatch.setenv("LIGHTGBM_TPU_DEVICE_BUDGET", "1024")
    X, y = xy
    assert _train(X, y, {"boosting": "dart"}, rounds=1).boosting.ooc is None


# ======================================================================
# residency accounting
# ======================================================================
@pytest.mark.parametrize("depth", [1, 2, 3])
def test_stream_accounting_bounds_residency(xy_big, depth):
    """Peak in-flight chunks never exceed the ring's depth, each pass
    streams the whole grid once, and a tree takes one pass a leaf (the
    root's and one a split)."""
    X, y = xy_big
    bst = _train(X, y, dict(OOC, ooc_prefetch_depth=depth), rounds=3)
    ooc = bst.boosting.ooc
    st = ooc.stats
    assert ooc.depth == depth and st.peak_inflight <= depth
    assert st.chunks == st.passes * ooc.plan.num_chunks
    assert st.passes == sum(t.num_leaves for t in bst.boosting.models)
    assert st.bytes == st.passes * X.shape[0] * 12  # 10 one-byte bins padded to 12


def test_stream_trace_records(xy_big, tmp_path, monkeypatch):
    """A traced streamed run writes the JAX package's records
    (docs/OBSERVABILITY.md): the ``ooc.plan`` event, an ``ooc.grow`` span
    a tree, and a tree's ``ooc.chunks`` / ``ooc.bytes`` counters summing
    to the stream's totals."""
    from lightgbm_tpu_torch.obs import report, tracer

    path = str(tmp_path / "run.jsonl")
    monkeypatch.setenv("LIGHTGBM_TPU_TRACE", path)
    X, y = xy_big
    try:
        bst = _train(X, y, OOC, rounds=2)
    finally:
        tracer.close()
    recs = [r for r in report.load_trace(path) if str(r.get("name", "")).startswith("ooc.")]
    by = {}
    for r in recs:
        by.setdefault(r["name"], []).append(r)
    st = bst.boosting.ooc.stats
    assert by["ooc.plan"][0]["chunks"] == 3 and len(by["ooc.grow"]) == 2
    assert sum(r["value"] for r in by["ooc.chunks"]) == st.chunks
    assert sum(r["value"] for r in by["ooc.bytes"]) == st.bytes
    assert {"ooc.fetch_ms", "ooc.stall_ms", "ooc.overlap_pct"} <= set(by)


# ======================================================================
# checkpoints
# ======================================================================
class Kill(Exception):
    pass


def _killer(at):
    def cb(env):
        if env.model.boosting.iter > at:
            raise Kill()
    cb.order = 35
    return cb


def test_kill_resume_byte_identical(tmp_path, xy_big):
    X, y = xy_big
    want = _train(X, y, OOC, rounds=6).model_to_string()
    d = str(tmp_path / "ck")
    with pytest.raises(Kill):
        _train(X, y, OOC, rounds=6, checkpoint_dir=d, checkpoint_freq=2, callbacks=[_killer(3)])
    assert max(CheckpointStore(d).steps()) == 2
    assert _train(X, y, OOC, rounds=6, checkpoint_dir=d,
                  checkpoint_freq=2).model_to_string() == want


def test_resume_with_a_different_grid_is_refused(tmp_path, xy_big):
    X, y = xy_big
    d = str(tmp_path / "ck")
    with pytest.raises(Kill):
        _train(X, y, OOC, rounds=6, checkpoint_dir=d, checkpoint_freq=2, callbacks=[_killer(3)])
    with pytest.raises(CheckpointMismatch, match="chunk schedule|different training config"):
        _train(X, y, dict(OOC, ooc_chunk_rows=8192), rounds=6, checkpoint_dir=d,
               checkpoint_freq=2)


def test_schedule_backstop_refuses_a_shifted_grid(xy_big, monkeypatch):
    """The ``ooc_schedule`` check itself: an ``auto`` grid that shifts
    without a config change, and a blob of an in-memory run restored into
    a streamed one, are refused."""
    X, y = xy_big
    bst = _train(X, y, OOC, rounds=2)
    st = capture(bst)
    assert st.meta["ooc_schedule"] == bst.boosting.ooc.schedule_fingerprint() == "12000r/4096c/3"
    st.meta["ooc_schedule"] = "999r/512c/2"
    with pytest.raises(CheckpointMismatch, match="chunk schedule"):
        restore(bst, st)
    del st.meta["ooc_schedule"]
    with pytest.raises(CheckpointMismatch, match="chunk schedule"):
        restore(bst, st)


def test_jax_ooc_checkpoint_resumes_in_port(tmp_path, xy_big, ql2_texts):
    X, y = xy_big
    d = str(tmp_path / "ck")
    p = dict(PARAMS, **QL2)
    lgb.train(dict(p), lgb.Dataset(X, label=y, params=dict(p)), 2, verbose_eval=False,
              checkpoint_dir=d, checkpoint_freq=2)
    res = _train(X, y, QL2, checkpoint_dir=d, checkpoint_freq=2, checkpoint_resume="force")
    assert res.current_iteration() == 4 and res.boosting.ooc is not None
    assert res.model_to_string() == ql2_texts["jax"]


def test_port_ooc_checkpoint_resumes_in_jax(tmp_path, xy_big, ql2_texts):
    X, y = xy_big
    d = str(tmp_path / "ck")
    _train(X, y, QL2, rounds=2, checkpoint_dir=d, checkpoint_freq=2)
    p = dict(PARAMS, **QL2)
    res = lgb.train(dict(p), lgb.Dataset(X, label=y, params=dict(p)), 4, verbose_eval=False,
                    checkpoint_dir=d, checkpoint_freq=2, checkpoint_resume="force")
    assert res.current_iteration() == 4 and res.boosting.ooc is not None
    assert res.model_to_string() == ql2_texts["port"]
