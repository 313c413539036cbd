"""The port's streamed ingest (data/ingest.py, data/sketch.py,
data/stats.py) against the JAX package's on the same files: the bins,
bin mappers, label, weights and query groups must be equal, and equal to
the port's in-memory load of the same file.  Also the routing (the auto
threshold, the environment variable, the ``stream_ingest`` key and
``use_two_round_loading``), a validation file streamed with the
training set's mappers, and bad rows."""

import numpy as np
import pytest

from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.data import ingest as jingest
from lightgbm_tpu.data.sketch import CategoricalSketch as JCategoricalSketch
from lightgbm_tpu.data.sketch import NumericSketch as JNumericSketch
from lightgbm_tpu.data.stats import SketchCollector as JSketchCollector
from lightgbm_tpu.io.dataset import BinnedDataset as JBinned

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.data import ingest
from lightgbm_tpu_torch.data.sketch import CategoricalSketch, NumericSketch
from lightgbm_tpu_torch.data.stats import SketchCollector

PARAMS = dict(max_bin=31, min_data_in_leaf=5, bin_construct_sample_cnt=500, verbose=-1)


def _same(a, b):
    assert np.array_equal(np.asarray(a.binned), np.asarray(b.binned))
    assert a.binned.dtype == b.binned.dtype
    assert np.array_equal(a.used_feature_map, b.used_feature_map)
    assert a.num_total_features == b.num_total_features
    assert list(a.feature_names) == list(b.feature_names)
    assert [m.to_string() for m in a.bin_mappers] == [m.to_string() for m in b.bin_mappers]
    for ma, mb in zip(a.bin_mappers, b.bin_mappers, strict=True):
        assert np.asarray(ma.bin_upper_bound).tobytes() == np.asarray(mb.bin_upper_bound).tobytes()
    for k in ("label", "weights", "query_boundaries"):
        x, z = getattr(a.metadata, k), getattr(b.metadata, k)
        assert (x is None) == (z is None), k
        if x is not None:
            assert np.asarray(x).tobytes() == np.asarray(z).tobytes(), k


def _csv(tmp_path, n=1500, seed=0, name="d.csv"):
    """A header, a query-id column, a weight column and a categorical one."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, 4)).round(4)
    X[:, 2] = rng.integers(0, 5, n)
    y = (X[:, 0] > 0).astype(int)
    q = np.repeat(np.arange(n // 50), 50)
    w = rng.random(n).round(3) + 0.5
    path = tmp_path / name
    rows = [f"{y[i]},{q[i]},{w[i]}," + ",".join(f"{v:g}" for v in X[i]) for i in range(n)]
    path.write_text("y,qid,w,a,b,c,d\n" + "\n".join(rows) + "\n")
    return str(path)


CSV_PARAMS = dict(PARAMS, header=True, label_column="name:y", group_column="name:qid",
                  weight_column="name:w")


def _both(path, params, chunk_rows=None, **kw):
    port = ingest.stream_dataset(path, Config.from_params(dict(params)), chunk_rows=chunk_rows,
                                 **kw)
    jax = jingest.stream_dataset(path, JConfig.from_params(dict(params)), chunk_rows=chunk_rows,
                                 **kw)
    _same(port, jax)
    return port


@pytest.mark.parametrize("chunk_rows", [None, 97])
def test_csv_matches_jax_and_in_memory(tmp_path, chunk_rows, monkeypatch):
    path = _csv(tmp_path)
    port = _both(path, CSV_PARAMS, chunk_rows, categorical_feature=["c"])
    assert port.metadata.num_queries == 30
    assert port.ingest_report["chunks_pass2"] == (1 if chunk_rows is None else 16)
    monkeypatch.setenv("LIGHTGBM_TPU_STREAM_INGEST", "0")
    mem = lgt.Dataset(path, params=CSV_PARAMS, categorical_feature=["c"]).construct()
    assert not hasattr(mem, "ingest_report")
    _same(port, mem)


def test_libsvm_matches_jax_and_in_memory(tmp_path, monkeypatch):
    rng = np.random.default_rng(1)
    lines = []
    for i in range(800):
        feats = sorted(rng.choice(12, size=rng.integers(1, 6), replace=False))
        lines.append(f"{rng.integers(0, 2)} " + " ".join(f"{j}:{rng.normal():.4f}"
                                                          for j in feats))
    lines[5] = "1 15:2.5"  # the widest column appears in one row only
    path = tmp_path / "d.svm"
    path.write_text("\n".join(lines) + "\n")
    (tmp_path / "d.svm.weight").write_text("\n".join(["1", "2"] * 400) + "\n")
    port = _both(str(path), PARAMS, chunk_rows=64)
    assert port.num_total_features == 16 and port.metadata.weights is not None
    monkeypatch.setenv("LIGHTGBM_TPU_STREAM_INGEST", "0")
    _same(port, lgt.Dataset(str(path), params=PARAMS).construct())


def test_valid_file_streams_with_reference_mappers(tmp_path, monkeypatch):
    train, valid = _csv(tmp_path), _csv(tmp_path, n=400, seed=5, name="v.csv")
    ref = ingest.stream_dataset(train, Config.from_params(CSV_PARAMS))
    jref = jingest.stream_dataset(train, JConfig.from_params(CSV_PARAMS))
    port = ingest.stream_dataset(valid, Config.from_params(CSV_PARAMS), reference=ref)
    jax = jingest.stream_dataset(valid, JConfig.from_params(CSV_PARAMS), reference=jref)
    _same(port, jax)
    assert port.bin_mappers is ref.bin_mappers
    # Dataset.create_valid on a path streams with the reference's mappers
    monkeypatch.setenv("LIGHTGBM_TPU_STREAM_INGEST", "1")
    tr = lgt.Dataset(train, params=CSV_PARAMS)
    va = tr.create_valid(valid)
    _same(va.construct(), port)
    assert va.construct().ingest_report["streamed"]


def test_routing_matches_jax(tmp_path, monkeypatch):
    path = _csv(tmp_path, n=300)
    size_mb = (tmp_path / "d.csv").stat().st_size / 2**20
    cases = [({}, {}), ({"LIGHTGBM_TPU_STREAM_INGEST": "1"}, {}),
             ({"LIGHTGBM_TPU_STREAM_INGEST": "0"}, {"use_two_round_loading": True}),
             ({"LIGHTGBM_TPU_STREAM_INGEST": f"{size_mb / 2}"}, {}),
             ({"LIGHTGBM_TPU_STREAM_INGEST": f"{size_mb * 2}"}, {}),
             ({}, {"stream_ingest": "true"}), ({}, {"stream_ingest": "false"}),
             ({}, {"use_two_round_loading": True}), ({"LIGHTGBM_TPU_STREAM_INGEST": "auto"},
                                                     {"stream_ingest": "force"})]
    got = []
    for env, params in cases:
        monkeypatch.delenv("LIGHTGBM_TPU_STREAM_INGEST", raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        p = ingest.should_stream(path, Config.from_params(dict(params)))
        assert p == jingest.should_stream(path, JConfig.from_params(dict(params)))
        assert ingest.stream_mode(Config.from_params(dict(params))) == \
            jingest.stream_mode(JConfig.from_params(dict(params)))
        ds = lgt.Dataset(path, params=dict(CSV_PARAMS, **params)).construct()
        assert hasattr(ds, "ingest_report") == p
        got.append(p)
    assert got == [False, True, False, True, False, True, False, True, True]


def test_bad_rows_skipped_like_jax(tmp_path):
    path = tmp_path / "d.csv"
    rows = [f"{i % 2},{i * 0.5},{(i * 7) % 11}" for i in range(300)]
    rows[17], rows[250] = "1,oops,3", "0,1"
    path.write_text("\n".join(rows) + "\n")
    params = dict(PARAMS, bad_row_policy="skip")
    port = _both(str(path), params, chunk_rows=50)
    assert port.num_data == 298 and port.ingest_report["bad_rows"] == 2
    with pytest.raises(lgt.LightGBMError, match="malformed data row 18"):
        ingest.stream_dataset(str(path), Config.from_params(PARAMS))


def _sketch_state(sk):
    vals, cnts = sk.to_distinct_counts()
    extra = (sk.zero_cnt, sk.nan_cnt, sk.spilled) if hasattr(sk, "zero_cnt") else (
        sk.error, sk.nan_cnt, sk.spilled)
    return vals.tobytes(), cnts.tobytes(), sk.total_cnt, extra


@pytest.mark.parametrize("kind", ["numeric_exact", "numeric_spilled", "categorical"])
def test_sketches_match_jax(kind):
    """Chunk updates and a merge of two sketches, exact, spilled to GK and
    Misra-Gries, give the JAX package's summaries."""
    rng = np.random.default_rng(2)
    if kind == "categorical":
        col = rng.integers(0, 700, 3000).astype(float)
        make = (lambda: CategoricalSketch(cap=500), lambda: JCategoricalSketch(cap=500))
    else:
        col = (np.round(rng.normal(size=3000), 2) if kind == "numeric_exact"
               else rng.normal(size=3000))
        make = (lambda: NumericSketch(cap=500), lambda: JNumericSketch(cap=500))
    col[::7] = 0.0
    col[::11] = np.nan
    states = []
    for new in make:
        a, b = new(), new()
        for chunk in np.array_split(col[:2000], 5):
            a.update(chunk)
        b.update(col[2000:])
        a.merge(b)
        states.append(_sketch_state(a))
    assert states[0] == states[1]
    assert states[0][3][2] == (kind != "numeric_exact")


def test_sketch_collector_matches_jax():
    rng = np.random.default_rng(3)
    X = np.round(rng.normal(size=(900, 4)), 1)
    X[:, 1] = rng.integers(0, 6, 900)
    port, jax = SketchCollector(categorical={1}, cap=40), JSketchCollector(categorical={1}, cap=40)
    for chunk in np.array_split(X, 4):
        port.update(chunk[:, :3])
        jax.update(chunk[:, :3])
    port.update(X[:10])  # a chunk one column wider: the new column back-filled with zeros
    jax.update(X[:10])
    assert port.summary() == jax.summary()
    assert [_sketch_state(s) for s in port.sketches] == [_sketch_state(s) for s in jax.sketches]
    # one process: the merge across hosts changes nothing, as the JAX package's
    before = [_sketch_state(s) for s in port.sketches]
    port.merge_across_hosts()
    jax.merge_across_hosts()
    assert [_sketch_state(s) for s in port.sketches] == before
    assert [_sketch_state(s) for s in jax.sketches] == before
    assert port.rows_seen == jax.rows_seen


def test_jax_ingest_cache_trains_in_port(tmp_path):
    """task=ingest of either package gives a cache the other trains from:
    the JAX package's streamed cache gives the port's model of the same
    file loaded in memory."""
    path = _csv(tmp_path)
    jds = jingest.stream_dataset(path, JConfig.from_params(CSV_PARAMS))
    jds.save_binary(path + ".bin", source_path=path)
    assert JBinned.is_binary_cache(path + ".bin")
    params = dict(CSV_PARAMS, objective="binary", num_leaves=7)
    a = lgt.train(params, lgt.Dataset(path + ".bin"), 3, device="cpu").model_to_string()
    b = lgt.train(params, lgt.Dataset(path, params={"stream_ingest": "false"}), 3,
                  device="cpu").model_to_string()
    assert a == b
