"""The port's binary dataset cache (data/cache.py, io/dataset.py
save_binary / load_binary, Dataset.save_binary) against the JAX
package's: the same npz members and header, so a cache written by either
package loads in the other; round trips, block CRCs, the refusal of a
stale source, of a format-v1 cache and of a newer format; and a model
trained from a cache whose text is byte-identical to the one trained
from the same rows in memory."""

import json
import os
import zipfile

import numpy as np
import pytest

from lightgbm_tpu.data.cache import chunk_crcs as jchunk_crcs
from lightgbm_tpu.io.dataset import BinnedDataset as JBinned
from lightgbm_tpu.utils.log import LightGBMError as JError

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch import LightGBMError
from lightgbm_tpu_torch.data import cache
from lightgbm_tpu_torch.io.dataset import BinnedDataset

PARAMS = dict(objective="binary", num_leaves=7, max_bin=31, min_data_in_leaf=5, verbose=-1)


def _data(n=600, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, 5))
    X[:, 3] = rng.integers(0, 4, n)  # a categorical column
    X[rng.random(n) < 0.1, 1] = np.nan
    y = (X[:, 0] + 0.3 * rng.standard_normal(n) > 0).astype(np.float32)
    return X, y, rng.random(n).astype(np.float32) + 0.5


def _port_set(tmp_path, with_meta=True):
    X, y, w = _data()
    kw = dict(weight=w, group=[200, 150, 250], init_score=np.linspace(-1, 1, len(y))) \
        if with_meta else {}
    ds = lgt.Dataset(X, label=y, categorical_feature=[3], params=PARAMS, **kw)
    path = str(tmp_path / "d.bin")
    ds.save_binary(path)
    return ds.construct(), path


def _same(a, b):
    """Two binned datasets (of either package) hold the same state."""
    assert np.array_equal(np.asarray(a.binned), np.asarray(b.binned))
    assert a.binned.dtype == b.binned.dtype
    assert np.array_equal(a.used_feature_map, b.used_feature_map)
    assert a.num_total_features == b.num_total_features and a.max_bin == b.max_bin
    assert list(a.feature_names) == list(b.feature_names)
    for ma, mb in zip(a.bin_mappers, b.bin_mappers, strict=True):
        sa, sb = ma.state(), mb.state()
        assert sa.keys() == sb.keys()
        for k in sa:
            assert np.array_equal(np.asarray(sa[k]), np.asarray(sb[k])), k
    for k in ("label", "weights", "query_boundaries", "init_score"):
        x, z = getattr(a.metadata, k), getattr(b.metadata, k)
        assert (x is None) == (z is None), k
        if x is not None:
            assert np.asarray(x).tobytes() == np.asarray(z).tobytes(), k


def test_round_trip(tmp_path):
    src, path = _port_set(tmp_path)
    assert BinnedDataset.is_binary_cache(path)
    back = BinnedDataset.load_binary(path)
    _same(src, back)
    assert isinstance(back.binned, np.memmap) and back.cache_path == path
    assert not BinnedDataset.is_binary_cache(str(tmp_path / "missing"))
    # the Dataset's own label and weights override the cache's
    ds = lgt.Dataset(path, label=np.zeros(600), weight=np.ones(600))
    assert ds.construct().metadata.label.sum() == 0
    assert ds.get_weight().sum() == 600


def test_block_crcs(tmp_path):
    X, y, _ = _data(n=9000)
    ds = lgt.Dataset(X, label=y, params=PARAMS)
    path = str(tmp_path / "d.bin")
    ds.save_binary(path)
    binned = ds.construct().binned
    assert np.array_equal(cache.chunk_crcs(binned), jchunk_crcs(binned))
    with cache.CacheReader(path) as r:
        assert r.crcs.shape == (3,) and r.crc_rows == 4096
        assert np.array_equal(r.read_rows(4096, 9000), binned[4096:])
        r.verify_all()
        off = r.data_offset + 5000 * r.row_bytes
    with open(path, "r+b") as f:  # flip one bin of row 5000
        f.seek(off)
        b = f.read(1)
        f.seek(off)
        f.write(bytes([b[0] ^ 1]))
    with cache.CacheReader(path) as r:
        with pytest.raises(IOError, match=r"CRC mismatch on rows \[4096, 8192\)"):
            r.read_rows(4096, 8192)


def test_refuses_stale_source_and_newer_format(tmp_path):
    X, y, _ = _data(n=200)
    csv = tmp_path / "d.csv"
    np.savetxt(csv, np.column_stack([y, X]), delimiter=",", fmt="%.6f")
    path = str(tmp_path / "d.csv.bin")
    lgt.Dataset(str(csv), params=PARAMS).save_binary(path)
    meta = json.loads(str(np.load(path)["__cache_meta__"]))
    assert meta["source_path"] == str(csv) and meta["format_version"] == 2
    BinnedDataset.load_binary(path)
    with open(csv, "a") as f:
        f.write("1,0,0,0,0,0\n")
    with pytest.raises(LightGBMError, match="Refusing stale binary dataset"):
        BinnedDataset.load_binary(path)
    with pytest.raises(JError, match="Refusing stale binary dataset"):
        JBinned.load_binary(path)

    def rewrite(name, edit):
        out = str(tmp_path / name)
        with np.load(path) as z:
            members = {k: z[k] for k in z.files}
        edit(members)
        with open(out, "wb") as f:
            np.savez(f, **members)
        return out

    os.remove(csv)  # the source gone: nothing to compare against
    newer = rewrite("newer.bin", lambda m: m.update(__cache_meta__=np.asarray(json.dumps(
        dict(meta, format_version=3)))))
    with pytest.raises(LightGBMError, match="cache format v3, newer than this build"):
        BinnedDataset.load_binary(newer)
    v1 = rewrite("v1.bin", lambda m: m.pop("__cache_meta__"))
    with pytest.raises(LightGBMError, match="predates cache format v2"):
        BinnedDataset.load_binary(v1)


def test_jax_cache_loads_in_port(tmp_path):
    X, y, w = _data()
    import lightgbm_tpu as lgb

    jds = lgb.Dataset(X, label=y, weight=w, group=[300, 300], categorical_feature=[3],
                      params=PARAMS)
    path = str(tmp_path / "jax.bin")
    jds.save_binary(path)
    _same(jds.construct(), BinnedDataset.load_binary(path))


def test_port_cache_loads_in_jax(tmp_path):
    src, path = _port_set(tmp_path)
    with zipfile.ZipFile(path) as zf:
        assert zf.getinfo("binned.npy").compress_type == zipfile.ZIP_STORED
    assert JBinned.is_binary_cache(path)
    _same(src, JBinned.load_binary(path))


def test_model_from_cache_is_byte_identical(tmp_path):
    X, y, _ = _data()
    mem = lgt.train(PARAMS, lgt.Dataset(X, label=y, categorical_feature=[3]), 4, device="cpu")
    path = str(tmp_path / "d.bin")
    lgt.Dataset(X, label=y, categorical_feature=[3], params=PARAMS).save_binary(path)
    cached = lgt.train(PARAMS, lgt.Dataset(path), 4, device="cpu")
    assert cached.model_to_string() == mem.model_to_string()
    # a validation set from a cache, evaluated as the in-memory one
    res = {}
    lgt.train(dict(PARAMS, metric="auc"), lgt.Dataset(path), 2, device="cpu",
              valid_sets=[lgt.Dataset(path)], evals_result=res, verbose_eval=False)
    assert len(res["valid_0"]["auc"]) == 2
