"""lightgbm_tpu_torch dataset construction and packing against the JAX
package: bin upper bounds, the binned matrix, feature infos and the
packed matrix must be byte-identical on the same seeded data (NaNs,
few-distinct-value columns, a categorical column, a constant column)."""

import numpy as np
import pytest

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.ops import pkernels as jpk
from lightgbm_tpu_torch.convert import dataset_from_arrays
from lightgbm_tpu_torch.ops import pkernels as tpk


def _data(seed=0, n=3000):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, 7))
    X[rng.random(n) < 0.1, 0] = np.nan  # missing values
    X[:, 1] = rng.integers(0, 3, n)  # few distinct values
    X[:, 2] = np.where(rng.random(n) < 0.7, 0.0, X[:, 2])  # mostly zero
    X[:, 3] = rng.integers(0, 6, n)  # categorical
    X[:, 4] = 1.5  # constant: trivial, dropped
    X[:, 5] = np.round(X[:, 5] * 1000) / 7  # many distinct values
    y = (rng.random(n) < 0.5).astype(np.float32)
    return X, y


CASES = [dict(max_bin=63), dict(max_bin=255), dict(max_bin=15, min_data_in_bin=5),
         dict(max_bin=31, categorical_feature=[3])]


@pytest.mark.parametrize("params", CASES, ids=[str(c) for c in CASES])
def test_binned_dataset_identical(params):
    X, y = _data()
    params = dict(params)
    cats = params.pop("categorical_feature", "auto")
    jd = lgb.Dataset(X, label=y, params=params, categorical_feature=cats).construct()
    td = lgt.Dataset(X, label=y, params=params, categorical_feature=cats).construct()
    np.testing.assert_array_equal(td.used_feature_map, jd.used_feature_map)
    assert len(td.bin_mappers) == len(jd.bin_mappers)
    for mt, mj in zip(td.bin_mappers, jd.bin_mappers):
        np.testing.assert_array_equal(mt.bin_upper_bound, mj.bin_upper_bound)
        assert (mt.num_bin, mt.default_bin, mt.bin_type) == (mj.num_bin, mj.default_bin,
                                                            mj.bin_type)
    assert td.binned.dtype == jd.binned.dtype
    np.testing.assert_array_equal(td.binned, jd.binned)
    assert td.feature_infos() == jd.feature_infos()


@pytest.mark.parametrize("bits,nbins", [(8, 63), (4, 16)])
def test_pack_matrix_identical(bits, nbins):
    rng = np.random.default_rng(5)
    n, f = 2500, 9
    bins = rng.integers(0, nbins, size=(n, f), dtype=np.uint8)
    label = rng.random(n).astype(np.float32)
    weight = (rng.random(n) + 0.5).astype(np.float32)
    for w in (None, weight):
        pj = np.asarray(jpk.pack_matrix(bins, jpk.PLayout(f, bits=bits), label=label,
                                        weight=w, num_real=n - 7))
        pt = tpk.pack_matrix(bins, tpk.PLayout(f, bits=bits), label=label, weight=w,
                             num_real=n - 7).numpy()
        np.testing.assert_array_equal(pt, pj)


def test_unpack_bins_roundtrip():
    rng = np.random.default_rng(2)
    bins = rng.integers(0, 200, size=(700, 13), dtype=np.uint8)
    lay = tpk.PLayout(13)
    p = tpk.pack_matrix(bins, lay)
    np.testing.assert_array_equal(tpk.unpack_bins(p, lay, 0, 700).numpy().T, bins)


def test_dataset_from_arrays_matches_jax_dataset():
    X, y = _data(seed=3)
    jd = lgb.Dataset(X, label=y, params={"max_bin": 63}).construct()
    td = dataset_from_arrays(jd.binned, [m.state() for m in jd.bin_mappers], jd.metadata.label,
                             used_feature_map=jd.used_feature_map,
                             num_total_features=jd.num_total_features,
                             feature_names=jd.feature_names, max_bin=jd.max_bin)
    np.testing.assert_array_equal(td.binned, jd.binned)
    assert td.feature_infos() == jd.feature_infos()
    assert td.max_num_bin == jd.max_num_bin
