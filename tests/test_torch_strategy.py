"""lightgbm_tpu_torch/tree/strategy.py and the monotone branch of the split
scan against the JAX package.

- ``parse_monotone_constraints``: the same tuple from a comma list, a
  Python list (through the Config), a dict by index and by name; the same
  ``LightGBMError`` message on bad input.
- ``TreeStrategy.from_config``: the same nested tuple, with a categorical
  column (its constraint zeroed) and a feature binning pruned.
- The split scan with random ``monotone`` directions and random leaf
  bounds: the same feature, threshold and zero/missing placement, the
  gain and the clipped outputs within 1e-5 relative (the JAX package's
  float32 prefix sums against the port's rounded float64 ones); a batch of
  leaves gives each leaf the result it gets alone; ``monotone=None`` is
  the unconstrained scan bit for bit.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.ops import split as js
from lightgbm_tpu.tree import strategy as jst
from lightgbm_tpu.utils.log import LightGBMError as JError
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.ops import split as ts
from lightgbm_tpu_torch.tree import strategy as tst
from lightgbm_tpu_torch.utils.log import LightGBMError as TError

NAMES = ["a", "b", "c", "d"]
PARSE = [
    ("list", "1,0,-1,0"),
    ("plus_spaces", " +1, 0 ,-1,1"),
    ("empty", ""),
    ("zeros", "0,0,0,0"),
    ("dict_index", {0: 1, "2": -1}),
    ("dict_name", {"b": -1, "d": 1}),
    ("dict_mixed", {"a": 1, 3: -1}),
]
BAD = [
    ("length", "1,0"),
    ("direction", "1,2,0,0"),
    ("not_int", "1,x,0,0"),
    ("unknown_name", {"zz": 1}),
    ("index_range", {7: 1}),
    ("dict_direction", {"a": -3}),
]


@pytest.mark.parametrize("value", [p[1] for p in PARSE], ids=[p[0] for p in PARSE])
def test_parse_matches_jax(value):
    assert (tst.parse_monotone_constraints(value, 4, NAMES)
            == jst.parse_monotone_constraints(value, 4, NAMES))


@pytest.mark.parametrize("value", [b[1] for b in BAD], ids=[b[0] for b in BAD])
def test_parse_errors_match_jax(value):
    with pytest.raises(JError) as je:
        jst.parse_monotone_constraints(value, 4, NAMES)
    with pytest.raises(TError) as te:
        tst.parse_monotone_constraints(value, 4, NAMES)
    assert str(te.value) == str(je.value)


def _datasets(params):
    """The same rows binned by each package: column 1 categorical, column 3
    constant (pruned by binning)."""
    rng = np.random.default_rng(2)
    X = rng.standard_normal((400, 5))
    X[:, 1] = rng.integers(0, 4, 400)
    X[:, 3] = 1.5
    y = rng.standard_normal(400)
    kw = dict(label=y, categorical_feature=[1], feature_name=["a", "b", "c", "d", "e"])
    jd = lgb.Dataset(X, **kw).construct(params)
    td = lgt.Dataset(X, **kw).construct(params)
    return jd, td


@pytest.mark.parametrize("mc", ["1,1,-1,1,0", [0, -1, 0, 0, 1], {"e": -1, "b": 1}, "",
                                "0,0,0,0,0"],
                         ids=["list", "pylist", "dict", "empty", "zeros"])
@pytest.mark.parametrize("linear", [False, True])
def test_from_config_matches_jax(mc, linear):
    params = dict(objective="regression", verbose=-1, monotone_constraints=mc,
                  linear_tree=linear, linear_lambda=0.5)
    jd, td = _datasets(params)
    jc, tc = JConfig.from_params(params), TConfig.from_params(params)
    js_, ts_ = jst.TreeStrategy.from_config(jc, jd), tst.TreeStrategy.from_config(tc, td)
    assert tuple(ts_) == tuple(js_)
    assert ts_.split_gain.constrained == js_.split_gain.constrained
    assert ts_.leaf_fit.linear == linear


def _case(seed, F=9, B=24, cat=False):
    rng = np.random.default_rng(seed)
    nb = rng.integers(3, B + 1, F)
    nb[0] = B
    cnt = rng.integers(0, 40, (F, B)).astype(np.float32)
    for f in range(F):
        cnt[f, nb[f]:] = 0
    tot = cnt[0].sum()
    for f in range(1, F):
        cnt[f] = np.floor(cnt[f] / max(cnt[f].sum(), 1) * tot)
        cnt[f, 0] += tot - cnt[f].sum()
    g = (rng.standard_normal((F, B)) * cnt).astype(np.float32)
    h = (rng.random((F, B)) * cnt).astype(np.float32)
    hist = np.stack([g, h, cnt], axis=2)
    db = np.asarray([rng.integers(0, n) for n in nb]).astype(np.int32)
    is_cat = np.zeros(F, bool)
    if cat:
        is_cat[[2, 5]] = True
    mono = rng.integers(-1, 2, F).astype(np.int32)
    mono[is_cat] = 0
    # bounds around the leaf's own output, so some candidates clip
    out = float(-hist[0, :, 0].sum() / (hist[0, :, 1].sum() + 1.0))
    lo, hi = sorted(out + rng.normal(0, abs(out) + 0.1, 2))
    if seed % 3 == 0:
        lo, hi = -np.inf, np.inf
    elif seed % 3 == 1:
        lo = -np.inf
    return hist, nb.astype(np.int32), db, is_cat, mono, np.float32(lo), np.float32(hi)


HYPERS = [(0.0, 0.0, 5.0, 1e-3, 0.0), (0.5, 2.0, 20.0, 1.0, 0.1)]


def _jax_split(hist, nb, db, is_cat, fmask, hyper, use_missing, mono, lo, hi):
    jmeta = js.FeatureMeta(jnp.asarray(nb), jnp.asarray(db), jnp.asarray(is_cat))
    jhyp = js.SplitHyper(*(jnp.float32(v) for v in hyper))
    sums = hist[0].sum(0)
    return js.best_split_all_features(
        jnp.asarray(hist), jnp.float32(sums[0]), jnp.float32(sums[1]), jnp.float32(sums[2]),
        jmeta, jhyp, jnp.asarray(fmask), use_missing, monotone=jnp.asarray(mono),
        leaf_lo=jnp.float32(lo), leaf_hi=jnp.float32(hi))


def _torch_split(hists, nb, db, is_cat, fmask, hyper, use_missing, mono, lo, hi, cat):
    tmeta = ts.FeatureMeta(torch.from_numpy(nb.astype(np.int64)),
                           torch.from_numpy(db.astype(np.int64)), torch.from_numpy(is_cat))
    thyp = ts.SplitHyper(*(np.float32(v) for v in hyper))
    h = torch.from_numpy(np.stack(hists))
    s = h[:, 0].sum(1)
    m = None if mono is None else torch.from_numpy(mono.astype(np.int64))
    return ts.best_split_all_features(
        h, s[:, 0], s[:, 1], s[:, 2], tmeta, thyp, torch.from_numpy(fmask), use_missing,
        has_categorical=cat, monotone=m, leaf_lo=torch.tensor(lo, dtype=torch.float32),
        leaf_hi=torch.tensor(hi, dtype=torch.float32))


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("use_missing", [True, False])
@pytest.mark.parametrize("cat", [False, True])
@pytest.mark.parametrize("hyper", HYPERS, ids=["default", "regularized"])
def test_monotone_split_matches_jax(seed, use_missing, cat, hyper):
    hist, nb, db, is_cat, mono, lo, hi = _case(seed, cat=cat)
    fmask = np.ones(hist.shape[0], np.float32)
    fmask[4] = 0.0
    jr = _jax_split(hist, nb, db, is_cat, fmask, hyper, use_missing, mono, lo, hi)
    tr = _torch_split([hist], nb, db, is_cat, fmask, hyper, use_missing, mono, [lo], [hi],
                      cat)
    jg, tg = float(jr.gain), float(tr.gain[0])
    if not np.isfinite(jg):
        assert not np.isfinite(tg)
        return
    assert int(tr.feature[0]) == int(jr.feature)
    assert int(tr.threshold_bin[0]) == int(jr.threshold_bin)
    assert int(tr.default_bin_for_zero[0]) == int(jr.default_bin_for_zero)
    assert abs(tg - jg) <= 1e-5 * max(abs(jg), 1e-12)
    np.testing.assert_allclose([float(tr.left_output[0]), float(tr.right_output[0])],
                               [float(jr.left_output), float(jr.right_output)], rtol=1e-5,
                               atol=1e-6)
    assert lo <= float(tr.left_output[0]) <= hi and lo <= float(tr.right_output[0]) <= hi


def test_monotone_batch_equals_single():
    """Five leaves with their own bounds in one call: each leaf's result
    is the one it gets alone, bit for bit."""
    cases = [_case(seed + 20, cat=True) for seed in range(5)]
    nb, db, is_cat, mono = cases[0][1:5]
    F, B = cases[0][0].shape[:2]
    hists = []
    for c in cases:  # the first case's features and metadata, other bins' sums
        h = c[0].copy()
        for f in range(F):
            h[f, nb[f]:] = 0
        hists.append(h)
    fmask = np.ones(F, np.float32)
    los, his = [c[5] for c in cases], [c[6] for c in cases]
    batch = _torch_split(hists, nb, db, is_cat, fmask, HYPERS[0], True, mono, los, his, True)
    for i in range(len(cases)):
        one = _torch_split(hists[i:i + 1], nb, db, is_cat, fmask, HYPERS[0], True, mono,
                           los[i:i + 1], his[i:i + 1], True)
        for name in one._fields:
            assert torch.equal(getattr(batch, name)[i:i + 1], getattr(one, name)), name


def test_unconstrained_path_unchanged():
    """monotone=None is the scan of the unconstrained port, and all-zero
    directions with infinite bounds choose the same split."""
    hist, nb, db, is_cat, mono, _, _ = _case(4, cat=True)
    fmask = np.ones(hist.shape[0], np.float32)
    plain = _torch_split([hist], nb, db, is_cat, fmask, HYPERS[1], True, None, [0.0], [0.0],
                         True)
    zeros = _torch_split([hist], nb, db, is_cat, fmask, HYPERS[1], True, np.zeros_like(mono),
                         [-np.inf], [np.inf], True)
    for name in ("feature", "threshold_bin", "default_bin_for_zero", "left_sum_g",
                 "left_sum_h", "left_cnt", "left_output", "right_output"):
        assert torch.equal(getattr(plain, name), getattr(zeros, name)), name
    assert abs(float(plain.gain[0]) - float(zeros.gain[0])) <= 1e-5 * abs(float(plain.gain[0]))
