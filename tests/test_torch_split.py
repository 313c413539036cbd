"""lightgbm_tpu_torch split search against lightgbm_tpu/ops/split.py on
random histograms: the chosen feature, threshold and zero/missing
placement must be exact, the gain within 1e-5 relative; a batch of
leaves gives each leaf the result it gets alone."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lightgbm_tpu.ops import split as js
from lightgbm_tpu_torch.ops import split as ts


def _case(seed, F=9, B=24, cat=False):
    rng = np.random.default_rng(seed)
    nb = rng.integers(3, B + 1, F)
    nb[0] = B
    cnt = rng.integers(0, 40, (F, B)).astype(np.float32)
    for f in range(F):
        cnt[f, nb[f]:] = 0
    # every feature sees the same rows: rescale counts to one total
    tot = cnt[0].sum()
    for f in range(1, F):
        cnt[f] = np.floor(cnt[f] / max(cnt[f].sum(), 1) * tot)
        cnt[f, 0] += tot - cnt[f].sum()
    g = (rng.standard_normal((F, B)) * cnt).astype(np.float32)
    h = (rng.random((F, B)) * cnt).astype(np.float32)
    hist = np.stack([g, h, cnt], axis=2)
    db = np.asarray([rng.integers(0, n) for n in nb])
    is_cat = np.zeros(F, bool)
    if cat:
        is_cat[[2, 5]] = True
    return hist, nb.astype(np.int32), db.astype(np.int32), is_cat


HYPERS = [(0.0, 0.0, 5.0, 1e-3, 0.0), (0.5, 2.0, 20.0, 1.0, 0.1), (0.0, 1.0, 1.0, 10.0, 0.0)]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("use_missing", [True, False])
@pytest.mark.parametrize("cat", [False, True])
@pytest.mark.parametrize("hyper", HYPERS, ids=["default", "regularized", "min_hess"])
def test_matches_jax(seed, use_missing, cat, hyper):
    hist, nb, db, is_cat = _case(seed, cat=cat)
    F = hist.shape[0]
    fmask = np.ones(F, np.float32)
    fmask[4] = 0.0
    sums = hist[0].sum(0)
    jmeta = js.FeatureMeta(jnp.asarray(nb), jnp.asarray(db), jnp.asarray(is_cat))
    jhyp = js.SplitHyper(*(jnp.float32(v) for v in hyper))
    jr = js.best_split_all_features(jnp.asarray(hist), jnp.float32(sums[0]),
                                    jnp.float32(sums[1]), jnp.float32(sums[2]), jmeta, jhyp,
                                    jnp.asarray(fmask), use_missing)
    tmeta = ts.FeatureMeta(torch.from_numpy(nb.astype(np.int64)),
                           torch.from_numpy(db.astype(np.int64)), torch.from_numpy(is_cat))
    thyp = ts.SplitHyper(*(np.float32(v) for v in hyper))
    s = torch.from_numpy(sums[None])
    tr = ts.best_split_all_features(torch.from_numpy(hist[None]), s[:, 0], s[:, 1], s[:, 2],
                                    tmeta, thyp, torch.from_numpy(fmask), use_missing,
                                    has_categorical=cat)
    jg, tg = float(jr.gain), float(tr.gain[0])
    if not np.isfinite(jg):
        assert not np.isfinite(tg)
        return
    assert int(tr.feature[0]) == int(jr.feature)
    assert int(tr.threshold_bin[0]) == int(jr.threshold_bin)
    assert int(tr.default_bin_for_zero[0]) == int(jr.default_bin_for_zero)
    assert abs(tg - jg) <= 1e-5 * max(abs(jg), 1e-12)
    np.testing.assert_allclose(
        [float(tr.left_sum_g[0]), float(tr.left_sum_h[0]), float(tr.left_cnt[0])],
        [float(jr.left_sum_g), float(jr.left_sum_h), float(jr.left_cnt)], rtol=1e-5,
        atol=1e-4)


def test_batch_equals_single():
    hists, sums = [], []
    for seed in range(5):
        h, nb, db, is_cat = _case(seed + 10, cat=True)
        hists.append(h)
        sums.append(h[0].sum(0))
    meta = ts.FeatureMeta(torch.from_numpy(nb.astype(np.int64)),
                          torch.from_numpy(db.astype(np.int64)), torch.from_numpy(is_cat))
    hyp = ts.SplitHyper(*(np.float32(v) for v in HYPERS[0]))
    H = torch.from_numpy(np.stack(hists))
    S = torch.from_numpy(np.stack(sums))
    fm = torch.ones(H.shape[1])
    batch = ts.best_split_all_features(H, S[:, 0], S[:, 1], S[:, 2], meta, hyp, fm)
    for i in range(5):
        one = ts.best_split_all_features(H[i:i + 1], S[i:i + 1, 0], S[i:i + 1, 1],
                                         S[i:i + 1, 2], meta, hyp, fm)
        for a, b in zip(batch, one):
            assert torch.equal(a[i:i + 1], b)


def test_leaf_output_np_matches_torch():
    rng = np.random.default_rng(0)
    g = rng.standard_normal(1000).astype(np.float32) * 10
    h = rng.random(1000).astype(np.float32) * 5
    g[:3] = 0.0
    for l1, l2 in ((0.0, 0.0), (0.3, 1.5)):
        a = ts.leaf_output_np(g, h, l1, l2)
        b = ts.leaf_output(torch.from_numpy(g), torch.from_numpy(h), np.float32(l1),
                           np.float32(l2)).numpy()
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))
