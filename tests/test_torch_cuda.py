"""lightgbm_tpu_torch's CUDA kernels against their plain PyTorch versions,
on the card.

Every test here carries the ``cuda`` marker and skips where no card is
present.  The file imports neither jax nor the JAX package, so it runs on
a machine that has only PyTorch for CUDA:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: left counts, partitioned matrices (the partition is stable in
both versions), histogram counts, hist_segment_q's integer histograms,
the mask grower's models (card against CPU) and score_add bit-exact; histogram g/h
sums within 1e-5 of the largest bin per channel (both versions sum in
float64 and round once, in different orders); recomputed gradients
within 1e-6 relative, and bit-exact for update_channels (both sides take
the objectives' exp in float64 and round once).
"""

import numpy as np
import pytest
import torch

from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.io.dataset import Metadata
from lightgbm_tpu_torch.objective import create_objective
from lightgbm_tpu_torch.ops import histogram as th
from lightgbm_tpu_torch.ops import pkernels as pk

pytestmark = pytest.mark.cuda

N, F = 20000, 11


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _packed(b=32, bits=8, seed=7):
    rng = np.random.default_rng(seed)
    lay = pk.PLayout(F, bits=bits)
    bins = rng.integers(0, b, size=(N, F), dtype=np.uint8)
    label = (rng.random(N) < 0.4).astype(np.float32)
    weight = (rng.random(N) + 0.5).astype(np.float32)
    P = pk.pack_matrix(bins, lay, label=label, weight=weight).numpy()
    P[lay.G, :N] = rng.standard_normal(N).astype(np.float32).view(np.int32)
    P[lay.H, :N] = np.abs(rng.standard_normal(N)).astype(np.float32).view(np.int32)
    P[lay.SEL, :N] = (rng.random(N) < 0.85).astype(np.float32).view(np.int32)
    P[lay.SCORE, :N] = (0.3 * rng.standard_normal(N)).astype(np.float32).view(np.int32)
    return torch.from_numpy(P), lay, label, weight


def _objective(name, label, weight, **params):
    obj = create_objective(Config.from_params(dict(params, objective=name)))
    md = Metadata(len(label))
    md.set_label(label)
    md.set_weights(weight)
    obj.init(md, len(label))
    return obj


# every row-local objective of B1 and B10 (csrc/common.cuh ObjKind), with
# the parameters that put Huber's rows on both sides of its delta
KINDS = ["binary", "regression", "regression_l1", "huber", "fair", "poisson"]
KIND_PARAMS = {"huber": {"huber_delta": 0.3}, "fair": {"fair_c": 0.7}}


def _assert_hist(hk, hr):
    hk, hr = hk.cpu().double(), hr.cpu().double()
    assert torch.equal(hk[..., 2], hr[..., 2])
    for c in (0, 1):
        err = (hk[..., c] - hr[..., c]).abs().max() / max(float(hr[..., c].abs().max()), 1.0)
        assert float(err) <= 1e-5


@pytest.mark.parametrize("objective", KINDS)
def test_update_and_root_hist(dev, objective):
    P, lay, label, weight = _packed()
    obj = _objective(objective, label, weight, **KIND_PARAMS.get(objective, {}))
    delta = torch.from_numpy(np.random.default_rng(1).standard_normal(N).astype(np.float32))
    Pk, Pr = P.to(dev), P.to(dev)
    before = pk.update_and_root_hist.launches
    _, hk = pk.update_and_root_hist(Pk, lay, obj, delta=delta, num_rows=N, num_features=F,
                                    num_bins=32)
    assert pk.update_and_root_hist.launches == before + 1
    _, hr = pk.update_and_root_hist_ref(Pr, lay, obj, delta=delta, num_rows=N, num_features=F,
                                        num_bins=32)
    torch.cuda.synchronize()
    for r in (lay.G, lay.H):
        a, b = Pk[r, :N].view(torch.float32), Pr[r, :N].view(torch.float32)
        assert float((a - b).abs().max() / b.abs().max()) <= 1e-6
    other = [r for r in range(lay.C) if r not in (lay.G, lay.H)]
    assert torch.equal(Pk[other], Pr[other])
    assert torch.equal(Pk[:, N:], P[:, N:].to(dev))
    _assert_hist(hk, hr)


# (start, cnt, feat, thr, zero_bin, dbz, cat, off_lo, off_hi, bias): empty,
# tiny unaligned, tile-aligned, categorical, zero-bin and EFB range remaps
SEGMENTS = [
    (0, 1024, 3, 15, 0, 0, 0, 0, 256, 0),
    (1024, 0, 0, 7, 0, 0, 0, 0, 256, 0),
    (1024, 137, 0, 7, 5, 11, 0, 0, 256, 0),
    (1161, 7031, 10, 4, 0, 0, 1, 0, 256, 0),
    (8192, 8192, 7, 20, 0, 3, 0, 3, 20, 1),
    (16384, 3000, 1, 31, 0, 0, 0, 0, 256, 0),
]


def _tab(bits):
    per = 32 // bits
    return torch.tensor([[s, c, f // per, (f % per) * bits, zb, dbz, t, cat, lo,
                          min(hi, 1 << bits), bias, 0]
                         for s, c, f, t, zb, dbz, cat, lo, hi, bias in SEGMENTS])


@pytest.mark.parametrize("bits,nbins", [(8, 32), (4, 16)])
def test_level_stream(dev, bits, nbins):
    P, lay, *_ = _packed(b=nbins, bits=bits)
    tab = _tab(bits)
    tab[:, 6] = tab[:, 6].clamp(max=nbins - 1)
    Pk, Pr = P.to(dev), P.to(dev)
    kw = dict(num_features=F, num_bins=nbins, bits=bits, smax=8)
    before = pk.level_stream.launches
    _, nk, hk = pk.level_stream(Pk, tab, len(SEGMENTS), **kw)
    assert pk.level_stream.launches == before + 1
    _, nr, hr = pk.level_stream_ref(Pr, tab, len(SEGMENTS), **kw)
    torch.cuda.synchronize()
    assert torch.equal(nk.cpu(), nr.cpu())
    assert torch.equal(Pk, Pr)
    _assert_hist(hk, hr)


@pytest.mark.parametrize("seg", SEGMENTS, ids=[f"seg{i}" for i in range(len(SEGMENTS))])
def test_split_stream(dev, seg):
    P, lay, *_ = _packed()
    s, c, f, t, zb, dbz, cat, lo, hi, bias = seg
    args = (s, c, f // 4, (f % 4) * 8, zb, dbz, t, cat, lo, hi, bias)
    Pk, Pr = P.to(dev), P.to(dev)
    _, nk, lk, rk = pk.split_stream(Pk, *args, num_features=F, num_bins=32)
    _, nr, lr, rr = pk.split_stream_ref(Pr, *args, num_features=F, num_bins=32)
    torch.cuda.synchronize()
    assert int(nk) == int(nr)
    assert torch.equal(Pk, Pr)
    _assert_hist(lk, lr)
    _assert_hist(rk, rr)


def test_score_add(dev):
    P, lay, *_ = _packed()
    delta = torch.from_numpy(np.random.default_rng(2).standard_normal(N).astype(np.float32))
    Pk, Pr = P.to(dev), P.to(dev)
    before = pk.score_add.launches
    pk.score_add(Pk, lay, delta, num_rows=N)
    assert pk.score_add.launches == before + 1
    pk.score_add_ref(Pr, lay, delta, num_rows=N)
    torch.cuda.synchronize()
    assert torch.equal(Pk, Pr)


# (start, cnt, feat, thr, zero_bin, dbz, cat, off_lo, off_hi, bias) of
# split_stream's own cases: all-left, all-right (a categorical bin no
# row holds), one row, an unaligned start over many row tiles with a
# ragged last tile, and the whole matrix
SPLIT_EXTRA = [
    (77, 3001, 2, 31, 0, 0, 0, 0, 256, 0),
    (5, 4000, 4, 99, 0, 0, 1, 0, 256, 0),
    (19999, 1, 6, 3, 0, 0, 0, 0, 256, 0),
    (333, 15001, 9, 12, 2, 2, 0, 0, 256, 0),
    (0, N, 8, 16, 0, 0, 0, 0, 256, 0),
]


@pytest.mark.parametrize("seg", SPLIT_EXTRA, ids=["all-left", "all-right", "one-row",
                                                  "tiles-unaligned", "all-rows"])
def test_split_stream_segments(dev, seg):
    P, lay, *_ = _packed(seed=3)
    s, c, f, t, zb, dbz, cat, lo, hi, bias = seg
    args = (s, c, f // 4, (f % 4) * 8, zb, dbz, t, cat, lo, hi, bias)
    Pk, Pr = P.to(dev), P.to(dev)
    before = (pk.split_stream.launches, pk.split_stream.rows)
    _, nk, lk, rk = pk.split_stream(Pk, *args, num_features=F, num_bins=32)
    assert (pk.split_stream.launches, pk.split_stream.rows) == (before[0] + 1, before[1] + c)
    _, nr, lr, rr = pk.split_stream_ref(Pr, *args, num_features=F, num_bins=32)
    torch.cuda.synchronize()
    assert int(nk) == int(nr)
    assert torch.equal(Pk, Pr)
    _assert_hist(lk, lr)
    _assert_hist(rk, rr)


@pytest.mark.parametrize("kernel", ["split_stream", "level_stream"])
def test_partition_many_tiles(dev, kernel):
    """More row tiles than one warp's look-back window (32) reads at a
    time, in one segment and in a table of segments."""
    rng = np.random.default_rng(21)
    n, f, b = 300_000, 28, 64
    lay = pk.PLayout(f)
    P = pk.pack_matrix(rng.integers(0, b, size=(n, f), dtype=np.uint8), lay,
                       label=(rng.random(n) < 0.5).astype(np.float32))
    P[lay.G, :n] = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).view(torch.int32)
    P[lay.H, :n] = torch.from_numpy(rng.random(n).astype(np.float32)).view(torch.int32)
    Pk, Pr = P.to(dev), P.to(dev)
    kw = dict(num_features=f, num_bins=b, bits=8)
    if kernel == "split_stream":
        args = (11, n - 20, 2, 8, 0, 0, 30, 0, 0, 256, 0)
        assert pk.partition_blocks([n - 20], pk.partition_tile(n - 20, 132))[0] > 32
        _, nk, lk, rk = pk.split_stream(Pk, *args, **kw)
        _, nr, lr, rr = pk.split_stream_ref(Pr, *args, **kw)
        hk, hr = torch.stack([lk, rk]), torch.stack([lr, rr])
    else:
        tab = np.asarray([[0, 100_000, 0, 0, 0, 0, 20, 0, 0, 256, 0, 0],
                          [100_000, 7, 1, 8, 0, 0, 40, 0, 0, 256, 0, 0],
                          [100_007, n - 100_007, 6, 24, 3, 3, 33, 0, 0, 256, 0, 0]])
        _, nk, hk = pk.level_stream(Pk, tab, 3, smax=8, **kw)
        _, nr, hr = pk.level_stream_ref(Pr, tab, 3, smax=8, **kw)
    torch.cuda.synchronize()
    assert torch.equal(nk.cpu(), nr.cpu())
    assert torch.equal(Pk, Pr)
    _assert_hist(hk, hr)


@pytest.mark.parametrize("kernel", ["split_stream", "level_stream"])
def test_partition_feature_tiles(dev, kernel):
    """28 features of 256 bins: both children's float64 cells outgrow one
    block's shared memory, so the features are tiled over the grid and the
    blocks of feature tiles past the first stage their rows straight from
    the matrix; many row tiles, 30 % of the rows unselected."""
    rng = np.random.default_rng(31)
    n, f, b = 100_000, 28, 256
    lay = pk.PLayout(f)
    P = pk.pack_matrix(rng.integers(0, b, size=(n, f), dtype=np.uint8), lay)
    P[lay.G, :n] = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).view(torch.int32)
    P[lay.H, :n] = torch.from_numpy(rng.random(n).astype(np.float32)).view(torch.int32)
    P[lay.SEL, :n] = torch.from_numpy((rng.random(n) < 0.7).astype(np.float32)).view(
        torch.int32)
    Pk, Pr = P.to(dev), P.to(dev)
    kw = dict(num_features=f, num_bins=b, bits=8)
    if kernel == "split_stream":
        args = (13, n - 50, 5, 16, 0, 0, 140, 0, 0, 256, 0)
        assert pk.partition_blocks([n - 50], pk.partition_tile(n - 50, 132))[0] > 32
        _, nk, lk, rk = pk.split_stream(Pk, *args, **kw)
        _, nr, lr, rr = pk.split_stream_ref(Pr, *args, **kw)
        hk, hr = torch.stack([lk, rk]), torch.stack([lr, rr])
    else:
        tab = np.asarray([[0, 40_000, 0, 8, 0, 0, 100, 0, 0, 256, 0, 0],
                          [40_000, 5, 2, 0, 0, 0, 7, 1, 0, 256, 0, 0],
                          [40_005, n - 40_005, 6, 24, 3, 3, 200, 0, 0, 256, 0, 0]])
        _, nk, hk = pk.level_stream(Pk, tab, 3, smax=4, **kw)
        _, nr, hr = pk.level_stream_ref(Pr, tab, 3, smax=4, **kw)
    torch.cuda.synchronize()
    assert torch.equal(nk.cpu(), nr.cpu())
    assert torch.equal(Pk, Pr)
    _assert_hist(hk, hr)


@pytest.mark.parametrize("n", [20000, 20001, 20002, 20003])
@pytest.mark.parametrize("delta_offset", [0, 1])
def test_score_add_alignments(dev, n, delta_offset):
    """Every N % 4, so the score row starts 0, 4, 8 or 12 bytes past a
    16-byte boundary, against a delta at the same or another offset; the
    first and last columns past num_rows stay untouched."""
    rng = np.random.default_rng(n)
    lay = pk.PLayout(F)
    P = pk.pack_matrix(rng.integers(0, 32, size=(n, F), dtype=np.uint8), lay)
    P[lay.SCORE, :n] = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).view(
        torch.int32)
    dfull = torch.from_numpy(rng.standard_normal(n + 1).astype(np.float32)).to(dev)
    delta = dfull[delta_offset:delta_offset + n]
    Pk, Pr = P.to(dev), P.to(dev)
    pk.score_add(Pk, lay, delta, num_rows=n - 3)
    pk.score_add_ref(Pr, lay, delta, num_rows=n - 3)
    torch.cuda.synchronize()
    assert (Pk[lay.SCORE].data_ptr() % 16 == 0) == (lay.SCORE * (n + pk.BLK) % 4 == 0)
    assert torch.equal(Pk, Pr)


def _packed_multi(K, b=32, seed=9):
    rng = np.random.default_rng(seed)
    lay = pk.PLayout(F, num_score=K)
    bins = rng.integers(0, b, size=(N, F), dtype=np.uint8)
    label = rng.integers(0, K, N).astype(np.float32)
    weight = (rng.random(N) + 0.5).astype(np.float32)
    P = pk.pack_matrix(bins, lay, label=label, weight=weight).numpy()
    for k in range(K):
        P[lay.SCORE + k, :N] = rng.standard_normal(N).astype(np.float32).view(np.int32)
        P[lay.g_row(k), :N] = rng.standard_normal(N).astype(np.float32).view(np.int32)
        P[lay.h_row(k), :N] = rng.random(N).astype(np.float32).view(np.int32)
    P[lay.SEL, :N] = (rng.random(N) < 0.85).astype(np.float32).view(np.int32)
    return torch.from_numpy(P), lay, label, weight


@pytest.mark.parametrize("name,K,with_sel", [("multiclass", 7, False), ("multiclass", 16, True),
                                             ("multiclassova", 5, False)])
def test_update_multi_and_hists(dev, name, K, with_sel):
    """K=16 at F=11, B=32 fits one feature tile; the tiled path runs in
    chip_smoke.py's wide check."""
    P, lay, label, weight = _packed_multi(K)
    extra = {"is_unbalance": True} if name == "multiclassova" else {}
    obj = _objective(name, label, weight, num_class=K, **extra)
    sel = (torch.rand(N, generator=torch.Generator().manual_seed(3)) < 0.7).float() \
        if with_sel else None
    Pk, Pr = P.to(dev), P.to(dev)
    before = pk.update_multi_and_hists.launches
    _, hk = pk.update_multi_and_hists(Pk, lay, obj, sel=sel, num_rows=N, num_features=F,
                                      num_bins=32)
    assert pk.update_multi_and_hists.launches == before + 1
    _, hr = pk.update_multi_and_hists_ref(Pr, lay, obj, sel=sel, num_rows=N, num_features=F,
                                          num_bins=32)
    torch.cuda.synchronize()
    gh = [r for k in range(K) for r in (lay.g_row(k), lay.h_row(k))]
    for r in gh:
        a, b = Pk[r, :N].view(torch.float32), Pr[r, :N].view(torch.float32)
        assert float((a - b).abs().max() / b.abs().max()) <= 1e-6
    other = [r for r in range(lay.C) if r not in gh]
    assert torch.equal(Pk[other], Pr[other])
    for k in range(K):
        _assert_hist(hk[k], hr[k])


HIST_SEGS = [(0, 0), (3, 700), (703, 1), (1024, 9000), (10024, 9976)]


@pytest.mark.parametrize("bits,nbins", [(8, 32), (4, 16)])
def test_hist_segments_and_dyn(dev, bits, nbins):
    P, lay, *_ = _packed(b=nbins, bits=bits)
    tab = torch.zeros((8, 2), dtype=torch.int64)
    tab[: len(HIST_SEGS)] = torch.tensor(HIST_SEGS)
    kw = dict(num_features=F, num_bins=nbins, bits=bits, smax=8)
    Pk = P.to(dev)
    before = (pk.hist_segments.launches, pk.hist_dyn.launches)
    hk = pk.hist_segments(Pk, tab, len(HIST_SEGS), **kw)
    dk = pk.hist_dyn(Pk, 37, N - 40, F, nbins, bits=bits)
    assert (pk.hist_segments.launches, pk.hist_dyn.launches) == (before[0] + 1, before[1] + 1)
    hr = pk.hist_segments_ref(Pk, tab, len(HIST_SEGS), **kw)
    dr = pk.hist_dyn_ref(Pk, 37, N - 40, F, nbins, bits=bits)
    torch.cuda.synchronize()
    _assert_hist(hk, hr)
    _assert_hist(dk, dr)


def test_level_stream_multiclass_layout(dev):
    """level_stream on a K=7 layout (C=40) reads class 3's g/h rows."""
    P, lay, *_ = _packed_multi(7)
    tab = _tab(8)
    Pk, Pr = P.to(dev), P.to(dev)
    kw = dict(num_features=F, num_bins=32, bits=8, smax=8, rows=lay.class_rows(3))
    _, nk, hk = pk.level_stream(Pk, tab, len(SEGMENTS), **kw)
    _, nr, hr = pk.level_stream_ref(Pr, tab, len(SEGMENTS), **kw)
    torch.cuda.synchronize()
    assert torch.equal(nk.cpu(), nr.cpu())
    assert torch.equal(Pk, Pr)
    _assert_hist(hk, hr)


def test_train_multiclass_cuda_matches_cpu(dev):
    import lightgbm_tpu_torch as lgt

    rng = np.random.default_rng(1)
    X = rng.standard_normal((20000, 6)).astype(np.float32)
    cat = rng.integers(0, 5, 20000)
    X = np.concatenate([X, np.eye(5, dtype=np.float32)[cat]], axis=1)
    y = np.digitize(X[:, 0] + 0.5 * (cat == 2), [-0.4, 0.5]).astype(np.float32)
    params = dict(objective="multiclass", num_class=3, num_leaves=31, learning_rate=0.2,
                  max_bin=31, min_data_in_leaf=20, verbose=-1)
    pk.reset_launch_counts()
    bc = lgt.train(params, lgt.Dataset(X, label=y), 3)
    counts = pk.launch_counts()
    assert counts["update_multi_and_hists"] == 3 and counts["score_add"] > 0
    assert bc.boosting.ptrainer.bmeta is not None
    bp = lgt.train(params, lgt.Dataset(X, label=y), 3, device="cpu")
    np.testing.assert_allclose(bc.predict(X), bp.predict(X), rtol=1e-3, atol=1e-4)


def test_train_cuda_matches_cpu(dev):
    import lightgbm_tpu_torch as lgt

    rng = np.random.default_rng(0)
    X = rng.standard_normal((20000, 8)).astype(np.float32)
    y = (rng.random(20000) < 1 / (1 + np.exp(-(X @ rng.standard_normal(8))))).astype(np.float32)
    params = dict(objective="binary", num_leaves=31, learning_rate=0.2, max_bin=31,
                  min_data_in_leaf=20, verbose=-1)
    pk.reset_launch_counts()
    bc = lgt.train(params, lgt.Dataset(X, label=y), 3)  # device=None: the card
    counts = pk.launch_counts()
    assert counts["update_and_root_hist"] == 3 and counts["level_stream"] > 0
    bp = lgt.train(params, lgt.Dataset(X, label=y), 3, device="cpu")
    np.testing.assert_allclose(bc.predict(X), bp.predict(X), rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("objective", KINDS)
@pytest.mark.parametrize("with_sel", [False, True])
def test_update_channels(dev, objective, with_sel):
    P, lay, label, weight = _packed()
    obj = _objective(objective, label, weight, **KIND_PARAMS.get(objective, {}))
    rng = np.random.default_rng(4)
    delta = torch.from_numpy(rng.standard_normal(N).astype(np.float32))
    sel = torch.from_numpy((rng.random(N) < 0.5).astype(np.float32)) if with_sel else None
    Pk, Pr = P.to(dev), P.to(dev)
    before = pk.update_channels.launches
    pk.update_channels(Pk, lay, obj, delta=delta, sel=sel, num_rows=N)
    assert pk.update_channels.launches == before + 1
    pk.update_channels_ref(Pr, lay, obj, delta=delta, sel=sel, num_rows=N)
    torch.cuda.synchronize()
    assert torch.equal(Pk, Pr)


@pytest.mark.parametrize("objective", KINDS)
def test_update_and_root_hist_sel_mul(dev, objective):
    P, lay, label, weight = _packed()
    obj = _objective(objective, label, weight, **KIND_PARAMS.get(objective, {}))
    rng = np.random.default_rng(5)
    sel = torch.from_numpy((rng.random(N) < 0.4).astype(np.float32))
    mul = torch.from_numpy(np.where(rng.random(N) < 0.3, 7.0, 1.0).astype(np.float32))
    Pk, Pr = P.to(dev), P.to(dev)
    kw = dict(sel=sel, mul=mul, num_rows=N, num_features=F, num_bins=32)
    _, hk = pk.update_and_root_hist(Pk, lay, obj, **kw)
    _, hr = pk.update_and_root_hist_ref(Pr, lay, obj, **kw)
    torch.cuda.synchronize()
    assert torch.equal(Pk, Pr)
    _assert_hist(hk, hr)
    # with_hist=False: the same channel writes, no histogram
    Pn = P.to(dev)
    _, none = pk.update_and_root_hist(Pn, lay, obj, with_hist=False, **kw)
    assert none is None and torch.equal(Pn, Pk)


class _UnknownKind:
    """An objective whose kernel kind no source knows."""

    weights = None

    def kernel_params(self):
        return (99, 1.0, 1.0, 1.0)


def test_unknown_objective_kind_raises(dev):
    """B1 and B10 dispatch on every kind by name: another kind launches
    nothing and the wrapper raises, instead of training L2."""
    P, lay, _, _ = _packed()
    Pk = P.to(dev)
    before = (pk.update_and_root_hist.launches, pk.update_channels.launches)
    with pytest.raises(RuntimeError, match="update_and_root_hist"):
        pk.update_and_root_hist(Pk, lay, _UnknownKind(), num_rows=N, num_features=F,
                                num_bins=32)
    with pytest.raises(RuntimeError, match="update_and_root_hist"):
        pk.update_and_root_hist(Pk, lay, _UnknownKind(), num_rows=N, num_features=F,
                                num_bins=32, with_hist=False)
    with pytest.raises(RuntimeError, match="update_channels"):
        pk.update_channels(Pk, lay, _UnknownKind(), num_rows=N)
    torch.cuda.synchronize()
    assert (pk.update_and_root_hist.launches, pk.update_channels.launches) == before
    assert torch.equal(Pk, P.to(dev))


@pytest.mark.parametrize("objective", KINDS[2:])
def test_train_objectives_cuda_matches_cpu(dev, objective):
    """Each regression objective on the fused path: the card's model
    text equals the CPU's (both take the correctly rounded exp, no FMA,
    histograms rounded once)."""
    import lightgbm_tpu_torch as lgt

    rng = np.random.default_rng(2)
    X = rng.standard_normal((20000, 8)).astype(np.float32)
    y = (X[:, 0] - 0.5 * X[:, 1] + 0.3 * rng.standard_normal(20000)).astype(np.float32)
    if objective == "poisson":
        y = rng.poisson(np.exp(0.5 * X[:, 0])).astype(np.float32)
    params = dict(objective=objective, num_leaves=31, learning_rate=0.2, max_bin=31,
                  min_data_in_leaf=20, verbose=-1, **KIND_PARAMS.get(objective, {}))
    pk.reset_launch_counts()
    bc = lgt.train(params, lgt.Dataset(X, label=y), 3)
    assert pk.launch_counts()["update_and_root_hist"] == 3
    bp = lgt.train(params, lgt.Dataset(X, label=y), 3, device="cpu")

    def text(b):
        return b.model_to_string().split("feature importances:")[0]

    assert text(bc) == text(bp)


# update kernels' edge cases, (rows, features, bins, bits, select, every
# row in one bin): a block stages 256 rows at a time, so 1, 31 and 257
# rows lie below one chunk or just past it; select None keeps the
# matrix's own, "zero" selects no row, "rand" 30 % (with a GOSS
# multiplier for B1)
UPDATE_EDGES = {
    "1-row": (1, 11, 32, 8, None, False),
    "31-rows": (31, 11, 32, 8, None, False),
    "257-rows": (257, 11, 32, 8, None, False),
    "20003-rows": (20_003, 11, 32, 8, "rand", False),
    "zero-select": (20_003, 11, 32, 8, "zero", False),
    "one-bin": (20_003, 11, 32, 8, None, True),
    "4-bit": (20_003, 11, 16, 4, "rand", False),
    "feature-tiles": (5_000, 300, 256, 8, "rand", False),
    # 16-bit words: at K = 16 one feature's cells fit only in tight stripes
    "16-bit-800-bins": (5_000, 3, 800, 16, "rand", False),
}


def _update_case(dev, n, nf, b, bits, sel, one_bin, K, seed=13):
    """(P on the card, layout, objective, kwargs) of one update edge case:
    binary for K = 1, else softmax; weighted rows."""
    rng = np.random.default_rng(seed)
    lay = pk.PLayout(nf, num_score=K, bits=bits)
    dt = np.uint16 if bits == 16 else np.uint8
    bins = np.full((n, nf), 5, dt) if one_bin else rng.integers(0, b, (n, nf), dt)
    label = ((rng.random(n) < 0.4) if K == 1 else rng.integers(0, K, n)).astype(np.float32)
    weight = (rng.random(n) + 0.5).astype(np.float32)
    # pack_matrix takes uint8 bins (the trainer's); 16-bit words by hand
    P = pk.pack_matrix(bins.astype(np.uint8) if bits < 16 else np.zeros((n, nf), np.uint8),
                       lay, label=label, weight=weight).numpy()
    if bits == 16:
        words = np.pad(bins, ((0, 0), (0, 2 * lay.W - nf))).astype(np.uint32)
        P[:lay.W, :n] = (words[:, 0::2] | words[:, 1::2] << 16).view(np.int32).T
    for k in range(K):
        P[lay.SCORE + k, :n] = rng.standard_normal(n).astype(np.float32).view(np.int32)
    P[lay.SEL, :n] = (rng.random(n) < 0.85).astype(np.float32).view(np.int32)
    obj = (_objective("binary", label, weight) if K == 1
           else _objective("multiclass", label, weight, num_class=K))
    kw = dict(num_rows=n, num_features=nf, num_bins=b, bits=bits)
    if sel == "zero":
        kw["sel"] = torch.zeros(n)
    elif sel == "rand":
        kw["sel"] = torch.from_numpy((rng.random(n) < 0.3).astype(np.float32))
        if K == 1:
            kw["mul"] = torch.from_numpy(np.where(rng.random(n) < 0.5, 8.5, 1.0).astype(np.float32))
    if K == 1:
        kw["delta"] = torch.from_numpy((0.1 * rng.standard_normal(n)).astype(np.float32))
    return torch.from_numpy(P).to(dev), lay, obj, kw


@pytest.mark.parametrize("K", [1, 2, 16], ids=["update_and_root_hist", "multi-K2", "multi-K16"])
@pytest.mark.parametrize("case", list(UPDATE_EDGES))
def test_update_edges(dev, case, K):
    """B1 (K = 1) and B2 against their plain versions on the edge cases;
    K = 16 at 11 features and the 300-feature case need feature tiles."""
    P, lay, obj, kw = _update_case(dev, *UPDATE_EDGES[case], K)
    kern, ref = ((pk.update_and_root_hist, pk.update_and_root_hist_ref) if K == 1
                 else (pk.update_multi_and_hists, pk.update_multi_and_hists_ref))
    Pk, Pr = P.clone(), P.clone()
    _, hk = kern(Pk, lay, obj, **kw)
    _, hr = ref(Pr, lay, obj, **kw)
    torch.cuda.synchronize()
    n = kw["num_rows"]
    gh = [r for k in range(K) for r in (lay.g_row(k), lay.h_row(k))]
    for r in gh:
        a, b = Pk[r, :n].view(torch.float32), Pr[r, :n].view(torch.float32)
        assert float((a - b).abs().max() / max(float(b.abs().max()), 1.0)) <= 1e-6
    other = [r for r in range(lay.C) if r not in gh]
    assert torch.equal(Pk[other], Pr[other])
    assert torch.equal(Pk[:, n:], P[:, n:])
    for k in range(K):
        _assert_hist(hk.reshape(K, *hk.shape[-3:])[k], hr.reshape(K, *hr.shape[-3:])[k])
    if K == 1:
        Pn = P.clone()
        _, none = kern(Pn, lay, obj, with_hist=False, **kw)
        assert none is None and torch.equal(Pn, Pk)


@pytest.mark.parametrize("nb", [1024, 4000, 9600])
def test_update_and_root_hist_many_bins(dev, nb):
    """B1 at 16-bit words and many bins: a tile of two features (1024
    bins), of one feature in a narrowed stripe (4000), and of one feature
    in a tight stripe with a short staged chunk (9600)."""
    P, lay, obj, kw = _update_case(dev, 5_000, 2, nb, 16, "rand", False, 1, seed=nb)
    Pk, Pr = P.clone(), P.clone()
    _, hk = pk.update_and_root_hist(Pk, lay, obj, **kw)
    _, hr = pk.update_and_root_hist_ref(Pr, lay, obj, **kw)
    torch.cuda.synchronize()
    n = kw["num_rows"]
    for r in (lay.G, lay.H):
        a, b = Pk[r, :n].view(torch.float32), Pr[r, :n].view(torch.float32)
        assert float((a - b).abs().max() / max(float(b.abs().max()), 1.0)) <= 1e-6
    assert torch.equal(Pk[[r for r in range(lay.C) if r not in (lay.G, lay.H)]],
                       Pr[[r for r in range(lay.C) if r not in (lay.G, lay.H)]])
    _assert_hist(hk, hr)


@pytest.mark.parametrize("params", [
    dict(bagging_fraction=0.8, bagging_freq=2, feature_fraction=0.7),
    dict(boosting="goss"),
], ids=["bagging", "goss"])
def test_train_sampled_cuda_matches_cpu(dev, params):
    import lightgbm_tpu_torch as lgt

    rng = np.random.default_rng(2)
    X = rng.standard_normal((20000, 8)).astype(np.float32)
    y = (rng.random(20000) < 1 / (1 + np.exp(-(X @ rng.standard_normal(8))))).astype(np.float32)
    params = dict(params, objective="binary", num_leaves=31, learning_rate=0.5, max_bin=31,
                  min_data_in_leaf=20, verbose=-1)
    pk.reset_launch_counts()
    bc = lgt.train(params, lgt.Dataset(X, label=y), 4)
    if "boosting" in params:
        assert pk.launch_counts()["update_channels"] == 2  # iterations 2 and 3 sample
    bp = lgt.train(params, lgt.Dataset(X, label=y), 4, device="cpu")
    np.testing.assert_allclose(bc.predict(X), bp.predict(X), rtol=1e-3, atol=1e-4)
    sel = [b.boosting.ptrainer._draws(3)[0] for b in (bc, bp)]
    if sel[0] is not None:
        assert torch.equal(sel[0].cpu(), sel[1])


@pytest.mark.parametrize("quantized", [False, True], ids=["hist_segment", "hist_segment_q"])
@pytest.mark.parametrize("nf,nb", [(11, 32), (7, 300), (600, 64)],
                         ids=["8bit", "16bit", "feature-tiled"])
def test_hist_segment_kernels(dev, quantized, nf, nb):
    """B8 and B9 on the column-packed layout: a sub-range, select zeros,
    16-bit bins, and 600 features x 64 bins, whose float64 cells need
    feature tiles.  B9 is exact; B8 counts exact, sums as the others."""
    rng = np.random.default_rng(nf)
    per, bits = (4, 8) if nb <= 256 else (2, 16)
    bins = torch.from_numpy(rng.integers(0, nb, (N, nf)).astype(np.int32))
    sel = torch.from_numpy((rng.random(N) < 0.6).astype(np.float32))
    if quantized:
        g = torch.from_numpy(rng.integers(-15, 16, N).astype(np.int16))
        h = torch.from_numpy(rng.integers(0, 16, N).astype(np.int16))
        P = th.pack_columns_q(bins, g, h, sel, per, bits)
        kern, ref, count = th.hist_segment_q, th.hist_segment_q_ref, th.hist_segment_q
    else:
        g = torch.from_numpy(rng.standard_normal(N).astype(np.float32))
        h = torch.from_numpy(np.abs(rng.standard_normal(N)).astype(np.float32))
        P = th.pack_columns(bins, g, h, sel, per=per, bits=bits)
        kern, ref, count = th.hist_segment, th.hist_segment_ref, th.hist_segment
    Pk = P.to(dev)
    for lo, hi in ((0, N), (123, N - 77)):
        before = count.launches
        hk = kern(Pk, lo, hi, nf, nb, per, bits)
        assert count.launches == before + 1
        hr = ref(Pk, lo, hi, nf, nb, per, bits)
        torch.cuda.synchronize()
        if quantized:
            assert hk.dtype == torch.int32 and torch.equal(hk, hr)
        else:
            _assert_hist(hk, hr)
    assert float(kern(Pk, 5, 5, nf, nb, per, bits).abs().sum()) == 0


# name: (features, bins of 8-bit words, selected rows, lo, hi, every row in one bin)
HIST_EDGES = {
    "no-row": (11, 63, "none", 0, N, False),
    "one-row": (11, 63, "one", 0, N, False),
    "every-row": (11, 63, "all", 0, N, False),
    "one-bin": (54, 2, "all", 0, N, True),
    "unaligned-ends": (54, 63, "some", 3, N - 5, False),
    "feature-tiled": (600, 64, "some", 1, N - 2, False),
}


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("quantized", [False, True], ids=["hist_segment", "hist_segment_q"])
@pytest.mark.parametrize("case", list(HIST_EDGES))
def test_hist_segment_edges(dev, case, quantized, bits):
    """B8 and B9 on edge cases, at 8- and 16-bit words: the histogram
    (B9 bit-identical), one launch, the selected-row tally, and the
    cached workspace left zeroed for the next call."""
    nf, nb, kind, lo, hi, one_bin = HIST_EDGES[case]
    per = 32 // bits
    nb = nb if bits == 8 else 300 + nb
    rng = np.random.default_rng(sum(map(ord, case)) + bits)
    bins = rng.integers(0, nb, (N, nf))
    if one_bin:
        bins[:] = nb - 1
    bins = torch.from_numpy(bins.astype(np.int32))
    sel = {"none": np.zeros(N), "all": np.ones(N), "some": rng.random(N) < 0.4,
           "one": np.arange(N) == N // 3}[kind]
    s = torch.from_numpy(sel.astype(np.float32))
    if quantized:
        g = torch.from_numpy(rng.integers(-15, 16, N).astype(np.int16))
        h = torch.from_numpy(rng.integers(0, 16, N).astype(np.int16))
        P = th.pack_columns_q(bins, g, h, s, per, bits).to(dev)
        kern, ref = th.hist_segment_q, th.hist_segment_q_ref
    else:
        g = torch.from_numpy(rng.standard_normal(N).astype(np.float32))
        h = torch.from_numpy(np.abs(rng.standard_normal(N)).astype(np.float32))
        P = th.pack_columns(bins, g, h, s, per=per, bits=bits).to(dev)
        kern, ref = th.hist_segment, th.hist_segment_ref
    before, rows = kern.launches, th.selected_rows()[kern.__name__]
    for _ in range(2):  # the second call runs on the workspace the first left
        hk = kern(P, lo, hi, nf, nb, per, bits)
        hr = ref(P, lo, hi, nf, nb, per, bits)
        torch.cuda.synchronize()
        if quantized:
            assert hk.dtype == torch.int32 and torch.equal(hk, hr)
        else:
            _assert_hist(hk, hr)
    assert kern.launches == before + 2
    assert th.selected_rows()[kern.__name__] - rows == 2 * int(sel[lo:hi].sum())
    w = th._WORK[(P.device.index, torch.cuda.current_stream(P.device).cuda_stream)]
    assert int(w.words[:2].abs().sum()) == 0 and int(w.cells.abs().sum()) == 0


def _mask_inputs(rng, n, nf, nb, quantized, per, bits, dev):
    """(packed matrix, kernel, plain version) of random bins below nb and
    40 % of the rows selected."""
    bins = torch.from_numpy(rng.integers(0, nb, (n, nf)).astype(np.int32))
    s = torch.from_numpy((rng.random(n) < 0.4).astype(np.float32))
    if quantized:
        g = torch.from_numpy(rng.integers(-15, 16, n).astype(np.int16))
        h = torch.from_numpy(rng.integers(0, 16, n).astype(np.int16))
        return (th.pack_columns_q(bins, g, h, s, per, bits).to(dev), th.hist_segment_q,
                th.hist_segment_q_ref)
    g = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    h = torch.from_numpy(np.abs(rng.standard_normal(n)).astype(np.float32))
    return (th.pack_columns(bins, g, h, s, per=per, bits=bits).to(dev), th.hist_segment,
            th.hist_segment_ref)


@pytest.mark.parametrize("quantized", [False, True], ids=["hist_segment", "hist_segment_q"])
@pytest.mark.parametrize("nf,nb", [(28, 1024), (5, 4000), (3, 9600)])
def test_hist_segment_many_bins(dev, quantized, nf, nb):
    """B8 and B9 at 16-bit words and many bins: feature tiles of a few
    features (1024 bins), of one feature (4000), and of one feature with
    a short staged chunk (9600 bins of float64 cells)."""
    P, kern, ref = _mask_inputs(np.random.default_rng(nb), N, nf, nb, quantized, 2, 16, dev)
    hk = kern(P, 1, N - 3, nf, nb, 2, 16)
    hr = ref(P, 1, N - 3, nf, nb, 2, 16)
    torch.cuda.synchronize()
    if quantized:
        assert hk.dtype == torch.int32 and torch.equal(hk, hr)
    else:
        _assert_hist(hk, hr)


@pytest.mark.parametrize("quantized", [False, True], ids=["hist_segment", "hist_segment_q"])
def test_hist_segment_two_streams(dev, quantized):
    """Calls on two streams of one card, issued without waiting, each use
    their own stream's workspace and match the plain version."""
    rng = np.random.default_rng(41)
    mats = [_mask_inputs(rng, N, 11, 63, quantized, 4, 8, dev) for _ in range(2)]
    streams = [torch.cuda.Stream(dev) for _ in mats]
    torch.cuda.synchronize()
    outs = [[], []]
    for _ in range(3):
        for k, ((P, kern, _), st) in enumerate(zip(mats, streams)):
            with torch.cuda.stream(st):
                outs[k].append(kern(P, 0, N, 11, 63))
    torch.cuda.synchronize()
    for (P, _, ref), got in zip(mats, outs):
        hr = ref(P, 0, N, 11, 63)
        for hk in got:
            if quantized:
                assert torch.equal(hk, hr)
            else:
                _assert_hist(hk, hr)


@pytest.mark.parametrize("params", [
    dict(objective="binary", use_quantized_grad=True),
    dict(objective="regression", use_quantized_grad=True, max_bin=300),
    dict(objective="multiclass", num_class=3, boosting="goss", learning_rate=0.5),
], ids=["quantized-binary", "quantized-l2-16bit", "multiclass-goss"])
def test_train_mask_grower_cuda_matches_cpu(dev, params):
    import lightgbm_tpu_torch as lgt

    rng = np.random.default_rng(6)
    X = rng.standard_normal((20000, 8)).astype(np.float32)
    z = X @ rng.standard_normal(8)
    y = {"binary": (rng.random(20000) < 1 / (1 + np.exp(-z))).astype(np.float32),
         "regression": z.astype(np.float32),
         "multiclass": np.digitize(z, [-0.5, 0.5]).astype(np.float32)}[params["objective"]]
    params = dict(dict(num_leaves=31, learning_rate=0.2, max_bin=31, min_data_in_leaf=20,
                       verbose=-1), **params)
    pk.reset_launch_counts()
    bc = lgt.train(params, lgt.Dataset(X, label=y), 4)
    assert bc.boosting.ptrainer is None
    name = "hist_segment_q" if params.get("use_quantized_grad") else "hist_segment"
    assert pk.launch_counts()[name] > 0
    bp = lgt.train(params, lgt.Dataset(X, label=y), 4, device="cpu")
    assert bc.model_to_string() == bp.model_to_string()


# ---- the fused grower as one device program (device-resident segments,
# one CUDA graph a tree)
@pytest.mark.parametrize("kernel", ["split_stream", "level_stream"])
def test_partition_device_table_equals_host(dev, kernel):
    """B3/B4 given their segments as device tensors (the plan, the tiles
    and the grid's bound on the card) partition as their host-int launches
    do: equal left counts, matrices and histograms.  Rows at or past
    n_active are ignored whatever they hold, a count past the matrix is
    clamped to it, and a count of 0 leaves the matrix as it is."""
    P, lay, *_ = _packed(seed=5)
    Ph, Pd = P.to(dev), P.to(dev)
    kw = dict(num_features=F, num_bins=32)
    if kernel == "split_stream":
        for seg in [(333, 15001, 1, 8, 2, 2, 12, 0, 0, 256, 0), (0, N, 2, 0, 0, 0, 16, 0, 0, 256, 0),
                    (19990, 10, 0, 24, 0, 0, 5, 1, 0, 256, 0), (77, 0, 1, 8, 0, 0, 3, 0, 0, 256, 0)]:
            _, nh, lh, rh = pk.split_stream(Ph, *seg, **kw)
            dseg = [torch.tensor(v, device=dev) for v in seg]
            before = pk.split_stream.launches
            _, nd, ld, rd = pk.split_stream(Pd, *dseg, **kw)
            assert pk.split_stream.launches == before + 1
            torch.cuda.synchronize()
            assert int(nh) == int(nd) and torch.equal(Ph, Pd)
            _assert_hist(torch.stack([ld, rd]), torch.stack([lh, rh]))
        # a count past the matrix's rows: clamped to [start, N)
        _, nh, lh, rh = pk.split_stream(Ph, 19000, N - 19000, 1, 0, 0, 0, 9, 0, **kw)
        _, nd, ld, rd = pk.split_stream(Pd, torch.tensor(19000, device=dev),
                                        torch.tensor(5 * N, device=dev), 1, 0, 0, 0, 9, 0, **kw)
    else:
        tab = np.asarray([[0, 7000, 0, 0, 0, 0, 10, 0, 0, 256, 0, 0],
                          [7000, 3, 1, 8, 0, 0, 20, 0, 0, 256, 0, 0],
                          [7003, 0, 2, 16, 0, 0, 20, 0, 0, 256, 0, 0],
                          [7003, N - 7003, 2, 0, 3, 3, 13, 1, 0, 256, 0, 0]])
        _, nh, hh = pk.level_stream(Ph, tab, 4, smax=6, **kw)
        junk = np.concatenate([tab, [[5, 900, 1, 0, 0, 0, 1, 0, 0, 256, 0, 0]] * 2])
        before = pk.level_stream.launches
        _, nd, hd = pk.level_stream(Pd, torch.from_numpy(junk).to(dev),
                                    torch.tensor(4, device=dev), smax=6, **kw)
        assert pk.level_stream.launches == before + 1
        ld, lh = hd, hh
    torch.cuda.synchronize()
    assert torch.equal(nh.cpu(), nd.cpu()) and torch.equal(Ph, Pd)
    _assert_hist(ld, lh)


def _fused_setup(dev, objective="binary", K=1, leaves=63, n=40000):
    """A trainer on the card and a fresh (p, root histograms) of its
    first iteration."""
    import lightgbm_tpu_torch as lgt

    rng = np.random.default_rng(12)
    X = rng.standard_normal((n, 10)).astype(np.float32)
    z = X @ rng.standard_normal(10)
    y = (np.digitize(z, [-0.5, 0.5]) if K > 1 else z > 0).astype(np.float32)
    params = dict(objective=objective, num_leaves=leaves, max_bin=63, min_data_in_leaf=5,
                  verbose=-1, **({"num_class": K} if K > 1 else {}))
    bst = lgt.train(params, lgt.Dataset(X, label=y), 1)
    pt = bst.boosting.ptrainer
    lay, prm = pt.layout, pt.params
    kw = dict(num_rows=pt.num_rows, num_features=prm.cols, num_bins=prm.bins_hist,
              bits=prm.bits)
    if K > 1:
        p, roots = pk.update_multi_and_hists(pt.p.clone(), lay, pt.objective, **kw)
    else:
        p, root = pk.update_and_root_hist(pt.p.clone(), lay, pt.objective, **kw)
        roots = root[None]
    return pt, p, roots


@pytest.mark.parametrize("K", [1, 3], ids=["binary", "softmax-3"])
def test_tree_graph_replay_equals_eager(dev, K):
    """A tree replayed as a CUDA graph gives the eager grower's records,
    tables and partitioned matrix byte for byte, for every class."""
    from lightgbm_tpu_torch.ops.pgrow import TreeGraphs, grow_tree_partitioned

    pt, p0, roots = _fused_setup(dev, "multiclass" if K > 1 else "binary", K)
    graphs = TreeGraphs(pt.meta, pt.bmeta, pt.params, dev)
    pg = p0.clone()
    for rounds in range(2):  # the first call captures, the second replays
        for k in range(K):
            rows = pt.layout.class_rows(k) if K > 1 else None
            pg.copy_(p0)
            got = graphs.grow(pg, pt.feature_mask, pt.hyper, roots[k], rows)
            got = [x.clone() for x in got]
            pe = p0.clone()
            want, pe = grow_tree_partitioned(pe, pt.feature_mask, pt.meta, pt.hyper, pt.params,
                                             roots[k], rows=rows, bmeta=pt.bmeta)
            torch.cuda.synchronize()
            assert int(got[0]) == int(want.num_splits) > 0
            for a, b in zip(got[1:], want[1:]):
                assert torch.equal(a, b)
            assert torch.equal(pg, pe)
    assert len(graphs.graphs) == K


def _is_sync(w) -> bool:
    """A warning of sync debug mode "warn" for one synchronizing call (its
    first use in a process also warns that the mode is a prototype)."""
    text = str(w.message)
    return "synchroniz" in text and "debug mode" not in text


def test_tree_graph_needs_no_host_sync(dev):
    """After its capture, a fused tree replays under sync debug mode
    "error": nothing in it waits for the card; a whole chunk reads the
    card once, at its end."""
    import warnings

    from lightgbm_tpu_torch.ops.pgrow import TreeGraphs

    pt, p0, roots = _fused_setup(dev)
    graphs = TreeGraphs(pt.meta, pt.bmeta, pt.params, dev)
    graphs.grow(p0, pt.feature_mask, pt.hyper, roots[0])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tree = graphs.grow(p0, pt.feature_mask, pt.hyper, roots[0])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert int(tree.num_splits) > 0
    pt.train_chunk(2, 0.1, 1)  # captures nothing new
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            trees, _, n_done = pt.train_chunk(3, 0.1, 3)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [w for w in caught if _is_sync(w)]
    assert n_done == 3 and len(trees) == 3 and len(syncs) == 1


def _binary_data(n=20000, seed=5):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, 8))
    y = (rng.random(n) < 1 / (1 + np.exp(-(X @ rng.standard_normal(8))))).astype(np.float32)
    return X, y


API_PARAMS = dict(objective="binary", num_leaves=31, learning_rate=0.2, max_bin=31,
                  min_data_in_leaf=20, verbose=-1)


def test_init_scores_and_rollback_through_score_add(dev):
    """Continued training's initial scores and rollback_one_iter's
    subtract go through score_add on the card: each leaves the score band
    bit-equal to the plain version applied to a copy of the band."""
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.engine import _apply_init_model

    X, y = _binary_data()
    init = lgt.train(API_PARAMS, lgt.Dataset(X, label=y), 3, device="cpu")
    ds = lgt.Dataset(X, label=y)
    bst = lgt.Booster(params=API_PARAMS, train_set=ds)
    pt, n = bst.boosting.ptrainer, len(y)
    ref = pt.p.clone()
    scores = init.boosting.predict_raw_scores(X).astype(np.float32)
    before = pk.score_add.launches
    _apply_init_model(bst, init, ds)
    assert pk.score_add.launches == before + 1
    pk.score_add_ref(ref, pt.layout, torch.from_numpy(scores[0]).to(dev), num_rows=n)
    torch.cuda.synchronize()
    assert torch.equal(pt.p, ref)
    bst.update()
    bst.update()
    ref, delta = pt.p.clone(), pt._last_delta.clone()
    before = pk.score_add.launches
    bst.rollback_one_iter()
    assert pk.score_add.launches == before + 1 and not pt.score_dirty
    pk.score_add_ref(ref, pt.layout, -delta, num_rows=n)
    torch.cuda.synchronize()
    assert torch.equal(pt.p, ref)
    assert bst.current_iteration() == 4


@pytest.mark.parametrize("K", [1, 3])
def test_rollback_cuda_matches_cpu(dev, K):
    """Rollback then one more iteration, on the card and on the CPU: the
    same model text (K = 3 rewrites the band from the scores)."""
    import lightgbm_tpu_torch as lgt

    X, y = _binary_data()
    params = API_PARAMS
    if K == 3:
        y = np.digitize(X[:, 0] + 0.3 * X[:, 1], [-0.4, 0.5]).astype(np.float32)
        params = dict(API_PARAMS, objective="multiclass", num_class=3)
    texts = []
    for d in (dev, "cpu"):
        b = lgt.train(params, lgt.Dataset(X, label=y), 3, device=d)
        b.rollback_one_iter()
        b.update()
        texts.append(b.model_to_string())
    assert texts[0] == texts[1]


def test_pred_leaf_cuda_matches_cpu(dev):
    import lightgbm_tpu_torch as lgt

    X, y = _binary_data()
    text = lgt.train(API_PARAMS, lgt.Dataset(X, label=y), 4, device="cpu").model_to_string()
    Xn = X.copy()
    Xn[::7, 3] = np.nan
    leaves = [lgt.Booster(model_str=text, device=d).predict(Xn, pred_leaf=True)
              for d in (dev, "cpu")]
    np.testing.assert_array_equal(leaves[0], leaves[1])
    es = dict(pred_early_stop=True, pred_early_stop_freq=1, pred_early_stop_margin=1.0)
    raw = [lgt.Booster(model_str=text, device=d).predict(Xn, raw_score=True, **es)
           for d in (dev, "cpu")]
    np.testing.assert_array_equal(raw[0], raw[1])


# ---- the tree strategies on the mask grower: monotone constraints and
# linear leaves
def _search_inputs(dev, seed, F=6, B=32):
    """Two children's random (F, B, 3) histograms and (2, 3) sums."""
    rng = np.random.default_rng(seed)
    cnt = rng.integers(0, 50, (2, 1, B)).astype(np.float32).repeat(F, axis=1)
    g = (rng.standard_normal((2, F, B)) * cnt).astype(np.float32)
    h = (rng.random((2, F, B)) * cnt).astype(np.float32)
    hist = torch.from_numpy(np.stack([g, h, cnt], axis=3)).to(dev)
    return hist, hist[:, 0].sum(dim=1)


def test_monotone_child_search_graph_equals_eager(dev):
    """The captured monotone child search against its eager run: captured
    at the first call, then replayed with new histograms and new bounds."""
    from lightgbm_tpu_torch.ops import grow
    from lightgbm_tpu_torch.ops.split import FeatureMeta, SplitHyper

    F, B = 6, 32
    meta = FeatureMeta(torch.full((F,), B, dtype=torch.int64, device=dev),
                       torch.tensor([0, 3, 31, 7, 0, 12], dtype=torch.int64, device=dev),
                       torch.zeros(F, dtype=torch.bool, device=dev))
    hyper = SplitHyper(*(np.float32(v) for v in (0.0, 1.0, 5.0, 1e-3, 0.0)))
    fmask = torch.ones(F, dtype=torch.float32, device=dev)
    params = grow.GrowParams(num_leaves=15, num_bins=B, has_categorical=False,
                             monotone=(1, -1, 0, 1, 0, -1))
    searches = {}
    for seed, bounds in ((0, [[-np.inf, -0.5], [np.inf, 0.7]]), (1, [[-0.2, -1.0], [0.4, 0.1]]),
                         (2, [[-np.inf, -np.inf], [np.inf, np.inf]])):
        hist, sums = _search_inputs(dev, seed, F, B)
        b = torch.tensor(bounds, dtype=torch.float32, device=dev)
        search = grow._child_search(searches, dev, F, B, meta, hyper, params, False)
        got = search(hist[0], hist[1], sums, fmask, None, b).clone()
        want = grow._best_rows(hist, sums, meta, hyper, fmask, params, False, None,
                               grow.monotone_tensor(params, dev), b)
        assert torch.equal(got, want), seed
    assert len(searches) == 1  # one graph, replayed with each seed's inputs


def test_constrained_and_plain_searches_apart(dev):
    """One ``searches`` dict, two trees: the constrained grower and the
    unconstrained one capture separate graphs, and each tree equals its
    CPU run."""
    from lightgbm_tpu_torch.ops import grow
    from lightgbm_tpu_torch.ops.histogram import pack_bin_words
    from lightgbm_tpu_torch.ops.split import FeatureMeta, SplitHyper

    rng = np.random.default_rng(3)
    n, F, B = 20000, 6, 32
    bins = rng.integers(0, B, (n, F)).astype(np.uint8)
    g = (bins[:, 0] / B - bins[:, 1] / B + 0.3 * rng.standard_normal(n)).astype(np.float32)
    h = np.ones(n, np.float32)
    hyper = SplitHyper(*(np.float32(v) for v in (0.0, 1.0, 20.0, 1e-3, 0.0)))
    devices = (dev, torch.device("cpu"))
    metas = {d.type: FeatureMeta(torch.full((F,), B, dtype=torch.int64, device=d),
                                 torch.zeros(F, dtype=torch.int64, device=d),
                                 torch.zeros(F, dtype=torch.bool, device=d)) for d in devices}
    searches, trees = {}, {}
    for mono in ((), (1, -1, 0, 0, 0, 0)):
        params = grow.GrowParams(num_leaves=15, num_bins=B, has_categorical=False, monotone=mono)
        for d in devices:
            words = pack_bin_words(torch.from_numpy(bins).to(d), 4, 8)
            trees[mono, d.type] = grow.grow_tree(
                words, torch.from_numpy(g).to(d), torch.from_numpy(h).to(d),
                torch.ones(n, device=d), torch.ones(F, device=d), metas[d.type], hyper, params,
                searches=searches)
        a, b = trees[mono, "cuda"], trees[mono, "cpu"]
        assert a.num_splits == b.num_splits > 3
        for name in ("rec_leaf", "rec_feat", "rec_thr", "rec_lval", "rec_rval"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    graphs = list(searches.values())
    assert len(graphs) == 2 and graphs[0] is not graphs[1]
    assert sorted(v.mono is None for v in graphs) == [False, True]


def test_linear_fit_cuda_matches_cpu(dev):
    """The float64 normal equations on the card against the CPU (each
    rounded once to float32: equal within 1e-6 relative), and a linear
    model trained on each: the same splits and linear leaves,
    coefficients within 1e-4 relative, predictions within 1e-4."""
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.ops.predict import bins_column
    from lightgbm_tpu_torch.tree import linear as tl

    rng = np.random.default_rng(8)
    n, F, B, L = 50000, 6, 32, 9
    bins = rng.integers(0, B, (n, F)).astype(np.uint8)
    g = rng.standard_normal(n).astype(np.float32)
    h = (rng.random(n) + 0.1).astype(np.float32)
    sel = (rng.random(n) < 0.8).astype(np.float32)
    leaf = rng.integers(0, L, n).astype(np.int32)
    paths = [tuple(rng.choice(F, rng.integers(0, 4), replace=False)) for _ in range(L)]
    fi, fv = tl.pack_path_features(paths, L, 3)
    lut = np.sort(rng.standard_normal((F, B)).astype(np.float32), axis=1)
    out = []
    for d in (dev, torch.device("cpu")):
        t = [torch.from_numpy(x).to(d) for x in (bins, g, h, sel, leaf, lut)]
        out.append(tl.linear_fit_stats(bins_column(t[0]), t[1], t[2], t[3], t[4], fi, fv, t[5],
                                       L))
    for x, y in zip(out[0], out[1]):
        x, y = x.cpu().numpy(), y.numpy()
        assert np.abs(x - y).max() <= 1e-6 * np.abs(y).max()

    X = rng.standard_normal((20000, 5))
    yv = X[:, 0] - 0.5 * X[:, 1] + 0.1 * rng.standard_normal(20000)
    params = dict(objective="regression", num_leaves=15, linear_tree=True, linear_lambda=0.01,
                  verbose=-1)
    pk.reset_launch_counts()
    bc = lgt.train(params, lgt.Dataset(X, label=yv), 3)
    assert pk.launch_counts()["hist_segment"] > 0
    bp = lgt.train(params, lgt.Dataset(X, label=yv), 3, device="cpu")
    for a, b in zip(bc.boosting.models, bp.boosting.models):
        np.testing.assert_array_equal(a.split_feature[:a.num_leaves - 1],
                                      b.split_feature[:b.num_leaves - 1])
        np.testing.assert_array_equal(a.leaf_is_linear, b.leaf_is_linear)
        for ca, cb in zip(a.leaf_coeff, b.leaf_coeff):
            np.testing.assert_allclose(ca, cb, rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(bc.predict(X), bp.predict(X), rtol=1e-4, atol=1e-4)


def _cli_files(d):
    """A TSV training file, a CSV validation file with a header and a conf."""
    rng = np.random.default_rng(12)
    X = rng.standard_normal((30000, 6)).round(5)
    y = (X[:, 0] - X[:, 1] + 0.3 * rng.standard_normal(30000) > 0).astype(int)
    np.savetxt(d / "t.tsv", np.column_stack([y[:25000], X[:25000]]), delimiter="\t", fmt="%g")
    np.savetxt(d / "v.csv", np.column_stack([y[25000:], X[25000:]]), delimiter=",", fmt="%g",
               header="y,a,b,c,d,e,f", comments="")
    (d / "train.conf").write_text("task=train\nobjective=binary\nmetric=auc\ndata=t.tsv\n"
                                  "num_trees=4\nnum_leaves=31\nmax_bin=63\nsnapshot_freq=-1\n"
                                  "verbose=-1\n")


def test_cli_train_and_predict_on_card_match_cpu(dev, tmp_path, monkeypatch):
    """The CLI trains on the card when no device is named (the fused
    kernels launch) with the trees of device=cpu, and predicts a file
    with a header."""
    from lightgbm_tpu_torch import cli

    _cli_files(tmp_path)
    monkeypatch.chdir(tmp_path)
    pk.reset_launch_counts()
    assert cli.main(["config=train.conf", "output_model=card.txt"]) == 0
    counts = pk.launch_counts()
    for k in ("update_and_root_hist", "level_stream", "score_add"):
        assert counts[k] > 0, k
    assert cli.main(["config=train.conf", "output_model=cpu.txt", "device=cpu"]) == 0
    card, cpu = (open(f).read() for f in ("card.txt", "cpu.txt"))
    assert card[card.index("Tree=0"):card.index("feature importances")] == \
        cpu[cpu.index("Tree=0"):cpu.index("feature importances")]
    for device, out in ((None, "p_card.txt"), ("cpu", "p_cpu.txt")):
        argv = ["task=predict", "data=v.csv", "header=true", "input_model=card.txt",
                f"output_result={out}"] + ([f"device={device}"] if device else [])
        assert cli.main(argv) == 0
    assert open("p_card.txt").read() == open("p_cpu.txt").read()
    assert len(open("p_card.txt").read().splitlines()) == 5000


def test_cli_cache_and_valid_file_on_card(dev, tmp_path, monkeypatch):
    """task=train with is_save_binary_file on the card (one chunk), then
    from the cache it wrote with a validation file (a chunk an
    iteration): the same trees."""
    from lightgbm_tpu_torch import cli

    _cli_files(tmp_path)
    monkeypatch.chdir(tmp_path)
    assert cli.main(["config=train.conf", "is_save_binary_file=true", "output_model=a.txt"]) == 0
    assert cli.main(["config=train.conf", "data=t.tsv.bin", "valid_data=v.csv", "header=true",
                     "output_model=b.txt"]) == 0
    a, b = (open(f).read() for f in ("a.txt", "b.txt"))
    assert a[a.index("Tree=0"):a.index("feature importances")] == \
        b[b.index("Tree=0"):b.index("feature importances")]


# ---- serving: one CUDA graph per row bucket (serve/compilecache.py)
def _served_models():
    """A binary model with NaN and zero values, a K=3 softmax one and a
    linear-leaf one, trained on the CPU; their artifacts."""
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.serve import PredictorArtifact

    X, y = _binary_data()
    X = X.copy()
    X[::9, 1] = np.nan
    X[::11, 2] = 0.0
    base = dict(num_leaves=31, learning_rate=0.2, verbose=-1)
    runs = (dict(base, objective="binary"),
            dict(base, objective="multiclass", num_class=3),
            dict(base, objective="regression", linear_tree=True))
    labels = (y, (X[:, 0] > 0.3).astype(np.float64) + (X[:, 1] > 0), X[:, 0] - X[:, 2])
    arts = [PredictorArtifact.from_booster(lgt.train(p, lgt.Dataset(X, label=lab), 4,
                                                     device="cpu"))
            for p, lab in zip(runs, labels)]
    return X, arts


def _eager_walk(p, rows, raw_score=True):
    """(K, n) float64 outputs of a PackedPredictor's walk called eagerly on
    its device (no graph) over the pieces the predictor walks, each padded
    to its bucket: the exact and linear walks through ops/predict, the
    quantized through ops/qpredict."""
    from lightgbm_tpu_torch.model.ensemble import split_hi_lo
    from lightgbm_tpu_torch.ops.predict import _leaves_raw, class_sums, raw_leaf_outputs
    from lightgbm_tpu_torch.ops.qpredict import qpredict_raw, quantize_data

    r = p.raw
    k = r.num_class_arrays
    rows = np.asarray(rows, np.float64)[:, :r.num_features]
    step = r._piece_rows()
    outs = []
    for lo in range(0, len(rows), step):
        piece = rows[lo:lo + step]
        n = len(piece)
        piece = np.pad(piece, ((0, r.bucket(n) - n), (0, 0)))
        if p.quantized:
            a = r._arrays
            codes = quantize_data(piece, a.qbin_edges, a.qbin_offsets, a.feature_flags)
            raw = qpredict_raw(torch.from_numpy(codes).to(r.device), r.trees, r.levels, k)
        else:
            planes = [torch.from_numpy(x).to(r.device) for x in split_hi_lo(piece)]
            leaves = _leaves_raw(planes, r.trees, levels=r.levels)
            raw = class_sums(raw_leaf_outputs(leaves, planes[0], r.trees), k)
        if not raw_score and r.objective is not None:
            raw = r.objective.convert_output(raw)
        outs.append(raw[:, :n].double().cpu().numpy())
    return np.concatenate(outs, axis=1)


@pytest.mark.parametrize("flavor", ["exact", "quantized", "multiclass", "linear"])
def test_serving_graphs_equal_eager_at_every_bucket(dev, flavor):
    """Each bucket's replay equals the eager walk on the card bit for bit
    (raw and converted), and a warmed predictor captures nothing more
    over mixed sizes, pieces past the largest bucket included."""
    from lightgbm_tpu_torch.obs.trace import total_compiles
    from lightgbm_tpu_torch.serve import PackedPredictor
    from lightgbm_tpu_torch.serve.compilecache import bucket_ladder

    X, arts = _served_models()
    art = {"exact": arts[0], "quantized": arts[0].quantize(), "multiclass": arts[1],
           "linear": arts[2]}[flavor]
    graphs = PackedPredictor(art, device=dev)
    stats = graphs.warmup(512)
    assert stats["compiles"] == len(bucket_ladder(512)) == len(graphs.raw._graphs)
    c0 = total_compiles()
    for n in [1, 7, 8, 9, 100, 255, 256, 257, 512, 513, 2000]:
        for raw_score in (True, False):
            a = graphs.raw.predict_scores(X[:n], raw_score=raw_score)
            np.testing.assert_array_equal(a, _eager_walk(graphs, X[:n], raw_score))
    assert total_compiles() == c0
    cpu = PackedPredictor(art, device="cpu").predict(X[:600])
    np.testing.assert_allclose(graphs.predict(X[:600]), cpu, rtol=1e-6, atol=1e-7)


def test_serving_same_shape_swap_captures_nothing(dev):
    """A same-shape retrain swapped into a warmed slot: in place, 0
    captures, the new model's predictions from the old buffers."""
    from lightgbm_tpu_torch.serve import PackedPredictor, PredictorArtifact, SwappablePredictor

    X, arts = _served_models()
    art = arts[0]
    fields = {f: np.array(getattr(art.arrays, f)) for f in type(art.arrays).FIELDS}
    fields["leaf_value"] = (fields["leaf_value"] * np.float32(1.1)).astype(np.float32)
    new = PredictorArtifact(type(art.arrays)(**fields), art.meta)
    slot = SwappablePredictor(PackedPredictor(art, device=dev), version=1)
    slot.warmup(256)
    live = slot.predictor
    st = slot.swap_to(new, 2, warmup_max_rows=256)
    assert st["in_place"] and st["new_compiles"] == 0 and slot.predictor is live
    out, ver = slot.predict(X[:300], raw_score=True)
    assert ver == 2
    np.testing.assert_array_equal(out, _eager_walk(PackedPredictor(new, device=dev), X[:300])[0])


def test_serving_swap_to_another_shape_under_load(dev):
    """A swap to another shape class (binary -> K=3) while a thread keeps
    replaying the live graphs: the new ladder is captured on its own
    stream beside them (new_compiles = the bucket count), no request
    fails, and each answer is its own version's."""
    import threading
    import time

    from lightgbm_tpu_torch.serve import PackedPredictor, SwappablePredictor
    from lightgbm_tpu_torch.serve.compilecache import bucket_ladder

    X, arts = _served_models()
    want = {1: PackedPredictor(arts[0], device="cpu").predict(X[:700], raw_score=True),
            2: PackedPredictor(arts[1], device="cpu").predict(X[:700], raw_score=True)}
    slot = SwappablePredictor(PackedPredictor(arts[0], device=dev), version=1)
    slot.warmup(1024)
    answers, errors, stop = [], [], threading.Event()

    def client():
        rng = np.random.default_rng(3)
        while not stop.is_set():
            n = int(rng.integers(1, 700))
            try:
                answers.append((n,) + slot.predict(X[:n], raw_score=True))
            except Exception as e:  # noqa: BLE001 - every failure is reported
                errors.append(repr(e))

    th = threading.Thread(target=client)
    th.start()
    try:
        st = slot.swap_to(arts[1], 2, warmup_max_rows=1024)
        deadline = time.monotonic() + 30
        while not any(v == 2 for _, _, v in answers[-5:]) and time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        stop.set()
        th.join()
    assert not errors, errors[:3]
    assert not st["in_place"] and st["new_compiles"] == len(bucket_ladder(1024))
    versions = {v for _, _, v in answers}
    assert versions == {1, 2}
    for n, out, v in answers:
        np.testing.assert_allclose(out, want[v][:n], rtol=1e-6, atol=1e-6)


# ---- out-of-core training: B8/B9's carry mode, the pinned prefetch ring,
# a streamed tree against the resident one
CARRY_GRIDS = {"one": (0, N), "uneven": (0, 1, 4096, 4097, 9000, 19999, N),
               "unaligned": (123, 5000, 5001, 12345, N - 77)}


@pytest.mark.parametrize("quantized", [False, True], ids=["hist_segment", "hist_segment_q"])
@pytest.mark.parametrize("grid", list(CARRY_GRIDS))
@pytest.mark.parametrize("nf,nb", [(11, 32), (7, 300)], ids=["8bit", "16bit"])
def test_hist_carry_mode(dev, quantized, grid, nf, nb):
    """The carry mode folds column ranges into one float64 (int32) carry:
    finalized it equals one resident launch over the whole range (B9
    exactly, B8 after its single rounding); against the plain version's
    carry B9 is exact and B8's rounded histogram is held as B8's is (its
    float64 sums in another order may differ in their last bits)."""
    rng = np.random.default_rng(nf + nb)
    per, bits = (4, 8) if nb <= 256 else (2, 16)
    bins = torch.from_numpy(rng.integers(0, nb, (N, nf)).astype(np.int32))
    sel = torch.from_numpy((rng.random(N) < 0.6).astype(np.float32))
    if quantized:
        g = torch.from_numpy(rng.integers(-15, 16, N).astype(np.int16))
        h = torch.from_numpy(rng.integers(0, 16, N).astype(np.int16))
        P = th.pack_columns_q(bins, g, h, sel, per, bits)
        kern, count = th.hist_segment_q, th.hist_segment_q
    else:
        g = torch.from_numpy(rng.standard_normal(N).astype(np.float32))
        h = torch.from_numpy(np.abs(rng.standard_normal(N)).astype(np.float32))
        P = th.pack_columns(bins, g, h, sel, per=per, bits=bits)
        kern, count = th.hist_segment, th.hist_segment
    Pk = P.to(dev)
    edges = CARRY_GRIDS[grid]
    carry = th.new_carry(nf, nb, quantized, dev)
    ref = th.new_carry(nf, nb, quantized, "cpu")
    before = count.launches
    for lo, hi in zip(edges[:-1], edges[1:]):
        th.accumulate_histogram(carry, Pk, lo, hi, nf, nb, per, bits)
        th.accumulate_histogram(ref, P, lo, hi, nf, nb, per, bits)
    assert count.launches == before + len(edges) - 1
    whole = kern(Pk, edges[0], edges[-1], nf, nb, per, bits)
    folded = th.finalize_histogram(carry)
    torch.cuda.synchronize()
    assert folded.dtype == whole.dtype and torch.equal(folded, whole)
    if quantized:
        assert torch.equal(carry.cpu(), ref) and torch.equal(folded.cpu(), ref)
    else:
        _assert_hist(folded, th.finalize_histogram(ref))


@pytest.mark.parametrize("depth", [1, 2, 3])
@pytest.mark.parametrize("dtype,cols", [(np.uint8, 7), (np.uint8, 28), (np.uint16, 5)])
def test_prefetch_ring_on_card(dev, depth, dtype, cols):
    """The pinned ring on its copy stream gives the bytes a synchronous
    copy gives, chunk for chunk over two passes, with at most ``depth``
    chunks in flight; the copies are timed."""
    from lightgbm_tpu_torch.data.prefetch import (ArrayChunkSource, ChunkPlan, ChunkPrefetcher,
                                                   chunk_layout)

    rng = np.random.default_rng(cols)
    binned = rng.integers(0, 255 if dtype == np.uint8 else 700, (50_000, cols)).astype(dtype)
    plan = ChunkPlan(len(binned), 12_288)
    pf = ChunkPrefetcher(ArrayChunkSource(binned), plan, depth, device=dev)
    tdtype, padded = chunk_layout(dtype, cols)
    for _ in range(2):
        seen = []
        for i, start, stop, chunk in pf.stream():
            want = np.zeros((stop - start, padded), binned.dtype)
            want[:, :cols] = binned[start:stop]
            want = torch.from_numpy(want.view(np.int16) if dtype == np.uint16 else want)
            assert chunk.dtype == tdtype and torch.equal(chunk.cpu(), want)
            seen.append((i, start, stop))
        assert seen == [(i, s, e) for i, (s, e) in enumerate(plan.bounds)]
    assert pf.stats.peak_inflight <= depth and pf.stats.passes == 2
    assert pf.stats.copy_s > 0


@pytest.mark.parametrize("params", [dict(objective="binary"),
                                    dict(objective="regression", use_quantized_grad=True),
                                    dict(objective="regression", linear_tree=True)],
                         ids=["float", "quantized", "linear"])
def test_ooc_tree_equals_resident_on_card(dev, params, monkeypatch):
    """Out-of-core training on the card (three chunks, B8/B9 in carry
    mode) gives the resident mask grower's model text."""
    import lightgbm_tpu_torch as lgt

    monkeypatch.setenv("LIGHTGBM_TPU_PGROW", "0")
    rng = np.random.default_rng(8)
    X = rng.standard_normal((10_000, 9)).astype(np.float32)
    z = X @ rng.standard_normal(9)
    y = (rng.random(10_000) < 1 / (1 + np.exp(-z))).astype(np.float32)
    params = dict(dict(num_leaves=31, max_bin=63, min_data_in_leaf=20, verbose=-1), **params)
    want = lgt.train(params, lgt.Dataset(X, label=y), 3).model_to_string()
    pk.reset_launch_counts()
    bst = lgt.train(dict(params, out_of_core="true", ooc_chunk_rows=4096),
                    lgt.Dataset(X, label=y), 3)
    assert bst.boosting.ooc is not None and bst.boosting.ooc.plan.num_chunks == 3
    name = "hist_segment_q" if params.get("use_quantized_grad") else "hist_segment"
    assert pk.launch_counts()[name] > 0
    assert bst.model_to_string() == want


def _host_group(mode, shards, params, meta, hyper, dev, **kw):
    """One tree grown by LocalComm rank threads on ``dev``: [(GrowResult,
    ledger)] by rank; a failing rank aborts the group."""
    import threading

    from lightgbm_tpu_torch.parallel import HostParallelLearner, LocalGroup

    group = LocalGroup(len(shards))
    out, errs = [None] * len(shards), []
    fmask = torch.ones(meta.num_bins.shape[0], device=dev)

    def rank(r, comm):
        try:
            b, g, h = (t.to(dev) for t in shards[r])
            out[r] = (HostParallelLearner(mode, comm, params, **kw).grow(
                b, g, h, torch.ones(g.shape[0], device=dev), fmask, meta, hyper),
                dict(comm.ledger))
        except BaseException as e:  # noqa: BLE001 - raised below
            errs.append(e)
            group.barrier.abort()

    threads = [threading.Thread(target=rank, args=(r, c), daemon=True)
               for r, c in enumerate(group.comms())]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
        assert not t.is_alive()
    if errs:
        raise errs[0]
    return out


def _tree(gr, skip=("leaf_id",)):
    return {k: (v.cpu().numpy() if torch.is_tensor(v) else np.asarray(v))
            for k, v in gr._asdict().items() if k not in skip}


def _assert_trees_equal(a, b, skip=("leaf_id",)):
    ta, tb = _tree(a, skip), _tree(b, skip)
    for k in ta:
        np.testing.assert_array_equal(ta[k], tb[k], err_msg=k)


@pytest.fixture
def host_shards():
    """4,000 x 13 rows at 32 bins, a few signal columns, and the split
    hyperparameters and growth parameters of the host learners' tests."""
    from lightgbm_tpu_torch.ops.grow import GrowParams
    from lightgbm_tpu_torch.ops.split import FeatureMeta, SplitHyper

    rng = np.random.default_rng(9)
    n, f, b = 4000, 13, 32
    bins = rng.integers(0, b, size=(n, f)).astype(np.uint8)
    grad = (bins[:, :3].astype(np.float32) @ np.array([1.0, -0.7, 0.4], np.float32) / b
            + 0.1 * rng.standard_normal(n).astype(np.float32))
    hess = np.ones(n, np.float32)
    meta = lambda d: FeatureMeta(torch.full((f,), b, dtype=torch.int64, device=d),  # noqa: E731
                                 torch.zeros(f, dtype=torch.int64, device=d),
                                 torch.zeros(f, dtype=torch.bool, device=d))
    hyper = SplitHyper(*(np.float32(v) for v in (0.0, 0.1, 20.0, 1e-3, 0.0)))
    t = [torch.from_numpy(a) for a in (bins, grad, hess)]
    return t, meta, hyper, GrowParams(num_leaves=31, num_bins=b)


@pytest.mark.parametrize("mode,kw", [("data", {}), ("feature", {}), ("voting", {"top_k": 13}),
                                     ("voting", {"top_k": 3}), ("data", {"quantized": True})],
                         ids=["data", "feature", "voting-full", "voting-3", "data-quantized"])
def test_host_learner_card_equals_cpu(dev, host_shards, mode, kw):
    """Each mode over 4 rank threads on the card (B8 or B9 a node) grows the
    CPU's tree (plain versions) with the same ledger; B8/B9 launched."""
    t, meta, hyper, params = host_shards
    n = t[0].shape[0]
    cuts = np.linspace(0, n, 5).astype(int)
    shards = ([t] * 4 if mode == "feature"
              else [[a[cuts[r]:cuts[r + 1]] for a in t] for r in range(4)])
    name = "hist_segment_q" if kw.get("quantized") else "hist_segment"
    before = getattr(th, name).launches
    card = _host_group(mode, shards, params, meta(dev), hyper, dev, **kw)
    assert getattr(th, name).launches > before
    cpu = _host_group(mode, shards, params, meta("cpu"), hyper, torch.device("cpu"), **kw)
    for (gc, lc), (gp, lp) in zip(card, cpu):
        _assert_trees_equal(gc, gp, skip=())
        assert lc == lp
    assert int(card[0][0].num_splits) > 5


def test_host_learner_contracts_on_card(dev, host_shards):
    """feature == the serial grower, voting(2k >= F) == data, and the
    quantized tree at R = 1 == R = 4, all on the card."""
    from lightgbm_tpu_torch.ops.grow import grow_tree

    t, meta, hyper, params = host_shards
    n, f = t[0].shape
    m = meta(dev)
    serial = grow_tree(th.pack_bin_words(t[0].to(dev)), t[1].to(dev), t[2].to(dev),
                       torch.ones(n, device=dev), torch.ones(f, device=dev), m, hyper, params)
    for gr, _ in _host_group("feature", [t] * 4, params, m, hyper, dev):
        _assert_trees_equal(gr, serial, skip=())
    cuts = np.linspace(0, n, 5).astype(int)
    shards = [[a[cuts[r]:cuts[r + 1]] for a in t] for r in range(4)]
    data = _host_group("data", shards, params, m, hyper, dev)
    vote = _host_group("voting", shards, params, m, hyper, dev, top_k=f)
    for (gd, _), (gv, _) in zip(data, vote):
        _assert_trees_equal(gd, gv, skip=())
    q4 = _host_group("data", shards, params, m, hyper, dev, quantized=True)
    q1 = _host_group("data", [t], params, m, hyper, dev, quantized=True)
    _assert_trees_equal(q1[0][0], q4[0][0])


def test_factory_cycle_on_card(dev, tmp_path):
    """A cold then a warm factory cycle trains on the card (B1 and B5
    launched) and promotes; the warm model equals lgt.train of the staged
    rows with the same init_model."""
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.factory import FactorySupervisor

    rng = np.random.default_rng(2)
    data = tmp_path / "data"
    data.mkdir()
    X = rng.standard_normal((6000, 8))
    y = (X[:, 0] + 0.5 * X[:, 1] - X[:, 2] > 0).astype(int)
    for i, rows in enumerate((slice(0, 4000), slice(4000, 6000))):
        if i:
            init = sup.state.current["model_path"]
        np.savetxt(data / f"part-{i}.csv", np.column_stack([y[rows], X[rows]]), delimiter=",",
                   fmt="%.6g")
        sup = FactorySupervisor(str(data), str(tmp_path / "work"), str(tmp_path / "reg"),
                                params=dict(objective="binary", num_leaves=15, verbose=-1),
                                num_boost_round=5, checkpoint_freq=2, debounce_ms=0.0,
                                canary_fraction=0.0)
        before = pk.update_and_root_hist.launches, pk.score_add.launches
        verdict = sup.run_cycle()
        assert verdict["verdict"] == "promoted" and verdict["warm_start"] == bool(i)
        assert pk.update_and_root_hist.launches > before[0] and pk.score_add.launches > before[1]
    stage = tmp_path / "stage.csv"
    stage.write_bytes((data / "part-0.csv").read_bytes() + (data / "part-1.csv").read_bytes())
    p = dict(objective="binary", num_leaves=15, verbose=-1, out_of_core="auto")
    want = lgt.train(p, lgt.Dataset(str(stage), params=dict(p)), 5, init_model=init,
                     device=dev).model_to_string()
    assert open(sup.state.current["model_path"]).read() == want


@pytest.mark.parametrize("mode", ["data", "quantized"])
def test_rank_processes_on_card_equal_rank_threads(dev, tmp_path, mode):
    """Two `python -m lightgbm_tpu_torch train` rank processes on the card
    (the env bootstrap, each rank's B8 or B9 on its shard) write the model
    of LocalComm rank threads in this process on the ranks' saved bins."""
    import json
    import os
    import socket
    import subprocess
    import sys
    import threading

    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.parallel import LocalGroup
    from lightgbm_tpu_torch.parallel.comm import rank_thread

    rng = np.random.default_rng(5)
    X = rng.standard_normal((4000, 8))
    y = (X[:, 0] + 0.5 * X[:, 1] - X[:, 2] * X[:, 3] > 0).astype(np.float32)
    params = dict(objective="binary", tree_learner="data", num_machines=2,
                  pre_partition="true", num_leaves=15, network_timeout=10, verbose=1,
                  **({"quantized_training": "true"} if mode == "quantized" else {}))
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = []
    for r in range(2):
        part = tmp_path / f"shard{r}.csv"
        rows = slice(r * 2000, (r + 1) * 2000)
        np.savetxt(part, np.column_stack([y[rows], X[rows]]), delimiter=",", fmt="%.9g")
        env = {k: v for k, v in os.environ.items() if not k.startswith("LIGHTGBM_TPU_")}
        env.update(PYTHONPATH=repo, LIGHTGBM_TPU_COORDINATOR=f"127.0.0.1:{port}",
                   LIGHTGBM_TPU_NUM_PROCESSES="2", LIGHTGBM_TPU_PROCESS_ID=str(r))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "lightgbm_tpu_torch", "train", f"data={part}",
             f"output_model={tmp_path / f'model{r}.txt'}", "num_iterations=3",
             "is_save_binary_file=true", *[f"{k}={v}" for k, v in params.items()]],
            cwd=str(tmp_path), env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    logs = [p.communicate(timeout=300)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
        assert "learner over 2 processes on cuda" in log, log[-3000:]
    ledgers = [json.loads(log.split("Bytes sent by purpose: ")[1].splitlines()[0])
               for log in logs]
    group, out = LocalGroup(2), [None, None]

    def rank(r, comm):
        with rank_thread(comm):
            b = lgt.train(dict(params, verbose=-1),
                          lgt.Dataset(str(tmp_path / f"shard{r}.csv.bin")), 3, device=dev)
            out[r] = (b.model_to_string(), dict(comm.ledger))

    ts = [threading.Thread(target=rank, args=(r, c)) for r, c in enumerate(group.comms())]
    for t in ts:
        t.start()
    for t in ts:
        t.join(300)
    for r in range(2):
        assert out[r][0] == (tmp_path / f"model{r}.txt").read_text()
        assert out[r][1] == ledgers[r]


def test_member_fleet_on_card(dev, tmp_path):
    """Two fleet members on the card (python -m lightgbm_tpu_torch.factory.
    member_worker, B9 in each) train a fleet of one's model bytes, and a
    member SIGKILLed mid-run leaves its survivor the same bytes."""
    import json
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    def fleet(tag, nproc, per=None):
        d = tmp_path / tag
        procs = []
        for m in range(nproc):
            env = {k: v for k, v in os.environ.items()
                   if not k.startswith(("LIGHTGBM_TPU_", "MEMBER_"))}
            env.update(PYTHONPATH=repo, MEMBER_NPROC=str(nproc), MEMBER_TREES="6",
                       LIGHTGBM_TPU_NET_TIMEOUT="8", **(per or {}).get(m, {}))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "lightgbm_tpu_torch.factory.member_worker", str(m),
                 str(d), str(d / "out")], env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        logs = [p.communicate(timeout=300)[0] for p in procs]
        return d, [p.returncode for p in procs], logs

    ref, rcs, logs = fleet("ref", 1)
    assert rcs == [0], logs[0][-3000:]
    two, rcs, logs = fleet("two", 2, {1: {"MEMBER_KILL_ITER": "2"}})
    assert rcs == [0, -9], logs[0][-3000:]
    meta = json.loads((two / "out.m0.json").read_text())
    assert meta["device"] == "cuda" and meta["launches"]["hist_segment_q"] > 0
    assert meta["final_members"] == [0] and meta["trees"] == 6
    assert (two / "out.m0.txt").read_text() == (ref / "out.m0.txt").read_text()


def test_distributed_ooc_card_equals_cpu(dev):
    """Rank-sharded out of core over 2 LocalComm rank threads, quantized:
    the card (B9's carry mode in each rank) trains the CPU's model bytes."""
    import threading

    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.factory.member_worker import make_data
    from lightgbm_tpu_torch.parallel import LocalGroup
    from lightgbm_tpu_torch.parallel.comm import rank_thread

    X, y = make_data(12000, 10, 5)
    full = lgt.Dataset(X, label=y, params={"max_bin": 31})
    p = dict(objective="binary", tree_learner="data", pre_partition=True, num_leaves=15,
             quantized_training=True, out_of_core="true", ooc_chunk_rows=1000, verbose=-1)

    def run(device):
        group, out = LocalGroup(2), [None, None]

        def rank(r, comm):
            with rank_thread(comm):
                ds = lgt.Dataset(X[r * 6000:(r + 1) * 6000], label=y[r * 6000:(r + 1) * 6000],
                                 reference=full)
                b = lgt.train(dict(p), ds, 3, device=device)
                out[r] = (b.model_to_string(), type(b.boosting.learner).__name__)

        ts = [threading.Thread(target=rank, args=(r, c)) for r, c in enumerate(group.comms())]
        for t in ts:
            t.start()
        for t in ts:
            t.join(300)
        return out

    before = th.hist_segment_q.launches
    card = run(dev)
    assert th.hist_segment_q.launches > before
    cpu = run("cpu")
    assert card[0][1] == "DistributedOocTrainer"
    assert card[0][0] == card[1][0] == cpu[0][0]
