"""lightgbm_tpu_torch's CUDA kernels against their plain PyTorch versions,
on the card.

Every test here carries the ``cuda`` marker and skips where no card is
present.  The file imports neither jax nor the JAX package, so it runs on
a machine that has only PyTorch for CUDA:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: left counts, partitioned matrices (the partition is stable in
both versions), histogram counts and score_add bit-exact; histogram g/h
sums within 1e-5 of the largest bin per channel (the plain version sums
in float64 and rounds once, the kernels add float32 partials with
atomics); recomputed gradients within 1e-6 relative.
"""

import numpy as np
import pytest
import torch

from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.io.dataset import Metadata
from lightgbm_tpu_torch.objective import create_objective
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


def _objective(name, label, weight):
    obj = create_objective(Config.from_params({"objective": name}))
    md = Metadata(len(label))
    md.set_label(label)
    md.set_weights(weight)
    obj.init(md, len(label))
    return obj


def _assert_hist(hk, hr):
    hk, hr = hk.cpu().double(), hr.cpu().double()
    assert torch.equal(hk[..., 2], hr[..., 2])
    for c in (0, 1):
        err = (hk[..., c] - hr[..., c]).abs().max() / max(float(hr[..., c].abs().max()), 1.0)
        assert float(err) <= 1e-5


@pytest.mark.parametrize("objective", ["binary", "regression"])
def test_update_and_root_hist(dev, objective):
    P, lay, label, weight = _packed()
    obj = _objective(objective, label, weight)
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
