"""lightgbm_tpu_torch kernel modules against the JAX package's kernels.

Each plain PyTorch version (what the port's wrappers run on the CPU) is
held against the JAX Pallas kernel run in interpret mode on the same
packed matrix, built the way tests/test_pgrow.py builds it.  Tolerances:
left counts, row sets and untouched columns exact; histograms 2e-3
relative (interpret mode emulates the TPU's bf16 3-term sums,
tests/test_pgrow.py:53); recomputed gradient channels 1e-6 relative
(exp differs by an ulp between XLA and PyTorch); score_add bit-exact.

The CUDA kernels themselves run only on the card:
tests/test_torch_cuda.py compares them with the plain versions there.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lightgbm_tpu.ops import pkernels as jpk
from lightgbm_tpu_torch.ops import pkernels as tpk

INTERP = True
HIST_TOL = 2e-3


def _make_packed(n=6000, f=11, b=32, seed=7, bits=8):
    rng = np.random.default_rng(seed)
    lay = jpk.PLayout(f, bits=bits)
    bins = rng.integers(0, b, size=(n, f), dtype=np.uint8)
    label = (rng.random(n) < 0.4).astype(np.float32)
    weight = (rng.random(n) + 0.5).astype(np.float32)
    P = np.asarray(jpk.pack_matrix(bins, lay, label=label, weight=weight)).copy()
    P[lay.G, :n] = rng.standard_normal(n).astype(np.float32).view(np.int32)
    P[lay.H, :n] = np.abs(rng.standard_normal(n)).astype(np.float32).view(np.int32)
    P[lay.SEL, :n] = (rng.random(n) < 0.85).astype(np.float32).view(np.int32)
    P[lay.SCORE, :n] = (0.3 * rng.standard_normal(n)).astype(np.float32).view(np.int32)
    return P, lay, label, weight


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1.0)


def _canon(mat, lo, hi, rowid):
    seg = mat[:, lo:hi]
    return seg[:, np.argsort(seg[rowid], kind="stable")]


def _objectives(label, weight):
    """The binary objective in both packages, bound to the same labels."""
    from lightgbm_tpu.config import Config as JConfig
    from lightgbm_tpu.io.dataset import Metadata as JMeta
    from lightgbm_tpu.objective import create_objective as jcreate
    from lightgbm_tpu_torch.config import Config as TConfig
    from lightgbm_tpu_torch.io.dataset import Metadata as TMeta
    from lightgbm_tpu_torch.objective import create_objective as tcreate

    out = []
    for create, Config, Meta in ((jcreate, JConfig, JMeta), (tcreate, TConfig, TMeta)):
        obj = create(Config.from_params({"objective": "binary", "scale_pos_weight": 1.5}))
        md = Meta(len(label))
        md.set_label(label)
        md.set_weights(weight)
        obj.init(md, len(label))
        out.append(obj)
    return out


class TestUpdateAndRootHist:
    @pytest.mark.parametrize("with_sel", [False, True])
    def test_matches_jax(self, with_sel):
        n, B = 6000, 32
        P, lay, label, weight = _make_packed(n=n)
        jobj, tobj = _objectives(label, weight)
        rng = np.random.default_rng(9)
        delta = rng.standard_normal(n).astype(np.float32)
        sel = (rng.random(n) < 0.6).astype(np.float32) if with_sel else None

        def grad_fn(score, lab, w):
            return jobj.gradients_rowwise(score, lab, w)

        Pj, hj = jpk.update_and_root_hist(
            jnp.asarray(P), lay, grad_fn, delta=delta, sel=sel, num_rows=n,
            num_features=lay.F, num_bins=B, interpret=INTERP)
        Pj = np.asarray(Pj)
        tlay = tpk.PLayout(lay.F)
        Pt, ht = tpk.update_and_root_hist(
            torch.from_numpy(P.copy()), tlay, tobj, delta=delta, sel=sel, num_rows=n,
            num_features=lay.F, num_bins=B)
        Pt = Pt.numpy()
        for r in (lay.G, lay.H):
            assert _rel(Pt[r, :n].view(np.float32), Pj[r, :n].view(np.float32)) < 1e-6
        for r in (lay.SCORE, lay.SEL):
            np.testing.assert_array_equal(Pt[r, :n], Pj[r, :n])
        other = [r for r in range(lay.C) if r not in (lay.G, lay.H, lay.SCORE, lay.SEL)]
        np.testing.assert_array_equal(Pt[other], P[other])
        # the port touches no column past the real rows
        np.testing.assert_array_equal(Pt[:, n:], P[:, n:])
        assert _rel(ht.numpy(), np.asarray(hj)) < HIST_TOL

    def test_l2_weighted_gradients(self):
        n = 3000
        P, lay, label, weight = _make_packed(n=n, seed=3)
        from lightgbm_tpu_torch.config import Config
        from lightgbm_tpu_torch.io.dataset import Metadata
        from lightgbm_tpu_torch.objective import create_objective

        obj = create_objective(Config.from_params({"objective": "regression"}))
        md = Metadata(n)
        md.set_label(label)
        md.set_weights(weight)
        obj.init(md, n)
        Pt, _ = tpk.update_and_root_hist(
            torch.from_numpy(P.copy()), tpk.PLayout(lay.F), obj, num_rows=n,
            num_features=lay.F, num_bins=32)
        score = P[lay.SCORE, :n].view(np.float32)
        np.testing.assert_array_equal(Pt.numpy()[lay.G, :n].view(np.float32),
                                      (score - label) * weight)
        np.testing.assert_array_equal(Pt.numpy()[lay.H, :n].view(np.float32), weight)


# (start, cnt, feat, thr, zero_bin, dbz, cat, off_lo, off_hi, bias)
SEGMENTS = [
    (0, 1024, 3, 15, 0, 0, 0, 0, None, 0),
    (1024, 0, 0, 7, 0, 0, 0, 0, None, 0),          # empty, block-aligned start
    (1024, 137, 0, 7, 5, 11, 0, 0, None, 0),       # tiny + zero-bin remap
    (1161, 2935, 10, 4, 0, 0, 1, 0, None, 0),      # categorical
    (4096, 900, 7, 20, 0, 3, 0, 3, 20, 1),         # EFB range remap
    (5000, 999, 1, 31, 0, 0, 0, 0, None, 0),       # all-left threshold
]


def _tab(segs, bits, smax=8):
    per = 32 // bits
    tab = np.zeros((smax, 12), np.int32)
    for i, (s, c, f, t, zb, dbz, cat, lo, hi, bias) in enumerate(segs):
        tab[i] = [s, c, f // per, (f % per) * bits, zb, dbz, t, cat, lo,
                  (1 << bits) if hi is None else hi, bias, 0]
    return tab


def _check_partition(Pt, Pj, P0, lay, segs, nlt, nlj):
    np.testing.assert_array_equal(np.asarray(nlt)[: len(segs)], np.asarray(nlj)[: len(segs)])
    covered = np.zeros(P0.shape[1], bool)
    for i, (s, c, *_rest) in enumerate(segs):
        nl = int(nlj[i])
        covered[s:s + c] = True
        for lo, hi in ((s, s + nl), (s + nl, s + c)):
            np.testing.assert_array_equal(_canon(Pt, lo, hi, lay.ROWID),
                                          _canon(Pj, lo, hi, lay.ROWID))
    # columns outside the segments (incl. the BLK tail) stay untouched
    np.testing.assert_array_equal(Pt[:, ~covered], P0[:, ~covered])


class TestLevelStream:
    @pytest.mark.parametrize("bits,nbins", [(8, 32), (4, 16)])
    def test_matches_jax(self, bits, nbins):
        P, lay, *_ = _make_packed(n=6000, b=nbins, bits=bits)
        F = lay.F
        segs = [s if bits == 8 or s[8] == 0 else s[:7] + (3, 12, 1) for s in SEGMENTS]
        segs = [s[:3] + (min(s[3], nbins - 1),) + s[4:] for s in segs]
        tab = _tab(segs, bits)
        Pj, nlj, hj = jpk.level_stream(
            jnp.array(P), jnp.asarray(tab), jnp.int32(len(segs)), num_features=F,
            num_bins=nbins, bits=bits, rows=lay.rows, smax=8, interpret=INTERP)
        Pt, nlt, ht = tpk.level_stream(
            torch.from_numpy(P.copy()), torch.from_numpy(tab), len(segs), num_features=F,
            num_bins=nbins, bits=bits, rows=lay.rows, smax=8)
        Pj, nlj = np.asarray(Pj), np.asarray(nlj)
        _check_partition(Pt.numpy(), Pj, P, lay, segs, nlt.numpy(), nlj)
        for i in range(len(segs)):
            for side, row0 in ((0, 0), (1, 7)):
                want = np.asarray(jpk._hist_from_rows(jnp.asarray(np.asarray(hj)[i]), F,
                                                      nbins, row0=row0))
                assert _rel(ht[i, side].numpy(), want) < HIST_TOL

    def test_zero_active_is_noop(self):
        P, lay, *_ = _make_packed(n=3000)
        Pt, nl, h = tpk.level_stream(torch.from_numpy(P.copy()), np.zeros((8, 12), np.int64),
                                     0, num_features=lay.F, num_bins=32, smax=8)
        np.testing.assert_array_equal(Pt.numpy(), P)
        assert int(nl.abs().sum()) == 0 and float(h.abs().sum()) == 0.0


class TestSplitStream:
    @pytest.mark.parametrize("seg", SEGMENTS, ids=[f"seg{i}" for i in range(len(SEGMENTS))])
    def test_matches_jax(self, seg):
        P, lay, *_ = _make_packed(n=6000)
        F, B = lay.F, 32
        s, c, f, t, zb, dbz, cat, lo, hi, bias = seg
        hi = 256 if hi is None else hi
        args = (s, c, f // 4, (f % 4) * 8, zb, dbz, t, cat, lo, hi, bias)
        Pj, nlj, lj, rj = jpk.split_stream(jnp.array(P), *args, num_features=F, num_bins=B,
                                           rows=lay.rows, interpret=INTERP)
        Pt, nlt, lt, rt = tpk.split_stream(torch.from_numpy(P.copy()), *args, num_features=F,
                                           num_bins=B, rows=lay.rows)
        _check_partition(Pt.numpy(), np.asarray(Pj), P, lay, [seg], [int(nlt)], [int(nlj)])
        assert _rel(lt.numpy(), np.asarray(lj)) < HIST_TOL
        assert _rel(rt.numpy(), np.asarray(rj)) < HIST_TOL


class TestScoreAdd:
    def test_bit_exact(self):
        n = 5000
        P, lay, *_ = _make_packed(n=n)
        delta = np.random.default_rng(4).standard_normal(n).astype(np.float32)
        Pj = np.asarray(jpk.score_add(jnp.array(P), lay, delta, 0, num_rows=n,
                                      interpret=INTERP))
        Pt = tpk.score_add(torch.from_numpy(P.copy()), tpk.PLayout(lay.F), delta,
                           num_rows=n).numpy()
        np.testing.assert_array_equal(Pt[:, :n], Pj[:, :n])
        np.testing.assert_array_equal(Pt[:, n:], P[:, n:])


class TestLayout:
    @pytest.mark.parametrize("f,bits", [(28, 8), (11, 8), (11, 4), (300, 8)])
    def test_rows_match_jax(self, f, bits):
        j, t = jpk.PLayout(f, bits=bits), tpk.PLayout(f, bits=bits)
        for k in ("W", "WPAD", "G", "H", "SEL", "SCORE", "LABEL", "ROWID", "WEIGHT", "BAND",
                  "C"):
            assert getattr(j, k) == getattr(t, k), k

    def test_slice_shape(self):
        lay = tpk.PLayout(28)
        assert (lay.W, lay.WPAD, lay.BAND, lay.C) == (7, 8, 8, 16)
