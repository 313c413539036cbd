"""lightgbm_tpu_torch kernel modules against the JAX package's kernels.

Each plain PyTorch version (what the port's wrappers run on the CPU) is
held against the JAX Pallas kernel run in interpret mode on the same
packed matrix, built the way tests/test_pgrow.py builds it.  Tolerances:
left counts, row sets and untouched columns exact; histograms 2e-3
relative (interpret mode emulates the TPU's bf16 3-term sums,
tests/test_pgrow.py:53); recomputed gradient channels 1e-6 relative
(exp differs by an ulp between XLA and PyTorch); score_add bit-exact;
segment histograms: counts exact, sums 2e-3.

The CUDA kernels themselves run only on the card:
tests/test_torch_cuda.py compares them with the plain versions there.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lightgbm_tpu.ops import histogram_pallas as jhp
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


LAYOUT_FIELDS = ("W", "WPAD", "G", "H", "SEL", "SCORE", "LABEL", "ROWID", "WEIGHT", "BAND", "C")


class TestLayout:
    @pytest.mark.parametrize("f,bits", [(28, 8), (11, 8), (11, 4), (300, 8)])
    def test_rows_match_jax(self, f, bits):
        j, t = jpk.PLayout(f, bits=bits), tpk.PLayout(f, bits=bits)
        for k in LAYOUT_FIELDS:
            assert getattr(j, k) == getattr(t, k), k

    @pytest.mark.parametrize("f,bits,k", [(12, 8, 7), (28, 8, 16), (11, 4, 3)])
    def test_multiclass_rows_match_jax(self, f, bits, k):
        j, t = jpk.PLayout(f, num_score=k, bits=bits), tpk.PLayout(f, num_score=k, bits=bits)
        for a in LAYOUT_FIELDS:
            assert getattr(j, a) == getattr(t, a), a
        for c in range(k):
            assert j.class_rows(c) == t.class_rows(c)

    def test_slice_shape(self):
        lay = tpk.PLayout(28)
        assert (lay.W, lay.WPAD, lay.BAND, lay.C) == (7, 8, 8, 16)

    def test_covertype_shape(self):
        """12 EFB columns, 7 classes: 40 channels."""
        lay = tpk.PLayout(12, num_score=7)
        assert (lay.W, lay.WPAD, lay.BAND, lay.C) == (3, 8, 32, 40)


def _make_packed_multi(K, n=5000, f=9, b=32, seed=17):
    rng = np.random.default_rng(seed)
    lay = jpk.PLayout(f, num_score=K)
    bins = rng.integers(0, b, size=(n, f), dtype=np.uint8)
    label = rng.integers(0, K, n).astype(np.float32)
    weight = (rng.random(n) + 0.5).astype(np.float32)
    P = np.asarray(jpk.pack_matrix(bins, lay, label=label, weight=weight)).copy()
    for k in range(K):
        P[lay.SCORE + k, :n] = rng.standard_normal(n).astype(np.float32).view(np.int32)
        P[lay.g_row(k), :n] = rng.standard_normal(n).astype(np.float32).view(np.int32)
        P[lay.h_row(k), :n] = rng.standard_normal(n).astype(np.float32).view(np.int32)
    P[lay.SEL, :n] = (rng.random(n) < 0.8).astype(np.float32).view(np.int32)
    return P, lay, label, weight


def _multi_objectives(name, K, label, weight):
    """The multiclass objective in both packages, bound to the same
    labels (OVA with is_unbalance, so each class has its own weights)."""
    from lightgbm_tpu.config import Config as JConfig
    from lightgbm_tpu.io.dataset import Metadata as JMeta
    from lightgbm_tpu.objective import create_objective as jcreate
    from lightgbm_tpu_torch.config import Config as TConfig
    from lightgbm_tpu_torch.io.dataset import Metadata as TMeta
    from lightgbm_tpu_torch.objective import create_objective as tcreate

    params = {"objective": name, "num_class": K}
    if name == "multiclassova":
        params["is_unbalance"] = True
    out = []
    for create, Config, Meta in ((jcreate, JConfig, JMeta), (tcreate, TConfig, TMeta)):
        obj = create(Config.from_params(params))
        md = Meta(len(label))
        md.set_label(label)
        md.set_weights(weight)
        obj.init(md, len(label))
        out.append(obj)
    return out


class TestUpdateMultiAndHists:
    @pytest.mark.parametrize("name,K", [("multiclass", 3), ("multiclass", 7),
                                        ("multiclassova", 4)])
    @pytest.mark.parametrize("with_sel,with_weight", [(False, False), (True, True),
                                                      (False, True)],
                             ids=["plain", "sel-weight", "weight"])
    def test_matches_jax(self, name, K, with_sel, with_weight):
        n, B = 5000, 32
        P, lay, label, weight = _make_packed_multi(K, n=n)
        jobj, tobj = _multi_objectives(name, K, label, weight if with_weight else None)
        sel = ((np.random.default_rng(3).random(n) < 0.6).astype(np.float32)
               if with_sel else None)

        def grad_all_fn(scores, lab, w):
            return jobj.gradients_rowwise_all(scores, lab, w if with_weight else None)

        Pj, hj = jpk.update_multi_and_hists(
            jnp.asarray(P), lay, grad_all_fn, sel=sel, num_rows=n, num_features=lay.F,
            num_bins=B, interpret=INTERP)
        Pj = np.asarray(Pj)
        Pt, ht = tpk.update_multi_and_hists(
            torch.from_numpy(P.copy()), tpk.PLayout(lay.F, num_score=K), tobj, sel=sel,
            num_rows=n, num_features=lay.F, num_bins=B)
        Pt = Pt.numpy()
        gh = [r for k in range(K) for r in (lay.g_row(k), lay.h_row(k))]
        for r in gh:
            assert _rel(Pt[r, :n].view(np.float32), Pj[r, :n].view(np.float32)) < 1e-6
        other = [r for r in range(lay.C) if r not in gh]
        np.testing.assert_array_equal(Pt[other, :n], Pj[other, :n])
        if not with_sel:
            np.testing.assert_array_equal(Pt[lay.SEL], P[lay.SEL])
        np.testing.assert_array_equal(Pt[:, n:], P[:, n:])
        assert ht.shape == (K, lay.F, B, 3)
        for k in range(K):
            np.testing.assert_array_equal(ht[k, ..., 2].numpy(), np.asarray(hj[k])[..., 2])
            assert _rel(ht[k].numpy(), np.asarray(hj[k])) < HIST_TOL


# [start, cnt] segment tables: empty, unaligned, block-spanning and large
HIST_SEGS = [(0, 0), (3, 700), (703, 1), (1024, 2048), (3072, 2800), (5872, 128)]


class TestSegmentHists:
    @pytest.mark.parametrize("bits,nbins", [(8, 32), (4, 16)])
    def test_hist_segments_match_jax(self, bits, nbins):
        P, lay, *_ = _make_packed(n=6000, b=nbins, bits=bits)
        tab = np.zeros((8, 2), np.int32)
        tab[: len(HIST_SEGS)] = HIST_SEGS
        kw = dict(num_features=lay.F, num_bins=nbins, bits=bits, rows=lay.rows, smax=8)
        hj = np.asarray(jhp.hist_segments(jnp.asarray(P), jnp.asarray(tab), len(HIST_SEGS),
                                          interpret=INTERP, **kw))
        ht = tpk.hist_segments(torch.from_numpy(P.copy()), torch.from_numpy(tab),
                               len(HIST_SEGS), **kw).numpy()
        assert ht.shape == (8, lay.F, nbins, 3)
        for s in range(len(HIST_SEGS)):
            np.testing.assert_array_equal(ht[s, ..., 2], hj[s, ..., 2])
            assert _rel(ht[s], hj[s]) < HIST_TOL
        assert not ht[len(HIST_SEGS):].any()

    @pytest.mark.parametrize("seg", [(0, 6000), (1024, 0), (37, 4001)],
                             ids=["all", "empty", "unaligned"])
    def test_hist_dyn_matches_jax(self, seg):
        P, lay, *_ = _make_packed(n=6000)
        start, cnt = seg
        hj = np.asarray(jpk.hist_dyn(jnp.asarray(P), start, cnt, lay.F, 32, rows=lay.rows,
                                     interpret=INTERP))
        ht = tpk.hist_dyn(torch.from_numpy(P.copy()), start, cnt, lay.F, 32,
                          rows=lay.rows).numpy()
        np.testing.assert_array_equal(ht[..., 2], hj[..., 2])
        assert _rel(ht, hj) < HIST_TOL

    def test_class_rows(self):
        """A multiclass layout's class-k (g, h) rows feed the histogram."""
        P, lay, *_ = _make_packed_multi(3, n=3000)
        rows = lay.class_rows(2)
        t = torch.from_numpy(P.copy())
        got = tpk.hist_dyn(t, 0, 3000, lay.F, 32, rows=rows)
        want = tpk.hist_segments(t, np.asarray([[0, 3000]]), 1, num_features=lay.F,
                                 num_bins=32, rows=rows, smax=1)[0]
        hj = np.asarray(jpk.hist_dyn(jnp.asarray(P), 0, 3000, lay.F, 32, rows=rows,
                                     interpret=INTERP))
        assert torch.equal(got, want)
        assert _rel(got.numpy(), hj) < HIST_TOL

    @pytest.mark.parametrize("bundled", [False, True], ids=["plain", "bundled"])
    def test_pgrow_level_hists_matches_jax(self, bundled):
        """pgrow.level_hists (the grower's root with the level grower on)
        streams G columns of BH bins: the matrix's, not the features'."""
        from lightgbm_tpu.ops.pgrow import PGrowParams as JParams, level_hists as jlevel
        from lightgbm_tpu_torch.ops.pgrow import PGrowParams as TParams, level_hists as tlevel

        P, lay, *_ = _make_packed(n=6000)
        shape = (dict(num_features=3 * lay.F, num_bins=16, num_cols=lay.F, num_bins_hist=32)
                 if bundled else dict(num_features=lay.F, num_bins=32))
        tab = np.zeros((4, 2), np.int32)
        tab[:2] = [(0, 2500), (2500, 3500)]
        hj = np.asarray(jlevel(jnp.asarray(P), jnp.asarray(tab), jnp.int32(2),
                               JParams(num_leaves=7, num_rows=6000, **shape), rows=lay.rows,
                               interpret=INTERP))
        ht = tlevel(torch.from_numpy(P.copy()), tab, 2,
                    TParams(num_leaves=7, num_rows=6000, **shape), rows=lay.rows).numpy()
        assert ht.shape == (4, lay.F, 32, 3)
        for s in range(2):
            np.testing.assert_array_equal(ht[s, ..., 2], hj[s, ..., 2])
            assert _rel(ht[s], hj[s]) < HIST_TOL
