"""The port's parallel tree learners (parallel/comm.py,
parallel/hostlearner.py), their split-search and wire helpers
(ops/split.py ``slice_features`` / ``best_split_feature_block``,
ops/qhist.py ``pack_hist_q`` ...) and the one-process fallback of
``tree_learner=data|feature|voting`` (boosting/gbdt.py), against the JAX
package on the CPU.

- ``LocalComm`` groups of R = 1, 2, 3 (and 4, 6) ranks as threads, on
  the shards of the JAX package's tests/test_wide_learners.py (2,000 x 41
  at 16 bins, and its 2,400 x 2,000 ``wide`` fixture);
- the bitwise contracts inside the port: feature mode equals the serial
  ``grow_tree``, voting with 2k >= F equals data mode, quantized trees
  equal for every rank count;
- against the JAX ``HostParallelLearner`` on the same inputs: the split
  lines of each mode (the float histograms differ in the sixth digit),
  the byte ledger by purpose exactly, and under quantized training every
  ``hist_q`` payload byte for byte (so the merged planes are equal) and
  the whole tree;
- ``pack_hist_q`` / ``unpack_hist_q`` / ``assemble_hist`` and the block
  split search against the JAX functions;
- C1: each parallel mode in one process trains the serial model with the
  JAX package's warning, through ``lgt.train`` and through a .conf given
  to the CLI in process, and matches the JAX package's model (split
  lines and header equal, predictions within 3e-3); the launcher's
  process count without a coordinator trains serially, a machine list
  whose peer never joins fails within its bound, and forced out of core
  with voting and ``top_k < 1`` are refused.

Rank threads are joined with a time limit, and a rank that raises aborts
the group's barrier, so a fault fails the test instead of hanging it.
"""

import os
import socket
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax._src.core
import jax.numpy as jnp

import lightgbm_tpu as lgb
from lightgbm_tpu.ops import qhist as jqhist
from lightgbm_tpu.ops import split as jsplit
from lightgbm_tpu.ops.grow import GrowParams as JGrowParams
from lightgbm_tpu.parallel import HostParallelLearner as JHostParallelLearner
from lightgbm_tpu.parallel import LocalComm as JLocalComm
from lightgbm_tpu.parallel import LocalGroup as JLocalGroup

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch import cli
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.ops import qhist
from lightgbm_tpu_torch.ops import split as tsplit
from lightgbm_tpu_torch.ops.grow import GrowParams, grow_tree
from lightgbm_tpu_torch.ops.histogram import pack_bin_words
from lightgbm_tpu_torch.parallel import HostParallelLearner, LocalComm, LocalGroup
from lightgbm_tpu_torch.parallel import hostlearner
from lightgbm_tpu_torch.utils.log import LightGBMError

JOIN_S = 120


@pytest.fixture(scope="module", autouse=True)
def jax_shim_and_one_thread():
    """jax 0.9 moved ``trace_state_clean`` out of ``jax.core``, where the
    JAX package's compile watch imports it from; and one torch intra-op
    thread (the CPU path is many small ops, run by several rank threads)."""
    had = hasattr(jax.core, "trace_state_clean")
    if not had:
        jax.core.trace_state_clean = jax._src.core.trace_state_clean
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    if not had:
        del jax.core.trace_state_clean


class _Recording(LocalComm):
    """A port rank that keeps every (purpose, blob) it sends."""

    def __init__(self, rank, group):
        super().__init__(rank, group)
        self.sent = []

    def allgather(self, blob, purpose="misc"):
        self.sent.append((purpose, bytes(blob)))
        return super().allgather(blob, purpose)


class _JRecording(JLocalComm):
    """The same for a JAX package rank."""

    def __init__(self, rank, group):
        super().__init__(rank, group)
        self.sent = []

    def allgather(self, blob, purpose="misc"):
        self.sent.append((purpose, bytes(blob)))
        return super().allgather(blob, purpose)


def _threads(group, comms, work):
    """Run ``work(rank, comm)`` on a thread per rank; a rank that raises
    aborts the barrier, the first error is raised, and a hang fails."""
    out, errs = [None] * len(comms), []

    def run(r, c):
        try:
            out[r] = work(r, c)
        except BaseException as e:  # noqa: BLE001 - surfaced below
            errs.append(e)
            group.barrier.abort()

    ts = [threading.Thread(target=run, args=(r, c), daemon=True) for r, c in enumerate(comms)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(JOIN_S)
        assert not t.is_alive(), "a rank thread did not finish in time"
    if errs:
        raise errs[0]
    return out


def _meta(f, B):
    return tsplit.FeatureMeta(torch.full((f,), B, dtype=torch.int64),
                              torch.zeros(f, dtype=torch.int64),
                              torch.zeros(f, dtype=torch.bool))


def _hyper(min_data=20.0):
    return tsplit.SplitHyper(*(np.float32(v) for v in (0.0, 0.1, min_data, 1e-3, 0.0)))


def _jmeta(f, B):
    return jsplit.FeatureMeta(jnp.full((f,), B, jnp.int32), jnp.zeros((f,), jnp.int32),
                              jnp.zeros((f,), bool))


def _jhyper(min_data=20.0):
    return jsplit.SplitHyper(jnp.float32(0.0), jnp.float32(0.1), jnp.float32(min_data),
                             jnp.float32(1e-3), jnp.float32(0.0))


def _port_group(mode, params, shards, **kw):
    """Grow one tree on every port rank: [(GrowResult, ledger, sent)]."""
    B, f = params.num_bins, shards[0][0].shape[1]
    grp = LocalGroup(len(shards))
    comms = [_Recording(r, grp) for r in range(len(shards))]
    meta, hyper, fmask = _meta(f, B), _hyper(), torch.ones(f)

    def work(r, c):
        b, g, h = shards[r]
        gr = HostParallelLearner(mode, c, params, **kw).grow(
            torch.from_numpy(b), torch.from_numpy(g), torch.from_numpy(h),
            torch.ones(len(g)), fmask, meta, hyper)
        return gr, dict(c.ledger), c.sent

    return _threads(grp, comms, work)


def _jax_group(mode, shards, **kw):
    """The same on the JAX package's ranks."""
    B = kw.pop("num_bins")
    f = shards[0][0].shape[1]
    params = JGrowParams(num_bins=B, **kw)
    grp = JLocalGroup(len(shards))
    comms = [_JRecording(r, grp) for r in range(len(shards))]
    meta, hyper = _jmeta(f, B), _jhyper()

    def work(r, c):
        b, g, h = shards[r]
        gr = JHostParallelLearner(mode, c, params).grow(
            jnp.asarray(b), jnp.asarray(g), jnp.asarray(h), jnp.ones((len(g),), jnp.float32),
            jnp.ones((f,), jnp.float32), meta, hyper)
        return jax.tree_util.tree_map(np.asarray, gr), dict(c.ledger), c.sent

    return _threads(grp, comms, work)


def _as_np(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _assert_same_tree(a, b, skip=()):
    for name, x, y in zip(a._fields, a, b):
        if name not in skip:
            np.testing.assert_array_equal(_as_np(x), _as_np(y), err_msg=f"field {name}")


def _assert_same_splits(a, b):
    """Split lines (leaf, feature, threshold, default bin) equal, or a
    first difference at a near-tie (gains within 1e-3 relative); gains
    and leaf values within float32 noise otherwise."""
    n = int(a.num_splits)
    assert n == int(b.num_splits)
    pa = np.stack([_as_np(a.rec_leaf), _as_np(a.rec_feat), _as_np(a.rec_thr),
                   _as_np(a.rec_dbz)])[:, :n]
    pb = np.stack([_as_np(b.rec_leaf), _as_np(b.rec_feat), _as_np(b.rec_thr),
                   _as_np(b.rec_dbz)])[:, :n]
    diff = np.nonzero((pa != pb).any(axis=0))[0]
    if diff.size:
        s = diff[0]
        ga, gb = float(_as_np(a.rec_gain)[s]), float(_as_np(b.rec_gain)[s])
        assert abs(ga - gb) <= 1e-3 * max(abs(ga), abs(gb)), (s, pa[:, s], pb[:, s], ga, gb)
        return
    np.testing.assert_allclose(_as_np(a.rec_gain)[:n], _as_np(b.rec_gain)[:n], rtol=1e-4)
    np.testing.assert_allclose(_as_np(a.leaf_value), _as_np(b.leaf_value), rtol=1e-4,
                               atol=1e-6)


def _row_shards(bins, grad, hess, nproc):
    cuts = np.linspace(0, len(grad), nproc + 1).astype(int)
    return [(bins[cuts[r]:cuts[r + 1]], grad[cuts[r]:cuts[r + 1]], hess[cuts[r]:cuts[r + 1]])
            for r in range(nproc)]


@pytest.fixture(scope="module")
def small():
    """tests/test_wide_learners.py's ``small``: 2,000 x 41 at 16 bins."""
    rng = np.random.default_rng(7)
    n, f, B = 2000, 41, 16
    bins = rng.integers(0, B, size=(n, f)).astype(np.uint8)
    grad = rng.normal(size=n).astype(np.float32)
    hess = np.ones(n, np.float32)
    return n, f, B, bins, grad, hess


@pytest.fixture(scope="module")
def wide():
    """tests/test_wide_learners.py's ``wide``: 2,400 x 2,000 at 16 bins, a
    few signal columns among noise, two row shards."""
    rng = np.random.default_rng(3)
    n, f, B = 2400, 2000, 16
    bins = rng.integers(0, B, size=(n, f)).astype(np.uint8)
    signal = bins[:, :5].astype(np.float32)
    grad = (signal @ np.array([1.0, -0.8, 0.6, -0.4, 0.3], np.float32) / B
            + 0.05 * rng.normal(size=n)).astype(np.float32)
    hess = np.ones(n, np.float32)
    return f, B, _row_shards(bins, grad, hess, 2)


def _serial(bins, grad, hess, params):
    n, f = bins.shape
    return grow_tree(pack_bin_words(torch.from_numpy(bins)), torch.from_numpy(grad),
                     torch.from_numpy(hess), torch.ones(n), torch.ones(f),
                     _meta(f, params.num_bins), _hyper(), params)


def test_local_group_stays_in_step_under_contention():
    """16 rank threads (more than this machine's cores) trade 200 rounds
    of blobs with a 1 us switch interval: every rank gathers exactly
    round i's blobs in rank order, and its ledger counts its own bytes."""
    import struct
    import sys

    R, rounds = 16, 200
    grp = LocalGroup(R)

    def work(r, comm):
        stale = 0
        for i in range(rounds):
            got = comm.allgather(struct.pack("<ii", r, i), "misc")
            stale += got != [struct.pack("<ii", k, i) for k in range(R)]
        return stale, comm.ledger

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        out = _threads(grp, grp.comms(), work)
    finally:
        sys.setswitchinterval(old)
    assert [o[0] for o in out] == [0] * R
    assert all(o[1] == {"misc": 8 * rounds} for o in out)


# ----------------------------------------------------------------------
# the bitwise contracts inside the port
# ----------------------------------------------------------------------
@pytest.mark.parametrize("nproc", [1, 2, 4])
def test_feature_mode_equals_serial_grower(small, nproc):
    n, f, B, bins, grad, hess = small
    params = GrowParams(num_leaves=15, num_bins=B)
    ref = _serial(bins, grad, hess, params)
    assert int(ref.num_splits) > 3
    for gr, _, _ in _port_group("feature", params, [(bins, grad, hess)] * nproc):
        _assert_same_tree(ref, gr)


def test_more_ranks_than_column_blocks(small):
    """41 columns over 6 ranks: 7 a rank, the last owns none and still
    keeps the exchanges in lockstep."""
    n, f, B, bins, grad, hess = small
    params = GrowParams(num_leaves=7, num_bins=B)
    ref = _serial(bins, grad, hess, params)
    for gr, _, _ in _port_group("feature", params, [(bins, grad, hess)] * 6):
        _assert_same_tree(ref, gr)


def test_feature_mode_ships_records_only(small):
    n, f, B, bins, grad, hess = small
    res = _port_group("feature", GrowParams(num_leaves=15, num_bins=B), [(bins, grad, hess)] * 2)
    ledger = res[0][1]
    assert set(ledger) == {"best_split"} and ledger["best_split"] > 0


def test_data_mode_on_one_rank_equals_serial_grower(small):
    n, f, B, bins, grad, hess = small
    params = GrowParams(num_leaves=15, num_bins=B)
    (gr, ledger, _), = _port_group("data", params, [(bins, grad, hess)])
    _assert_same_tree(_serial(bins, grad, hess, params), gr)


@pytest.mark.parametrize("nproc", [2, 3])
def test_full_vote_equals_data_mode(small, nproc):
    n, f, B, bins, grad, hess = small
    params = GrowParams(num_leaves=15, num_bins=B)
    shards = _row_shards(bins, grad, hess, nproc)
    data = _port_group("data", params, shards)
    vote = _port_group("voting", params, shards, top_k=f)  # 2k >= F
    for (gd, _, _), (gv, _, _) in zip(data, vote):
        _assert_same_tree(gd, gv)
    assert int(data[0][0].num_splits) > 3


def test_voting_ranks_agree(small):
    n, f, B, bins, grad, hess = small
    res = _port_group("voting", GrowParams(num_leaves=15, num_bins=B),
                      _row_shards(bins, grad, hess, 2), top_k=5)
    # leaf_id maps each rank's own rows; the tree itself is the same
    _assert_same_tree(res[0][0], res[1][0], skip=("leaf_id",))


@pytest.mark.parametrize("mode", ["data", "voting"])
def test_quantized_tree_is_the_same_for_any_rank_count(small, mode):
    """Exact integer merges: the tree does not depend on R (voting with
    2k >= F, where the elected set does not depend on the ballots)."""
    n, f, B, bins, grad, hess = small
    params = GrowParams(num_leaves=15, num_bins=B)
    trees = [_port_group(mode, params, _row_shards(bins, grad, hess, r), top_k=f,
                         quantized=True)[0][0] for r in (1, 2, 3)]
    assert int(trees[0].num_splits) > 3
    for t in trees[1:]:
        _assert_same_tree(trees[0], t, skip=("leaf_id",))


# ----------------------------------------------------------------------
# against the JAX package's learner
# ----------------------------------------------------------------------
@pytest.mark.parametrize("mode,top_k", [("data", 20), ("voting", 5), ("voting", 41),
                                        ("feature", 20)])
def test_split_lines_and_ledger_match_jax(small, mode, top_k):
    n, f, B, bins, grad, hess = small
    shards = ([(bins, grad, hess)] * 3 if mode == "feature"
              else _row_shards(bins, grad, hess, 3))
    port = _port_group(mode, GrowParams(num_leaves=15, num_bins=B), shards, top_k=top_k)
    jx = _jax_group(mode, shards, num_leaves=15, num_bins=B, top_k=top_k)
    _assert_same_splits(port[0][0], jx[0][0])
    assert [p[1] for p in port] == [j[1] for j in jx]


@pytest.mark.parametrize("mode", ["data", "voting"])
def test_quantized_wire_and_tree_equal_jax(small, mode):
    """Every payload byte for byte (the hist_q planes, the scale maxima,
    the integer root totals, elections, counts), so the merged planes are
    JAX's, and the same tree: gains and leaf values too.  A ballot is the
    same set of features; its order may differ where two local gains tie
    to the last digits (the leaf's local totals are summed in float64
    here, in XLA's float32 order there)."""
    n, f, B, bins, grad, hess = small
    shards = _row_shards(bins, grad, hess, 3)
    port = _port_group(mode, GrowParams(num_leaves=15, num_bins=B), shards, top_k=5,
                       quantized=True)
    jx = _jax_group(mode, shards, num_leaves=15, num_bins=B, top_k=5, quantized=True)
    for (pt, pl, ps), (jt, jl, js) in zip(port, jx):
        assert pl == jl
        assert [p for p, _ in ps] == [p for p, _ in js]
        for (purpose, a), (_, b) in zip(ps, js):
            if purpose == "vote":
                a, b = (sorted(np.frombuffer(x, np.int32)) for x in (a, b))
            assert a == b, purpose
        _assert_same_tree(pt, jt, skip=("leaf_id",))
        np.testing.assert_array_equal(_as_np(pt.leaf_id), jt.leaf_id)
    # the merge of the first histogram payloads, in both packages
    k = [i for i, (p, _) in enumerate(port[0][2]) if p == "hist_q"][2]
    blobs = [rank[2][k][1] for rank in port]
    F = f if mode == "data" else 10  # the root's columns: all, or the 2k elected
    ours, ours_cnt = hostlearner._merge_q(blobs, F, B)
    theirs, theirs_cnt = JHostParallelLearner._merge_q(None, blobs, F, B)
    np.testing.assert_array_equal(ours, theirs)
    assert (ours_cnt is None) == (theirs_cnt is None)


def test_wide_voting_keeps_the_gain_and_cuts_the_payload(wide):
    """At 2,000 features voting with top_k=20 keeps >= 90 % of data mode's
    gain, ships >= 5x fewer histogram bytes (the JAX contract), and its
    ledger is the JAX package's."""
    f, B, shards = wide
    params = GrowParams(num_leaves=7, num_bins=B)
    data = _port_group("data", params, shards)
    vote = _port_group("voting", params, shards, top_k=20)
    gd, gv = data[0][0], vote[0][0]
    assert int(gv.num_splits) > 0
    assert float(np.sum(gv.rec_gain)) >= 0.9 * float(np.sum(gd.rec_gain))
    assert vote[0][1]["hist"] * 5 <= data[0][1]["hist"]
    assert sum(vote[0][1].values()) * 5 <= sum(data[0][1].values())
    jx = _jax_group("voting", shards, num_leaves=7, num_bins=B, top_k=20, row_block=256)
    assert [v[1] for v in vote] == [j[1] for j in jx]
    _assert_same_splits(gv, jx[0][0])


def test_a_failing_rank_does_not_hang_the_group(small):
    n, f, B, bins, grad, hess = small
    shards = _row_shards(bins, grad, hess, 2)
    shards[1] = (shards[1][0][:, :3], shards[1][1], shards[1][2])  # a wrong width
    with pytest.raises(Exception):
        _port_group("data", GrowParams(num_leaves=7, num_bins=B), shards)


# ----------------------------------------------------------------------
# the wire and the block search against the JAX functions
# ----------------------------------------------------------------------
@pytest.mark.parametrize("case", ["int16", "int32", "three_planes", "three_planes_int32"])
def test_pack_hist_q_bytes_equal_jax(case):
    rng = np.random.default_rng(5)
    F, B = 7, 12
    big = 100000 if case.endswith("int32") or case == "int32" else 3000
    planes = rng.integers(-big, big, size=(F, B, 2)).astype(np.int32)
    planes[..., 1] = np.abs(planes[..., 1])
    counts = rng.integers(0, 50, size=(F, B)).astype(np.int32) if "three" in case else None
    blob = qhist.pack_hist_q(planes, counts)
    assert blob == jqhist.pack_hist_q(planes, counts)
    assert len(blob) == F * B * (2 if counts is None else 3) * (4 if big > 32767 else 2)
    back = qhist.unpack_hist_q(blob, F, B)
    np.testing.assert_array_equal(back, jqhist.unpack_hist_q(blob, F, B))
    np.testing.assert_array_equal(back[..., :2], planes)
    scales = np.array([0.013, 0.002], np.float32)
    np.testing.assert_array_equal(
        qhist.assemble_hist(back[..., :2], scales, 777.0, counts=counts),
        jqhist.assemble_hist(back[..., :2], scales, 777.0, counts=counts))
    with pytest.raises(ValueError, match="hist_q payload"):
        qhist.unpack_hist_q(blob[:-2], F, B)


@pytest.mark.parametrize("block", [(0, 5), (5, 12)])
def test_block_split_search_matches_jax_and_the_full_scan(block):
    rng = np.random.default_rng(11)
    F, B = 12, 16
    hist = np.zeros((F, B, 3), np.float32)
    rows = rng.integers(0, B, size=(3000, F))
    g = rng.normal(size=3000).astype(np.float32)
    for j in range(F):
        np.add.at(hist[j, :, 0], rows[:, j], g)
        np.add.at(hist[j, :, 1], rows[:, j], 1.0)
        np.add.at(hist[j, :, 2], rows[:, j], 1.0)
    sg, sh, sc = (np.float32(hist[0, :, i].astype(np.float64).sum()) for i in range(3))
    nb = rng.integers(3, B + 1, size=F)
    db = rng.integers(0, 3, size=F)
    cat = np.zeros(F, bool)
    cat[7] = True
    lo, hi = block
    tmeta = tsplit.FeatureMeta(torch.tensor(nb), torch.tensor(db), torch.tensor(cat))
    jmeta = jsplit.FeatureMeta(jnp.asarray(nb, jnp.int32), jnp.asarray(db, jnp.int32),
                               jnp.asarray(cat))
    tm = tsplit.slice_features(tmeta, lo, hi)
    jm = jsplit.slice_features(jmeta, lo, hi)
    for a, b in zip(tm, jm):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    th = torch.from_numpy(hist)
    s = [torch.tensor([v]) for v in (sg, sh, sc)]
    res = tsplit.best_split_feature_block(th[None, lo:hi], lo, *s, tm, _hyper(5.0),
                                          torch.ones(hi - lo))
    full = tsplit.best_split_per_feature(th[None], *s, tmeta, _hyper(5.0), torch.ones(F))
    fbest = int(res.feature[0])
    assert lo <= fbest < hi
    np.testing.assert_array_equal(res.gain.numpy(), full[0][:, lo:hi].max(dim=1).values.numpy())
    jr = jax.jit(jsplit.best_split_feature_block)(
        jnp.asarray(hist[lo:hi]), jnp.int32(lo), sg, sh, sc, jm, _jhyper(5.0),
        jnp.ones((hi - lo,), jnp.float32))
    assert fbest == int(jr.feature)
    assert int(res.threshold_bin[0]) == int(jr.threshold_bin)
    assert int(res.default_bin_for_zero[0]) == int(jr.default_bin_for_zero)
    np.testing.assert_allclose(float(res.gain[0]), float(jr.gain), rtol=1e-5)


# ----------------------------------------------------------------------
# C1: a parallel tree_learner in one process trains serially
# ----------------------------------------------------------------------
C1_PARAMS = dict(objective="binary", num_leaves=15, min_data_in_leaf=20, verbose=1)


def _conf(d, name, mode):
    """A .conf of the reference's keys training ``train.tsv`` with
    ``tree_learner=mode`` into ``name``.txt."""
    (d / f"{name}.conf").write_text(
        "task = train\nobjective = binary\ndata = train.tsv\nnum_trees = 3\n"
        f"num_leaves = 15\nmin_data_in_leaf = 20\ntree_learner = {mode}\n"
        f"output_model = {name}.txt\n")
    old = os.getcwd()
    os.chdir(d)
    try:
        assert cli.main([f"config={name}.conf", "device=cpu"]) == 0
    finally:
        os.chdir(old)
    return (d / f"{name}.txt").read_text()


@pytest.fixture(scope="module")
def c1_data(tmp_path_factory):
    """3,000 x 6 binary rows, the port's serial model of them, and the
    CLI's serial model of the same rows written as a TSV."""
    rng = np.random.default_rng(0)
    X = rng.standard_normal((3000, 6)).round(4)
    y = (X[:, 0] + 0.5 * X[:, 1] - X[:, 2] * X[:, 3] > 0).astype(np.float32)
    d = tmp_path_factory.mktemp("c1")
    np.savetxt(d / "train.tsv", np.column_stack([y, X]), delimiter="\t", fmt="%g")
    serial = lgt.train(dict(C1_PARAMS), lgt.Dataset(X, label=y), 3, device="cpu")
    return X, y, d, serial.model_to_string(), _conf(d, "serial", "serial")


def _split_lines(text):
    return [ln for ln in text.splitlines()
            if ln.startswith(("Tree=", "num_leaves=", "split_feature=", "threshold=",
                              "decision_type=", "left_child=", "right_child="))]


@pytest.mark.parametrize("mode", ["data", "feature", "voting"])
def test_parallel_learner_in_one_process_trains_serial(c1_data, mode, capsys):
    """The port trains the serial model with the JAX package's warning;
    the JAX package's model of the same mode (its mask grower on the CPU)
    has the same split lines and header, predictions within 3e-3; the
    CLI's model of a .conf with the mode is its serial one."""
    X, y, d, serial_text, cli_serial = c1_data
    params = dict(C1_PARAMS, tree_learner=mode)
    bst = lgt.train(dict(params), lgt.Dataset(X, label=y), 3, device="cpu")
    out = capsys.readouterr().out
    assert (f"tree_learner={mode} requested but only one device is visible; falling back to "
            "serial") in out
    assert "Using partitioned tree learner" in out
    text = bst.model_to_string()
    assert text == serial_text
    jtext = lgb.train(dict(params), lgb.Dataset(X, label=y, params=dict(params)), 3,
                      verbose_eval=False).model_to_string()
    assert _split_lines(text) == _split_lines(jtext)
    assert text.split("Tree=0")[0] == jtext.split("Tree=0")[0]
    np.testing.assert_allclose(bst.predict(X), lgb.Booster(model_str=jtext).predict(X),
                               rtol=3e-3, atol=3e-4)
    capsys.readouterr()
    assert _conf(d, mode, mode) == cli_serial
    assert "falling back to serial" in capsys.readouterr().out


def test_data_learner_out_of_core_streams_serially(c1_data, capsys):
    X, y = c1_data[:2]
    base = dict(C1_PARAMS, out_of_core="true", ooc_chunk_rows=4096)
    ref = lgt.train(dict(base), lgt.Dataset(X, label=y), 2, device="cpu").model_to_string()
    capsys.readouterr()
    text = lgt.train(dict(base, tree_learner="data"), lgt.Dataset(X, label=y), 2,
                     device="cpu").model_to_string()
    assert "only one process is attached; streaming serially" in capsys.readouterr().out
    assert text == ref


@pytest.mark.parametrize("how", ["env", "machine_list"])
def test_several_processes_are_refused(c1_data, how, tmp_path, monkeypatch, capsys):
    """Several processes asked for but not formed: the launcher's process
    count alone (no coordinator) trains serially with the JAX package's
    warning; a machine list whose peer never joins fails loudly, with
    ``CollectiveTimeoutError`` within its bound, and never trains alone."""
    from lightgbm_tpu_torch.parallel import CollectiveTimeoutError, distributed, net

    X, y, _, serial_text, _ = c1_data
    params = dict(C1_PARAMS, tree_learner="voting")
    if how == "env":
        monkeypatch.setenv("LIGHTGBM_TPU_NUM_PROCESSES", "2")
        text = lgt.train(params, lgt.Dataset(X, label=y), 3, device="cpu").model_to_string()
        assert "only one device is visible; falling back to serial" in capsys.readouterr().out
        assert text == serial_text and distributed.process_count() == 1
        return
    ports = []
    for _ in range(2):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        ports.append(s.getsockname()[1])
        s.close()
    (tmp_path / "mlist.txt").write_text("".join(f"127.0.0.1:{p}\n" for p in ports))
    # this process is rank 0 (its listen port), and rank 1 never comes
    params.update(num_machines=2, machine_list_file=str(tmp_path / "mlist.txt"),
                  local_listen_port=ports[0], network_timeout=1.5, network_retries=0)
    t0 = time.monotonic()
    try:
        with pytest.raises(CollectiveTimeoutError, match="rank 1 of 2 did not join"):
            lgt.train(params, lgt.Dataset(X, label=y), 1, device="cpu")
    finally:
        net._reset_for_tests()
    assert time.monotonic() - t0 < 2 * 1.5 + 10
    assert distributed.process_count() == 1


def test_elastic_membership_is_ignored_without_a_runtime(c1_data, capsys):
    X, y, _, serial_text, _ = c1_data
    text = lgt.train(dict(C1_PARAMS, elastic_membership=True), lgt.Dataset(X, label=y), 3,
                     device="cpu").model_to_string()
    assert "elastic_membership=true ignored: no adopted MembershipRuntime" in (
        capsys.readouterr().out)
    assert text == serial_text


@pytest.mark.parametrize("params,match", [
    # tests/test_wide_learners.py:225-241's inputs
    ({"tree_learner": "voting", "out_of_core": "true"}, "out_of_core"),
    ({"tree_learner": "feature", "out_of_core": "true"}, "out_of_core"),
    ({"top_k": 0}, "top_k"),
])
def test_config_refusals_match_jax(params, match):
    from lightgbm_tpu.config import Config as JConfig
    from lightgbm_tpu.utils.log import LightGBMError as JError

    with pytest.raises(LightGBMError, match=match):
        Config.from_params(params)
    with pytest.raises(JError, match=match):
        JConfig.from_params(params)
    # auto stays allowed: the router resolves it
    assert Config.from_params({"tree_learner": "voting"}).tree_learner == "voting"
    cfg = Config.from_params({"tree_learner_type": "voting", "topk": 7})
    assert cfg.tree_learner == "voting" and cfg.top_k == 7
