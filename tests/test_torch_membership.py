"""The port's live elastic membership in process (lightgbm_tpu_torch/
parallel/membership.py and the seams of boosting/gbdt.py), held against
the JAX package's parallel/membership.py where that runs in process.

- ``FileKVClient``: round trip and key encoding, a timed-out get whose
  error ``net._is_deadline_error`` classifies (``DEADLINE_EXCEEDED``),
  the exclusive ``try_create``, directory gets and prefix deletes, the
  get that does not wait, and one package's files read by the other's;
- ``MemberWatch`` over sparse member ids and the port's one heartbeat key
  a member;
- ``MembershipRuntime.sync`` with no churn, with a leave, a join and the
  commit, and with an eviction and the coordinator's re-election: each
  scenario runs on both packages' runtimes and the decisions are equal;
  ids are monotonic and never reused;
- the training seams: query-grouped data refused, an evicted member's
  shard rebuilt from the live rebalance plan, the rollback of a partly
  grown iteration restoring the boundary bit for bit (multiclass, and a
  quantized elastic member with its quantization counter), a fleet of one
  with ``elastic_membership`` against the same run without it;
- the epoch seams: the uid layout against the JAX ``net.epoch_uid``,
  ``collect.set_epoch``, ``Comm.epoch``, ``current_epoch`` (0 unarmed,
  the runtime's epoch armed), ``runtime_from_env`` and
  ``MembershipComm``'s ledger.
"""

import os
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax._src.core

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.parallel import collect, distributed, membership, net
from lightgbm_tpu_torch.parallel.membership import (FileKVClient, MembershipComm,
                                                    MembershipRuntime, MemberWatch)
from lightgbm_tpu_torch.utils.log import LightGBMError

pytestmark = pytest.mark.membership


@pytest.fixture(scope="module", autouse=True)
def jax_shim_and_one_thread():
    """jax 0.9 moved ``trace_state_clean`` out of ``jax.core``, where the
    JAX package's compile watch imports it from; one torch intra-op thread."""
    had = hasattr(jax.core, "trace_state_clean")
    if not had:
        jax.core.trace_state_clean = jax._src.core.trace_state_clean
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    if not had:
        del jax.core.trace_state_clean


@pytest.fixture
def calm_net(monkeypatch):
    """A short deadline for the in-process protocols (set before any
    runtime reads it), reset after."""
    monkeypatch.setenv("LIGHTGBM_TPU_NET_TIMEOUT", "8")
    net._reset_for_tests()
    yield
    net._reset_for_tests()


def _jmembership():
    from lightgbm_tpu.parallel import membership as jm

    return jm


# ----------------------------------------------------------------------
# FileKVClient
# ----------------------------------------------------------------------
def test_filekv_roundtrip_and_encoding(tmp_path):
    kv = FileKVClient(str(tmp_path / "kv"))
    kv.key_value_set_bytes("a/b", b"\x00\x01binary\xff")
    assert kv.blocking_key_value_get_bytes("a/b", 500) == b"\x00\x01binary\xff"
    kv.key_value_set("plain", "text")
    assert kv.blocking_key_value_get("plain", 500) == "text"
    kv.key_value_set_bytes("tiny", b"x")
    assert kv.blocking_key_value_get_bytes("tiny", 500) == b"x"
    kv.key_value_set_bytes("empty", b"")
    assert kv.blocking_key_value_get_bytes("empty", 500) == b""
    # hostile key components are percent-encoded, one path segment each
    kv.key_value_set_bytes("we ird/%41/..", b"v")
    assert kv.blocking_key_value_get_bytes("we ird/%41/..", 500) == b"v"
    kv.key_value_set_bytes("a/b", b"again")  # a set overwrites
    assert kv.key_value_try_get("a/b") == b"again"
    assert not [n for n in os.listdir(tmp_path / "kv" / "a") if n.startswith(".tmp")]


def test_filekv_blocking_get_times_out_as_a_deadline(tmp_path):
    kv = FileKVClient(str(tmp_path / "kv"))
    t0 = time.monotonic()
    with pytest.raises(Exception, match="DEADLINE_EXCEEDED") as ei:
        kv.blocking_key_value_get_bytes("never", 200)
    assert 0.15 < time.monotonic() - t0 < 5.0
    assert net._is_deadline_error(ei.value)


def test_filekv_try_get_does_not_wait(tmp_path):
    kv = FileKVClient(str(tmp_path / "kv"))
    t0 = time.monotonic()
    assert kv.key_value_try_get("absent/key") is None
    assert time.monotonic() - t0 < 0.5
    kv.key_value_set("present", "7")
    assert kv.key_value_try_get("present") == b"7"


def test_filekv_try_create_is_exclusive(tmp_path):
    kv = FileKVClient(str(tmp_path / "kv"))
    assert kv.try_create("members/0", b"1") is True
    assert kv.try_create("members/0", b"2") is False
    assert kv.blocking_key_value_get_bytes("members/0", 500) == b"1"


def test_filekv_dir_get_and_prefix_delete(tmp_path):
    kv = FileKVClient(str(tmp_path / "kv"))
    for i in range(3):
        kv.key_value_set_bytes(f"hb/7/{i}", str(i).encode())
    kv.key_value_set_bytes("hb/9/0", b"0")
    assert {k for k, _v in kv.key_value_dir_get("hb/")} == {"hb/7/0", "hb/7/1", "hb/7/2",
                                                            "hb/9/0"}
    kv.key_value_delete("hb/7/")
    assert {k for k, _v in kv.key_value_dir_get("hb/")} == {"hb/9/0"}
    kv.key_value_delete("hb/9/0")
    assert kv.key_value_dir_get("hb/") == []
    assert kv.key_value_dir_get("nothing/") == []


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_filekv_files_cross_packages(tmp_path, writer):
    jm = _jmembership()
    ours, theirs = FileKVClient(str(tmp_path)), jm.FileKVClient(str(tmp_path))
    w, r = (ours, theirs) if writer == "port" else (theirs, ours)
    w.key_value_set_bytes("epoch/0", b'{"members": [0, 1]}')
    assert w.try_create("members/.3", b"1")
    w.key_value_set("intent/join/4", "1")
    assert r.blocking_key_value_get_bytes("epoch/0", 500) == b'{"members": [0, 1]}'
    assert not r.try_create("members/.3", b"2")
    assert sorted(r.key_value_dir_get("intent/")) == [("intent/join/4", "1")]


# ----------------------------------------------------------------------
# MemberWatch
# ----------------------------------------------------------------------
def test_memberwatch_sparse_ids_and_eviction(tmp_path):
    kv = FileKVClient(str(tmp_path / "kv"))
    clock = [0.0]
    watch = MemberWatch(kv, member_id=0, members=(0, 3, 7), stale_after_s=10.0,
                        time_fn=lambda: clock[0])
    assert isinstance(watch, net.PeerWatch)
    kv.key_value_set(f"{net._HB_DIR}3", "1")
    kv.key_value_set(f"{net._HB_DIR}7", "1")
    assert watch.dead_ranks() == []
    clock[0] = 8.0  # member 7 freezes; member 3 keeps beating
    kv.key_value_set(f"{net._HB_DIR}3", "2")
    assert watch.dead_ranks() == []
    clock[0] = 15.0  # 7 frozen 15 s, 3 beat 7 s ago
    assert watch.dead_ranks() == [7]
    with pytest.raises(net.PeerFailureError) as ei:
        watch.check("test")
    assert ei.value.ranks == (7,)
    # a transition drops 7 from the roster; its bookkeeping goes too
    watch.set_members((0, 3, 9))
    kv.key_value_set(f"{net._HB_DIR}9", "1")
    assert watch.dead_ranks() == [] and 7 not in watch._seen


def test_heartbeat_writer_on_the_file_store(tmp_path):
    kv = FileKVClient(str(tmp_path / "kv"))
    hb = net.HeartbeatWriter(kv, 5, interval_s=0.05)
    hb.start()
    try:
        first = kv.key_value_try_get(f"{net._HB_DIR}5")
        time.sleep(0.3)
        assert kv.key_value_try_get(f"{net._HB_DIR}5") != first
    finally:
        hb.stop()
    assert kv.key_value_try_get(f"{net._HB_DIR}5") is None  # a clean stop removes it


# ----------------------------------------------------------------------
# the sync and commit protocol, on both packages' runtimes
# ----------------------------------------------------------------------
def _run_threads(fns, timeout=60):
    out, errs = [None] * len(fns), []

    def run(i):
        try:
            out[i] = fns[i]()
        except BaseException as e:  # noqa: BLE001 - surfaced below
            errs.append(e)

    ts = [threading.Thread(target=run, args=(i,), daemon=True) for i in range(len(fns))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout)
        assert not t.is_alive(), "a runtime thread did not finish in time"
    if errs:
        raise errs[0]
    return out


def _trio(mod, root):
    rts = [mod.MembershipRuntime(str(root), m) for m in range(3)]
    _run_threads([lambda rt=rt: rt.bootstrap(3, (200, 200, 200)) for rt in rts])
    return rts


def _decision(d):
    return None if d is None else (d.leavers, d.dead, d.joiners, d.participants,
                                   d.new_members, d.survivors)


def _scenario_no_churn(mod, root):
    rts = _trio(mod, root)
    try:
        out = _run_threads([rt.sync for rt in rts])
        assert [rt.epoch for rt in rts] == [0, 0, 0]
        return [_decision(d) for d in out]
    finally:
        for rt in rts:
            rt.stop()


def _scenario_leave_join(mod, root):
    rts = _trio(mod, root)
    joiner = mod.MembershipRuntime(str(root))
    try:
        rts[1].request_leave()
        jt = threading.Thread(target=joiner.join, kwargs={"timeout_s": 60}, daemon=True)
        jt.start()
        while not joiner.client.key_value_dir_get("intent/join/"):
            time.sleep(0.01)
        decisions = _run_threads([rt.sync for rt in rts])
        for rt, d in zip(rts, decisions):
            rt.commit_epoch(d, (200, 200, 200), iteration=4, num_data=600,
                            handoff_bytes=b"handoff-bytes" if rt.id == min(d.new_members)
                            else None)
        jt.join(30)
        assert not jt.is_alive()
        assert joiner.joined_mid_run and joiner.id == 3 and joiner.epoch == 1
        assert joiner.members == (0, 2, 3) and joiner.start_iter == 4
        assert joiner.read_handoff() == b"handoff-bytes"
        assert [rt.epoch for rt in rts] == [1, 1, 1]
        assert joiner.client.key_value_dir_get("intent/join/") == []  # consumed
        return [_decision(d) for d in decisions]
    finally:
        for rt in rts + [joiner]:
            rt.stop()


def _scenario_evict(mod, root):
    rts = _trio(mod, root)
    try:
        rts[0].stop()  # the coordinator's heartbeat stops
        decisions = _run_threads([lambda rt=rt: rt.sync(known_dead=(0,)) for rt in rts[1:]])
        for rt, d in zip(rts[1:], decisions):
            rt.commit_epoch(d, (300, 300), iteration=2, num_data=600)
        # re-election by construction: the lowest surviving id
        assert rts[1].is_coordinator and not rts[2].is_coordinator
        assert rts[1].members == (1, 2) and rts[1].epoch == 1
        assert (rts[1].rank, rts[2].rank) == (0, 1)
        return [_decision(d) for d in decisions]
    finally:
        for rt in rts:
            rt.stop()


SCENARIOS = {
    "no_churn": (_scenario_no_churn, [None, None, None]),
    "leave_join": (_scenario_leave_join,
                   [((1,), (), (3,), (0, 1, 2), (0, 2, 3), (0, 2))] * 3),
    "evict_reelect": (_scenario_evict, [((), (0,), (), (1, 2), (1, 2), (1, 2))] * 2),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_sync_decisions_equal_jax(tmp_path, calm_net, name):
    fn, want = SCENARIOS[name]
    ours = fn(membership, tmp_path / "port")
    assert ours == want
    assert fn(_jmembership(), tmp_path / "jax") == ours


def test_member_ids_are_monotonic_never_reused(tmp_path, calm_net):
    rts = _trio(membership, tmp_path)
    try:
        j1, j2 = MembershipRuntime(str(tmp_path)), MembershipRuntime(str(tmp_path))
        for j in (j1, j2):
            i = 0
            while not j.client.try_create(f"members/{i}", b"1"):
                i += 1
            j.id = i
        assert (j1.id, j2.id) == (3, 4)
    finally:
        for rt in rts:
            rt.stop()


def test_comm_allgather_is_scoped_to_the_epoch(tmp_path, calm_net):
    """Two members allgather through ``MembershipComm``: each sees both
    blobs in rank order, the ledger counts its own bytes by purpose, and
    the transport's time goes on the wait clock."""
    rts = [MembershipRuntime(str(tmp_path), m) for m in range(2)]
    _run_threads([lambda rt=rt: rt.bootstrap(2, (5, 5)) for rt in rts])
    try:
        comms = [MembershipComm(rt) for rt in rts]
        net.wait_clock_drain()
        out = _run_threads([lambda c=c, r=r: c.allgather(bytes([r]) * 3, "hist")
                            for r, c in enumerate(comms)])
        assert out == [[b"\x00" * 3, b"\x01" * 3]] * 2
        assert [c.ledger for c in comms] == [{"hist": 3}, {"hist": 3}]
        assert [(c.rank, c.nproc, c.epoch) for c in comms] == [(0, 2, 0), (1, 2, 0)]
        assert net.wait_clock_drain() > 0.0
        keys = [k for k, _v in rts[0].client.key_value_dir_get(net._COLLECT_DIR)]
        assert keys and all(net.uid_epoch(int(k.split("/")[1])) == 0 for k in keys)
    finally:
        for rt in rts:
            rt.stop()


# ----------------------------------------------------------------------
# the training seams
# ----------------------------------------------------------------------
@pytest.fixture
def armed(tmp_path, calm_net):
    """A fleet of one member over ``rows`` rows, armed for the booster."""
    made = []

    def make(X, y, rows=None):
        rt = MembershipRuntime(str(tmp_path / "fleet"), 0)
        rt.bootstrap(1, (len(y) if rows is None else rows,))
        rt.row_provider = lambda lo, hi: (X[lo:hi], y[lo:hi])
        membership.set_runtime(rt)
        made.append(rt)
        return rt

    yield make
    membership.set_runtime(None)
    for rt in made:
        rt.stop()


def test_membership_rejects_query_grouped_data(armed):
    rng = np.random.default_rng(5)
    X = rng.integers(0, 5, size=(120, 4)).astype(np.float32)
    y = rng.integers(0, 3, size=120).astype(np.float32)
    armed(X, y)
    p = dict(objective="lambdarank", tree_learner="data", pre_partition=True,
             elastic_membership=True, num_leaves=5, verbose=-1)
    with pytest.raises(LightGBMError, match="query"):
        lgt.train(p, lgt.Dataset(X, label=y, group=[30, 40, 50]), 2, device="cpu")


def test_membership_synthesize_uses_live_rebalance_plan(armed):
    """An evicted member's rows come from the live layout: after a
    rebalance the epoch record's counts are stale."""
    import zlib

    from lightgbm_tpu_torch.parallel.shardplan import ShardPlan

    rng = np.random.default_rng(9)
    X = rng.integers(0, 5, size=(600, 6)).astype(np.float32)
    y = (rng.random(600) < 0.5).astype(np.float32)
    rt = armed(X, y)
    p = dict(objective="binary", tree_learner="data", pre_partition=True,
             elastic_membership=True, num_leaves=5, min_data_in_leaf=20,
             boost_from_average=False, verbose=-1)
    g = lgt.train(p, lgt.Dataset(X, label=y), 3, device="cpu").boosting
    assert g._membership is rt

    def crc_label(lo):
        lab = y[lo:].astype(np.asarray(g.train_set.metadata.label).dtype)
        return zlib.crc32(np.ascontiguousarray(lab).tobytes()) & 0xFFFFFFFF

    rt.members, rt.counts = (0, 1), (360, 240)  # a fleet of two, by its record
    own = g._membership_capture()
    stale = g._membership_synthesize(1, own)
    assert stale.meta["num_data"] == 240
    assert stale.meta["data_fingerprint_parts"]["crc_label"] == crc_label(360)
    g._rebalance = {"plan": ShardPlan.from_counts((200, 400)), "ctl": None, "rank": 0,
                    "group_bounds": None}
    live = g._membership_synthesize(1, own)
    assert live.meta["num_data"] == 400
    assert live.meta["data_fingerprint_parts"]["crc_label"] == crc_label(200)
    assert live.arrays["scores"].shape == (1, 400)
    # rows [360, 600) are in both: the replay is per row
    assert np.array_equal(live.arrays["scores"][:, 160:], stale.arrays["scores"])
    # and the replay is the scores the member holds for its own rows
    replay = g._membership_replay_scores(np.asarray(g.train_set.binned))
    assert replay.tobytes() == g.scores.cpu().numpy().tobytes()


def test_rollback_restores_the_multiclass_boundary_bitwise(monkeypatch):
    """A multiclass iteration rolled back (fl(fl(a+v)-v) is not a), then
    replayed: the model is the uninterrupted run's."""
    monkeypatch.setenv("LIGHTGBM_TPU_PGROW", "0")  # the mask grower, as a member runs
    rng = np.random.default_rng(17)
    X = rng.integers(0, 6, size=(400, 5)).astype(np.float32)
    y = rng.integers(0, 3, size=400).astype(np.float32)
    p = dict(objective="multiclass", num_class=3, num_leaves=6, min_data_in_leaf=15,
             learning_rate=0.2, seed=3, verbose=-1)
    ref = lgt.Booster(params=dict(p), train_set=lgt.Dataset(X, label=y), device="cpu")
    for _ in range(6):
        ref.update()
    bst = lgt.Booster(params=dict(p), train_set=lgt.Dataset(X, label=y), device="cpu")
    for _ in range(4):
        bst.update()
    g = bst.boosting
    assert g.ptrainer is None
    g._member_iter_snapshot = g._membership_snapshot()
    boundary = g.scores.cpu().numpy().copy()
    n_models = len(g.models)
    bst.update()
    assert len(g.models) > n_models
    g._membership_rollback_partial()
    g.iter -= 1  # the real path fails before the boundary counts it
    assert len(g.models) == n_models
    assert g.scores.cpu().numpy().tobytes() == boundary.tobytes()
    for _ in range(2):
        bst.update()
    assert bst.model_to_string() == ref.model_to_string()


def test_rollback_restores_a_quantized_members_counter(armed):
    """A quantized elastic member: the rollback puts the learner's
    rounding counter back too, so the replayed tree rounds as before."""
    from lightgbm_tpu_torch.factory.member_worker import make_data

    X, y = make_data(600, 10, 5)
    p = dict(objective="binary", tree_learner="data", pre_partition=True,
             elastic_membership=True, num_leaves=7, learning_rate=0.2, max_bin=31,
             min_data_in_leaf=20, boost_from_average=False, quantized_training=True,
             seed=7, verbose=-1)
    armed(X, y)
    ref = lgt.Booster(params=dict(p), train_set=lgt.Dataset(X, label=y), device="cpu")
    for _ in range(5):
        ref.update()
    bst = lgt.Booster(params=dict(p), train_set=lgt.Dataset(X, label=y), device="cpu")
    for _ in range(3):
        bst.update()
    g = bst.boosting
    snap = g._membership_snapshot()
    assert snap["qiter"] == 2
    g._member_iter_snapshot = snap
    bst.update()
    g._membership_rollback_partial()
    g.iter -= 1
    assert g.learner._qiter == 2
    for _ in range(2):
        bst.update()
    assert bst.model_to_string() == ref.model_to_string()


def _split_lines(text):
    return [ln for ln in text.splitlines()
            if ln.startswith(("Tree=", "num_leaves=", "split_feature=", "threshold=",
                              "decision_type=", "left_child=", "right_child=", "leaf_value="))]


def test_elastic_key_without_a_runtime_equals_it_off(armed, capsys, monkeypatch):
    """``elastic_membership=true`` with no runtime warns and trains the
    model of the key off; armed, a fleet of one runs the data-parallel
    host learner over ``MembershipComm``, whose splits and leaf values are
    the serial grower's (its quantized leaf counts are the host learner's
    exact counts, which the serial grower derives from the hessians)."""
    from lightgbm_tpu_torch.factory.member_worker import make_data
    from lightgbm_tpu_torch.parallel import HostParallelLearner
    from lightgbm_tpu_torch.utils.log import Log

    monkeypatch.setattr(Log, "_level", 1)
    X, y = make_data(600, 10, 5)
    p = dict(objective="binary", tree_learner="data", pre_partition=True, num_leaves=7,
             learning_rate=0.2, max_bin=31, min_data_in_leaf=20, boost_from_average=False,
             quantized_training=True, seed=7, verbose=0)
    off = lgt.train(dict(p), lgt.Dataset(X, label=y), 4, device="cpu").model_to_string()
    capsys.readouterr()
    unarmed = lgt.train(dict(p, elastic_membership=True), lgt.Dataset(X, label=y), 4,
                        device="cpu")
    assert "elastic_membership=true ignored: no adopted MembershipRuntime" in \
        capsys.readouterr().out
    assert unarmed.boosting._membership is None
    assert unarmed.model_to_string().split("parameters:")[0] == off.split("parameters:")[0]
    armed(X, y)
    on = lgt.train(dict(p, elastic_membership=True), lgt.Dataset(X, label=y), 4,
                   device="cpu")
    g = on.boosting
    assert g._membership is not None and isinstance(g.learner, HostParallelLearner)
    assert isinstance(g.learner.comm, MembershipComm) and g.learner.comm.ledger["hist_q"] > 0
    assert _split_lines(on.model_to_string()) == _split_lines(off)


# ----------------------------------------------------------------------
# the epoch seams
# ----------------------------------------------------------------------
@pytest.mark.parametrize("epoch,seq,ns", [(7, (3 << 16) | 0xBEEF, 1 << 58), (0, 5, 0),
                                          ((1 << 18) - 1, 1, 1 << 60)])
def test_epoch_uid_layout_equals_jax(epoch, seq, ns):
    from lightgbm_tpu.parallel import net as jnet

    uid = net.epoch_uid(epoch, seq, ns=ns)
    assert uid == jnet.epoch_uid(epoch, seq, ns=ns)
    assert net.uid_epoch(uid) == epoch == jnet.uid_epoch(uid)


def test_epoch_uid_refuses_a_wide_epoch():
    assert net.uid_epoch(12345) == 0
    with pytest.raises(ValueError):
        net.epoch_uid(1 << 30, 0)


def test_collect_epoch_scoping_never_reuses_uids():
    prev_epoch, prev_uid = collect._kv_epoch, collect._kv_uid
    try:
        collect.set_epoch(0)
        a = net.epoch_uid(collect._kv_epoch, next(collect._kv_uid))
        collect.set_epoch(3)
        b = net.epoch_uid(collect._kv_epoch, next(collect._kv_uid))
        assert net.uid_epoch(b) == 3 and b != a
        seq = next(collect._kv_uid)
        collect.set_epoch(3)  # the same epoch again keeps the sequence
        assert next(collect._kv_uid) == seq + 1
    finally:
        collect._kv_epoch, collect._kv_uid = prev_epoch, prev_uid


def test_current_epoch_is_zero_unarmed_and_the_runtimes_armed(tmp_path, calm_net):
    from lightgbm_tpu_torch.parallel.comm import Comm, LocalComm, LocalGroup

    assert membership.runtime() is None and distributed.current_epoch() == 0
    assert Comm.epoch == 0 and LocalComm(0, LocalGroup(2)).epoch == 0
    rt = MembershipRuntime(str(tmp_path), 0)
    try:
        rt.bootstrap(1, (10,))
        rt.epoch = 4
        membership.set_runtime(rt)
        assert distributed.current_epoch() == 4 == MembershipComm(rt).epoch
    finally:
        membership.set_runtime(None)
        rt.stop()
    assert distributed.current_epoch() == 0


def test_runtime_from_env(tmp_path, monkeypatch):
    monkeypatch.delenv("LIGHTGBM_TPU_MEMBER_DIR", raising=False)
    assert membership.runtime_from_env() is None
    monkeypatch.setenv("LIGHTGBM_TPU_MEMBER_DIR", str(tmp_path))
    monkeypatch.setenv("LIGHTGBM_TPU_MEMBER_ID", "5")
    rt = membership.runtime_from_env()
    assert rt.id == 5 and rt.root == str(tmp_path) and rt.epoch == -1
    monkeypatch.delenv("LIGHTGBM_TPU_MEMBER_ID")
    assert membership.runtime_from_env().id is None
