"""The port's bounded transport (lightgbm_tpu_torch/parallel/net.py) on the
CPU, after the JAX package's tests/test_net.py: settings and the env,
the backoff schedule and retries, the fault spec, the heartbeat writer
and the peer watch, the bounded ``kv_gather`` (rank order, an empty
blob, the lazy GC of the previous uid and its chunks, a dead peer
classified within its budget, a live silent peer as a timeout, an
unreachable store as the coordinator's death) and the watchdog.

Each case runs against an in-memory fake of the store (a TCPStore's
semantics: a set overwrites, a delete removes one key, a get of a
missing key times out) and the gather cases also against a real
``torch.distributed.TCPStore`` in this process (``StoreClient``, its
server on 127.0.0.1).  The pure functions are held against the JAX
package's on the same inputs: the settings' defaults,
``backoff_schedule``, ``parse_fault_spec`` and ``epoch_uid``.
"""

import gc
import itertools
import socket
import threading
import time

import pytest

from lightgbm_tpu.parallel import net as jnet

from lightgbm_tpu_torch import cli, parallel
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.parallel import net
from lightgbm_tpu_torch.utils.log import LightGBMError


class FakeClient:
    """The store's three operations in memory, with a TCPStore's
    semantics: a set overwrites, a delete removes one key, a get of a
    missing key sleeps its timeout and raises DEADLINE_EXCEEDED."""

    def __init__(self):
        self.store = {}
        self.deleted = []
        self.lock = threading.Lock()

    def key_value_set(self, key, val):
        self.key_value_set_bytes(key, val.encode())

    def key_value_set_bytes(self, key, val):
        with self.lock:
            self.store[key] = bytes(val)

    def blocking_key_value_get_bytes(self, key, timeout_ms):
        deadline = time.monotonic() + timeout_ms / 1e3
        while True:
            with self.lock:
                if key in self.store:
                    return self.store[key]
            if time.monotonic() >= deadline:
                raise net.StoreDeadline(f"DEADLINE_EXCEEDED: {key}")
            time.sleep(0.001)

    def key_value_delete(self, key):
        with self.lock:
            self.deleted.append(key)
            self.store.pop(key, None)

    def key_value_try_get(self, key):
        with self.lock:
            return self.store.get(key)


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class RealStore:
    """A TCPStore server in this process and one client connection a
    rank, each with the FakeClient's view of the keys it holds."""

    def __init__(self, nproc=2):
        self.port = _free_port()
        self.master = net.StoreClient("127.0.0.1", self.port, is_master=True, world_size=nproc,
                                      timeout_s=5)
        self.clients = [self.master] + [self.master.connect() for _ in range(nproc - 1)]

    def has(self, key):
        try:
            self.master.blocking_key_value_get_bytes(key, 1)
            return True
        except net.StoreDeadline:
            return False

    def stop(self):
        """Shut the server down (as the coordinator's death would)."""
        self.clients = self.clients[1:]
        self.master = None
        gc.collect()


@pytest.fixture(autouse=True)
def _fresh_settings(monkeypatch):
    for var, _ in net._ENV_FIELDS.values():
        monkeypatch.delenv(var, raising=False)
    for var in ("LIGHTGBM_TPU_FAULT", "LIGHTGBM_TPU_FAULT_RANK", "LIGHTGBM_TPU_KV_CHUNK"):
        monkeypatch.delenv(var, raising=False)
    net._reset_for_tests()
    jnet._reset_for_tests()
    yield
    net._reset_for_tests()
    jnet._reset_for_tests()


# ----------------------------------------------------------------------
class TestSettings:
    def test_defaults_equal_jax(self):
        s, j = net.settings(), jnet.settings()
        assert (s.deadline_s, s.retries, s.backoff_base_s, s.backoff_max_s) == (
            j.deadline_s, j.retries, j.backoff_base_s, j.backoff_max_s)
        assert (s.stale_after(), s.hb_interval(), s.poll_s()) == (
            j.stale_after(), j.hb_interval(), j.poll_s())
        assert s.deadline_s == 120.0 and s.hb_interval() == 5.0

    def test_env_overrides(self, monkeypatch):
        monkeypatch.setenv("LIGHTGBM_TPU_NET_TIMEOUT", "8")
        monkeypatch.setenv("LIGHTGBM_TPU_NET_RETRIES", "1")
        net._reset_for_tests()
        s = net.settings()
        assert s.deadline_s == 8.0 and s.retries == 1
        assert s.hb_interval() == 2.0 and s.stale_after() == 8.0

    def test_config_param_applies_but_env_wins(self, monkeypatch):
        cfg = Config.from_params({"network_timeout": 30, "network_retries": 5})
        net.configure_from_config(cfg)
        assert net.settings().deadline_s == 30.0 and net.settings().retries == 5
        monkeypatch.setenv("LIGHTGBM_TPU_NET_TIMEOUT", "7")
        net._reset_for_tests()
        net.configure_from_config(cfg)
        assert net.settings().deadline_s == 7.0 and net.settings().retries == 5

    def test_config_rejects_bad_values_and_configure_unknown(self):
        with pytest.raises(LightGBMError, match="network_timeout"):
            Config.from_params({"network_timeout": 0})
        with pytest.raises(TypeError, match="unknown net setting"):
            net.configure(nonsense=1)


class TestBackoff:
    @pytest.mark.parametrize("args", [(5, 0.1, 0.4), (0, 0.1, 0.4), (3, 0.25, 5.0),
                                      (8, 0.1, 1.0)])
    def test_schedule_equals_jax(self, args):
        assert net.backoff_schedule(*args) == jnet.backoff_schedule(*args)
        assert net.backoff_schedule(5, 0.1, 0.4) == [0.1, 0.2, 0.4, 0.4, 0.4]

    def test_retry_succeeds_after_failures(self):
        net.configure(backoff_base_s=0.001, backoff_max_s=0.002)
        calls = []

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise OSError("transient")
            return "ok"

        assert net.retry_call(flaky, "unit") == "ok" and len(calls) == 3

    def test_exhaustion_raises_typed_timeout_with_cause(self):
        net.configure(retries=2, backoff_base_s=0.001, backoff_max_s=0.002)

        def dead():
            raise OSError("always down")

        with pytest.raises(net.CollectiveTimeoutError) as ei:
            net.retry_call(dead, "unit")
        assert isinstance(ei.value.__cause__, OSError) and ei.value.elapsed_s >= 0.0

    def test_deadline_caps_the_schedule(self):
        net.configure(backoff_base_s=0.2, backoff_max_s=5.0)
        t0 = time.monotonic()
        with pytest.raises(net.CollectiveTimeoutError):
            net.retry_call(lambda: 1 / 0, "unit", retries=50, deadline_s=0.05,
                           retry_on=(ZeroDivisionError,))
        assert time.monotonic() - t0 < 1.0


class TestFaultSpec:
    @pytest.mark.parametrize("spec", ["die:3", "drop_collective:2,delay:25", "delay:40:after:3",
                                      " delay:5 , die:7 ", "DIE:2"])
    def test_parse_equals_jax(self, spec):
        assert net.parse_fault_spec(spec) == jnet.parse_fault_spec(spec)

    @pytest.mark.parametrize("spec,match", [("explode:1", "unknown fault kind"),
                                            ("die:soon", "bad fault argument"),
                                            ("die", "1-based"),
                                            ("delay:5:after:0", "1-based"),
                                            ("die:1:2", "bad fault argument")])
    def test_rejects_like_jax(self, spec, match):
        with pytest.raises(ValueError, match=match):
            net.parse_fault_spec(spec)
        with pytest.raises(ValueError, match=match):
            jnet.parse_fault_spec(spec)

    def test_delay_fault_applies_and_scales(self, monkeypatch):
        monkeypatch.setenv("LIGHTGBM_TPU_FAULT", "delay:30")
        net._reset_for_tests()
        t0 = time.monotonic()
        net.fault_point()
        assert time.monotonic() - t0 >= 0.025
        net.set_delay_scale(0.0)
        t0 = time.monotonic()
        net.fault_point()
        assert time.monotonic() - t0 < 0.02 and net.delay_scale() == 0.0

    def test_delay_after_and_fault_rank_gate(self, monkeypatch):
        monkeypatch.setenv("LIGHTGBM_TPU_FAULT", "delay:40:after:2")
        net._reset_for_tests()
        t0 = time.monotonic()
        net.fault_point()  # call 1: not armed yet
        assert time.monotonic() - t0 < 0.03
        t0 = time.monotonic()
        net.fault_point()  # call 2: armed
        assert time.monotonic() - t0 >= 0.035
        monkeypatch.setenv("LIGHTGBM_TPU_FAULT_RANK", "1")  # this process is rank 0
        net._reset_for_tests()
        t0 = time.monotonic()
        net.fault_point()
        net.fault_point()
        assert time.monotonic() - t0 < 0.03

    def test_bad_spec_is_ignored_not_fatal(self, monkeypatch):
        monkeypatch.setenv("LIGHTGBM_TPU_FAULT", "explode:1")
        net._reset_for_tests()
        net.fault_point()

    @pytest.mark.parametrize("epoch,seq,ns", [(0, 0, 0), (0, 17, 0), (3, 5, 0),
                                              (1, 2, 1 << 60), ((1 << 18) - 1, 9, 0)])
    def test_epoch_uid_equals_jax(self, epoch, seq, ns):
        uid = net.epoch_uid(epoch, seq, ns)
        assert uid == jnet.epoch_uid(epoch, seq, ns)
        assert net.uid_epoch(uid) == jnet.uid_epoch(uid) == epoch
        with pytest.raises(ValueError):
            net.epoch_uid(1 << 18, 0)

    def test_wait_clock(self):
        net.wait_clock_add(0.25)
        net.wait_clock_add(-1.0)  # never negative
        assert net.wait_clock_drain() == 0.25 and net.wait_clock_drain() == 0.0


# ----------------------------------------------------------------------
class TestPeerWatch:
    def test_heartbeat_change_resets_age(self):
        c = FakeClient()
        clock = [0.0]
        w = net.PeerWatch(c, rank=0, nproc=2, stale_after_s=5.0, time_fn=lambda: clock[0])
        c.key_value_set("ltpu_hb/1", "1")
        assert w.dead_ranks() == []
        clock[0] = 4.0
        assert w.dead_ranks() == []
        clock[0] = 6.0  # frozen for > 5 s of observation
        assert w.dead_ranks() == [1]
        c.key_value_set("ltpu_hb/1", "2")  # a beat
        assert w.dead_ranks() == []
        assert w.ages() == {1: 0.0}

    def test_a_busy_store_does_not_hide_a_dead_peer(self):
        """A timed get on a busy store can time out on a key that exists;
        the sweep reads without waiting, so a frozen key never flaps to
        absent (which would read as a beat) and the dead peer shows."""
        class Busy(FakeClient):
            def blocking_key_value_get_bytes(self, key, timeout_ms):
                raise net.StoreDeadline(f"DEADLINE_EXCEEDED: {key}")

        c = Busy()
        clock = [0.0]
        w = net.PeerWatch(c, rank=0, nproc=2, stale_after_s=1.0, time_fn=lambda: clock[0])
        c.key_value_set("ltpu_hb/1", "7")
        for t in (0.0, 0.5, 1.0):
            clock[0] = t
            assert w.dead_ranks() == []
        clock[0] = 1.5
        assert w.dead_ranks() == [1]

    def test_never_started_peer_times_out_from_watch_start(self):
        c = FakeClient()
        clock = [0.0]
        w = net.PeerWatch(c, rank=0, nproc=3, stale_after_s=2.0, time_fn=lambda: clock[0])
        assert w.dead_ranks() == []
        clock[0] = 3.0
        assert w.dead_ranks() == [1, 2]

    def test_check_raises_typed_error_with_ranks(self):
        clock = [0.0]
        w = net.PeerWatch(FakeClient(), rank=0, nproc=2, stale_after_s=1.0,
                          time_fn=lambda: clock[0])
        clock[0] = 2.0
        with pytest.raises(net.PeerFailureError) as ei:
            w.check("unit", elapsed_s=2.0)
        assert ei.value.ranks == (1,) and ei.value.elapsed_s == 2.0

    def test_unreachable_store_is_coordinator_failure(self):
        class DownClient(FakeClient):
            def key_value_try_get(self, key):
                raise RuntimeError("Broken pipe")

        w = net.PeerWatch(DownClient(), rank=1, nproc=2, stale_after_s=1.0)
        with pytest.raises(net.PeerFailureError) as ei:
            w.dead_ranks()
        assert ei.value.ranks == (0,)


class TestHeartbeatWriter:
    @pytest.mark.parametrize("store", ["fake", "tcp"])
    def test_beats_and_cleans_up(self, store):
        real = RealStore() if store == "tcp" else None
        c = real.clients[1] if real else FakeClient()
        probe = real.master if real else c
        hb = net.HeartbeatWriter(c, rank=1, interval_s=0.01)
        hb.start()
        first = int(probe.blocking_key_value_get_bytes("ltpu_hb/1", 100))
        time.sleep(0.08)
        later = int(probe.blocking_key_value_get_bytes("ltpu_hb/1", 100))
        assert later > first >= 1  # one key, rewritten with a rising sequence
        hb.stop()
        with pytest.raises(net.StoreDeadline):  # removed on a clean stop
            probe.blocking_key_value_get_bytes("ltpu_hb/1", 5)


# ----------------------------------------------------------------------
def _clients(store):
    """(rank 0's client, rank 1's client, key probe, holder)."""
    if store == "fake":
        c = FakeClient()
        return c, c, (lambda k: k in c.store), c
    real = RealStore()
    return real.clients[0], real.clients[1], real.has, real


@pytest.mark.parametrize("store", ["fake", "tcp"])
class TestKvGather:
    def test_gather_returns_process_order(self, store):
        c0, c1, _, _ = _clients(store)
        net.configure(deadline_s=2.0)
        net._kv_put_payload(c1, 0, 1, "ltpu_collect/0/1", b"from-rank-1", 2.0, "test")
        out = net.kv_gather(0, b"from-rank-0", client=c0, rank=0, nproc=2)
        assert out == [b"from-rank-0", b"from-rank-1"]

    def test_empty_blob_roundtrip(self, store):
        c0, c1, _, _ = _clients(store)
        net._kv_put(c1, "k", b"")
        assert net._kv_get(c0, "k", 100) == b""
        net.configure(deadline_s=2.0)
        net._kv_put_payload(c1, 0, 1, "ltpu_collect/0/1", b"", 2.0, "test")
        assert net.kv_gather(0, b"", client=c0, rank=0, nproc=2) == [b"", b""]

    def test_lazy_gc_deletes_own_previous_uid(self, store):
        c0, c1, has, _ = _clients(store)
        net.configure(deadline_s=2.0)
        net._kv_put_payload(c1, 0, 1, "ltpu_collect/0/1", b"x", 2.0, "test")
        net.kv_gather(0, b"a", client=c0, rank=0, nproc=2)
        assert has("ltpu_collect/0/0")  # nothing to collect yet
        net._kv_put_payload(c1, 1, 1, "ltpu_collect/1/1", b"y", 2.0, "test")
        net.kv_gather(1, b"b", client=c0, rank=0, nproc=2)
        # finishing uid 1 proves every rank read this rank's uid 0
        assert not has("ltpu_collect/0/0") and has("ltpu_collect/1/0")

    def test_dead_peer_classified_within_budget(self, store):
        c0, c1, _, _ = _clients(store)
        net.configure(deadline_s=0.3, stale_after_s=0.3)
        c1.key_value_set("ltpu_hb/1", "1")  # beat once, then died
        w = net.PeerWatch(c0, rank=0, nproc=2, stale_after_s=0.3)
        t0 = time.monotonic()
        with pytest.raises(net.PeerFailureError) as ei:
            net.kv_gather(0, b"mine", client=c0, rank=0, nproc=2, watch=w)
        assert ei.value.ranks == (1,)
        assert time.monotonic() - t0 <= 2 * 0.3 + 0.5

    def test_live_but_silent_peer_is_collective_timeout(self, store):
        c0, c1, _, _ = _clients(store)
        beats = itertools.count(1)
        stop = threading.Event()

        def beat():  # rank 1 is alive (it beats) but never contributes
            while not stop.is_set():
                c1.key_value_set("ltpu_hb/1", str(next(beats)))
                time.sleep(0.02)

        t = threading.Thread(target=beat, daemon=True)
        t.start()
        net.configure(deadline_s=0.25, stale_after_s=0.25)
        w = net.PeerWatch(c0, rank=0, nproc=2, stale_after_s=0.25)
        t0 = time.monotonic()
        try:
            with pytest.raises(net.CollectiveTimeoutError) as ei:
                net.kv_gather(0, b"mine", client=c0, rank=0, nproc=2, watch=w)
        finally:
            stop.set()
            t.join()
        wall = time.monotonic() - t0
        assert 0.4 <= wall <= 1.5 and ei.value.elapsed_s >= 0.4

    def test_unreachable_store_is_peer_failure_after_retries(self, store):
        net.configure(deadline_s=1.0, retries=1, backoff_base_s=0.001, backoff_max_s=0.002)
        if store == "fake":
            class DownClient(FakeClient):
                def blocking_key_value_get_bytes(self, key, timeout_ms):
                    raise RuntimeError("Connection reset by peer")

            c1 = DownClient()
        else:
            real = RealStore()
            c1 = real.clients[1]
            real.stop()  # rank 0's process, and the store with it, is gone
        t0 = time.monotonic()
        with pytest.raises(net.PeerFailureError) as ei:
            net.kv_gather(0, b"mine", client=c1, rank=1, nproc=2)
        assert ei.value.ranks == (0,) and time.monotonic() - t0 < 2.0

    def test_chunked_payloads_and_their_gc(self, store, monkeypatch):
        c0, c1, has, _ = _clients(store)
        monkeypatch.setenv("LIGHTGBM_TPU_KV_CHUNK", "64")
        net.configure(deadline_s=5.0)
        res = {}

        def run(r, c, uid, blob):
            res[(uid, r)] = net.kv_gather(uid, blob, client=c, rank=r, nproc=2)

        for uid, blobs in ((0, [b"x" * 500, b"y" * 300]), (1, [b"p" * 200, b"q"])):
            ts = [threading.Thread(target=run, args=(r, c, uid, blobs[r]))
                  for r, c in enumerate((c0, c1))]
            for t in ts:
                t.start()
            for t in ts:
                t.join(30)
            assert res[(uid, 0)] == blobs and res[(uid, 1)] == blobs
            if uid == 0:
                assert has("ltpu_chunk/0/0/1") and has("ltpu_chunk/0/1/4")
        # finishing uid 1 collected uid 0's chunks, one key at a time
        assert not has("ltpu_chunk/0/0/1") and not has("ltpu_chunk/0/1/4")
        assert not has("ltpu_chunk/0/0/7")


class TestChunks:
    @pytest.mark.parametrize("size", [1, 1024, 3 * 1024 * 1024])
    def test_roundtrip_sizes_on_tcp(self, size, monkeypatch):
        monkeypatch.setenv("LIGHTGBM_TPU_KV_CHUNK", str(256 * 1024))
        real = RealStore()
        net.configure(deadline_s=10.0)
        payloads = [bytes([r]) * size + bytes([r]) for r in range(2)]
        res = {}

        def run(r):
            res[r] = net.kv_gather(0, payloads[r], client=real.clients[r], rank=r, nproc=2)

        ts = [threading.Thread(target=run, args=(r,)) for r in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(30)
        assert res[0] == payloads and res[1] == payloads

    def test_crc_mismatch_is_typed_corruption_error(self, monkeypatch):
        monkeypatch.setenv("LIGHTGBM_TPU_KV_CHUNK", "64")
        c = FakeClient()
        net.configure(deadline_s=2.0)
        net._kv_put_payload(c, 0, 1, "ltpu_collect/0/1", b"z" * 500, 2.0, "test")
        raw = bytearray(c.store["ltpu_chunk/0/1/1"])
        raw[-1] ^= 0xFF
        c.store["ltpu_chunk/0/1/1"] = bytes(raw)
        with pytest.raises(net.NetError, match="CRC mismatch"):
            net.kv_gather(0, b"mine", client=c, rank=0, nproc=2)

    def test_chunk_limit_env_and_default(self, monkeypatch):
        # a TCPStore value of ~10 MB resets its connection: the port chunks at 1 MiB
        assert net.kv_chunk_limit() == 1024 * 1024
        monkeypatch.setenv("LIGHTGBM_TPU_KV_CHUNK", "123")
        assert net.kv_chunk_limit() == 123
        monkeypatch.setenv("LIGHTGBM_TPU_KV_CHUNK", "bogus")
        assert net.kv_chunk_limit() == 1024 * 1024


class TestStoreClient:
    def test_deadline_is_told_apart_from_a_lost_store(self):
        real = RealStore()
        c = real.clients[1]
        with pytest.raises(net.StoreDeadline) as ei:
            c.blocking_key_value_get_bytes("missing", 20)
        assert net._is_deadline_error(ei.value)
        c.key_value_set_bytes("k", b"v")
        c.key_value_delete("k")
        with pytest.raises(net.StoreDeadline):
            real.master.blocking_key_value_get_bytes("k", 5)
        real.stop()
        with pytest.raises(RuntimeError) as ei:
            c.blocking_key_value_get_bytes("k", 20)
        assert not net._is_deadline_error(ei.value)


class TestWatchdog:
    def test_passes_value_and_errors_through(self):
        assert net.watchdog_call(lambda: 41 + 1, "unit") == 42
        with pytest.raises(KeyError):
            net.watchdog_call(lambda: {}["missing"], "unit")

    def test_hang_raises_bounded_timeout(self):
        net.configure(deadline_s=0.1, stale_after_s=0.05)
        t0 = time.monotonic()
        with pytest.raises(net.CollectiveTimeoutError):
            net.watchdog_call(lambda: time.sleep(5), "unit")
        assert time.monotonic() - t0 < 1.0
        assert net.abandoned_calls()  # the CLI then leaves through hard_exit

    def test_stale_peer_during_hang_is_peer_failure(self):
        c = FakeClient()
        net.configure(deadline_s=5.0, stale_after_s=0.05)
        c.key_value_set("ltpu_hb/1", "1")  # frozen
        w = net.PeerWatch(c, rank=0, nproc=2, stale_after_s=0.05)
        with pytest.raises(net.PeerFailureError):
            net.watchdog_call(lambda: time.sleep(5), "unit", watch=w)


class TestErrorsAndExits:
    def test_hierarchy_exports_and_exit_codes(self):
        assert issubclass(net.PeerFailureError, net.NetError)
        assert issubclass(net.CollectiveTimeoutError, net.NetError)
        assert issubclass(net.NetError, RuntimeError)
        assert parallel.PeerFailureError is net.PeerFailureError
        assert parallel.CollectiveTimeoutError is net.CollectiveTimeoutError
        assert (cli.EXIT_PEER_FAILURE, cli.EXIT_NET_TIMEOUT) == (75, 74)

    def test_no_client_is_a_net_error(self):
        net.set_client(None)
        with pytest.raises(net.NetError, match="not initialized"):
            net.require_client()
