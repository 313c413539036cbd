"""The bounded multi-process transport — PyTorch counterpart of
lightgbm_tpu/parallel/net.py: deadlines, retry with backoff, peer
liveness, typed failures, cooperative abort and fault injection, over a
``torch.distributed.TCPStore`` that rank 0 hosts at the coordinator's
``host:port`` (parallel/distributed.py starts it).

The JAX package rides the key-value store of ``jax.distributed``'s
coordination service; the port rides the TCPStore through
:class:`StoreClient`, which offers the three operations this module uses
on the JAX client (set bytes, a blocking get with a millisecond timeout,
delete) and a read that does not wait, for the liveness sweep.  Two
differences from that store shape the code:

- a TCPStore key is overwritten by a set, so each rank's heartbeat is one
  key, ``ltpu_hb/<rank>``, rewritten with a rising sequence number;
- ``delete_key`` removes one key (the JAX client deletes a subtree), so
  the chunk keys of a gather are deleted one by one.

The rest is the JAX package's:

- **Deadlines.**  Every primitive is bounded by ``NetSettings.deadline_s``
  (param ``network_timeout``, env ``LIGHTGBM_TPU_NET_TIMEOUT``).
- **Retry.**  Transient store errors retry on a deterministic exponential
  backoff (``network_retries`` / ``LIGHTGBM_TPU_NET_RETRIES``) within the
  deadline.
- **Liveness.**  :class:`HeartbeatWriter` rewrites its rank's key on its
  own connection (a failed write is retried at the next beat); :class:`PeerWatch` declares a rank dead when its key
  has not changed for ``stale_after`` of *local* time, so no clock is
  compared across hosts.
- **Typed failures.**  A dead peer raises :class:`PeerFailureError`
  within about twice the deadline (the wait window plus the staleness
  window); a lost or wedged collective with live peers raises
  :class:`CollectiveTimeoutError`; a store that cannot be reached is the
  coordinator's death, ``PeerFailureError`` with ranks ``(0,)``.
- **Cooperative abort.**  The survivors flush the latest checkpoint and
  leave through :func:`hard_exit`, which skips the interpreter's exit
  hooks (the store's shutdown barrier would wait on the dead peer).
- **Fault injection.**  ``LIGHTGBM_TPU_FAULT=die:N|drop_collective:N|
  delay:ms|delay:ms:after:N`` (gated by ``LIGHTGBM_TPU_FAULT_RANK``) is
  checked at every collective; :func:`set_delay_scale` scales the delays.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import signal
import struct
import sys
import threading
import time
import zlib
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..obs import tracer
from ..utils.log import Log

_HB_DIR = "ltpu_hb/"
_COLLECT_DIR = "ltpu_collect/"
_CHUNK_DIR = "ltpu_chunk/"

# epoch-scoped collective uids (the JAX package's layout): bits
# [EPOCH_SHIFT, EPOCH_SHIFT + EPOCH_BITS) carry the membership epoch, the
# low bits the sequence, the bits above a purpose namespace
EPOCH_SHIFT = 40
EPOCH_BITS = 18


def epoch_uid(epoch: int, seq: int, ns: int = 0) -> int:
    """``ns | epoch field | seq`` of an epoch-scoped collective."""
    epoch = int(epoch)
    if not 0 <= epoch < (1 << EPOCH_BITS):
        raise ValueError(f"epoch {epoch} outside the uid epoch field")
    return int(ns) | (epoch << EPOCH_SHIFT) | int(seq)


def uid_epoch(uid: int) -> int:
    """The epoch field of an epoch-scoped uid (0 in a static world)."""
    return (int(uid) >> EPOCH_SHIFT) & ((1 << EPOCH_BITS) - 1)


def _flight_dump(reason: str, error: Optional[BaseException] = None, **attrs) -> None:
    """Flush the crash flight recorder (obs/flight.py) as a typed failure
    is raised; a no-op with tracing off, never raises."""
    try:
        from ..obs import flight

        flight.dump(reason, error=error, **attrs)
    except Exception:  # the dying path must not fail again
        pass


# ----------------------------------------------------------------------
# errors
# ----------------------------------------------------------------------
class NetError(RuntimeError):
    """Base of the transport's failures; each carries how long the
    operation waited before it gave up."""

    def __init__(self, msg: str, elapsed_s: float = 0.0):
        super().__init__(msg)
        self.elapsed_s = float(elapsed_s)


class CollectiveTimeoutError(NetError):
    """The budget ran out while every peer still looked alive: a lost,
    wedged or badly skewed collective, or a bootstrap that never formed."""


class PeerFailureError(NetError):
    """Peers stopped heartbeating, or the coordinator's store is gone: the
    run cannot go on; survivors flush the latest checkpoint and exit."""

    def __init__(self, msg: str, ranks: Sequence[int] = (), elapsed_s: float = 0.0):
        super().__init__(msg, elapsed_s)
        self.ranks = tuple(int(r) for r in ranks)


# ----------------------------------------------------------------------
# settings: defaults < config params < env < configure()
# ----------------------------------------------------------------------
@dataclasses.dataclass
class NetSettings:
    """The deadline and retry knobs of every primitive."""

    deadline_s: float = 120.0      # a collective's wait window
    retries: int = 3               # retries of a transient error
    backoff_base_s: float = 0.1    # the first backoff; doubles a retry
    backoff_max_s: float = 5.0     # the backoff's cap
    heartbeat_interval_s: float = 0.0  # 0: deadline / 4, at most 5 s
    stale_after_s: float = 0.0         # 0: the deadline

    def hb_interval(self) -> float:
        if self.heartbeat_interval_s > 0:
            return self.heartbeat_interval_s
        return min(max(self.deadline_s / 4.0, 0.05), 5.0)

    def stale_after(self) -> float:
        return self.stale_after_s if self.stale_after_s > 0 else self.deadline_s

    def poll_s(self) -> float:
        """A get's slice between liveness sweeps."""
        return min(max(self.deadline_s / 16.0, 0.05), 0.5)


_ENV_FIELDS: Dict[str, Tuple[str, type]] = {
    "deadline_s": ("LIGHTGBM_TPU_NET_TIMEOUT", float),
    "retries": ("LIGHTGBM_TPU_NET_RETRIES", int),
    "backoff_base_s": ("LIGHTGBM_TPU_NET_BACKOFF", float),
    "heartbeat_interval_s": ("LIGHTGBM_TPU_NET_HEARTBEAT", float),
    "stale_after_s": ("LIGHTGBM_TPU_NET_STALE_AFTER", float),
}

_CONFIG_FIELDS = {
    "deadline_s": "network_timeout",
    "retries": "network_retries",
    "heartbeat_interval_s": "network_heartbeat_interval",
}

_settings: Optional[NetSettings] = None
_settings_lock = threading.Lock()


def _apply_env(s: NetSettings) -> NetSettings:
    for field, (var, typ) in _ENV_FIELDS.items():
        raw = os.environ.get(var, "").strip()
        if raw:
            try:
                setattr(s, field, typ(float(raw)) if typ is int else typ(raw))
            except ValueError:
                Log.warning("Unparsable %s=%r ignored", var, raw)
    return s


def settings() -> NetSettings:
    """The process's settings (the env is read once, lazily)."""
    global _settings
    with _settings_lock:
        if _settings is None:
            _settings = _apply_env(NetSettings())
        return _settings


def configure(**kw) -> NetSettings:
    """Override settings fields; wins over config params and the env."""
    s = settings()
    for k, v in kw.items():
        if not hasattr(s, k):
            raise TypeError(f"unknown net setting {k!r}")
        setattr(s, k, v)
    return s


def configure_from_config(config) -> NetSettings:
    """``network_timeout`` / ``network_retries`` /
    ``network_heartbeat_interval`` of a Config; the env wins (the
    launcher owns it)."""
    s = settings()
    for field, param in _CONFIG_FIELDS.items():
        if os.environ.get(_ENV_FIELDS[field][0], "").strip():
            continue
        val = getattr(config, param, None)
        if val is not None and float(val) > 0:
            setattr(s, field, type(getattr(s, field))(val))
    return s


def _reset_for_tests() -> None:
    """Drop the cached settings and fault state, so env changes count."""
    global _settings, _fault_specs, _fault_calls, _delay_scale, _wait_clock_s
    with _settings_lock:
        _settings = None
    with _fault_lock:
        _fault_specs = None
        _fault_calls = 0
    _delay_scale = 1.0
    with _wait_clock_lock:
        _wait_clock_s = 0.0
    _chunks_written.clear()


# ----------------------------------------------------------------------
# retry with backoff
# ----------------------------------------------------------------------
def backoff_schedule(retries: int, base_s: float, max_s: float) -> List[float]:
    """base, 2 base, 4 base, ... capped at ``max_s``: one delay a retry."""
    return [min(base_s * (2.0 ** i), max_s) for i in range(max(retries, 0))]


def retry_call(fn: Callable, what: str, retries: Optional[int] = None,
               deadline_s: Optional[float] = None, retry_on=(Exception,)):
    """``fn()`` with bounded retries on the backoff schedule; the attempts
    and sleeps together stay within ``deadline_s``, and running out raises
    :class:`CollectiveTimeoutError` chained to the last error."""
    s = settings()
    retries = s.retries if retries is None else int(retries)
    deadline = s.deadline_s if deadline_s is None else float(deadline_s)
    delays = backoff_schedule(retries, s.backoff_base_s, s.backoff_max_s)
    t0 = time.monotonic()
    last: Optional[BaseException] = None
    for attempt in range(retries + 1):
        try:
            return fn()
        except retry_on as e:  # noqa: PERF203 - the retry loop
            last = e
            elapsed = time.monotonic() - t0
            tracer.counter("net.retry", what=what)
            if attempt >= retries or elapsed + delays[attempt] > deadline:
                break
            Log.warning("%s failed (attempt %d/%d): %s — retrying in %.2fs", what,
                        attempt + 1, retries + 1, e, delays[attempt])
            time.sleep(delays[attempt])
    elapsed = time.monotonic() - t0
    tracer.counter("net.timeout", what=what)
    _flight_dump("collective_timeout", error=last, what=what, elapsed_s=round(elapsed, 3))
    raise CollectiveTimeoutError(
        f"{what} failed after {elapsed:.1f}s (retries={retries}, deadline={deadline:.0f}s): "
        f"{last}", elapsed_s=elapsed) from last


# ----------------------------------------------------------------------
# fault injection
# ----------------------------------------------------------------------
_fault_specs: Optional[List[Tuple]] = None
_fault_calls = 0
_fault_lock = threading.Lock()
# multiplicative scale on every injected delay (a host whose per-row
# compute is slow, when tied to a rank's row share)
_delay_scale = 1.0


def set_delay_scale(scale: float) -> None:
    """Scale the injected ``delay`` sleeps (a no-op without faults)."""
    global _delay_scale
    _delay_scale = max(float(scale), 0.0)


def delay_scale() -> float:
    return _delay_scale


# the seconds spent waiting inside the collectives' transport (after the
# fault point, so an injected stall is its rank's own time and its peers'
# wait)
_wait_clock_s = 0.0
_wait_clock_lock = threading.Lock()


def wait_clock_add(seconds: float) -> None:
    global _wait_clock_s
    with _wait_clock_lock:
        _wait_clock_s += max(float(seconds), 0.0)


def wait_clock_drain() -> float:
    """The transport wait accumulated since the last drain."""
    global _wait_clock_s
    with _wait_clock_lock:
        out = _wait_clock_s
        _wait_clock_s = 0.0
    return out


def parse_fault_spec(spec: str) -> List[Tuple]:
    """``die:N | drop_collective:N | delay:ms | delay:ms:after:N``, comma
    separated.  ``N`` is the 1-based collective call; a bare ``delay:ms``
    applies to every call, ``delay:ms:after:N`` from call N on."""
    out: List[Tuple] = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        fields = part.split(":")
        kind = fields[0].strip().lower()
        if kind not in ("die", "drop_collective", "delay"):
            raise ValueError(f"unknown fault kind {kind!r} in {spec!r}")
        if kind == "delay" and len(fields) == 4 and fields[2].strip().lower() == "after":
            try:
                ms, after = float(fields[1]), float(fields[3])
            except ValueError:
                raise ValueError(f"bad fault argument in {part!r}")
            if after < 1:
                raise ValueError(f"delay:ms:after:N needs a 1-based call index, got {part!r}")
            out.append(("delay_after", ms, after))
            continue
        if len(fields) > 2:
            raise ValueError(f"bad fault argument in {part!r}")
        arg = fields[1] if len(fields) > 1 else ""
        try:
            val = float(arg) if arg else 0.0
        except ValueError:
            raise ValueError(f"bad fault argument in {part!r}")
        if kind in ("die", "drop_collective") and val < 1:
            raise ValueError(f"{kind} needs a 1-based call index, got {part!r}")
        out.append((kind, val))
    return out


def _fault_applies_here() -> bool:
    target = os.environ.get("LIGHTGBM_TPU_FAULT_RANK", "").strip()
    if not target:
        return True
    from . import distributed

    try:
        return int(target) == distributed.process_index()
    except ValueError:
        return True


def fault_point(kind: str = "collective") -> None:
    """The injection hook at the top of every collective: parses
    ``LIGHTGBM_TPU_FAULT`` once, then one check a call when it is unset."""
    global _fault_specs, _fault_calls
    with _fault_lock:
        if _fault_specs is None:
            spec = os.environ.get("LIGHTGBM_TPU_FAULT", "")
            try:
                _fault_specs = parse_fault_spec(spec) if spec else []
            except ValueError as e:
                Log.warning("Ignoring LIGHTGBM_TPU_FAULT: %s", e)
                _fault_specs = []
        if not _fault_specs or not _fault_applies_here():
            return
        _fault_calls += 1
        calls = _fault_calls
    for item in _fault_specs:
        fkind, arg = item[0], item[1]
        if fkind == "delay":
            time.sleep(arg / 1e3 * _delay_scale)
        elif fkind == "delay_after" and calls >= int(item[2]):
            time.sleep(arg / 1e3 * _delay_scale)
        elif fkind == "die" and calls == int(arg):
            Log.warning("FAULT INJECTION: die at %s call %d", kind, calls)
            sys.stdout.flush()
            os.kill(os.getpid(), signal.SIGKILL)
        elif fkind == "drop_collective" and calls == int(arg):
            # a lost collective from a live process: the heartbeat goes
            # on, this rank never contributes, so its peers must raise
            # CollectiveTimeoutError and not PeerFailureError
            Log.warning("FAULT INJECTION: dropping %s call %d (wedging)", kind, calls)
            sys.stdout.flush()
            while True:
                time.sleep(3600)


# ----------------------------------------------------------------------
# the store
# ----------------------------------------------------------------------
class StoreDeadline(RuntimeError):
    """A get that timed out on a reachable store (its message carries
    ``DEADLINE_EXCEEDED``, as the JAX client's does)."""


class StoreClient:
    """The operations of the JAX coordination client that this module
    uses, over one connection to a ``torch.distributed.TCPStore``:
    ``key_value_set_bytes``, ``blocking_key_value_get_bytes`` (a
    millisecond timeout; a timeout raises :class:`StoreDeadline`, a lost
    connection the store's own error), ``key_value_delete`` (one key) and,
    for the liveness sweep, ``key_value_try_get``.
    With ``is_master`` the store's server runs in this process, which then
    holds every key: rank 0's.  :meth:`connect` opens another connection
    to the same server, for a thread of its own (a get holds its
    connection for its whole timeout)."""

    def __init__(self, host: str, port: int, *, is_master: bool = False,
                 world_size: Optional[int] = None, timeout_s: float = 30.0,
                 connect_s: Optional[float] = None):
        from torch.distributed import TCPStore

        self.host, self.port = str(host), int(port)
        # ``connect_s`` bounds the connect (the bootstrap's budget left);
        # every later set and delete waits up to ``timeout_s``
        self._timeout = datetime.timedelta(seconds=max(float(timeout_s), 0.001))
        connect = datetime.timedelta(seconds=max(float(connect_s), 0.001)) if connect_s \
            else self._timeout
        self._store = TCPStore(self.host, self.port, world_size, bool(is_master),
                               timeout=connect, wait_for_workers=False)
        self._store.set_timeout(self._timeout)
        self._lock = threading.Lock()

    def connect(self) -> "StoreClient":
        return StoreClient(self.host, self.port, timeout_s=self._timeout.total_seconds())

    def key_value_set_bytes(self, key: str, value: bytes) -> None:
        with self._lock:
            self._store.set(key, bytes(value))

    def key_value_set(self, key: str, value: str) -> None:
        self.key_value_set_bytes(key, str(value).encode())

    def blocking_key_value_get_bytes(self, key: str, timeout_ms: int) -> bytes:
        with self._lock:
            self._store.set_timeout(datetime.timedelta(milliseconds=max(int(timeout_ms), 1)))
            try:
                return bytes(self._store.get(key))
            except RuntimeError as e:
                if _is_store_timeout(e):
                    raise StoreDeadline(f"DEADLINE_EXCEEDED: {key}: {e}") from None
                raise
            finally:
                self._store.set_timeout(self._timeout)

    def key_value_delete(self, key: str) -> None:
        with self._lock:
            self._store.delete_key(key)

    def key_value_try_get(self, key: str) -> Optional[bytes]:
        """The value of ``key``, or None when it is absent, without
        waiting (the liveness sweep's read, where the JAX client lists a
        directory): a get with a short timeout would, on a busy host, time
        out on a key that exists and read as absent."""
        with self._lock:
            if not self._store.check([key]):
                return None
            return bytes(self._store.get(key))


def _is_store_timeout(e: BaseException) -> bool:
    """A TCPStore wait that ran out on a live connection (a lost one is a
    ``DistNetworkError``)."""
    import torch.distributed as dist

    net_err = getattr(dist, "DistNetworkError", None)
    if net_err is not None and isinstance(e, net_err):
        return False
    return "timeout" in str(e).lower()


_client_obj = None


def set_client(client) -> None:
    """The store client of this process (parallel/distributed.py sets it
    once the bootstrap formed; tests set a fake)."""
    global _client_obj
    _client_obj = client


def _client():
    return _client_obj


def require_client():
    client = _client()
    if client is None:
        raise NetError("distributed runtime not initialized (no store client)")
    return client


def _is_deadline_error(e: BaseException) -> bool:
    return "DEADLINE_EXCEEDED" in str(e)


# the frame prefix of every stored value (the JAX package's wire: its
# client could not read values shorter than 2 bytes, and barriers gather
# empty payloads)
_KV_FRAME = b"LT1\x00"

# chunked payloads: the head value carries the whole payload (_KV_RAW) or
# a descriptor and the first chunk (_KV_CHUNKED); the continuation chunks,
# each with its CRC, are written before the head, so a reader that sees
# the head never waits for a chunk
_KV_RAW = b"R"
_KV_CHUNKED = b"C"
_KV_CHUNK_HDR = struct.Struct("<IQ")  # (num_chunks, total_len)
_KV_CHUNK_ENV = "LIGHTGBM_TPU_KV_CHUNK"
# a TCPStore value of ~10 MB resets the connection (4 MB passes); the
# port chunks at 1 MiB
_KV_CHUNK_DEFAULT = 1024 * 1024
# (uid, rank) -> continuation keys written, for the lazy GC
_chunks_written: Dict[Tuple[int, int], int] = {}


def kv_chunk_limit() -> int:
    """The most payload bytes one value carries (the env shrinks it in
    tests, to chunk small blobs)."""
    raw = os.environ.get(_KV_CHUNK_ENV, "").strip()
    if raw:
        try:
            return max(int(raw), 1)
        except ValueError:
            Log.warning("Unparsable %s=%r ignored", _KV_CHUNK_ENV, raw)
    return _KV_CHUNK_DEFAULT


def _frame_chunk(chunk: bytes) -> bytes:
    return struct.pack("<I", zlib.crc32(chunk) & 0xFFFFFFFF) + chunk


def _unframe_chunk(raw: bytes, what: str, key: str) -> bytes:
    if len(raw) < 4:
        raise NetError(f"{what}: truncated KV chunk at {key}")
    want = struct.unpack("<I", raw[:4])[0]
    chunk = raw[4:]
    got = zlib.crc32(chunk) & 0xFFFFFFFF
    if got != want:
        raise NetError(f"{what}: KV chunk CRC mismatch at {key} (stored {want:#010x}, "
                       f"computed {got:#010x}) — payload corrupted in the store")
    return chunk


def _kv_put_payload(client, uid: int, rank: int, key: str, blob: bytes, deadline: float,
                    what: str) -> None:
    """``blob`` under ``key``, split over ``ltpu_chunk/`` keys (written
    first) when it passes the chunk limit."""
    limit = kv_chunk_limit()
    if len(blob) <= limit:
        retry_call(lambda: _kv_put(client, key, _KV_RAW + blob), what=f"{what}[set uid={uid}]",
                   deadline_s=deadline)
        return
    chunks = [blob[i:i + limit] for i in range(0, len(blob), limit)]
    for i in range(1, len(chunks)):
        ckey = f"{_CHUNK_DIR}{uid}/{rank}/{i}"
        framed = _frame_chunk(chunks[i])
        retry_call(lambda k=ckey, v=framed: _kv_put(client, k, v),
                   what=f"{what}[set chunk uid={uid}/{i}]", deadline_s=deadline)
    _chunks_written[(uid, rank)] = len(chunks) - 1
    tracer.counter("net.kv_chunk", float(len(chunks) - 1), what=what)
    head = _KV_CHUNKED + _KV_CHUNK_HDR.pack(len(chunks), len(blob)) + _frame_chunk(chunks[0])
    retry_call(lambda: _kv_put(client, key, head), what=f"{what}[set uid={uid}]",
               deadline_s=deadline)


def _kv_read_payload(client, uid: int, r: int, head: bytes, poll_ms: int,
                     budget_left: Callable[[], float], watch: Optional["PeerWatch"],
                     what: str) -> bytes:
    """One rank's payload from its head value and, when split, its
    continuation chunks."""
    if head[:1] == _KV_RAW:
        return head[1:]
    if head[:1] != _KV_CHUNKED:
        raise NetError(f"{what}: unrecognized KV payload framing {head[:1]!r} from rank {r} "
                       "(version skew between ranks?)")
    nchunks, total = _KV_CHUNK_HDR.unpack_from(head, 1)
    parts = [_unframe_chunk(head[1 + _KV_CHUNK_HDR.size:], what, f"{_COLLECT_DIR}{uid}/{r}")]
    for i in range(1, nchunks):
        key = f"{_CHUNK_DIR}{uid}/{r}/{i}"
        while True:
            if budget_left() <= 0:
                if watch is not None:
                    watch.check(what)
                tracer.counter("net.timeout", what=what)
                raise CollectiveTimeoutError(f"{what} uid={uid}: chunk {i}/{nchunks} from rank "
                                             f"{r} never appeared within the budget")
            try:
                raw = _kv_get(client, key, poll_ms)
                break
            except Exception as e:
                if not _is_deadline_error(e):
                    raise NetError(f"{what} uid={uid}: store error reading chunk {key}: "
                                   f"{e}") from e
                if watch is not None:
                    watch.check(what)
        parts.append(_unframe_chunk(raw, what, key))
    blob = b"".join(parts)
    if len(blob) != total:
        raise NetError(f"{what} uid={uid}: reassembled payload from rank {r} is {len(blob)} "
                       f"bytes, descriptor said {total}")
    return blob


def _gc_chunks(client, uid: int, rank: int) -> None:
    """Delete this rank's continuation keys of gather ``uid``, one key at
    a time (a TCPStore deletes no subtree)."""
    cnt = _chunks_written.pop((uid, rank), 0)
    for i in range(1, cnt + 1):
        try:
            client.key_value_delete(f"{_CHUNK_DIR}{uid}/{rank}/{i}")
        except Exception:  # the GC is best effort
            pass


def _kv_put(client, key: str, blob: bytes) -> None:
    client.key_value_set_bytes(key, _KV_FRAME + blob)


def _kv_get(client, key: str, timeout_ms: int) -> bytes:
    raw = bytes(client.blocking_key_value_get_bytes(key, timeout_ms))
    return raw[len(_KV_FRAME):]


# ----------------------------------------------------------------------
# heartbeats and liveness
# ----------------------------------------------------------------------
class HeartbeatWriter:
    """A daemon thread rewriting this rank's key ``ltpu_hb/<rank>`` with a
    rising sequence number every ``interval_s``; a killed rank's key stops
    changing, which is the signal :class:`PeerWatch` reads."""

    def __init__(self, client, rank: int, interval_s: float):
        self._client = client
        self._rank = int(rank)
        self._interval = float(interval_s)
        self._seq = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name="ltpu-heartbeat", daemon=True)

    def start(self) -> None:
        self._beat()  # the first beat lands before any collective waits on it
        self._thread.start()

    def _beat(self) -> None:
        self._seq += 1
        self._client.key_value_set(f"{_HB_DIR}{self._rank}", str(self._seq))

    def _run(self) -> None:
        while not self._stop.wait(self._interval):
            try:
                with tracer.span("net.heartbeat", rank=self._rank):
                    self._beat()
            except Exception as e:
                # beat again next time: a write that failed on a busy host
                # must not read as this rank's death; a store that is gone
                # is classified by the foreground collective
                Log.debug("heartbeat write failed: %s", e)

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2.0)
        try:  # a clean exit removes the key
            self._client.key_value_delete(f"{_HB_DIR}{self._rank}")
        except Exception:
            pass


class PeerWatch:
    """The liveness sweep over the ranks' heartbeat keys: a rank is dead
    when its key has not changed for ``stale_after_s`` since this watch
    last saw it change (local time only)."""

    def __init__(self, client, rank: int, nproc: int, stale_after_s: Optional[float] = None,
                 time_fn: Callable[[], float] = time.monotonic):
        self._client = client
        self.rank = int(rank)
        self.nproc = int(nproc)
        self._stale_after = stale_after_s
        self._time = time_fn
        self._lock = threading.Lock()
        # rank -> (last observed key state, local time it changed)
        self._seen: Dict[int, Tuple[str, float]] = {}
        self._t_start = time_fn()

    def _states(self) -> Dict[int, str]:
        out: Dict[int, str] = {}
        for r in range(self.nproc):
            if r != self.rank:
                val = self._client.key_value_try_get(f"{_HB_DIR}{r}")
                out[r] = "<absent>" if val is None else val.decode()
        return out

    def ages(self) -> Dict[int, float]:
        """Seconds since each peer's heartbeat last changed, as this
        process observed it."""
        now = self._time()
        states = self._states()
        out: Dict[int, float] = {}
        with self._lock:
            for r in range(self.nproc):
                if r == self.rank:
                    continue
                cur = states.get(r, "<absent>")
                prev = self._seen.get(r)
                if prev is None or prev[0] != cur:
                    # first sight or a change: alive as of now (a key absent
                    # at first sight counts from the watch's start, so a
                    # peer that never started still times out)
                    t_mark = self._t_start if (prev is None and cur == "<absent>") else now
                    self._seen[r] = (cur, t_mark)
                    out[r] = now - t_mark
                else:
                    out[r] = now - prev[1]
        return out

    def dead_ranks(self) -> List[int]:
        stale = self._stale_after if self._stale_after is not None else settings().stale_after()
        try:
            ages = self.ages()
        except Exception as e:
            # the store itself is gone: rank 0, which hosts it, died
            _flight_dump("coordinator_unreachable", error=e)
            raise PeerFailureError(f"distributed store unreachable (coordinator dead?): {e}",
                                   ranks=(0,)) from e
        return [r for r, age in sorted(ages.items()) if age > stale]

    def check(self, what: str, elapsed_s: float = 0.0) -> None:
        """Raise :class:`PeerFailureError` when a peer went stale."""
        dead = self.dead_ranks()
        if dead:
            stale = (self._stale_after if self._stale_after is not None
                     else settings().stale_after())
            tracer.event("net.peer_failure", what=what, ranks=dead,
                         elapsed_s=round(elapsed_s, 3))
            _flight_dump("peer_failure", what=what, ranks=list(dead),
                         elapsed_s=round(elapsed_s, 3))
            raise PeerFailureError(f"rank(s) {dead} stopped heartbeating during {what} "
                                   f"(no change for > {stale:.1f}s)", ranks=dead,
                                   elapsed_s=elapsed_s)


_hb_writer: Optional[HeartbeatWriter] = None
_peer_watch: Optional[PeerWatch] = None
_hb_lock = threading.Lock()


def ensure_heartbeat() -> Optional[PeerWatch]:
    """Start this process's heartbeat writer (on a connection of its own)
    and peer watch once; None in one process or before the bootstrap."""
    global _hb_writer, _peer_watch
    with _hb_lock:
        if _peer_watch is not None:
            return _peer_watch
        client = _client()
        if client is None:
            return None
        from . import distributed

        nproc = distributed.process_count()
        if nproc <= 1:
            return None
        rank = distributed.process_index()
        s = settings()
        try:
            hb_client = client.connect() if hasattr(client, "connect") else client
            writer = HeartbeatWriter(hb_client, rank, s.hb_interval())
            writer.start()
        except Exception as e:  # the store is down at start
            Log.warning("Could not start heartbeat writer: %s", e)
            return None
        _hb_writer = writer
        _peer_watch = PeerWatch(client, rank, nproc)
        return _peer_watch


def peer_watch() -> Optional[PeerWatch]:
    return _peer_watch


def stop_heartbeat() -> None:
    """Stop the heartbeat and delete this rank's key (a clean shutdown)."""
    global _hb_writer, _peer_watch
    with _hb_lock:
        if _hb_writer is not None:
            _hb_writer.stop()
        _hb_writer = None
        _peer_watch = None


# ----------------------------------------------------------------------
# bounded primitives
# ----------------------------------------------------------------------
def kv_gather(uid: int, blob: bytes, *, client=None, rank: Optional[int] = None,
              nproc: Optional[int] = None, deadline_s: Optional[float] = None,
              watch: Optional[PeerWatch] = None, what: str = "kv_allgather") -> List[bytes]:
    """Every rank's ``blob`` of gather ``uid``, in rank order, bounded.

    The budget is ``deadline + stale_after`` (about twice the deadline):
    the wait window plus the window a peer's death needs to show.  Gets
    poll in short slices with a liveness sweep between them, so a dead
    peer raises :class:`PeerFailureError` as soon as it goes stale; the
    budget running out with live peers raises
    :class:`CollectiveTimeoutError`; a store that stays unreachable past
    the retries is the coordinator's death.

    GC: finishing gather ``uid`` proves every rank finished ``uid - 1``
    (each writes its key before it reads, in the same program order), so
    this rank's ``uid - 1`` keys are deleted here: the store holds O(ranks)
    keys however long the run."""
    s = settings()
    if client is None:
        client = require_client()
    if rank is None or nproc is None:
        from . import distributed

        rank = distributed.process_index() if rank is None else rank
        nproc = distributed.process_count() if nproc is None else nproc
    deadline = s.deadline_s if deadline_s is None else float(deadline_s)
    budget = deadline + s.stale_after()
    if watch is None:
        watch = _peer_watch
    poll_ms = max(int(s.poll_s() * 1e3), 10)

    own_key = f"{_COLLECT_DIR}{uid}/{rank}"
    try:
        _kv_put_payload(client, uid, rank, own_key, blob, deadline, what)
    except CollectiveTimeoutError as e:
        cause = e.__cause__
        if cause is None or _is_deadline_error(cause):
            raise
        # the set itself kept failing: the store, and rank 0 with it, is gone
        _flight_dump("coordinator_unreachable", error=cause, what=what)
        raise PeerFailureError(f"{what} uid={uid}: store unreachable (coordinator dead?): "
                               f"{cause}", ranks=(0,), elapsed_s=e.elapsed_s) from e

    t0 = time.monotonic()
    out: List[bytes] = []
    for r in range(nproc):
        if r == rank:
            out.append(blob)
            continue
        key = f"{_COLLECT_DIR}{uid}/{r}"
        misses = 0
        while True:
            elapsed = time.monotonic() - t0
            if elapsed >= budget:
                if watch is not None:
                    watch.check(what, elapsed_s=elapsed)
                tracer.counter("net.timeout", what=what)
                _flight_dump("collective_timeout", what=what, elapsed_s=round(elapsed, 3))
                raise CollectiveTimeoutError(
                    f"{what} uid={uid}: rank {r} never contributed within {budget:.1f}s "
                    f"(deadline={deadline:.1f}s) but peers look alive", elapsed_s=elapsed)
            try:
                head = _kv_get(client, key, poll_ms)
                out.append(_kv_read_payload(client, uid, r, head, poll_ms,
                                            lambda: budget - (time.monotonic() - t0), watch,
                                            what))
                break
            except NetError:
                raise
            except Exception as e:
                if not _is_deadline_error(e):
                    misses += 1
                    if misses > s.retries:
                        _flight_dump("coordinator_unreachable", error=e, what=what)
                        raise PeerFailureError(
                            f"{what} uid={uid}: store unreachable (coordinator dead?): {e}",
                            ranks=(0,), elapsed_s=elapsed) from e
                    time.sleep(min(backoff_schedule(s.retries, s.backoff_base_s,
                                                    s.backoff_max_s)[misses - 1],
                                   max(budget - elapsed, 0.0)))
                    continue
                if watch is not None:
                    watch.check(what, elapsed_s=time.monotonic() - t0)
    if uid > 0:
        try:
            client.key_value_delete(f"{_COLLECT_DIR}{uid - 1}/{rank}")
            _gc_chunks(client, uid - 1, rank)
            tracer.counter("net.kv_gc")
        except Exception:  # the GC is best effort
            pass
    return out


# the watchdog's workers abandoned on a timeout (see abandoned_calls)
_abandoned: List[threading.Thread] = []


def abandoned_calls() -> bool:
    """True while a call the watchdog gave up on still runs: a thread in
    the store's native code, which would abort the interpreter's exit (so
    the process leaves through :func:`hard_exit`)."""
    return any(t.is_alive() for t in _abandoned)


def watchdog_call(fn: Callable, what: str, deadline_s: Optional[float] = None,
                  watch: Optional[PeerWatch] = None):
    """Run a blocking call (the bootstrap's connect) on a daemon thread
    while this thread sweeps peer liveness: a stale peer raises
    :class:`PeerFailureError`, the budget running out
    :class:`CollectiveTimeoutError`.  The worker cannot be cancelled; on a
    timeout it is abandoned and the caller aborts the process."""
    s = settings()
    deadline = s.deadline_s if deadline_s is None else float(deadline_s)
    budget = deadline + s.stale_after()
    if watch is None:
        watch = _peer_watch
    box: Dict[str, object] = {}
    done = threading.Event()

    def _runner():
        try:
            box["value"] = fn()
        except BaseException as e:  # noqa: BLE001 - handed to the caller
            box["error"] = e
        finally:
            done.set()

    worker = threading.Thread(target=_runner, name=f"ltpu-net-{what}", daemon=True)
    worker.start()
    t0 = time.monotonic()
    while not done.wait(s.poll_s()):
        elapsed = time.monotonic() - t0
        if watch is not None:
            watch.check(what, elapsed_s=elapsed)
        if elapsed >= budget:
            _abandoned.append(worker)
            tracer.counter("net.timeout", what=what)
            _flight_dump("collective_timeout", what=what, elapsed_s=round(elapsed, 3))
            raise CollectiveTimeoutError(f"{what} did not complete within {budget:.1f}s "
                                         f"(deadline={deadline:.1f}s)", elapsed_s=elapsed)
    if "error" in box:
        raise box["error"]  # type: ignore[misc]
    return box.get("value")


# ----------------------------------------------------------------------
# cooperative abort
# ----------------------------------------------------------------------
def hard_exit(code: int) -> None:
    """Exit without the interpreter's exit hooks: the store's shutdown
    barrier (parallel/distributed.py) would wait on the dead peer.  Flushes
    the tracer and stdio first, then ``os._exit``."""
    try:
        tracer.close()
    except Exception:
        pass
    try:
        sys.stdout.flush()
        sys.stderr.flush()
    except Exception:
        pass
    os._exit(code)
