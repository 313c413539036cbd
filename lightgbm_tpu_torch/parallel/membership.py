"""Live elastic fleet membership over a shared-directory store — PyTorch
counterpart of lightgbm_tpu/parallel/membership.py.

Checkpoints merge every rank's training state into a rank-free form and
reshard it to any world size (ckpt/state.py); this module makes a resize
a runtime event.  Every member runs as one process of its own (no
``torch.distributed`` bootstrap: a TCPStore lives in rank 0's process,
whose death would end the fleet), and all coordination goes through a
:class:`FileKVClient`, a shared-directory store with the operations
``net.py`` uses on its TCPStore client (deadline-bounded gathers, chunked
payloads, CRC framing, heartbeat liveness).  No member holds state the
fleet needs, so the coordinator's death is one more eviction and the
lowest surviving member id is the re-elected coordinator.

Protocol (all keys under the fleet's directory):

- ``members/<id>``       write-once id allocation (monotonic; joiners
                         scan upward with :meth:`FileKVClient.try_create`)
- ``ltpu_hb/<id>``       net.py heartbeats (one key a member, rewritten),
                         swept by :class:`MemberWatch`
- ``intent/join/<id>``   a joiner announcing itself
- ``dead/<E>/<id>``      staleness evidence, written by any survivor
- ``epoch/<E>``          the epoch's membership record (members, shard
                         counts, iteration, num_data), write-once by
                         epoch ``E``'s coordinator
- ``handoff/<E>``        canonical TrainState bytes for epoch ``E``,
                         written before ``epoch/<E>`` so an admitted
                         joiner never finds it absent

At every iteration boundary each member runs :meth:`MembershipRuntime.
sync`, a small allgather of frozen intent payloads.  The participant set
is folded into the collective uid, so members that disagree on who is
alive gather in disjoint key spaces and time out instead of mixing
payloads; staleness evidence converges through ``dead/<E>`` and the retry
succeeds once every survivor sees the same world.  The transition itself
(state merge and reshard) is boosting/gbdt.py's, which owns the training
state; this module moves bytes and decides rosters.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
import time
import urllib.parse
import zlib
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..obs import tracer
from . import net

# disjoint uid namespaces a purpose (python ints, so the width is free)
_NS_COMM = 1 << 59       # learner-comm allgathers   | (E<<40) | seq
_NS_SYNC = 1 << 60       # boundary membership syncs | (E<<40) | (idx<<16) | dig
_NS_TRANS = 1 << 58      # transition state gathers  | (E<<40) | (idx<<16) | dig

_SYNC_ATTEMPTS = 4       # bounded convergence, then PeerFailureError

# a blocking get polls its file from the first interval, doubling up to
# the client's poll (2 ms): a gather waits for its slowest member, and a
# longer cap would add up to the cap to every collective (a stat a poll
# costs little)
_POLL_FIRST_S = 0.0002


class CleanLeave(Exception):
    """Raised through the training loop after a SIGTERM'd member has handed
    its shard off at an epoch transition: the worker flushes its outputs
    and exits 0, not 75."""

    def __init__(self, epoch: int):
        super().__init__(f"clean leave at membership epoch {epoch}")
        self.epoch = int(epoch)


# ----------------------------------------------------------------------
# FileKVClient: a shared-directory store
# ----------------------------------------------------------------------
class _Deadline(Exception):
    """Its message carries DEADLINE_EXCEEDED, so ``net._is_deadline_error``
    classifies a missing key as the TCPStore client's timeout."""


def _enc(component: str) -> str:
    # "." and ".." are valid quote() outputs but walk the tree; the
    # leading dot is encoded so every component is a plain name
    q = urllib.parse.quote(component, safe="")
    return "%2E" + q[1:] if q.startswith(".") else q


def _dec(component: str) -> str:
    return urllib.parse.unquote(component)


class FileKVClient:
    """The store operations ``net.py`` uses (``key_value_set(_bytes)``,
    ``blocking_key_value_get(_bytes)``, ``key_value_delete``,
    ``key_value_try_get``) on a shared directory, plus the JAX client's
    ``key_value_dir_get`` and the write-once :meth:`try_create` that the
    membership protocol's epoch records rest on.  A key is a nested path
    (one percent-encoded component a ``/``-separated key component); a
    write lands by an atomic rename (``try_create`` by a hard link, which
    fails if the key exists), so a reader never sees part of a value.  The
    file layout is the JAX package's, so either package reads the other's
    fleet directory."""

    def __init__(self, root: str, poll_s: float = 0.002):
        self._root = os.path.abspath(root)
        self._poll = float(poll_s)
        self._tmp_seq = 0
        self._lock = threading.Lock()
        os.makedirs(self._root, exist_ok=True)

    # -- paths ---------------------------------------------------------
    def _path(self, key: str) -> str:
        parts = [p for p in key.split("/") if p]
        if not parts:
            raise ValueError(f"empty KV key: {key!r}")
        return os.path.join(self._root, *[_enc(p) for p in parts])

    def _tmp_path(self, final: str) -> str:
        with self._lock:
            self._tmp_seq += 1
            seq = self._tmp_seq
        # the pid alone is not unique: several clients share a process
        # (in-process fleet tests, SpotFleet's own client)
        return os.path.join(os.path.dirname(final), f".tmp.{os.getpid()}.{id(self):x}.{seq}")

    def _write(self, key: str, value: bytes, *, exclusive: bool) -> bool:
        final = self._path(key)
        tmp = self._tmp_path(final)
        # no fsync: the rename makes the value visible to every process
        # whole; durability across a machine crash is not the fleet's
        # promise (its members die with the machine).  The directory is
        # made only when the open finds it missing (a stat and a mkdir on
        # every write stood out in a member's profile: chip_contention.py)
        try:
            f = open(tmp, "wb")
        except FileNotFoundError:
            os.makedirs(os.path.dirname(final), exist_ok=True)
            f = open(tmp, "wb")
        with f:
            f.write(value)
        try:
            if exclusive:
                try:
                    os.link(tmp, final)  # create-or-fail, with the whole value
                except FileExistsError:
                    return False
            else:
                os.replace(tmp, final)
                tmp = None
            return True
        finally:
            if tmp is not None:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass

    # -- the store surface ---------------------------------------------
    def key_value_set_bytes(self, key: str, value: bytes) -> None:
        self._write(key, bytes(value), exclusive=False)

    def key_value_set(self, key: str, value: str) -> None:
        self._write(key, str(value).encode("utf-8"), exclusive=False)

    def key_value_try_get(self, key: str) -> Optional[bytes]:
        """The value of ``key``, or None when it is absent, without waiting."""
        try:
            with open(self._path(key), "rb") as f:
                return f.read()
        except (FileNotFoundError, IsADirectoryError, NotADirectoryError):
            return None

    def blocking_key_value_get_bytes(self, key: str, timeout_ms: int) -> bytes:
        path = self._path(key)
        deadline = time.monotonic() + max(0, int(timeout_ms)) / 1000.0
        pause = _POLL_FIRST_S
        while True:
            try:
                with open(path, "rb") as f:
                    return f.read()
            except (FileNotFoundError, IsADirectoryError, NotADirectoryError):
                pass
            left = deadline - time.monotonic()
            if left <= 0:
                raise _Deadline(f"DEADLINE_EXCEEDED: kv key {key!r} absent after "
                                f"{timeout_ms}ms")
            time.sleep(min(pause, left))
            pause = min(pause * 2, self._poll)

    def blocking_key_value_get(self, key: str, timeout_ms: int) -> str:
        return self.blocking_key_value_get_bytes(key, timeout_ms).decode("utf-8",
                                                                         errors="replace")

    def key_value_dir_get(self, prefix: str) -> List[Tuple[str, str]]:
        """Every (key, value) under ``prefix``."""
        parts = [p for p in prefix.split("/") if p]
        base = os.path.join(self._root, *[_enc(p) for p in parts])
        if not os.path.isdir(base):
            return []
        out: List[Tuple[str, str]] = []
        for dirpath, _dirnames, filenames in os.walk(base):
            for name in filenames:
                if name.startswith(".tmp"):
                    continue
                rel = os.path.relpath(os.path.join(dirpath, name), base)
                comps = parts + [_dec(c) for c in rel.split(os.sep)]
                try:
                    with open(os.path.join(dirpath, name), "rb") as f:
                        val = f.read().decode("utf-8", errors="replace")
                except OSError:
                    continue  # racing a delete or a publish
                out.append(("/".join(comps), val))
        return out

    def key_value_delete(self, key: str) -> None:
        """Delete one key, or with a trailing ``/`` every key under it."""
        if key.endswith("/"):
            shutil.rmtree(self._path(key), ignore_errors=True)
            return
        try:
            os.unlink(self._path(key))
        except OSError:
            pass

    # -- membership extension ------------------------------------------
    def try_create(self, key: str, value: bytes) -> bool:
        """Write-once: True iff this call published ``key``.  A reader that
        loses the race still sees the whole value (written to a temporary
        file before the link makes it visible)."""
        return self._write(key, bytes(value), exclusive=True)


# ----------------------------------------------------------------------
# MemberWatch: PeerWatch over an explicit, changing set of member ids
# ----------------------------------------------------------------------
class MemberWatch(net.PeerWatch):
    """``net.PeerWatch`` sweeps ranks ``0..nproc-1``; after churn the live
    member ids are sparse (ids are monotonic, never reused), so this
    sweeps an explicit set.  ``set_members`` is called at every epoch
    transition; the staleness bookkeeping of ids that stay carries over."""

    def __init__(self, client, member_id: int, members: Sequence[int],
                 stale_after_s: Optional[float] = None,
                 time_fn: Callable[[], float] = time.monotonic):
        super().__init__(client, rank=member_id, nproc=0, stale_after_s=stale_after_s,
                         time_fn=time_fn)
        self._members = frozenset(int(m) for m in members)

    def set_members(self, members: Sequence[int]) -> None:
        with self._lock:
            self._members = frozenset(int(m) for m in members)
            # evicted or departed ids must not linger as stale peers
            for r in list(self._seen):
                if r not in self._members:
                    del self._seen[r]

    def _states(self) -> Dict[int, str]:
        with self._lock:
            members = sorted(self._members)
        out: Dict[int, str] = {}
        for r in members:
            if r != self.rank:
                val = self._client.key_value_try_get(f"{net._HB_DIR}{r}")
                out[r] = "<absent>" if val is None else val.decode()
        return out

    def ages(self) -> Dict[int, float]:
        now = self._time()
        states = self._states()
        out: Dict[int, float] = {}
        with self._lock:
            for r in sorted(self._members):
                if r == self.rank:
                    continue
                cur = states.get(r, "<absent>")
                prev = self._seen.get(r)
                if prev is None or prev[0] != cur:
                    # PeerWatch.ages' rule: a key absent at first sight
                    # counts from the watch's start, so a member that
                    # never started still times out
                    t_mark = self._t_start if (prev is None and cur == "<absent>") else now
                    self._seen[r] = (cur, t_mark)
                    out[r] = now - t_mark
                else:
                    out[r] = now - prev[1]
        return out


# ----------------------------------------------------------------------
# churn decisions
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ChurnDecision:
    """The outcome of one membership sync: every participant derives the
    same decision from the same gathered payloads, so no agreement round
    is needed."""

    leavers: Tuple[int, ...]       # clean SIGTERM departures (still alive)
    dead: Tuple[int, ...]          # evicted on staleness evidence
    joiners: Tuple[int, ...]       # admitted intent/join ids
    participants: Tuple[int, ...]  # old members still alive (leavers included)
    new_members: Tuple[int, ...]   # the next epoch's sorted roster

    @property
    def survivors(self) -> Tuple[int, ...]:
        return tuple(m for m in self.participants if m not in self.leavers)


def _digest(parts: Sequence[int]) -> int:
    raw = ",".join(str(p) for p in parts).encode("ascii")
    return zlib.crc32(raw) & 0xFFFF


# ----------------------------------------------------------------------
# MembershipRuntime
# ----------------------------------------------------------------------
class MembershipRuntime:
    """One worker's handle on the fleet: identity, roster, heartbeat,
    liveness watch and the epoch-stamped sync and transition protocol.

    Lifecycle: construct -> :meth:`bootstrap` (a launch-time member) or
    :meth:`join` (a mid-run arrival) -> the booster routes collectives
    through :meth:`comm_allgather` and calls :meth:`sync` at every
    iteration boundary -> on churn, :meth:`gather_states` and
    :meth:`commit_epoch` move the fleet to the next epoch."""

    def __init__(self, root: str, member_id: Optional[int] = None):
        self.root = os.path.abspath(root)
        self.client = FileKVClient(os.path.join(self.root, "kv"))
        self.id = None if member_id is None else int(member_id)
        self.epoch: int = -1
        self.members: Tuple[int, ...] = ()
        self.counts: Optional[Tuple[int, ...]] = None
        self.start_iter: int = 0
        self.num_data: Optional[int] = None
        self.joined_mid_run = False
        # fn(lo, hi) -> (X_raw, y): the global rows [lo, hi), which an
        # evicted member's shard is rebuilt from, and a survivor's grown
        # shard, with no disk round trip
        self.row_provider = None
        self._leave = threading.Event()
        self._hb: Optional[net.HeartbeatWriter] = None
        self.watch: Optional[MemberWatch] = None
        self._comm_seq = 0
        self._sync_index = 0
        self._trans_index = 0
        self._last_sync_uid: Optional[int] = None
        self._last_sync_rank = 0

    # -- identity and roster -------------------------------------------
    @property
    def rank(self) -> int:
        return self.members.index(self.id)

    @property
    def nproc(self) -> int:
        return len(self.members)

    @property
    def is_coordinator(self) -> bool:
        return bool(self.members) and self.id == self.members[0]

    def request_leave(self) -> None:
        """Safe in a signal handler: marks the intent; the leave itself is
        negotiated at the next boundary sync."""
        self._leave.set()

    @property
    def leave_requested(self) -> bool:
        return self._leave.is_set()

    # -- lifecycle -----------------------------------------------------
    def _start_liveness(self) -> None:
        s = net.settings()
        self._hb = net.HeartbeatWriter(self.client, self.id, interval_s=s.hb_interval())
        self._hb.start()
        self.watch = MemberWatch(self.client, self.id, self.members)

    def _adopt_epoch(self, epoch: int, record: Dict) -> None:
        self.epoch = int(epoch)
        self.members = tuple(int(m) for m in record["members"])
        self.counts = tuple(int(c) for c in record["counts"])
        self.start_iter = int(record.get("iteration", 0))
        self.num_data = int(record["num_data"])
        self._comm_seq = 0
        self._sync_index = 0
        self._trans_index = 0
        if self.watch is not None:
            self.watch.set_members(self.members)

    def bootstrap(self, nproc: int, counts: Sequence[int]) -> None:
        """A launch-time member, ``id`` in [0, nproc): registers the id, the
        lowest id publishes epoch 0, and every member adopts it."""
        if self.id is None or not (0 <= self.id < nproc):
            raise ValueError(f"bootstrap needs member_id in [0,{nproc}), got {self.id}")
        self.client.try_create(f"members/{self.id}", b"1")
        record = {"members": list(range(nproc)), "counts": [int(c) for c in counts],
                  "iteration": 0, "num_data": int(sum(counts))}
        if self.id == 0:
            self.client.try_create("epoch/0", json.dumps(record).encode("utf-8"))
        blob = self.client.blocking_key_value_get_bytes(
            "epoch/0", int(net.settings().deadline_s * 1000))
        self._adopt_epoch(0, json.loads(blob))
        self._start_liveness()
        tracer.event("member.join", member=self.id, epoch=0, mid_run=False)

    def _epoch_records(self) -> Dict[int, Dict]:
        out = {}
        for key, _val in self.client.key_value_dir_get("epoch/"):
            try:
                e = int(key.split("/")[-1])
            except ValueError:
                continue
            out[e] = json.loads(self.client.blocking_key_value_get_bytes(f"epoch/{e}", 1000))
        return out

    def join(self, timeout_s: Optional[float] = None) -> None:
        """A mid-run arrival: allocate the next monotonic id, announce the
        intent, and wait until an epoch record admits this member."""
        budget = timeout_s if timeout_s is not None else 8 * net.settings().deadline_s
        deadline = time.monotonic() + budget
        if self.id is None:
            # the fleet exists before anyone joins it: wait for its first
            # record, then allocate above every id a record has listed,
            # so a joiner racing the launch members never takes their ids
            self.client.blocking_key_value_get_bytes("epoch/0", int(max(1.0, budget) * 1000))
            floor = 1 + max(m for rec in self._epoch_records().values() for m in rec["members"])
            i = floor
            while not self.client.try_create(f"members/{i}", b"1"):
                i += 1
            self.id = i
        else:
            self.client.try_create(f"members/{self.id}", b"1")
        self.members = (self.id,)  # provisional, until admitted
        self._start_liveness()
        self.client.key_value_set_bytes(f"intent/join/{self.id}", b"1")
        poll = min(0.05, max(0.01, net.settings().poll_s()))
        while True:
            best = None
            for key, _val in self.client.key_value_dir_get("epoch/"):
                try:
                    e = int(key.split("/")[-1])
                except ValueError:
                    continue
                if best is None or e > best:
                    best = e
            if best is not None:
                record = json.loads(self.client.blocking_key_value_get_bytes(f"epoch/{best}",
                                                                             1000))
                if self.id in record["members"]:
                    self._adopt_epoch(best, record)
                    break
            if time.monotonic() >= deadline:
                raise net.CollectiveTimeoutError(
                    f"join: no epoch admitted member {self.id} within {budget:.1f}s",
                    elapsed_s=budget)
            time.sleep(poll)
        self.joined_mid_run = True
        self.client.key_value_delete(f"intent/join/{self.id}")
        tracer.event("member.join", member=self.id, epoch=self.epoch, mid_run=True)

    def stop(self) -> None:
        if self._hb is not None:
            self._hb.stop()
            self._hb = None

    # -- collectives ---------------------------------------------------
    def comm_allgather(self, blob: bytes, what: str = "collective") -> List[bytes]:
        """The learner's allgather among the epoch's members; the uid
        carries the epoch, so an iteration retried after a transition never
        meets a key of the old epoch."""
        uid = net.epoch_uid(self.epoch, self._comm_seq, ns=_NS_COMM)
        self._comm_seq += 1
        return net.kv_gather(uid, blob, client=self.client, rank=self.rank, nproc=self.nproc,
                             watch=self.watch, what=what)

    # -- boundary sync -------------------------------------------------
    def _mark_dead(self, member: int) -> None:
        if member != self.id and member in self.members:
            self.client.try_create(f"dead/{self.epoch}/{int(member)}", b"1")

    def _read_dead(self) -> frozenset:
        out = set()
        for key, _val in self.client.key_value_dir_get(f"dead/{self.epoch}/"):
            try:
                out.add(int(key.split("/")[-1]))
            except ValueError:
                continue
        return frozenset(out & set(self.members) - {self.id})

    def _poll_joins(self) -> List[int]:
        out = set()
        for key, _val in self.client.key_value_dir_get("intent/join/"):
            try:
                out.add(int(key.split("/")[-1]))
            except ValueError:
                continue
        return sorted(out - set(self.members))

    def sync(self, known_dead: Sequence[int] = ()) -> Optional[ChurnDecision]:
        """One boundary sync: None when the world is unchanged, else a
        :class:`ChurnDecision`.  Every member runs sync ``i`` at the same
        training point, so the (epoch, index, participant digest) uid is
        the same exactly when the members agree on who is alive; members
        that disagree gather in disjoint uid spaces, time out, refresh the
        ``dead/<E>`` evidence and retry until they converge."""
        for d in known_dead:
            self._mark_dead(d)
        payload = json.dumps({
            "id": self.id,
            "leave": self._leave.is_set(),
            "joins": self._poll_joins(),
        }).encode("utf-8")  # frozen: every retry posts the same bytes
        idx = self._sync_index
        self._sync_index += 1
        deadline_s = net.settings().deadline_s
        last_err: Optional[BaseException] = None
        for _attempt in range(_SYNC_ATTEMPTS):
            dead = self._read_dead()
            parts = tuple(m for m in self.members if m not in dead)
            uid = net.epoch_uid(self.epoch, (idx << 16) | _digest(parts), ns=_NS_SYNC)
            try:
                blobs = net.kv_gather(uid, payload, client=self.client,
                                      rank=parts.index(self.id), nproc=len(parts),
                                      deadline_s=deadline_s, watch=None, what="member_sync")
            except Exception as e:
                last_err = e
                if self.watch is not None:
                    for d in self.watch.dead_ranks():
                        self._mark_dead(d)
                continue
            records = [json.loads(b) for b in blobs]
            if tuple(sorted(r["id"] for r in records)) != parts:
                last_err = net.CollectiveTimeoutError("member_sync uid collision", elapsed_s=0.0)
                continue  # a 16-bit digest collision between divergent views
            if self._last_sync_uid is not None:
                # our slot of the previous sync's uid space
                self.client.key_value_delete(
                    f"{net._COLLECT_DIR}{self._last_sync_uid}/{self._last_sync_rank}")
            self._last_sync_uid = uid
            self._last_sync_rank = parts.index(self.id)
            leavers = tuple(sorted(r["id"] for r in records if r["leave"]))
            joins = set()
            for r in records:
                joins.update(int(j) for j in r.get("joins", ()))
            joiners = tuple(sorted(joins - set(self.members)))
            dead = tuple(sorted(set(self.members) - set(parts)))
            if not leavers and not joiners and not dead:
                return None
            new_members = tuple(sorted((set(parts) - set(leavers)) | set(joiners)))
            if not new_members:
                raise net.PeerFailureError("membership sync left an empty fleet", ranks=dead)
            return ChurnDecision(leavers=leavers, dead=dead, joiners=joiners,
                                 participants=parts, new_members=new_members)
        raise net.PeerFailureError(
            f"membership sync {idx} failed to converge after {_SYNC_ATTEMPTS} attempts: "
            f"{last_err}", ranks=tuple(sorted(self._read_dead())))

    # -- transition ----------------------------------------------------
    def gather_states(self, state_bytes: bytes, participants: Sequence[int]) -> List[bytes]:
        """TrainState bytes of ``participants`` (the old roster less the
        dead; leavers included, they hand their shard off before leaving),
        chunked and CRC-framed by ``net.kv_gather``; a death here raises
        PeerFailureError and the caller syncs again."""
        parts = tuple(participants)
        idx = self._trans_index
        self._trans_index += 1
        uid = net.epoch_uid(self.epoch, (idx << 16) | _digest(parts), ns=_NS_TRANS)
        return net.kv_gather(uid, state_bytes, client=self.client, rank=parts.index(self.id),
                             nproc=len(parts), watch=self.watch, what="member_handoff")

    def commit_epoch(self, decision: ChurnDecision, counts: Sequence[int], iteration: int,
                     num_data: int, handoff_bytes: Optional[bytes] = None) -> None:
        """Advance to epoch E+1.  The new coordinator (the lowest id of the
        new roster) publishes the handoff before the epoch record, so an
        admitted joiner can read both; every survivor adopts the roster
        it derived without reading the record back."""
        new_epoch = self.epoch + 1
        record = {"members": list(decision.new_members), "counts": [int(c) for c in counts],
                  "iteration": int(iteration), "num_data": int(num_data)}
        for d in decision.dead:
            tracer.event("member.evict", member=d, epoch=new_epoch)
        for m in decision.leavers:
            tracer.event("member.leave", member=m, epoch=new_epoch)
        for j in decision.joiners:
            tracer.event("member.join", member=j, epoch=new_epoch, mid_run=True)
        if self.id == min(decision.new_members):
            if handoff_bytes is not None:
                self.client.try_create(f"handoff/{new_epoch}", handoff_bytes)
            self.client.try_create(f"epoch/{new_epoch}", json.dumps(record).encode("utf-8"))
            # GC: the superseded handoff, the staleness evidence, the join
            # intents, the departed members' heartbeats and the collective
            # keys of epochs every member has left (epoch E's may still be
            # read by a slow survivor; E-1's are drained: every member is
            # past the E-1 -> E transition)
            self.client.key_value_delete(f"handoff/{new_epoch - 1}")
            self.client.key_value_delete(f"dead/{self.epoch}/")
            for j in decision.joiners:
                self.client.key_value_delete(f"intent/join/{j}")
            for gone in tuple(decision.dead) + tuple(decision.leavers):
                self.client.key_value_delete(f"{net._HB_DIR}{gone}")
            self._gc_collect_epochs(before=self.epoch)
        self._adopt_epoch(new_epoch, record)
        tracer.event("member.epoch", epoch=new_epoch, members=list(self.members),
                     coordinator=self.members[0], iteration=int(iteration))

    def _gc_collect_epochs(self, before: int) -> None:
        """Delete the membership collectives' keys (and their chunks) whose
        epoch field is below ``before``: no one reads them any more."""
        seen = set()
        for key, _val in self.client.key_value_dir_get(net._COLLECT_DIR):
            parts = key.split("/")
            if len(parts) < 2:
                continue
            try:
                uid = int(parts[1])
            except ValueError:
                continue
            if uid < _NS_TRANS or uid in seen:
                continue  # a static world's uids carry no namespace
            seen.add(uid)
            if net.uid_epoch(uid) < before:
                self.client.key_value_delete(f"{net._COLLECT_DIR}{uid}/")
                self.client.key_value_delete(f"{net._CHUNK_DIR}{uid}/")

    def read_handoff(self, epoch: Optional[int] = None) -> bytes:
        e = self.epoch if epoch is None else int(epoch)
        return self.client.blocking_key_value_get_bytes(
            f"handoff/{e}", int(net.settings().deadline_s * 1000))


# ----------------------------------------------------------------------
# the learner's communicator
# ----------------------------------------------------------------------
class MembershipComm:
    """parallel/comm.py's ``Comm`` surface whose rank and world follow the
    live epoch: HostParallelLearner reads ``comm.rank`` / ``comm.nproc``
    at every collective, so an epoch transition resizes the learner with
    no change to it.  (Not a ``Comm`` subclass: that pins rank and world
    as attributes at construction.)  The transport's time goes on
    ``net.wait_clock_add`` after the fault point, as in collect.py, so the
    rebalance controller reads a member's compute without its waits."""

    def __init__(self, runtime: MembershipRuntime):
        self._rt = runtime
        self.ledger: Dict[str, int] = {}

    @property
    def rank(self) -> int:
        return self._rt.rank

    @property
    def nproc(self) -> int:
        return self._rt.nproc

    @property
    def epoch(self) -> int:
        return self._rt.epoch

    def _account(self, blob: bytes, purpose: str) -> None:
        self.ledger[purpose] = self.ledger.get(purpose, 0) + len(blob)

    def ledger_total(self) -> int:
        return sum(self.ledger.values())

    def allgather(self, blob: bytes, purpose: str = "misc") -> List[bytes]:
        self._account(blob, purpose)
        tracer.counter("net.bytes", float(len(blob)), purpose=purpose, transport="member_kv")
        net.fault_point("collective")
        t0 = time.perf_counter()
        try:
            return self._rt.comm_allgather(blob, what=purpose)
        finally:
            net.wait_clock_add(time.perf_counter() - t0)


# ----------------------------------------------------------------------
# the process's runtime (worker scripts set it before building a Booster)
# ----------------------------------------------------------------------
_runtime: Optional[MembershipRuntime] = None


def set_runtime(rt: Optional[MembershipRuntime]) -> None:
    global _runtime
    _runtime = rt


def runtime() -> Optional[MembershipRuntime]:
    return _runtime


def runtime_from_env() -> Optional[MembershipRuntime]:
    """The runtime of a process that built none: LIGHTGBM_TPU_MEMBER_DIR
    names the fleet directory and LIGHTGBM_TPU_MEMBER_ID this worker's id
    (bootstrap or join is still the worker's: this builds the handle, not
    adopted)."""
    root = os.environ.get("LIGHTGBM_TPU_MEMBER_DIR")
    if not root:
        return None
    mid = os.environ.get("LIGHTGBM_TPU_MEMBER_ID")
    return MembershipRuntime(root, None if mid is None else int(mid))
