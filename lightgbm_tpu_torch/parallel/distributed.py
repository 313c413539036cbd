"""The multi-process bootstrap — PyTorch counterpart of
lightgbm_tpu/parallel/distributed.py.

The JAX package forms its world with ``jax.distributed.initialize`` and
rides that coordination service's key-value store wherever its backend
has no multi-process computations.  The port has one such transport
only: rank 0 hosts a ``torch.distributed.TCPStore`` at the coordinator's
``host:port`` and every rank connects to it (parallel/net.py
``StoreClient``); the collectives of parallel/collect.py exchange byte
blobs through it.  (NCCL runs no two ranks on one card, so the ranks of a
one-card machine cannot use it.)

A process finds its place in this order, as in the JAX package:

1. the env: ``LIGHTGBM_TPU_COORDINATOR=host:port``,
   ``LIGHTGBM_TPU_NUM_PROCESSES``, ``LIGHTGBM_TPU_PROCESS_ID``;
2. the reference's keys: ``machines`` ("host:port,host:port,...") or
   ``machine_list_file`` with ``num_machines``.  The first machine is the
   coordinator (rank 0); this process's rank is ``LIGHTGBM_TPU_PROCESS_ID``
   or the index of the entry naming this host, with
   ``local_listen_port`` to break a tie (linkers_socket.cpp:90-134).

Each process holds its own rows (the reference's ``pre_partition=true``).
A bootstrap that was asked for and cannot form raises
``CollectiveTimeoutError`` within the net deadline; it never trains
alone.  With no coordinator (``LIGHTGBM_TPU_NUM_PROCESSES`` alone) there
is nothing to join and ``ensure_initialized`` returns False.

``process_index``, ``process_count`` and ``is_multiprocess`` are the
port's stand-ins for ``jax.process_*``; every module of the port reads the
world from them.  In a rank thread (parallel/comm.py ``rank_thread``)
they report that thread's rank and world.
"""

from __future__ import annotations

import atexit
import os
import socket
import time
from typing import List, Optional

from ..obs import tracer
from ..utils.log import Log
from . import net
from .comm import thread_comm

_BOOT_DIR = "ltpu_boot/"
_DONE_DIR = "ltpu_done/"

_initialized = False
_rank = 0
_world = 1


def process_index() -> int:
    """This process's rank (0 in one process)."""
    comm = thread_comm()
    return comm.rank if comm is not None else _rank


def process_count() -> int:
    """The processes of the run (1 until a bootstrap formed)."""
    comm = thread_comm()
    return comm.nproc if comm is not None else _world


def is_multiprocess() -> bool:
    return process_count() > 1


def current_epoch() -> int:
    """The live membership epoch of this process's fleet, the stamp an
    elastic transition bumps (parallel/membership.py); a static world and
    a run with no adopted runtime report 0."""
    from . import membership

    rt = membership.runtime()
    return max(rt.epoch, 0) if rt is not None else 0


def _split_address(addr: str):
    host, _, port = addr.strip().rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"coordinator address {addr!r} is not host:port")
    return host, int(port)


def _bounded_initialize(coord: str, nproc: int, pid: int) -> "net.StoreClient":
    """Start (rank 0) or reach the store at ``coord`` and wait until all
    ``nproc`` ranks have registered, within the net deadline: connection
    errors retry on the backoff schedule, and what does not form in time
    raises ``CollectiveTimeoutError``."""
    s = net.settings()
    deadline = s.deadline_s
    host, port = _split_address(coord)
    delays = net.backoff_schedule(s.retries, s.backoff_base_s, s.backoff_max_s)
    t0 = time.monotonic()

    def left() -> float:
        return deadline - (time.monotonic() - t0)

    client = None
    for attempt in range(s.retries + 1):
        try:
            client = net.watchdog_call(
                lambda: net.StoreClient(host, port, is_master=(pid == 0), world_size=nproc,
                                        timeout_s=deadline, connect_s=max(left(), 0.5)),
                what="distributed.initialize", deadline_s=max(left(), 0.5))
            break
        except net.NetError:
            raise
        except RuntimeError as e:
            elapsed = time.monotonic() - t0
            if attempt >= s.retries or left() <= delays[attempt]:
                raise net.CollectiveTimeoutError(
                    f"distributed bootstrap to {coord} failed after {attempt + 1} attempt(s) "
                    f"in {elapsed:.1f}s: {e}", elapsed_s=elapsed) from e
            Log.warning("distributed.initialize failed (attempt %d/%d): %s — retrying in "
                        "%.2fs", attempt + 1, s.retries + 1, e, delays[attempt])
            time.sleep(delays[attempt])
    # the registration barrier: the run forms when every rank has said so
    net._kv_put(client, f"{_BOOT_DIR}{pid}", b"")
    for r in range(nproc):
        while True:
            try:
                net._kv_get(client, f"{_BOOT_DIR}{r}", max(int(min(left(), 0.5) * 1e3), 1))
                break
            except Exception as e:
                elapsed = time.monotonic() - t0
                if not net._is_deadline_error(e):
                    raise net.CollectiveTimeoutError(
                        f"distributed bootstrap to {coord}: store error while rank {r} "
                        f"registers: {e}", elapsed_s=elapsed) from e
                if left() <= 0:
                    raise net.CollectiveTimeoutError(
                        f"distributed bootstrap to {coord}: rank {r} of {nproc} did not join "
                        f"within {deadline:.1f}s", elapsed_s=elapsed) from None
    return client


def machines_from_config(config) -> List[str]:
    """The machine list: ``machine_list_file`` (one host:port a line),
    else ``machines``."""
    if getattr(config, "machine_list_file", ""):
        with open(config.machine_list_file) as f:
            return [ln.strip() for ln in f if ln.strip()]
    machines = getattr(config, "machines", "") or ""
    return [m.strip() for m in machines.split(",") if m.strip()]


def _rank_from_machines(machines: List[str], config) -> Optional[int]:
    """The entry naming this host; ``local_listen_port`` breaks a tie."""
    local = {socket.gethostname(), socket.getfqdn(), "127.0.0.1", "localhost"}
    try:
        local.add(socket.gethostbyname(socket.gethostname()))
    except OSError:
        pass
    lport = str(getattr(config, "local_listen_port", ""))
    matches = [i for i, m in enumerate(machines) if m.split(":")[0] in local]
    if len(matches) > 1:
        by_port = [i for i in matches
                   if len(machines[i].split(":")) > 1 and machines[i].split(":")[1] == lport]
        if len(by_port) == 1:
            matches = by_port
        else:
            Log.fatal("Cannot infer this process's rank: %d machine-list entries match the "
                      "local host and local_listen_port does not disambiguate; set "
                      "LIGHTGBM_TPU_PROCESS_ID", len(matches))
    return matches[0] if matches else None


def ensure_initialized(config=None, process_id: Optional[int] = None) -> bool:
    """Form the multi-process world once, when the run asks for one.
    True when several processes are (or already were) up."""
    global _initialized, _rank, _world
    if config is not None:
        net.configure_from_config(config)
    if thread_comm() is not None:
        return process_count() > 1
    if _initialized:
        return _world > 1

    coord = os.environ.get("LIGHTGBM_TPU_COORDINATOR", "")
    nproc = int(os.environ.get("LIGHTGBM_TPU_NUM_PROCESSES", "0") or 0)
    pid_env = os.environ.get("LIGHTGBM_TPU_PROCESS_ID", "")
    pid = process_id if process_id is not None else (int(pid_env) if pid_env else None)

    if not coord and config is not None and getattr(config, "num_machines", 1) > 1:
        machines = machines_from_config(config)
        if machines:
            coord = machines[0]
            nproc = nproc or int(config.num_machines)
            if pid is None:
                pid = _rank_from_machines(machines, config)
    if not coord or not nproc or pid is None:
        return False
    if nproc <= 1:
        _initialized = True
        return False

    tracer.refresh_from_env()  # the bootstrap may come before training opens the trace
    Log.info("Initializing distributed runtime: coordinator=%s rank=%d/%d (deadline=%.0fs, "
             "retries=%d)", coord, pid, nproc, net.settings().deadline_s,
             net.settings().retries)
    t0 = time.perf_counter()
    client = _bounded_initialize(coord, nproc=nproc, pid=pid)
    _initialized = True
    _rank, _world = int(pid), int(nproc)
    net.set_client(client)
    net.ensure_heartbeat()
    # rank, world and run_id on every trace record, for `report merge`
    tracer.set_identity(rank=_rank, world_size=_world, run_id=coord)
    boot_s = time.perf_counter() - t0
    tracer.event("net.bootstrap", secs=round(boot_s, 6), coordinator=coord)
    Log.info("Distributed runtime up: rank %d of %d in %.3f s", _rank, _world, boot_s)
    atexit.register(shutdown)
    return True


def shutdown() -> None:
    """The clean exit's barrier: each rank says it is done, and rank 0,
    whose process holds the store, waits (within the net deadline) until
    every rank has, so no rank loses the store before its last read.  A
    failure exit leaves through ``net.hard_exit`` and skips this."""
    global _initialized, _rank, _world
    client = net._client()
    if not _initialized or client is None or _world <= 1:
        return
    try:
        net._kv_put(client, f"{_DONE_DIR}{_rank}", b"")
        if _rank == 0:
            t_end = time.monotonic() + net.settings().deadline_s
            for r in range(1, _world):
                while True:
                    left = t_end - time.monotonic()
                    if left <= 0:
                        Log.warning("shutdown: rank %d never finished; closing the store", r)
                        break
                    try:
                        net._kv_get(client, f"{_DONE_DIR}{r}", max(int(min(left, 0.5) * 1e3), 1))
                        break
                    except Exception as e:
                        if not net._is_deadline_error(e):
                            raise
    except Exception as e:  # the store is gone already
        Log.debug("distributed shutdown: %s", e)
    net.stop_heartbeat()
    net.set_client(None)
    _initialized, _rank, _world = False, 0, 1
