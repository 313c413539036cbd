"""Host-level collectives of variable-length byte blobs — PyTorch
counterpart of lightgbm_tpu/parallel/collect.py.

Every exchange across processes (the distributed find-bin's mappers, the
ingest sketches, the learners' histograms and split records, the
checkpoint barrier) is one allgather of bytes through the store
(parallel/net.py ``kv_gather``): bounded by the net deadline, a dead peer
raising ``PeerFailureError`` within about twice it, each call a fault
injection point, the keys of the previous gather collected as it goes.

The JAX package also has an "array" transport over
``multihost_utils.process_allgather`` for backends with multi-process
computations; its torch form would be NCCL across cards, which no
one-card machine can run, so the port has the store transport only
(``transport="kv"`` in the traces, as on the JAX package's CPU backend).
One process returns ``[blob]`` and touches nothing; a rank thread
(parallel/comm.py ``rank_thread``) exchanges through its group.
"""

from __future__ import annotations

import itertools
import pickle
import time
from typing import List, Optional

from ..obs import tracer
from . import distributed, net
from .comm import thread_comm

# the processes make their collective calls in the same program order, so
# this counter gives matching keys across ranks (and kv_gather's lazy GC
# relies on that order)
_kv_uid = itertools.count()
# the membership epoch of the uids (net.epoch_uid): 0 in a static world
_kv_epoch = 0


def set_epoch(epoch: int) -> None:
    """Scope later gather uids to a membership epoch; the sequence
    restarts only on a real change."""
    global _kv_epoch, _kv_uid
    epoch = int(epoch)
    if epoch != _kv_epoch:
        _kv_epoch = epoch
        _kv_uid = itertools.count()


def _kv_allgather(blob: bytes) -> List[bytes]:
    return net.kv_gather(net.epoch_uid(_kv_epoch, next(_kv_uid)), blob,
                         client=net.require_client(), rank=distributed.process_index(),
                         nproc=distributed.process_count())


def allgather_bytes(blob: bytes, purpose: str = "misc") -> List[bytes]:
    """Every process's ``blob``, in process order, bounded: a dead or
    wedged peer raises ``net.PeerFailureError`` /
    ``net.CollectiveTimeoutError``.  ``purpose`` tags the bytes sent in the
    ``net.bytes`` counter."""
    comm = thread_comm()
    if comm is not None:
        return comm.exchange(blob)
    if distributed.process_count() == 1:
        return [blob]
    net.fault_point("collective")
    net.ensure_heartbeat()
    tracer.counter("net.bytes", float(len(blob)), purpose=purpose, transport="kv")
    with tracer.span("net.allgather", transport="kv", bytes=len(blob), purpose=purpose):
        # the transport alone is timed (after the fault point: an injected
        # stall is its rank's own time, and its peers' wait)
        t0 = time.perf_counter()
        try:
            return _kv_allgather(blob)
        finally:
            net.wait_clock_add(time.perf_counter() - t0)


def barrier(tag: str = "barrier") -> None:
    """Every process reaches this point, within the net deadline (an
    empty allgather)."""
    if distributed.process_count() == 1:
        return
    with tracer.span("net.barrier", tag=tag):
        allgather_bytes(b"")


def allgather_blob_lists(blobs: List[bytes], list_len: Optional[int] = None,
                         purpose: str = "misc") -> List[List[bytes]]:
    """Each process's list of blobs, one list a process in process order.
    ``list_len`` pads every list to one length with empty blobs (the
    find-bin's last feature block may be short)."""
    pad = list_len if list_len is not None else len(blobs)
    payload = pickle.dumps(list(blobs) + [b""] * (pad - len(blobs)),
                           protocol=pickle.HIGHEST_PROTOCOL)
    return [pickle.loads(p) for p in allgather_bytes(payload, purpose)]
