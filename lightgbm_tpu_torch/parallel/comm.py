"""Byte-blob communicators of the host-driven parallel learners —
PyTorch counterpart of lightgbm_tpu/parallel/comm.py.

The learners (``hostlearner.py``) express every exchange as an allgather
of opaque byte blobs: best-split records, partition bitmaps, vote
ballots, elected-column histograms.  ``NetComm`` runs them across
processes over the store collectives of ``collect.py``; ``LocalComm``
runs R ranks as threads of one process with a barrier-synchronized slot
exchange.  Both send the same bytes, so their ledgers are equal.

``rank_thread(comm)`` makes the calling thread rank ``comm.rank`` of an
in-process world of ``LocalComm`` ranks: parallel/distributed.py reports
that rank and world, parallel/collect.py exchanges through the group, and
GBDT trains over that comm in place of ``NetComm`` — the whole
multi-process path (find-bin, label average, learners, checkpoint
barrier) with rank threads, which the checks hold the processes' models
and ledgers against.

Every communicator keeps an always-on ``ledger``, purpose -> bytes this
rank sent: ``hist`` (float32 (g, h, count) histograms), ``best_split``
(split records, partition bitmaps, node counts and sums), ``vote``
(ballots), ``elect`` (election results) and ``hist_q`` (the quantized
int16 histogram wire, its scale maxima and its integer root totals).
Each exchange also emits the tracer counter ``net.bytes``.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, List, Optional

from ..obs import tracer


class Comm:
    """Allgather-of-bytes surface with a purpose-tagged byte ledger."""

    #: membership epoch the collectives are scoped to; a static world
    #: never bumps it (an elastic communicator would report its runtime's)
    epoch = 0

    def __init__(self, rank: int, nproc: int):
        self.rank = int(rank)
        self.nproc = int(nproc)
        self.ledger: Dict[str, int] = {}

    def _account(self, blob: bytes, purpose: str) -> None:
        self.ledger[purpose] = self.ledger.get(purpose, 0) + len(blob)

    def ledger_total(self) -> int:
        return sum(self.ledger.values())

    def allgather(self, blob: bytes, purpose: str = "misc") -> List[bytes]:
        raise NotImplementedError


class NetComm(Comm):
    """A rank of a multi-process run, over parallel/collect.py's bounded
    allgather (which emits the ``net.bytes`` counter)."""

    def __init__(self):
        from . import distributed

        super().__init__(distributed.process_index(), distributed.process_count())

    def allgather(self, blob: bytes, purpose: str = "misc") -> List[bytes]:
        from . import collect

        self._account(blob, purpose)
        return collect.allgather_bytes(blob, purpose=purpose)


class LocalGroup:
    """Shared state of an in-process group of ``LocalComm`` ranks.

    An exchange: write own slot -> barrier -> snapshot all slots ->
    barrier; the second barrier keeps a fast rank from overwriting its
    slot before a slow one has read it.  A rank that raises leaves the
    others waiting at the barrier: callers join rank threads with a time
    limit, or abort ``barrier`` (the waiters raise
    ``threading.BrokenBarrierError``)."""

    def __init__(self, nproc: int):
        self.nproc = int(nproc)
        self.slots: List[bytes] = [b""] * self.nproc
        self.barrier = threading.Barrier(self.nproc)

    def comms(self) -> List["LocalComm"]:
        return [LocalComm(r, self) for r in range(self.nproc)]


class LocalComm(Comm):
    """One rank of a ``LocalGroup``: exact byte accounting, no network."""

    def __init__(self, rank: int, group: LocalGroup):
        super().__init__(rank, group.nproc)
        self.group = group

    def allgather(self, blob: bytes, purpose: str = "misc") -> List[bytes]:
        self._account(blob, purpose)
        tracer.counter("net.bytes", float(len(blob)), purpose=purpose, transport="local")
        return self.exchange(blob)

    def exchange(self, blob: bytes) -> List[bytes]:
        """The slot exchange itself, not in the ledger (parallel/collect.py's
        collectives in a rank thread, which ``NetComm``'s ledger does not
        count either)."""
        if self.nproc == 1:
            return [blob]
        self.group.slots[self.rank] = blob
        self.group.barrier.wait()
        out = list(self.group.slots)
        self.group.barrier.wait()
        return out


_tls = threading.local()


@contextlib.contextmanager
def rank_thread(comm: LocalComm):
    """Within the block the calling thread is rank ``comm.rank`` of the
    in-process world of ``comm``'s group."""
    prev = getattr(_tls, "comm", None)
    _tls.comm = comm
    try:
        yield comm
    finally:
        _tls.comm = prev


def thread_comm() -> Optional[LocalComm]:
    """The ``LocalComm`` of the calling rank thread, or None."""
    return getattr(_tls, "comm", None)
