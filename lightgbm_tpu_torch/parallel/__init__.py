"""Parallel tree learners — PyTorch counterpart of lightgbm_tpu/parallel/:
the byte-blob communicators (``comm.py``: ``NetComm`` across processes,
``LocalComm`` rank threads in one process) and the host-driven data,
feature and voting learners over them (``hostlearner.py``), whose node
histograms run B8 / B9 (ops/histogram.py) on each rank's shard; the
multi-process transport under ``NetComm``: the bootstrap
(``distributed.py``), the bounded byte collectives (``collect.py``) and
the deadlines, heartbeats and typed failures under them (``net.py``),
over a TCPStore that rank 0 hosts.

Not ported: the mesh learner (``learner.py ShardedLearner``) and the
array transport, whose torch form is NCCL across two or more cards, and
the elastic membership.
"""

from .comm import Comm, LocalComm, LocalGroup, NetComm
from .hostlearner import HostParallelLearner
from .net import CollectiveTimeoutError, NetError, PeerFailureError

__all__ = ["CollectiveTimeoutError", "Comm", "HostParallelLearner", "LocalComm", "LocalGroup",
           "NetComm", "NetError", "PeerFailureError"]
