"""Parallel tree learners — PyTorch counterpart of lightgbm_tpu/parallel/,
the part that runs in one process: the byte-blob communicator surface
with its in-process rank group (``comm.py``) and the host-driven data,
feature and voting learners over it (``hostlearner.py``), whose node
histograms run B8 / B9 (ops/histogram.py) on each rank's shard.

The multi-process transport (``NetComm``, the bootstrap, deadlines and
heartbeats), the mesh learner and the elastic membership are not ported
yet: a run that asks for several processes is refused
(boosting/gbdt.py ``unsupported_feature``), and one process trains a
parallel ``tree_learner`` serially.
"""

from .comm import Comm, LocalComm, LocalGroup
from .hostlearner import HostParallelLearner

__all__ = ["Comm", "HostParallelLearner", "LocalComm", "LocalGroup"]
