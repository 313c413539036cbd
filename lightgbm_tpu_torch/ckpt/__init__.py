"""Checkpoints with bit-identical resume — PyTorch-port copy of
lightgbm_tpu/ckpt/.

A checkpoint is the complete training state, and a resume is bit for bit
the run that never stopped:

  ``state.py``    the versioned ``TrainState``: the trees in binary, the
                  training and validation scores, every random stream,
                  the early-stopping bests, and config and dataset
                  fingerprints that refuse a mismatched resume;
  ``store.py``    atomic tmp + fsync + rename writes, a CRC manifest,
                  rolling retention, the latest valid checkpoint past a
                  corrupt tail, the completion marker;
  ``manager.py``  ``CheckpointManager``: a training callback with
                  background writes and the SIGTERM flush-and-exit.

Blobs and directories are the JAX package's format: either package
resumes the other's checkpoints.  Over several processes rank 0 writes
one canonical container in global row order, which any world resumes.
"""

from .manager import CheckpointManager, PreemptionExit  # noqa: F401
from .state import CheckpointMismatch, TrainState, capture, restore  # noqa: F401
from .store import CheckpointStore  # noqa: F401

__all__ = ["CheckpointManager", "CheckpointMismatch", "CheckpointStore", "PreemptionExit",
           "TrainState", "capture", "restore"]
