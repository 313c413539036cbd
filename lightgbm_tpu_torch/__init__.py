"""lightgbm_tpu_torch — the PyTorch/CUDA port of lightgbm_tpu.

Trains the partitioned GBDT path (binary logloss and L2 regression,
serial learner) on an NVIDIA Hopper card through hand-written CUDA
kernels (``csrc/``), and predicts with plain torch.  Imports torch and
numpy only; the kernels build at first use, so the package imports on a
machine with no CUDA.  Entry points run on the card unless given
``device="cpu"``, where the kernels' plain PyTorch versions run.
"""

from .basic import Booster, Dataset
from .config import Config
from .engine import train
from .utils.log import LightGBMError

__all__ = ["Booster", "Config", "Dataset", "LightGBMError", "train"]
