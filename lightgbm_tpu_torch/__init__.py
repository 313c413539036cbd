"""lightgbm_tpu_torch — the PyTorch/CUDA port of lightgbm_tpu.

Trains gradient-boosted trees (GBDT, GOSS and DART; binary, multiclass,
regression and ranking objectives) on an NVIDIA Hopper card through
hand-written CUDA kernels (``csrc/``), and predicts with plain torch:
``train``, ``cv``, continued training, the ``Booster`` and ``Dataset``
methods and the scikit-learn-style estimators.  Imports torch and numpy
only (pandas, scipy and scikit-learn only when given their objects); the
kernels build at first use, so the package imports on a machine with no
CUDA.  Entry points run on the card unless given ``device="cpu"``, where
the kernels' plain PyTorch versions run.
"""

from .basic import Booster, Dataset
from .callback import early_stopping, log_evaluation, print_evaluation, record_evaluation
from .callback import reset_parameter
from .config import Config
from .engine import cv, train
from .sklearn import LGBMClassifier, LGBMModel, LGBMRanker, LGBMRegressor
from .utils.log import LightGBMError

__all__ = ["Booster", "Config", "Dataset", "LGBMClassifier", "LGBMModel", "LGBMRanker",
           "LGBMRegressor", "LightGBMError", "cv", "early_stopping", "log_evaluation",
           "print_evaluation", "record_evaluation", "reset_parameter", "train"]
