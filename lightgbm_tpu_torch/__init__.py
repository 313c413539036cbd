"""lightgbm_tpu_torch — the PyTorch/CUDA port of lightgbm_tpu.

Trains gradient-boosted trees (GBDT, GOSS and DART; binary, multiclass,
regression and ranking objectives) on an NVIDIA Hopper card through
hand-written CUDA kernels (``csrc/``), and predicts with plain torch:
``train``, ``cv``, continued training, the ``Booster`` and ``Dataset``
methods (data files and binary dataset caches among them), the
scikit-learn-style estimators, the command line
(``python -m lightgbm_tpu_torch task=train config=train.conf``), the
C++ and PMML model exports and plotting.  Imports torch and numpy only
(pandas, scipy, scikit-learn, matplotlib and graphviz only when a call
needs them); the kernels and the native text parser build at first use,
so the package imports on a machine with no CUDA.  Entry points run on
the card unless given ``device="cpu"``, where the kernels' plain PyTorch
versions run.
"""

from . import plotting
from .basic import Booster, Dataset
from .callback import early_stopping, log_evaluation, print_evaluation, record_evaluation
from .callback import reset_parameter
from .config import Config
from .engine import cv, train
from .plotting import create_tree_digraph, plot_importance, plot_metric, plot_tree
from .sklearn import LGBMClassifier, LGBMModel, LGBMRanker, LGBMRegressor
from .utils.log import LightGBMError

__all__ = ["Booster", "Config", "Dataset", "LGBMClassifier", "LGBMModel", "LGBMRanker",
           "LGBMRegressor", "LightGBMError", "create_tree_digraph", "cv", "early_stopping",
           "log_evaluation", "plot_importance", "plot_metric", "plot_tree", "print_evaluation",
           "record_evaluation", "reset_parameter", "train"]
