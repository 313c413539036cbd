"""Tree-growth strategies — PyTorch counterpart of lightgbm_tpu/tree/:
``strategy.py``, the four seams every learner reads (split gain, leaf
fit, histogram accumulation, export), and ``linear.py``, the
piecewise-linear leaf fit."""

from .strategy import (
    DEFAULT_STRATEGY,
    HistAccumStrategy,
    LeafFitStrategy,
    SplitGainStrategy,
    StateExportStrategy,
    TreeStrategy,
    parse_monotone_constraints,
)

__all__ = [
    "DEFAULT_STRATEGY",
    "HistAccumStrategy",
    "LeafFitStrategy",
    "SplitGainStrategy",
    "StateExportStrategy",
    "TreeStrategy",
    "parse_monotone_constraints",
]
