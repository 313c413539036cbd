"""Tree model layer — counterpart of lightgbm_tpu/model."""

from .ensemble import stack_trees
from .tree import Tree

__all__ = ["Tree", "stack_trees"]
