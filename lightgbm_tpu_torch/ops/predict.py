"""Batched tree traversal over raw features — PyTorch counterpart of
lightgbm_tpu/ops/predict.py ``predict_raw`` (Tree::Predict / GetLeaf,
include/LightGBM/tree.h:232-276).

All trees walk the whole batch in lockstep: a (T, N) node-index tensor
advances one level per step by gathers into the stacked node arrays.
Decisions use the triple-float (hi, lo, lo2) compare ``_le3``, which
reproduces the reference's float64 ``<=`` exactly on float32 hardware.
The JAX package predicts through XLA with no Pallas kernel, and so does
this module (plain torch).
"""

from __future__ import annotations

import numpy as np
import torch

from ..io.binning import MISSING_VALUE_RANGE
from ..model.ensemble import split_hi_lo

_MR = float(MISSING_VALUE_RANGE)
_MR_HI = np.float32(_MR)
_MR_LO = np.float32(_MR - float(_MR_HI))
_MR_LO2 = np.float32(_MR - float(_MR_HI) - float(_MR_LO))


def _le3(ah, al, al2, bh, bl, bl2):
    """Lexicographic ``a <= b`` over triple-float planes."""
    return (ah < bh) | ((ah == bh) & (al < bl)) | ((ah == bh) & (al == bl) & (al2 <= bl2))


class TreeArrays:
    """Stacked (T, M) node / (T, L) leaf tensors on one device."""

    FIELDS = ("split_feature_real", "threshold_real", "threshold_real_lo",
              "threshold_real_lo2", "default_value_real", "default_value_real_lo",
              "default_value_real_lo2", "is_categorical", "left_child", "right_child",
              "leaf_value")

    def __init__(self, **kw):
        for f in self.FIELDS:
            setattr(self, f, kw[f])

    @classmethod
    def from_stacked(cls, arrays: dict, device) -> "TreeArrays":
        """From model/ensemble.stack_trees numpy output."""
        out = {}
        for f in cls.FIELDS:
            a = np.asarray(arrays[f])
            t = torch.from_numpy(a.astype(np.int64) if a.dtype == np.int32 else a)
            out[f] = t.to(device)
        return cls(**out)


def predict_raw(data: np.ndarray, trees: TreeArrays) -> np.ndarray:
    """(N,) float64 raw scores: the float32 sum over trees of each row's
    leaf value."""
    dev = trees.leaf_value.device
    planes = [torch.from_numpy(np.ascontiguousarray(x)).to(dev)
              for x in split_hi_lo(np.asarray(data, np.float64))]
    T = trees.leaf_value.shape[0]
    n = planes[0].shape[0]
    node = torch.zeros((T, n), dtype=torch.int64, device=dev)
    tix = torch.arange(T, device=dev)[:, None]

    def at(a, j):  # (T, M) node array at (T, N) node indices
        return a[tix, j]

    while bool((node >= 0).any()):
        j = node.clamp(min=0)
        feat = at(trees.split_feature_real, j)
        v_hi, v_lo, v_lo2 = (torch.gather(x.expand(T, n, x.shape[1]), 2, feat[..., None])[..., 0]
                             for x in planes)
        gt_neg = ~_le3(v_hi, v_lo, v_lo2, -_MR_HI, -_MR_LO, -_MR_LO2)
        le_pos = _le3(v_hi, v_lo, v_lo2, _MR_HI, _MR_LO, _MR_LO2)
        is_zero = (gt_neg & le_pos) | torch.isnan(v_hi)  # NaN rides the zero bin
        f_hi = torch.where(is_zero, at(trees.default_value_real, j), v_hi)
        f_lo = torch.where(is_zero, at(trees.default_value_real_lo, j), v_lo)
        f_lo2 = torch.where(is_zero, at(trees.default_value_real_lo2, j), v_lo2)
        t_hi = at(trees.threshold_real, j)
        le = _le3(f_hi, f_lo, f_lo2, t_hi, at(trees.threshold_real_lo, j),
                  at(trees.threshold_real_lo2, j))
        goes_left = torch.where(at(trees.is_categorical, j),
                                f_hi.to(torch.int32) == t_hi.to(torch.int32), le)
        nxt = torch.where(goes_left, at(trees.left_child, j), at(trees.right_child, j))
        node = torch.where(node >= 0, nxt, node)
    vals = torch.gather(trees.leaf_value, 1, ~node)
    return vals.sum(dim=0).double().cpu().numpy()
