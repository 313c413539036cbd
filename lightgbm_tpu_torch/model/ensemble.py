"""Stacked tree arrays for batched prediction — the numpy half of
lightgbm_tpu/model/ensemble.py."""

from __future__ import annotations

from typing import List

import numpy as np


def split_hi_lo(x: np.ndarray):
    """Triple-float (hi, lo, lo2) planes of a float64 array:
    hi = f32(x), lo = f32(x - hi), lo2 = f32(x - hi - lo).  A
    lexicographic comparison of the planes reproduces the float64 ``<=``
    exactly (Tree::NumericalDecision is a double compare)."""
    f32max = np.finfo(np.float32).max
    c = np.clip(x, -f32max, f32max)
    hi = c.astype(np.float32)
    r1 = c - hi.astype(np.float64)
    lo = np.clip(r1, -f32max, f32max).astype(np.float32)
    r2 = r1 - lo.astype(np.float64)
    lo2 = np.clip(r2, -f32max, f32max).astype(np.float32)
    return hi, lo, lo2


def stack_trees(trees: List) -> dict:
    """Pad T trees to (T, M) node / (T, L) leaf numpy arrays.  Unused node
    slots point at leaf 0; a 1-leaf tree gets a sentinel node routing
    every row to its single leaf."""
    t = len(trees)
    m = max(max((tr.num_leaves - 1 for tr in trees), default=1), 1)
    L = max(max((tr.num_leaves for tr in trees), default=1), 1)
    split_feature = np.zeros((t, m), np.int32)
    threshold_real = np.zeros((t, m), np.float64)
    default_value = np.zeros((t, m), np.float64)
    is_cat = np.zeros((t, m), np.bool_)
    left = np.full((t, m), -1, np.int32)
    right = np.full((t, m), -1, np.int32)
    leaf_value = np.zeros((t, L), np.float32)
    for i, tr in enumerate(trees):
        n = tr.num_leaves
        if n <= 1:
            threshold_real[i, 0] = np.inf
            leaf_value[i, 0] = tr.leaf_value[0]
            continue
        k = n - 1
        split_feature[i, :k] = tr.split_feature[:k]
        threshold_real[i, :k] = tr.threshold[:k]
        default_value[i, :k] = tr.default_value[:k]
        is_cat[i, :k] = tr.decision_type[:k] == 1
        left[i, :k] = tr.left_child[:k]
        right[i, :k] = tr.right_child[:k]
        leaf_value[i, :n] = tr.leaf_value[:n]
    thr_hi, thr_lo, thr_lo2 = split_hi_lo(threshold_real)
    dv_hi, dv_lo, dv_lo2 = split_hi_lo(default_value)
    return {
        "split_feature_real": split_feature,
        "threshold_real": thr_hi,
        "threshold_real_lo": thr_lo,
        "threshold_real_lo2": thr_lo2,
        "default_value_real": dv_hi,
        "default_value_real_lo": dv_lo,
        "default_value_real_lo2": dv_lo2,
        "is_categorical": is_cat,
        "left_child": left,
        "right_child": right,
        "leaf_value": leaf_value,
    }
