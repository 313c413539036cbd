"""Stacked tree arrays for batched prediction — the numpy half of
lightgbm_tpu/model/ensemble.py, with the linear-leaf planes."""

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
    split_feature_inner = np.zeros((t, m), np.int32)
    threshold_bin = np.zeros((t, m), np.int32)
    zero_bin = np.zeros((t, m), np.int32)
    dbz = np.zeros((t, m), np.int32)
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
            threshold_bin[i, 0] = np.iinfo(np.int32).max
            leaf_value[i, 0] = tr.leaf_value[0]
            continue
        k = n - 1
        split_feature[i, :k] = tr.split_feature[:k]
        split_feature_inner[i, :k] = tr.split_feature_inner[:k]
        threshold_bin[i, :k] = tr.threshold_in_bin[:k]
        zero_bin[i, :k] = tr.zero_bin[:k]
        dbz[i, :k] = tr.default_bin_for_zero[:k]
        threshold_real[i, :k] = tr.threshold[:k]
        default_value[i, :k] = tr.default_value[:k]
        is_cat[i, :k] = tr.decision_type[:k] == 1
        left[i, :k] = tr.left_child[:k]
        right[i, :k] = tr.right_child[:k]
        leaf_value[i, :n] = tr.leaf_value[:n]
    thr_hi, thr_lo, thr_lo2 = split_hi_lo(threshold_real)
    dv_hi, dv_lo, dv_lo2 = split_hi_lo(default_value)
    out = _linear_planes(trees, t, L)
    out.update({
        "split_feature_real": split_feature,
        "split_feature_inner": split_feature_inner,
        "threshold_bin": threshold_bin,
        "zero_bin": zero_bin,
        "default_bin_for_zero": dbz,
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
    })
    return out


LINEAR_FIELDS = ("leaf_feat_inner", "leaf_feat_real", "leaf_feat_valid", "leaf_coeff",
                 "leaf_const", "leaf_is_linear")


def _linear_planes(trees: List, t: int, L: int) -> dict:
    """The (T, L, k) linear-leaf planes (JAX ensemble.py l.106-149),
    emitted only when a tree has linear leaf models, so constant stacks
    keep their layout: ``leaf_feat_inner`` for walks over bins (with a
    value table), ``leaf_feat_real`` for raw rows; padded slots have
    coefficient 0 and validity 0."""
    if not any(getattr(tr, "is_linear", False) for tr in trees):
        return {}
    k = max([1] + [len(fs) for tr in trees if tr.is_linear for fs in tr.leaf_features])
    feat_inner = np.zeros((t, L, k), np.int32)
    feat_real = np.zeros((t, L, k), np.int32)
    feat_valid = np.zeros((t, L, k), np.float32)
    coeff = np.zeros((t, L, k), np.float32)
    const = np.zeros((t, L), np.float32)
    is_lin = np.zeros((t, L), np.bool_)
    for i, tr in enumerate(trees):
        if not tr.is_linear:
            continue
        n = max(tr.num_leaves, 1)
        const[i, :n] = tr.leaf_const[:n]
        is_lin[i, :n] = tr.leaf_is_linear[:n]
        for li in range(min(n, len(tr.leaf_features))):
            fs = tr.leaf_features[li]
            if not fs or not tr.leaf_is_linear[li]:
                continue
            feat_real[i, li, :len(fs)] = fs
            feat_inner[i, li, :len(fs)] = tr.leaf_features_inner[li]
            feat_valid[i, li, :len(fs)] = 1.0
            coeff[i, li, :len(fs)] = tr.leaf_coeff[li]
    return dict(zip(LINEAR_FIELDS, (feat_inner, feat_real, feat_valid, coeff, const, is_lin)))
