"""Batched tree traversal — PyTorch counterpart of lightgbm_tpu/ops/predict.py
``predict_raw`` and ``predict_leaf`` over raw features (Tree::Predict /
GetLeaf, include/LightGBM/tree.h:232-276), ``predict_binned`` over a
dataset's bins (the validation scores, gbdt.cpp:989-1008 AddScore on
binned data) and ``predict_words`` over the mask grower's packed bin
words (rollback and DART on the training set).

All trees walk the batch in lockstep: a (T, N) node-index tensor
advances one level per step by gathers into the stacked node arrays; a
raw batch goes in row chunks that keep the (T, rows) tensors near 2^26
elements.
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


# rows a traversal walks at once: its (T, rows) node tensors stay near
# this many elements, so a large batch does not hold many GiB of them
_CHUNK_ELEMS = 1 << 26


def _row_chunks(n: int, T: int):
    step = max(1, _CHUNK_ELEMS // max(T, 1))
    return [(lo, min(n, lo + step)) for lo in range(0, n, step)] or [(0, 0)]


def _leaves_raw(planes, trees: TreeArrays) -> torch.Tensor:
    """(T, N) int64 leaf of each row of the (hi, lo, lo2) feature planes in
    each stacked tree."""
    dev = trees.leaf_value.device
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
    return ~node


def _chunked_raw(data: np.ndarray, trees: TreeArrays, fn):
    """``fn(leaves)`` of each row chunk of ``data``, concatenated along the
    last axis."""
    dev = trees.leaf_value.device
    planes = split_hi_lo(np.asarray(data, np.float64))
    outs = []
    for lo, hi in _row_chunks(planes[0].shape[0], trees.leaf_value.shape[0]):
        chunk = [torch.from_numpy(np.ascontiguousarray(x[lo:hi])).to(dev) for x in planes]
        outs.append(fn(_leaves_raw(chunk, trees)))
    return torch.cat(outs, dim=-1)


def predict_leaf(data: np.ndarray, trees: TreeArrays) -> torch.Tensor:
    """(T, N) int64 leaf index of each row of a raw float64 matrix in each
    stacked tree, on the trees' device: the walk of ``predict_raw`` (the
    same float64-exact compare), so a row's leaf and its raw score always
    follow one path (Tree::GetLeaf, the JAX package's
    ``Tree.predict_leaf_index`` row by row)."""
    return _chunked_raw(data, trees, lambda leaves: leaves)


def predict_raw(data: np.ndarray, trees: TreeArrays, num_class: int = 1) -> np.ndarray:
    """(K, N) float64 raw scores, K = ``num_class``: class k is the
    float32 sum of each row's leaf value over the trees i with
    i % K == k (the model stores the K trees of an iteration in turn)."""
    def sums(leaves):
        vals = torch.gather(trees.leaf_value, 1, leaves)
        return torch.stack([vals[k::num_class].sum(dim=0) for k in range(num_class)])

    return _chunked_raw(data, trees, sums).double().cpu().numpy()


BINNED_FIELDS = ("split_feature_inner", "threshold_bin", "zero_bin", "default_bin_for_zero",
                 "is_categorical", "left_child", "right_child", "leaf_value")


def _predict_columns(n: int, column, arrays: dict, dev) -> torch.Tensor:
    """(N,) float32 leaf-value sum of stacked trees over binned rows;
    ``column(features (T, N), rows)`` gives each row's bin of the feature
    a tree's node tests.  A bin equal to a node's zero bin takes its
    default bin for zero, then ``==`` (categorical) or ``<=`` against the
    threshold bin."""
    a = {f: torch.from_numpy(np.asarray(arrays[f])).to(dev) for f in BINNED_FIELDS}
    a = {f: (v.to(torch.int64) if v.dtype == torch.int32 else v) for f, v in a.items()}
    T = a["leaf_value"].shape[0]
    rows = torch.arange(n, device=dev)
    tix = torch.arange(T, device=dev)[:, None]
    node = torch.zeros((T, n), dtype=torch.int64, device=dev)
    while bool((node >= 0).any()):
        j = node.clamp(min=0)
        col = column(a["split_feature_inner"][tix, j], rows)
        fval = torch.where(col == a["zero_bin"][tix, j], a["default_bin_for_zero"][tix, j], col)
        thr = a["threshold_bin"][tix, j]
        goes_left = torch.where(a["is_categorical"][tix, j], fval == thr, fval <= thr)
        nxt = torch.where(goes_left, a["left_child"][tix, j], a["right_child"][tix, j])
        node = torch.where(node >= 0, nxt, node)
    return torch.gather(a["leaf_value"], 1, ~node).sum(dim=0)


def predict_binned(bins: torch.Tensor, arrays: dict) -> torch.Tensor:
    """(N,) float32 sum of the leaf values of stacked trees over binned
    rows: ``bins`` is an (N, F) integer tensor of inner-feature bins (an
    unbundled dataset's), ``arrays`` model/ensemble.stack_trees output."""
    bins_t = bins.t()
    return _predict_columns(bins.shape[0], lambda f, rows: bins_t[f, rows].to(torch.int64),
                            arrays, bins.device)


def predict_words(words: torch.Tensor, per: int, bits: int, arrays: dict) -> torch.Tensor:
    """``predict_binned`` over the mask grower's (W, N) packed bin words
    (ops/histogram.py ``pack_bin_words``: feature f in word f // per at
    bit (f % per) * bits), so a traversal of the training set needs no
    (N, F) copy of its bins on the device."""
    mask = (1 << bits) - 1

    def column(f, rows):
        w = words[f // per, rows].to(torch.int64) & 0xFFFFFFFF
        return (w >> ((f % per) * bits)) & mask

    return _predict_columns(words.shape[1], column, arrays, words.device)
