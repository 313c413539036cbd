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
``Booster.predict`` steps until every row sits on a leaf (a host read a
step); the server's walk (serve/compilecache.py) gives ``_leaves_raw`` a
static step count (``walk_levels``) so that a CUDA graph can hold it.
The JAX package predicts through XLA with no Pallas kernel, and so does
this module (plain torch).

Linear leaves (the JAX package's ``predict_raw_linear`` and
``tree/linear.py predict_linear_binned``): when the stacked trees carry linear planes
(model/ensemble.py emits them only then), a linear leaf's output is
const + coeff · x, x the raw value's float32 hi plane (a NaN path feature
keeps the constant) or, over bins, the bin's representative value from
the caller's value table; constant stacks take the plain gather.
"""

from __future__ import annotations

import numpy as np
import torch

from ..io.binning import MISSING_VALUE_RANGE
from ..model.ensemble import LINEAR_FIELDS, split_hi_lo
from ..tree.linear import apply_linear, binned_values

_MR = float(MISSING_VALUE_RANGE)
_MR_HI = np.float32(_MR)
_MR_LO = np.float32(_MR - float(_MR_HI))
_MR_LO2 = np.float32(_MR - float(_MR_HI) - float(_MR_LO))


def _le3(ah, al, al2, bh, bl, bl2):
    """Lexicographic ``a <= b`` over triple-float planes."""
    return (ah < bh) | ((ah == bh) & (al < bl)) | ((ah == bh) & (al == bl) & (al2 <= bl2))


def _to_device(arrays: dict, fields, device) -> dict:
    """The named numpy arrays as tensors on ``device``, int32 widened to
    int64 (index dtype)."""
    out = {}
    for f in fields:
        a = np.asarray(arrays[f])
        out[f] = torch.from_numpy(a.astype(np.int64) if a.dtype == np.int32 else a).to(device)
    return out


def _linear_tensors(arrays: dict, device):
    """The stack's linear planes on ``device``, or None for a constant
    stack."""
    return _to_device(arrays, LINEAR_FIELDS, device) if LINEAR_FIELDS[0] in arrays else None


class TreeArrays:
    """Stacked (T, M) node / (T, L) leaf tensors on one device, and the
    (T, L, k) linear planes when a tree has linear leaves."""

    FIELDS = ("split_feature_real", "threshold_real", "threshold_real_lo",
              "threshold_real_lo2", "default_value_real", "default_value_real_lo",
              "default_value_real_lo2", "is_categorical", "left_child", "right_child",
              "leaf_value")

    def __init__(self, linear=None, **kw):
        for f in self.FIELDS:
            setattr(self, f, kw[f])
        self.linear = linear

    @classmethod
    def from_stacked(cls, arrays: dict, device) -> "TreeArrays":
        """From model/ensemble.stack_trees numpy output."""
        return cls(linear=_linear_tensors(arrays, device),
                   **_to_device(arrays, cls.FIELDS, device))


class PackedTreeArrays:
    """Stacked (T, M) node / (T, L) leaf numpy arrays under the JAX
    package's ``TreeArrays.FIELDS`` names: the host record of a packed
    predictor artifact (serve/artifact.py), binned planes included, so an
    artifact written by either package loads in the other.  A tree with
    one leaf has node 0 as (left=~0, right=~0)."""

    FIELDS = (
        "split_feature",  # (T, M) int32 — inner (binned) feature
        "split_feature_real",  # (T, M) int32 — original feature
        "threshold_bin",  # (T, M) int32
        "threshold_real",  # (T, M) f32 hi plane
        "threshold_real_lo",  # (T, M) f32 lo plane
        "threshold_real_lo2",  # (T, M) f32 lo2 plane
        "zero_bin",  # (T, M) int32
        "default_bin_for_zero",  # (T, M) int32
        "default_value_real",  # (T, M) f32 hi plane
        "default_value_real_lo",  # (T, M) f32 lo plane
        "default_value_real_lo2",  # (T, M) f32 lo2 plane
        "is_categorical",  # (T, M) bool
        "left_child",  # (T, M) int32  (>=0 node, <0 → leaf ~idx)
        "right_child",  # (T, M) int32
        "leaf_value",  # (T, L) f32 (post-shrinkage)
    )

    def __init__(self, **kw):
        for f in self.FIELDS:
            setattr(self, f, kw[f])

    def validate(self) -> "PackedTreeArrays":
        """Every field 2-D, (T, M) for the node planes and (T, L) for
        ``leaf_value``; raises ValueError naming the first offending
        field."""
        t_m = None
        for f in PackedTreeArrays.FIELDS:
            shape = tuple(getattr(getattr(self, f), "shape", ()))
            if len(shape) != 2:
                raise ValueError(f"TreeArrays.{f} must be 2-D, got shape {shape}")
            if f == "leaf_value":
                if t_m is not None and shape[0] != t_m[0]:
                    raise ValueError(f"TreeArrays.leaf_value has {shape[0]} trees but the "
                                     f"node arrays have {t_m[0]}")
            elif t_m is None:
                t_m = shape
            elif shape != t_m:
                raise ValueError(f"TreeArrays.{f} has shape {shape}, expected {t_m} "
                                 f"(T, M) like the other node arrays")
        return self

    def to_device(self, device) -> TreeArrays:
        """The raw walk's tensors on ``device`` (linear planes included)."""
        host = {f: getattr(self, f) for f in self.FIELDS}
        linear = None
        if isinstance(self, PackedLinearTreeArrays):
            linear = _to_device({f: getattr(self, f) for f in self.LINEAR_FIELDS},
                                self.LINEAR_FIELDS, device)
        return TreeArrays(linear=linear, **_to_device(host, TreeArrays.FIELDS, device))


class PackedLinearTreeArrays(PackedTreeArrays):
    """``PackedTreeArrays`` and the (T, L, K) linear-leaf planes of a v3
    artifact (JAX ``LinearTreeArrays``)."""

    LINEAR_FIELDS = (
        "leaf_feat_real",  # (T, L, K) int32 — raw-path gather index
        "leaf_feat_valid",  # (T, L, K) f32 0/1 — padded-slot mask
        "leaf_coeff",  # (T, L, K) f32 (post-shrinkage)
        "leaf_const",  # (T, L) f32 (post-shrinkage)
        "leaf_is_linear",  # (T, L) bool
    )
    FIELDS = PackedTreeArrays.FIELDS + LINEAR_FIELDS

    def validate(self) -> "PackedLinearTreeArrays":
        tlk = None
        for f in ("leaf_feat_real", "leaf_feat_valid", "leaf_coeff"):
            shape = tuple(getattr(getattr(self, f), "shape", ()))
            if len(shape) != 3:
                raise ValueError(f"LinearTreeArrays.{f} must be 3-D (T, L, K), "
                                 f"got shape {shape}")
            if tlk is None:
                tlk = shape
            elif shape != tlk:
                raise ValueError(f"LinearTreeArrays.{f} has shape {shape}, expected "
                                 f"{tlk} like the other coefficient planes")
        PackedTreeArrays.validate(self)
        for f in ("leaf_const", "leaf_is_linear"):
            shape = tuple(getattr(getattr(self, f), "shape", ()))
            if len(shape) != 2:
                raise ValueError(f"LinearTreeArrays.{f} must be 2-D (T, L), "
                                 f"got shape {shape}")
        return self


def leaf_outputs(leaves: torch.Tensor, leaf_value: torch.Tensor, linear, feat: str,
                 x_of) -> torch.Tensor:
    """(T, N) float32 output of each row's leaf in each tree: the leaf
    value, or for a linear leaf its model at ``x_of(feats, lo, hi)``'s
    values of the plane ``linear[feat]`` (tree/linear.py
    ``apply_linear``)."""
    out = torch.gather(leaf_value, 1, leaves)
    if linear is None:
        return out
    for t in range(leaves.shape[0]):
        apply_linear(out[t], leaves[t], linear[feat][t], linear["leaf_feat_valid"][t],
                     linear["leaf_coeff"][t], linear["leaf_const"][t],
                     linear["leaf_is_linear"][t], x_of)
    return out


# rows a traversal walks at once: its (T, rows) node tensors stay near
# this many elements, so a large batch does not hold many GiB of them
_CHUNK_ELEMS = 1 << 26


def _row_chunks(n: int, T: int):
    step = max(1, _CHUNK_ELEMS // max(T, 1))
    return [(lo, min(n, lo + step)) for lo in range(0, n, step)] or [(0, 0)]


def walk_levels(left_child: np.ndarray, right_child: np.ndarray) -> int:
    """1 + the deepest split node's depth over stacked (T, M) child arrays
    (``>= 0`` a node, ``< 0`` a leaf): the steps after which every row of
    every tree sits on a leaf.  Padded slots are unreachable from node 0."""
    left = np.asarray(left_child, np.int64)
    right = np.asarray(right_child, np.int64)
    t, m = left.shape
    depth = np.full((t, m), -1, np.int64)
    depth[:, 0] = 0
    d = 0
    while True:
        cur = depth == d
        if not cur.any():
            return d
        for child in (left, right):
            ti, j = np.nonzero(cur & (child >= 0))
            depth[ti, child[ti, j]] = d + 1
        d += 1


def _leaves_raw(planes, trees: TreeArrays, levels=None) -> torch.Tensor:
    """(T, N) int64 leaf of each row of the (hi, lo, lo2) feature planes in
    each stacked tree.  Without ``levels`` the walk steps until every row
    sits on a leaf (a host read a step); with it, exactly ``levels`` steps
    (at least ``walk_levels`` of the trees) and no read of the device, so
    the walk can be captured in a CUDA graph: a finished row stays put."""
    dev = trees.leaf_value.device
    T = trees.leaf_value.shape[0]
    n = planes[0].shape[0]
    node = torch.zeros((T, n), dtype=torch.int64, device=dev)
    tix = torch.arange(T, device=dev)[:, None]

    def at(a, j):  # (T, M) node array at (T, N) node indices
        return a[tix, j]

    def more(step):
        return bool((node >= 0).any()) if levels is None else step < levels

    step = 0
    while more(step):
        step += 1
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
    """``fn(leaves, planes)`` of each row chunk of ``data`` (its leaves and
    its (hi, lo, lo2) planes), concatenated along the last axis."""
    dev = trees.leaf_value.device
    planes = split_hi_lo(np.asarray(data, np.float64))
    outs = []
    for lo, hi in _row_chunks(planes[0].shape[0], trees.leaf_value.shape[0]):
        chunk = [torch.from_numpy(np.ascontiguousarray(x[lo:hi])).to(dev) for x in planes]
        outs.append(fn(_leaves_raw(chunk, trees), chunk))
    return torch.cat(outs, dim=-1)


def raw_leaf_outputs(leaves: torch.Tensor, hi_plane: torch.Tensor,
                     trees: TreeArrays) -> torch.Tensor:
    """(T, N) float32 leaf outputs of raw rows whose float32 hi plane is
    ``hi_plane`` (N, F): linear leaves read their path features there
    (JAX ``predict_raw_linear``)."""
    return leaf_outputs(leaves, trees.leaf_value, trees.linear, "leaf_feat_real",
                        lambda feats, lo, hi: torch.gather(hi_plane[lo:hi], 1, feats))


def predict_leaf(data: np.ndarray, trees: TreeArrays) -> torch.Tensor:
    """(T, N) int64 leaf index of each row of a raw float64 matrix in each
    stacked tree, on the trees' device: the walk of ``predict_raw`` (the
    same float64-exact compare), so a row's leaf and its raw score always
    follow one path (Tree::GetLeaf, the JAX package's
    ``Tree.predict_leaf_index`` row by row)."""
    return _chunked_raw(data, trees, lambda leaves, planes: leaves)


def predict_raw(data: np.ndarray, trees: TreeArrays, num_class: int = 1) -> np.ndarray:
    """(K, N) float64 raw scores, K = ``num_class``: class k is the
    float32 sum of each row's leaf value over the trees i with
    i % K == k (the model stores the K trees of an iteration in turn)."""
    def sums(leaves, planes):
        return class_sums(raw_leaf_outputs(leaves, planes[0], trees), num_class)

    return _chunked_raw(data, trees, sums).double().cpu().numpy()


# torch.sum over the trees (dim 0) on the CPU sums the columns of a
# partial block of this many in another order, so a row's sum would
# depend on how many rows share its batch; whole blocks sum alike
_CPU_SUM_COLS = 128


def class_sums(vals: torch.Tensor, num_class: int) -> torch.Tensor:
    """(K, N) float32 sums of (T, N) tree outputs, class k over the trees
    i with i % K == k.  On the CPU the columns are padded to whole blocks
    of ``_CPU_SUM_COLS``, so a row's sum is the same in a batch of any
    size (a served row's equals ``Booster.predict``'s)."""
    n = vals.shape[1]
    vals = vals.float()
    if vals.device.type == "cpu" and n % _CPU_SUM_COLS:
        vals = torch.nn.functional.pad(vals, (0, _CPU_SUM_COLS - n % _CPU_SUM_COLS))
    return torch.stack([vals[k::num_class].sum(dim=0)[:n] for k in range(num_class)])


BINNED_FIELDS = ("split_feature_inner", "threshold_bin", "zero_bin", "default_bin_for_zero",
                 "is_categorical", "left_child", "right_child", "leaf_value")


def bins_column(bins: torch.Tensor):
    """``column(f, rows)`` of an (N, F) bin tensor: the int64 bins of
    features ``f`` at ``rows`` (broadcast)."""
    return lambda f, rows: bins[rows, f].to(torch.int64)


def words_column(words: torch.Tensor, per: int, bits: int):
    """``column(f, rows)`` of the mask grower's (W, N) packed bin words
    (ops/histogram.py ``pack_bin_words``: feature f in word f // per at
    bit (f % per) * bits)."""
    mask = (1 << bits) - 1

    def column(f, rows):
        w = words[f // per, rows].to(torch.int64) & 0xFFFFFFFF
        return (w >> ((f % per) * bits)) & mask

    return column


def _predict_columns(n: int, column, arrays: dict, dev, lut=None) -> torch.Tensor:
    """(N,) float32 output sum of stacked trees over binned rows;
    ``column(features (T, N), rows)`` gives each row's bin of the feature
    a tree's node tests.  A bin equal to a node's zero bin takes its
    default bin for zero, then ``==`` (categorical) or ``<=`` against the
    threshold bin.  Linear leaves read their path features' bins through
    ``lut``, the (F, B) value table (tree/linear.py ``build_value_lut``)."""
    a = _to_device(arrays, BINNED_FIELDS, dev)
    linear = _linear_tensors(arrays, dev)
    if linear is not None and lut is None:
        raise ValueError("linear trees over bins need the bin value table (lut)")
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
    x_of = binned_values(column, lut) if linear is not None else None
    return leaf_outputs(~node, a["leaf_value"], linear, "leaf_feat_inner", x_of).sum(dim=0)


def predict_binned(bins: torch.Tensor, arrays: dict, lut=None) -> torch.Tensor:
    """(N,) float32 sum of the outputs of stacked trees over binned rows:
    ``bins`` is an (N, F) integer tensor of inner-feature bins (an
    unbundled dataset's), ``arrays`` model/ensemble.stack_trees output,
    ``lut`` the value table linear leaves need."""
    return _predict_columns(bins.shape[0], bins_column(bins), arrays, bins.device, lut)


def predict_words(words: torch.Tensor, per: int, bits: int, arrays: dict,
                  lut=None) -> torch.Tensor:
    """``predict_binned`` over the mask grower's (W, N) packed bin words,
    so a traversal of the training set needs no (N, F) copy of its bins
    on the device."""
    return _predict_columns(words.shape[1], words_column(words, per, bits), arrays,
                            words.device, lut)
