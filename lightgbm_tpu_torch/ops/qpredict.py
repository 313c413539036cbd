"""Quantized batched tree traversal — PyTorch counterpart of
lightgbm_tpu/ops/qpredict.py, the serving-only narrow-int path.

``ops/predict.py`` reproduces the reference's float64 decisions with a
triple-float compare at every node.  A trained model only ever compares a
feature against the finite set of thresholds its own nodes hold, so every
value maps to its integer rank among the feature's thresholds and one
int16 compare per node routes exactly as the float64 reference does.

Encoding (per feature, on the host, float64 throughout): ``table`` = the
sorted distinct thresholds the model's reachable nodes use on the feature
(categorical features store ``trunc(threshold)``); a value ``v`` encodes
as ``2 * searchsorted(table, v, side="left") + (v in table)``, so a node
threshold ``table[i]`` gets the odd code ``2i + 1`` and

    numeric:      code(v) <= 2i + 1  <=>  v <= t
    categorical:  code(v) == 2i + 1  <=>  v == t

Zero and missing values (the DefaultValueForZero range, and NaN) get
``ZERO_CODE``; each node carries its ``default_value`` pre-encoded
(``default_q``), so the remap is one integer select.

The node arrays narrow to int16/int8 and are level-packed (breadth-first
order); ``levels`` (1 + the deepest split node's depth) is a static step
count, so the device walk is a fixed loop of ``levels`` steps with no host
read, which a CUDA graph can hold (serve/compilecache.py).  Leaf values
are stored float16 (or bfloat16) and summed in float32: the only drift
from the exact path, bounded by ``drift_bound``.  The host half is the
JAX package's numpy code; bfloat16 is kept as its raw 16 bits on the host
(numpy has no bfloat16), as the JAX package persists it.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np
import torch

from ..io.binning import MISSING_VALUE_RANGE
from ..utils.log import Log
from .predict import _row_chunks, class_sums

# data code for zero/missing rows (never a valid rank code, which are >= 0)
ZERO_CODE = np.int16(-1)

# widest representable rank code / node index / feature index
_I16_MAX = 32767

LEAF_DTYPES = ("float16", "bfloat16")


def quant_predict_enabled(default: bool = False) -> bool:
    """The ``LIGHTGBM_TPU_QUANT_PREDICT`` pin, read live per call: ``0``
    forces the exact path everywhere, ``1`` opts ``Booster.predict`` and
    serving into the quantized path, unset defers to ``default``."""
    v = os.environ.get("LIGHTGBM_TPU_QUANT_PREDICT")
    if v is None:
        return bool(default)
    return v.strip().lower() not in ("0", "false", "off", "")


def to_bfloat16_bits(x: np.ndarray) -> np.ndarray:
    """uint16 bits of float32 ``x`` rounded to bfloat16 (nearest, ties to
    even; a NaN stays a quiet NaN)."""
    bits = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    rounded = (bits + 0x7FFF + ((bits >> 16) & 1)) >> 16
    nan = np.isnan(np.asarray(x, np.float32))
    out = np.where(nan, (bits >> 16) | 0x40, rounded)
    return out.astype(np.uint16)


def bfloat16_bits_to_float32(bits: np.ndarray) -> np.ndarray:
    return (np.asarray(bits, np.uint16).astype(np.uint32) << 16).view(np.float32)


def narrow_leaves(leaf: np.ndarray, leaf_dtype: str) -> np.ndarray:
    """float32 leaf values in ``leaf_dtype``'s host form: float16, or
    bfloat16's uint16 bits."""
    if leaf_dtype == "float16":
        return np.asarray(leaf, np.float32).astype(np.float16)
    if leaf_dtype == "bfloat16":
        return to_bfloat16_bits(leaf)
    Log.fatal("Unsupported quantized leaf dtype %r (supported: %s)",
              leaf_dtype, ", ".join(LEAF_DTYPES))
    raise AssertionError  # unreachable


class QTreeArrays:
    """Stacked quantized arrays for T trees on the host: narrow node
    planes plus the per-feature threshold tables that encode request data.

    ``levels`` is the static walk bound (1 + max node depth);
    serve/compilecache.py pads it up the same power-of-two ladder as M/L
    so that a same-shape retrain keeps its graphs.  ``leaf_value`` is
    float16, or bfloat16's uint16 bits with ``leaf_dtype="bfloat16"``.
    """

    NODE_FIELDS = (
        "split_feature",  # (T, M) int16 — original feature index
        "threshold_q",  # (T, M) int16 — odd rank code of the threshold
        "default_q",  # (T, M) int16 — rank code of default_value
        "flags",  # (T, M) int8 — bit0: categorical
        "left_child",  # (T, M) int16 (>=0 node, <0 -> leaf ~idx)
        "right_child",  # (T, M) int16
        "leaf_value",  # (T, L) f16 or bf16 bits (post-shrinkage)
    )
    TABLE_FIELDS = (
        "qbin_edges",  # (E,) f64 — per-feature tables, flattened
        "qbin_offsets",  # (F+1,) int32 — table j is edges[off[j]:off[j+1]]
        "feature_flags",  # (F,) int8 — bit0: categorical compare (trunc)
    )
    FIELDS = NODE_FIELDS + TABLE_FIELDS

    def __init__(self, levels: int, leaf_dtype: str = None, **kw):
        self.levels = int(levels)
        for f in self.FIELDS:
            setattr(self, f, kw[f])
        if leaf_dtype is None:
            leaf_dtype = ("float16" if np.asarray(self.leaf_value).dtype == np.float16
                          else str(np.asarray(self.leaf_value).dtype))
        self.leaf_dtype = leaf_dtype

    def validate(self) -> "QTreeArrays":
        t_m = None
        for f in self.NODE_FIELDS:
            a = getattr(self, f)
            shape = tuple(getattr(a, "shape", ()))
            if len(shape) != 2:
                raise ValueError(
                    f"QTreeArrays.{f} must be 2-D, got shape {shape}")
            if f == "leaf_value":
                if t_m is not None and shape[0] != t_m[0]:
                    raise ValueError(
                        f"QTreeArrays.leaf_value has {shape[0]} trees but "
                        f"the node arrays have {t_m[0]}")
                want = np.float16 if self.leaf_dtype == "float16" else np.uint16
                if self.leaf_dtype not in LEAF_DTYPES or np.asarray(a).dtype != want:
                    raise ValueError(
                        f"QTreeArrays.leaf_value dtype {self.leaf_dtype} "
                        f"is not one of {LEAF_DTYPES}")
            elif t_m is None:
                t_m = shape
            elif shape != t_m:
                raise ValueError(
                    f"QTreeArrays.{f} has shape {shape}, expected {t_m}")
        off = np.asarray(self.qbin_offsets)
        edges = np.asarray(self.qbin_edges)
        if off.ndim != 1 or off.size < 1 or off[0] != 0 \
                or off[-1] != edges.size or np.any(np.diff(off) < 0):
            raise ValueError(
                "QTreeArrays.qbin_offsets must be a monotone prefix-sum "
                "ending at len(qbin_edges)")
        if np.asarray(self.feature_flags).shape != (off.size - 1,):
            raise ValueError(
                "QTreeArrays.feature_flags must have one entry per feature")
        if self.levels < 1:
            raise ValueError("QTreeArrays.levels must be >= 1")
        return self

    @property
    def num_features(self) -> int:
        return int(np.asarray(self.qbin_offsets).size - 1)


def _encode(table: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Rank codes (int64) of ``v`` against one sorted threshold table."""
    v = np.asarray(v, np.float64)
    i = np.searchsorted(table, v, side="left")
    exact = (i < table.size) & (table[np.minimum(i, table.size - 1)] == v) \
        if table.size else np.zeros(v.shape, bool)
    return 2 * i + exact


def _bfs_order(left: np.ndarray, right: np.ndarray) -> Tuple[np.ndarray, int]:
    """Breadth-first node order for one tree (root = node 0): the visit
    order (depth-major, unreachable padded slots appended last so array
    shapes are kept) and 1 + max depth."""
    m = left.shape[0]
    depth = np.full(m, -1, np.int64)
    order: List[int] = []
    frontier = [0]
    depth[0] = 0
    d = 0
    while frontier:
        order.extend(frontier)
        nxt = []
        for j in frontier:
            for c in (left[j], right[j]):
                if c >= 0 and depth[c] < 0:
                    depth[c] = d + 1
                    nxt.append(int(c))
        frontier = nxt
        d += 1
    levels = int(depth.max()) + 1
    order.extend(j for j in range(m) if depth[j] < 0)
    return np.asarray(order, np.int64), levels


def quantize_tree_arrays(arrays, leaf_dtype: str = "float16",
                         num_features: int = 0) -> QTreeArrays:
    """Quantize an exact host-side tree record (the artifact's fields:
    ``split_feature_real``, the triple-float threshold and default planes,
    ``is_categorical``, the children, ``leaf_value``) into a
    ``QTreeArrays``.  The float64 thresholds and default values come back
    exactly from the triple-float planes (they do not overlap), so
    quantizing a loaded artifact is as lossless as quantizing the Booster.
    """
    feat = np.asarray(arrays.split_feature_real, np.int64)
    thr = (np.asarray(arrays.threshold_real, np.float64)
           + np.asarray(arrays.threshold_real_lo, np.float64)
           + np.asarray(arrays.threshold_real_lo2, np.float64))
    dv = (np.asarray(arrays.default_value_real, np.float64)
          + np.asarray(arrays.default_value_real_lo, np.float64)
          + np.asarray(arrays.default_value_real_lo2, np.float64))
    is_cat = np.asarray(arrays.is_categorical, bool)
    left = np.asarray(arrays.left_child, np.int64)
    right = np.asarray(arrays.right_child, np.int64)
    leaf = np.asarray(arrays.leaf_value, np.float32)

    t, m = feat.shape
    if m > _I16_MAX:
        Log.fatal(
            "Quantized serving supports at most %d nodes per tree, this "
            "model has %d — serve the exact artifact instead", _I16_MAX, m)
    num_features = max(int(feat.max()) + 1 if t else 1, int(num_features))
    if num_features > _I16_MAX:
        Log.fatal(
            "Quantized serving supports at most %d features, this model "
            "uses feature index %d — serve the exact artifact instead",
            _I16_MAX, num_features - 1)

    # reachable internal nodes + breadth-first level packing, per tree
    orders = np.empty((t, m), np.int64)
    reach = np.zeros((t, m), bool)
    levels = 1
    for i in range(t):
        order, lv = _bfs_order(left[i], right[i])
        orders[i] = order
        levels = max(levels, lv)
        seen = np.zeros(m, bool)
        seen[0] = True
        stack = [0]
        while stack:
            j = stack.pop()
            for c in (left[i, j], right[i, j]):
                if c >= 0 and not seen[c]:
                    seen[c] = True
                    stack.append(int(c))
        reach[i] = seen

    # per-feature threshold tables from reachable nodes only, with the
    # categorical trunc folded in (identity compare on ints)
    feature_flags = np.zeros(num_features, np.int8)
    for j in np.unique(feat[reach & is_cat]):
        feature_flags[j] = 1
    tables: List[np.ndarray] = []
    offsets = np.zeros(num_features + 1, np.int32)
    for j in range(num_features):
        mask = reach & (feat == j)
        tj = thr[mask]
        if feature_flags[j]:
            tj = np.trunc(tj)
        table = np.unique(tj)
        if 2 * table.size + 1 > _I16_MAX:
            Log.fatal(
                "Quantized serving supports at most %d distinct "
                "thresholds per feature, feature %d has %d — serve the "
                "exact artifact instead", (_I16_MAX - 1) // 2, j, table.size)
        tables.append(table)
        offsets[j + 1] = offsets[j] + table.size
    edges = np.concatenate(tables) if tables else np.zeros(0, np.float64)

    # encode every node's threshold/default per feature, in the ORIGINAL
    # node order (the BFS gather below reorders them)
    thr_codes = np.zeros((t, m), np.int64)
    def_codes = np.zeros((t, m), np.int64)
    for j in range(num_features):
        mask = feat == j
        if not mask.any():
            continue
        tv, dvv = thr[mask], dv[mask]
        if feature_flags[j]:
            tv, dvv = np.trunc(tv), np.trunc(dvv)
        thr_codes[mask] = _encode(tables[j], tv)
        def_codes[mask] = _encode(tables[j], dvv)

    # per-node fields in BFS order; child node indices remapped
    q_feat = np.zeros((t, m), np.int16)
    q_thr = np.zeros((t, m), np.int16)
    q_def = np.zeros((t, m), np.int16)
    q_flags = np.zeros((t, m), np.int8)
    q_left = np.zeros((t, m), np.int16)
    q_right = np.zeros((t, m), np.int16)
    for i in range(t):
        order = orders[i]
        newpos = np.empty(m, np.int64)
        newpos[order] = np.arange(m)
        q_feat[i] = feat[i, order].astype(np.int16)
        q_thr[i] = thr_codes[i, order].astype(np.int16)
        q_def[i] = def_codes[i, order].astype(np.int16)
        q_flags[i] = is_cat[i, order].astype(np.int8)
        lo_ = left[i, order]
        ro_ = right[i, order]
        q_left[i] = np.where(lo_ >= 0, newpos[np.maximum(lo_, 0)],
                             lo_).astype(np.int16)
        q_right[i] = np.where(ro_ >= 0, newpos[np.maximum(ro_, 0)],
                              ro_).astype(np.int16)

    return QTreeArrays(
        levels=levels,
        leaf_dtype=leaf_dtype,
        split_feature=q_feat,
        threshold_q=q_thr,
        default_q=q_def,
        flags=q_flags,
        left_child=q_left,
        right_child=q_right,
        leaf_value=narrow_leaves(leaf, leaf_dtype),
        qbin_edges=edges,
        qbin_offsets=offsets,
        feature_flags=feature_flags,
    ).validate()


def quantize_data(data: np.ndarray, qbin_edges: np.ndarray,
                  qbin_offsets: np.ndarray,
                  feature_flags: np.ndarray) -> np.ndarray:
    """(N, F) int16 rank codes for raw (N, >=F) float64 features; the
    zero/missing remap (``|v|`` in (-MISSING_VALUE_RANGE,
    MISSING_VALUE_RANGE] or NaN -> ``ZERO_CODE``) in plain float64."""
    edges = np.asarray(qbin_edges, np.float64)
    offsets = np.asarray(qbin_offsets, np.int64)
    flags = np.asarray(feature_flags)
    nf = offsets.size - 1
    data = np.asarray(data, np.float64)
    if data.ndim == 1:
        data = data.reshape(1, -1)
    out = np.empty((data.shape[0], nf), np.int16)
    mr = float(MISSING_VALUE_RANGE)
    for j in range(nf):
        v = data[:, j]
        is_zero = ((v > -mr) & (v <= mr)) | np.isnan(v)
        vv = np.where(is_zero, 0.0, v)
        if flags[j]:
            vv = np.trunc(vv)
        code = _encode(edges[offsets[j]:offsets[j + 1]], vv)
        out[:, j] = np.where(is_zero, ZERO_CODE, code).astype(np.int16)
    return out


def _spacing(maxabs: np.ndarray, leaf_dtype: str) -> np.ndarray:
    """The ulp of each value of ``maxabs`` after narrowing to
    ``leaf_dtype`` (bfloat16: float32's ulp times 2^16, as bfloat16 keeps
    float32's exponent and 7 of its 23 fraction bits)."""
    if leaf_dtype == "float16":
        return np.spacing(maxabs.astype(np.float16)).astype(np.float64)
    if leaf_dtype == "bfloat16":
        x = bfloat16_bits_to_float32(to_bfloat16_bits(maxabs.astype(np.float32)))
        return np.spacing(x).astype(np.float64) * 65536.0
    Log.fatal("Unsupported quantized leaf dtype %r (supported: %s)",
              leaf_dtype, ", ".join(LEAF_DTYPES))
    raise AssertionError  # unreachable


def drift_bound(leaf_value, leaf_dtype: str = "float16") -> float:
    """Bound on |quantized - exact| raw scores for one class of stacked
    trees (``leaf_value`` the exact float32 leaves): routing is exact, so
    the drift is the leaf narrowing (half an ulp of each tree's largest
    |leaf| in ``leaf_dtype``) plus float32 re-accumulation slack."""
    leaf = np.abs(np.asarray(leaf_value, np.float64))
    if leaf.size == 0:
        return 0.0
    maxabs = leaf.max(axis=-1)
    half_ulp = _spacing(maxabs, leaf_dtype) / 2.0
    # f32 pairwise/sequential accumulation over T terms
    accum = leaf.max() * leaf.shape[0] * float(np.finfo(np.float32).eps)
    return float(np.sum(half_ulp) + accum)


class QTrees:
    """The node planes of a ``QTreeArrays`` on one device, as narrow as on
    the host (int16 / int8 node fields, float16 or bfloat16 leaves)."""

    def __init__(self, arrays: QTreeArrays, device):
        for f in QTreeArrays.NODE_FIELDS[:-1]:
            setattr(self, f, torch.from_numpy(np.ascontiguousarray(getattr(arrays, f)))
                    .to(device))
        leaf = np.ascontiguousarray(arrays.leaf_value)
        t = torch.from_numpy(leaf.view(np.int16) if leaf.dtype == np.uint16 else leaf)
        dtype = torch.bfloat16 if arrays.leaf_dtype == "bfloat16" else torch.float16
        self.leaf_value = t.view(dtype).to(device)

    def tensors(self):
        return [getattr(self, f) for f in QTreeArrays.NODE_FIELDS]


def qleaves(qbins: torch.Tensor, trees: QTrees, levels: int) -> torch.Tensor:
    """(T, N) int64 leaf index of each row of the (N, F) int16 rank codes
    in each level-packed quantized tree: exactly ``levels`` steps of int16
    compares and gathers, no host read (JAX ``_traverse_one_tree_q``)."""
    T = trees.split_feature.shape[0]
    n = qbins.shape[0]
    codes = qbins.expand(T, n, qbins.shape[1])
    node = torch.zeros((T, n), dtype=torch.int64, device=qbins.device)
    for _ in range(int(levels)):
        j = node.clamp(min=0)
        feat = torch.gather(trees.split_feature, 1, j).long()
        q = torch.gather(codes, 2, feat[..., None])[..., 0]
        fq = torch.where(q == int(ZERO_CODE), torch.gather(trees.default_q, 1, j), q)
        thr = torch.gather(trees.threshold_q, 1, j)
        goes_left = torch.where(torch.gather(trees.flags, 1, j) != 0, fq == thr, fq <= thr)
        nxt = torch.where(goes_left, torch.gather(trees.left_child, 1, j),
                          torch.gather(trees.right_child, 1, j))
        node = torch.where(node >= 0, nxt.long(), node)
    return ~node


def qpredict_raw(qbins: torch.Tensor, trees: QTrees, levels: int,
                 num_class: int = 1) -> torch.Tensor:
    """(K, N) float32 raw scores over (N, F) int16 rank codes: each row's
    narrow leaf, widened and summed in float32 per class (tree i is
    class i % K)."""
    leaves = qleaves(qbins, trees, levels)
    return class_sums(torch.gather(trees.leaf_value, 1, leaves), num_class)


def qpredict_leaf(qbins: torch.Tensor, trees: QTrees, levels: int) -> torch.Tensor:
    """(T, N) leaf indices (PredictLeafIndex mode, quantized)."""
    return qleaves(qbins, trees, levels)


def qpredict_scores(data: np.ndarray, arrays: QTreeArrays, trees: QTrees,
                    num_class: int = 1) -> np.ndarray:
    """(K, N) float64 raw scores of raw (N, >=F) float64 rows: rank-encoded
    on the host, walked in row chunks on the trees' device (the eager
    counterpart of the server's captured walk)."""
    codes = quantize_data(data, arrays.qbin_edges, arrays.qbin_offsets, arrays.feature_flags)
    dev = trees.leaf_value.device
    outs = [qpredict_raw(torch.from_numpy(codes[lo:hi]).to(dev), trees, arrays.levels,
                         num_class)
            for lo, hi in _row_chunks(codes.shape[0], trees.leaf_value.shape[0])]
    return torch.cat(outs, dim=-1).double().cpu().numpy()
