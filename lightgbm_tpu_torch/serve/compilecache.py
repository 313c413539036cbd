"""Shape-bucketed serving predictors: one CUDA graph per row bucket —
PyTorch counterpart of lightgbm_tpu/serve/compilecache.py.

A server answers arbitrary request sizes.  Every batch is padded up a
power-of-two bucket ladder, so any request size N lands on one of
``log2(max_rows)`` shapes.  In the JAX package each bucket is one compiled
XLA program; here each bucket is one captured CUDA graph per predictor:

- static input buffers hold the bucket's triple-float (hi, lo, lo2)
  planes (exact and linear walks) or its int16 rank codes (quantized);
- the graph runs the fixed-step walk (``ops/predict.py _leaves_raw`` with
  ``levels``, or ``ops/qpredict.py qleaves``), the per-class float32 sums
  and the objective's ``convert_output``; the host copies the raw or the
  converted rows out and strips the padding;
- a predictor's graphs share one memory pool and one stream, and run
  under the predictor's lock: a batch fills the buffers, replays and
  copies out before the next batch may touch them;
- every capture counts through ``obs/trace.py note_compile``, so
  ``warmup()``'s ``compiles`` and the server's ``/stats`` report graph
  captures where the JAX package reports XLA compiles.

Padded rows are zeros; the walk is row-independent, so real rows' outputs
do not depend on the padding.  Tree arrays are padded to canonical shape
classes (``tree_shape_bucket``), and so is the walk's step count, so a
same-shape retrain fits the live predictor's buffers: a hot swap copies
the new arrays into them (``adopt``) and captures nothing.  Requests
larger than the largest warmed bucket run in pieces of that bucket, so a
warmed predictor never captures again.  Captures run on the predictor's
own stream in ``thread_local`` mode, so a server keeps launching other
predictors' graphs from its batcher threads meanwhile.

On the CPU (``device="cpu"``) the same code runs eagerly, with no graph.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..model.ensemble import split_hi_lo
from ..obs import metrics
from ..obs.trace import compile_counts, note_compile, total_compiles, tracer
from ..ops.predict import (_CHUNK_ELEMS, PackedLinearTreeArrays, PackedTreeArrays,
                           _leaves_raw, class_sums, raw_leaf_outputs, walk_levels)
from ..ops.qpredict import QTreeArrays, QTrees, qpredict_raw, quantize_data
from ..utils.device import resolve_device
from ..utils.log import Log

DEFAULT_MIN_BUCKET = 8

# the walk's node planes a device predictor holds (after the three data
# planes, the JAX package's call order)
_TREE_ARG_FIELDS = (
    "split_feature_real",
    "threshold_real",
    "threshold_real_lo",
    "threshold_real_lo2",
    "default_value_real",
    "default_value_real_lo",
    "default_value_real_lo2",
    "is_categorical",
    "left_child",
    "right_child",
    "leaf_value",
)
_LINEAR_TREE_ARG_FIELDS = _TREE_ARG_FIELDS + PackedLinearTreeArrays.LINEAR_FIELDS

# one capture at a time in the process: each runs on its predictor's own
# stream in thread_local mode while batcher threads replay other graphs
_CAPTURE_LOCK = threading.Lock()


def _captures_of(walk: str):
    return lambda: float(compile_counts().get(f"graph_capture.{walk}", 0))


metrics.registry.counter("lightgbm_tpu_serve_predict_compiles_total",
                         "CUDA graph captures of the serve.predict_raw walk",
                         fn=_captures_of("serve.predict_raw"))


def tree_shape_bucket(n: int) -> int:
    """Canonical padded size for a stacked-tree axis (node count M, leaf
    count L, coefficient count K, the walk's steps): the next power of two
    >= max(n, 2).  Two models whose arrays differ only in data-dependent
    sizes land in one shape class, so a same-shape retrain keeps the live
    predictor's graphs.  Padded node slots are unreachable and padded leaf
    columns are never gathered, so outputs are bit-identical."""
    b = 2
    while b < n:
        b <<= 1
    return b


def pad_tree_arrays(arrays: PackedTreeArrays) -> PackedTreeArrays:
    """Pad a host ``PackedTreeArrays`` to canonical shape buckets
    ((T, M) -> (T, bucket(M)), (T, L) -> (T, bucket(L))); the input when
    already canonical."""
    m = arrays.split_feature.shape[1]
    L = arrays.leaf_value.shape[1]
    mb, lb = tree_shape_bucket(m), tree_shape_bucket(L)
    if mb == m and lb == L:
        return arrays
    fields = {}
    for f in PackedTreeArrays.FIELDS:
        a = np.asarray(getattr(arrays, f))
        pad = (lb if f == "leaf_value" else mb) - a.shape[1]
        fields[f] = np.pad(a, ((0, 0), (0, pad))) if pad else a
    return PackedTreeArrays(**fields).validate()


def pad_linear_tree_arrays(arrays: PackedLinearTreeArrays) -> PackedLinearTreeArrays:
    """Linear counterpart of ``pad_tree_arrays``: the node/leaf planes pad
    to the same classes and the coefficient planes to (T, bucket(L),
    bucket(K)); padded coefficient slots are zero with
    ``leaf_feat_valid`` 0, so they add exactly 0."""
    m = arrays.split_feature.shape[1]
    L = arrays.leaf_value.shape[1]
    k = arrays.leaf_coeff.shape[2]
    mb, lb, kb = tree_shape_bucket(m), tree_shape_bucket(L), tree_shape_bucket(k)
    if mb == m and lb == L and kb == k:
        return arrays
    fields = {}
    for f in PackedLinearTreeArrays.FIELDS:
        a = np.asarray(getattr(arrays, f))
        if a.ndim == 3:
            fields[f] = np.pad(a, ((0, 0), (0, lb - a.shape[1]), (0, kb - a.shape[2])))
        else:
            pad = (lb if f in ("leaf_value", "leaf_const", "leaf_is_linear")
                   else mb) - a.shape[1]
            fields[f] = np.pad(a, ((0, 0), (0, pad))) if pad else a
    return PackedLinearTreeArrays(**fields).validate()


def pad_qtree_arrays(arrays: QTreeArrays) -> QTreeArrays:
    """Quantized counterpart of ``pad_tree_arrays``: the narrow node planes
    pad to the same (T, bucket(M)) / (T, bucket(L)) classes and ``levels``
    rounds up the same ladder (steps past a tree's depth leave every row
    on its leaf)."""
    m = arrays.split_feature.shape[1]
    L = arrays.leaf_value.shape[1]
    mb, lb = tree_shape_bucket(m), tree_shape_bucket(L)
    levels = tree_shape_bucket(arrays.levels)
    if mb == m and lb == L and levels == arrays.levels:
        return arrays
    fields = {}
    for f in QTreeArrays.NODE_FIELDS:
        a = np.asarray(getattr(arrays, f))
        pad = (lb if f == "leaf_value" else mb) - a.shape[1]
        fields[f] = np.pad(a, ((0, 0), (0, pad))) if pad else a
    for f in QTreeArrays.TABLE_FIELDS:
        fields[f] = getattr(arrays, f)
    return QTreeArrays(levels=levels, leaf_dtype=arrays.leaf_dtype, **fields).validate()


def bucket_for(n: int, min_bucket: int = DEFAULT_MIN_BUCKET) -> int:
    """Smallest power-of-two >= max(n, min_bucket)."""
    if n <= 0:
        n = 1
    b = max(int(min_bucket), 1)
    while b < n:
        b <<= 1
    return b


def bucket_ladder(max_rows: int, min_bucket: int = DEFAULT_MIN_BUCKET) -> List[int]:
    """The distinct buckets covering request sizes 1..max_rows."""
    ladder = []
    n = 1
    while True:
        b = bucket_for(n, min_bucket)
        if not ladder or b != ladder[-1]:
            ladder.append(b)
        if b >= max_rows:
            return ladder
        n = b + 1


def _check_shard(shard: bool, device: torch.device) -> None:
    """A row-sharded predictor splits its rows over the visible cards, as
    the JAX package does over its local devices: with one card it shards
    nothing."""
    if shard and device.type == "cuda" and torch.cuda.device_count() > 1:
        raise NotImplementedError(
            "lightgbm_tpu_torch: shard=1 over several cards waits for the port's "
            "multi-card learners and transport (queue A2d); serve with shard=0 or one "
            "visible card")


class _BucketGraph:
    """One bucket's static input buffer, captured graph and output."""

    __slots__ = ("x", "graph", "out")


class _BucketedPredictor:
    """The shared machinery of the three walks: ``_host_input`` encodes a
    request on the host, ``_compute`` maps a device input to the (2, K,
    bucket) float32 raw and converted scores."""

    kind = ""
    rows_counter = ""

    def __init__(self, num_class: int, num_features: int, objective=None, device=None,
                 min_bucket: int = DEFAULT_MIN_BUCKET, shard: bool = False):
        self.device = resolve_device(device)
        self.num_class_arrays = int(num_class)
        self.num_features = int(num_features)
        self.objective = objective
        self.min_bucket = int(min_bucket)
        _check_shard(shard, self.device)
        self.warm_rows = 0  # the largest warmed bucket (0: none yet)
        self._lock = threading.Lock()
        self._graphs: Dict[int, _BucketGraph] = {}
        self.stream = self.pool = None  # eager on the CPU
        if self.device.type == "cuda":
            self.stream = torch.cuda.Stream(self.device)
            self.pool = torch.cuda.graph_pool_handle()

    # -- subclass parts --------------------------------------------------
    def _tensors(self) -> List[torch.Tensor]:
        raise NotImplementedError

    def _host_input(self, data: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def _input_shape(self, bucket: int):
        raise NotImplementedError

    def _walk(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def _static(self) -> tuple:
        return ()

    # -- shapes ------------------------------------------------------------
    @property
    def num_trees(self) -> int:
        return int(self._tensors()[0].shape[0])

    def bucket(self, n: int) -> int:
        return bucket_for(n, self.min_bucket)

    def _piece_rows(self) -> int:
        """The most rows one walk takes: the largest warmed bucket, and at
        most a bucket whose (T, rows) node tensors stay near 2^26
        elements."""
        limit = _CHUNK_ELEMS // max(self.num_trees, 1)
        cap = max(self.min_bucket, 1)
        while cap * 2 <= limit:
            cap *= 2
        return min(cap, self.warm_rows) if self.warm_rows else cap

    def shape_key(self) -> tuple:
        """What a captured graph bakes in besides its tensors' contents:
        the walk, its static step count, the objective's conversion and
        every device tensor's shape and dtype.  Two predictors with equal
        keys can exchange arrays (``adopt``)."""
        obj = self.objective.to_string() if self.objective is not None else None
        return (type(self).__name__, self.num_class_arrays, self.num_features, obj,
                self._static(), tuple((tuple(t.shape), t.dtype) for t in self._tensors()))

    @property
    def device_bytes(self) -> int:
        return int(sum(t.numel() * t.element_size() for t in self._tensors()))

    # -- the walk ----------------------------------------------------------
    def _compute(self, x: torch.Tensor) -> torch.Tensor:
        raw = self._walk(x)
        conv = self.objective.convert_output(raw) if self.objective is not None else raw
        return torch.stack([raw, conv])

    def _capture(self, bucket: int) -> _BucketGraph:
        g = _BucketGraph()
        g.x = torch.zeros(self._input_shape(bucket), dtype=self._input_dtype,
                          device=self.device)
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with _CAPTURE_LOCK:
            with torch.cuda.stream(self.stream):
                self._compute(g.x)  # first run outside the capture
            g.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g.graph, pool=self.pool, stream=self.stream,
                                  capture_error_mode="thread_local"):
                g.out = self._compute(g.x)
        note_compile(f"graph_capture.{self.kind}")
        self._graphs[bucket] = g
        return g

    def _run(self, host: np.ndarray, n: int, raw_score: bool) -> np.ndarray:
        """(K, n) float64 outputs of one padded host input; holds the lock
        from the buffers' fill to the copy out."""
        which = 0 if raw_score else 1
        with self._lock:
            if self.stream is None:
                x = torch.from_numpy(host).to(self.device)
                return self._compute(x)[which, :, :n].double().cpu().numpy()
            bucket = host.shape[-2]
            g = self._graphs.get(bucket) or self._capture(bucket)
            with torch.cuda.stream(self.stream):
                g.x.copy_(torch.from_numpy(host))
                g.graph.replay()
                return g.out[which, :, :n].cpu().double().numpy()

    def predict_scores(self, data: np.ndarray, raw_score: bool = False) -> np.ndarray:
        """(K, N) float64 scores of (N, >=F) raw features: raw, or through
        the objective's conversion (raw when there is no objective)."""
        data = np.asarray(data, np.float64)
        if data.ndim == 1:
            data = data.reshape(1, -1)
        n = data.shape[0]
        step = self._piece_rows()
        outs = []
        for lo in range(0, max(n, 1), step):
            piece = data[lo:lo + step, :self.num_features]
            host = self._host_input(piece)
            pad = self.bucket(piece.shape[0]) - piece.shape[0]
            if pad:
                widths = [(0, 0)] * host.ndim
                widths[-2] = (0, pad)
                host = np.pad(host, widths)
            outs.append(self._run(np.ascontiguousarray(host), piece.shape[0], raw_score))
        tracer.counter(self.rows_counter, float(n))
        return outs[0] if len(outs) == 1 else np.concatenate(outs, axis=1)

    def predict_raw_scores(self, data: np.ndarray) -> np.ndarray:
        """(K, N) float64 raw scores for (N, F) raw features."""
        return self.predict_scores(data, raw_score=True)

    # -- warmup and swap ---------------------------------------------------
    def warmup(self, max_rows: int, num_features: Optional[int] = None,
               buckets: Optional[List[int]] = None) -> Dict:
        """Capture the bucket ladder up to ``max_rows`` rows (on the card;
        on the CPU run it once) through the full path, walk and
        conversion.  Returns (and traces) the buckets and the captures:
        after it, no request captures again."""
        if buckets is None:
            buckets = bucket_ladder(max_rows, self.min_bucket)
        width = self.num_features if num_features is None else int(num_features)
        c0 = total_compiles()
        t0 = time.perf_counter()
        self.warm_rows = 0
        with tracer.span("serve_warmup", buckets=len(buckets)):
            for b in buckets:
                self.predict_scores(np.zeros((b, width)))
        self.warm_rows = max(buckets)
        stats = {
            "buckets": list(buckets),
            "compiles": total_compiles() - c0,
            "secs": round(time.perf_counter() - t0, 4),
        }
        tracer.event("serve_warmup_done", **stats)
        return stats

    def adopt(self, other: "_BucketedPredictor") -> None:
        """Take ``other``'s tree arrays into this predictor's tensors, the
        ones its graphs read: a same-shape swap with no capture.  Holds the
        lock, so no batch runs on half-copied arrays."""
        if other.shape_key() != self.shape_key():
            raise ValueError("adopt needs a predictor of the same shape class")
        with self._lock:
            if self.stream is not None:
                # the arrays were put on the card on this thread's stream
                self.stream.wait_stream(torch.cuda.current_stream(self.device))
            ctx = (torch.cuda.stream(self.stream) if self.stream is not None
                   else contextlib.nullcontext())
            with ctx:
                for dst, src in zip(self._tensors(), other._tensors()):
                    dst.copy_(src)
                if self.stream is not None:
                    self.stream.synchronize()
            self._adopt_host(other)
            self.objective = other.objective

    def _adopt_host(self, other) -> None:
        pass


def _class_order(t: int, k: int) -> None:
    if k <= 0 or t % k != 0:
        Log.fatal("%d stacked trees are not a multiple of num_tree_per_iteration=%d", t, k)


class BucketedRawPredictor(_BucketedPredictor):
    """The exact walk over triple-float planes (``ops/predict.py``): the
    reference's float64 decisions, leaf values summed in float32 per
    class, as ``Booster.predict``."""

    kind = "serve.predict_raw"
    rows_counter = "serve_predict_rows"
    _input_dtype = torch.float32

    def __init__(self, arrays: PackedTreeArrays, num_tree_per_iteration: int,
                 num_features: int = 0, **kw):
        arrays.validate()
        t = arrays.split_feature.shape[0]
        _class_order(t, int(num_tree_per_iteration))
        if num_features <= 0:
            num_features = int(np.asarray(arrays.split_feature_real).max()) + 1 if t else 1
        super().__init__(num_tree_per_iteration, num_features, **kw)
        self.levels = tree_shape_bucket(walk_levels(arrays.left_child, arrays.right_child))
        self.trees = arrays.to_device(self.device)

    @classmethod
    def from_tree_arrays(cls, arrays: PackedTreeArrays, num_tree_per_iteration: int,
                         **kw) -> "BucketedRawPredictor":
        """Pad to canonical tree-shape buckets (``tree_shape_bucket``) and
        put the arrays on the device."""
        arrays.validate()
        return cls(pad_tree_arrays(arrays), num_tree_per_iteration, **kw)

    @classmethod
    def from_models(cls, models: List, num_tree_per_iteration: int,
                    **kw) -> "BucketedRawPredictor":
        from .artifact import stacked_tree_arrays

        return cls.from_tree_arrays(stacked_tree_arrays(models), num_tree_per_iteration, **kw)

    def _tensors(self) -> List[torch.Tensor]:
        out = [getattr(self.trees, f) for f in _TREE_ARG_FIELDS]
        if self.trees.linear is not None:
            out += [self.trees.linear[f] for f in PackedLinearTreeArrays.LINEAR_FIELDS]
        return out

    def _static(self) -> tuple:
        return (self.levels,)

    def _input_shape(self, bucket: int):
        return (3, bucket, self.num_features)

    def _host_input(self, data: np.ndarray) -> np.ndarray:
        return np.stack(split_hi_lo(data))

    def _walk(self, x: torch.Tensor) -> torch.Tensor:
        planes = (x[0], x[1], x[2])
        leaves = _leaves_raw(planes, self.trees, levels=self.levels)
        return class_sums(raw_leaf_outputs(leaves, planes[0], self.trees),
                          self.num_class_arrays)


class BucketedLinearRawPredictor(BucketedRawPredictor):
    """The linear-leaf (v3 artifact) walk: ``BucketedRawPredictor``'s, a
    linear leaf's output const + coeff · x over the raw rows' float32 hi
    plane (a NaN path feature keeps the constant)."""

    kind = "serve.predict_linear"
    rows_counter = "serve_linear_rows"

    @classmethod
    def from_tree_arrays(cls, arrays: PackedLinearTreeArrays, num_tree_per_iteration: int,
                         **kw) -> "BucketedLinearRawPredictor":
        arrays.validate()
        return cls(pad_linear_tree_arrays(arrays), num_tree_per_iteration, **kw)


class BucketedQuantizedPredictor(_BucketedPredictor):
    """The quantized walk (``ops/qpredict.py``): requests are rank-encoded
    on the host, then ``levels`` steps of int16 compares; float16/bfloat16
    leaves summed in float32."""

    kind = "serve.qpredict"
    rows_counter = "serve_qpredict_rows"
    _input_dtype = torch.int16

    def __init__(self, arrays: QTreeArrays, num_tree_per_iteration: int, **kw):
        arrays.validate()
        _class_order(arrays.split_feature.shape[0], int(num_tree_per_iteration))
        super().__init__(num_tree_per_iteration, arrays.num_features, **kw)
        self.levels = int(arrays.levels)
        self._set_tables(arrays)
        self.trees = QTrees(arrays, self.device)

    def _set_tables(self, arrays: QTreeArrays) -> None:
        self._edges = np.asarray(arrays.qbin_edges, np.float64)
        self._offsets = np.asarray(arrays.qbin_offsets, np.int64)
        self._feature_flags = np.asarray(arrays.feature_flags)
        self._arrays = arrays

    @classmethod
    def from_qtree_arrays(cls, arrays: QTreeArrays, num_tree_per_iteration: int,
                          **kw) -> "BucketedQuantizedPredictor":
        arrays.validate()
        return cls(pad_qtree_arrays(arrays), num_tree_per_iteration, **kw)

    def _tensors(self) -> List[torch.Tensor]:
        return self.trees.tensors()

    def _static(self) -> tuple:
        return (self.levels, self._arrays.leaf_dtype)

    def _input_shape(self, bucket: int):
        return (bucket, self.num_features)

    def _host_input(self, data: np.ndarray) -> np.ndarray:
        return quantize_data(data, self._edges, self._offsets, self._feature_flags)

    def _walk(self, x: torch.Tensor) -> torch.Tensor:
        return qpredict_raw(x, self.trees, self.levels, self.num_class_arrays)

    def _adopt_host(self, other) -> None:
        self._set_tables(other._arrays)
