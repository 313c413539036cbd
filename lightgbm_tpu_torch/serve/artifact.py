"""Packed predictor artifacts — the serving-side model format, PyTorch
counterpart of lightgbm_tpu/serve/artifact.py.

A trained model's inference state is the stacked node arrays the walk
reads plus a small metadata record (objective string, class count,
feature names).  A packed artifact freezes them into one versioned
``.npz``, so a server loads with ``np.load`` instead of reparsing model
text.  The file format is the JAX package's, so an artifact written by
either package loads in the other:

  ``__meta__``           0-d array holding one JSON string (META_KEYS)
  ``<field>``            one entry per ``PackedTreeArrays.FIELDS`` name
                         (v1, exact), ``QTreeArrays.FIELDS`` (v2,
                         quantized; bfloat16 leaves as raw uint16 bits) or
                         ``PackedLinearTreeArrays.FIELDS`` (v3, linear
                         leaves).  Tree order is model order: tree ``i``
                         is class ``i % num_tree_per_iteration``.
"""

from __future__ import annotations

import io
import json
from typing import Dict, List, Optional

import numpy as np

from ..ops.predict import PackedLinearTreeArrays, PackedTreeArrays
from ..ops.qpredict import QTreeArrays
from ..utils.log import LightGBMError, Log

FORMAT_VERSION = 1  # exact flavor
QUANT_FORMAT_VERSION = 2  # quantized flavor (meta carries "flavor")
LINEAR_FORMAT_VERSION = 3  # linear-leaf flavor
SUPPORTED_VERSIONS = (FORMAT_VERSION, QUANT_FORMAT_VERSION, LINEAR_FORMAT_VERSION)
META_KEYS = (
    "format_version",
    "num_class",
    "num_tree_per_iteration",
    "num_trees",
    "num_features",
    "objective",
    "boost_from_average",
    "feature_names",
    "pandas_categorical",
)
# quantized (format_version 2) artifacts additionally require these
QUANT_META_KEYS = ("flavor", "levels", "leaf_dtype")
# linear (format_version 3) artifacts additionally require these
LINEAR_META_KEYS = ("flavor",)

# model/ensemble.stack_trees key -> artifact field name (the JAX
# package's TreeArrays names); ``leaf_feat_inner`` is a training-side
# plane the raw-serving artifact does not carry
_STACK_TO_FIELD = {
    "split_feature_inner": "split_feature",
    "split_feature_real": "split_feature_real",
    "threshold_bin": "threshold_bin",
    "threshold_real": "threshold_real",
    "threshold_real_lo": "threshold_real_lo",
    "threshold_real_lo2": "threshold_real_lo2",
    "zero_bin": "zero_bin",
    "default_bin_for_zero": "default_bin_for_zero",
    "default_value_real": "default_value_real",
    "default_value_real_lo": "default_value_real_lo",
    "default_value_real_lo2": "default_value_real_lo2",
    "is_categorical": "is_categorical",
    "left_child": "left_child",
    "right_child": "right_child",
    "leaf_value": "leaf_value",
    "leaf_feat_real": "leaf_feat_real",
    "leaf_feat_valid": "leaf_feat_valid",
    "leaf_coeff": "leaf_coeff",
    "leaf_const": "leaf_const",
    "leaf_is_linear": "leaf_is_linear",
}


def stacked_tree_arrays(models: List) -> PackedTreeArrays:
    """Stack host Trees into a ``PackedTreeArrays`` —
    ``PackedLinearTreeArrays`` when any tree carries linear leaf models."""
    from ..model.ensemble import stack_trees

    fields = {_STACK_TO_FIELD[k]: np.asarray(v) for k, v in stack_trees(models).items()
              if k in _STACK_TO_FIELD}
    if "leaf_coeff" in fields:
        return PackedLinearTreeArrays(**fields).validate()
    return PackedTreeArrays(**fields).validate()


def _refuse(origin: str, what: str, e: Exception) -> None:
    """A numpy or zip error while reading ``origin`` as one actionable
    refusal; the package's own fatals pass through."""
    if isinstance(e, LightGBMError):
        raise e
    Log.fatal("%s %s (%s: %s)", origin, what, type(e).__name__, e)


class PredictorArtifact:
    """Host-side packed model: a ``PackedTreeArrays`` (exact), a
    ``QTreeArrays`` (quantized) or a ``PackedLinearTreeArrays`` (linear)
    and a metadata dict."""

    def __init__(self, arrays, meta: Dict):
        self.arrays = arrays
        self.meta = dict(meta)
        self.validate()

    # -- construction --------------------------------------------------
    @classmethod
    def from_booster(cls, booster, num_iteration: int = -1, quantized: bool = False,
                     leaf_dtype: str = "float16") -> "PredictorArtifact":
        """Freeze a trained or loaded ``Booster``'s inference state;
        ``quantized=True`` packs the int16 rank-quantized flavor
        (format_version 2, ops/qpredict.py) instead of the exact arrays."""
        b = booster.boosting
        models = b._used_models(num_iteration)
        if not models:
            Log.fatal("Cannot pack an artifact from a model with no trees")
        if b.objective is not None:
            objective = b.objective.to_string()
        else:
            objective = getattr(b, "objective_name_loaded", "") or ""
        meta = {
            "format_version": FORMAT_VERSION,
            "num_class": int(b.num_class),
            "num_tree_per_iteration": int(b.num_tree_per_iteration),
            "num_trees": len(models),
            "num_features": int(b.max_feature_idx) + 1,
            "objective": objective,
            "boost_from_average": bool(b.boost_from_average_),
            "feature_names": list(b.feature_names or []),
            "pandas_categorical": getattr(booster, "pandas_categorical", []) or [],
        }
        arrays = stacked_tree_arrays(models)
        if isinstance(arrays, PackedLinearTreeArrays):
            meta["format_version"] = LINEAR_FORMAT_VERSION
            meta["flavor"] = "linear"
        art = cls(arrays, meta)
        return art.quantize(leaf_dtype) if quantized else art

    @property
    def flavor(self) -> str:
        return str(self.meta.get("flavor", "exact"))

    def quantize(self, leaf_dtype: str = "float16") -> "PredictorArtifact":
        """The quantized flavor of this artifact (exact routing, see
        ops/qpredict.py); a quantized artifact returns itself."""
        if self.flavor == "quantized":
            return self
        if self.flavor == "linear":
            Log.fatal(
                "Quantized serving does not support linear-leaf (v3) "
                "artifacts — the int16 rank-quantized traversal has no "
                "coefficient planes; serve the exact linear path, or "
                "retrain with linear_tree=false to quantize")
        from ..ops.qpredict import quantize_tree_arrays

        q = quantize_tree_arrays(self.arrays, leaf_dtype=leaf_dtype,
                                 num_features=self.num_features)
        meta = dict(self.meta)
        meta["format_version"] = QUANT_FORMAT_VERSION
        meta["flavor"] = "quantized"
        meta["levels"] = int(q.levels)
        meta["leaf_dtype"] = q.leaf_dtype
        return PredictorArtifact(q, meta)

    # -- persistence ---------------------------------------------------
    def _payload(self) -> Dict[str, np.ndarray]:
        if self.flavor == "quantized":
            fields = QTreeArrays.FIELDS
        elif self.flavor == "linear":
            fields = PackedLinearTreeArrays.FIELDS
        else:
            fields = PackedTreeArrays.FIELDS
        payload = {f: np.asarray(getattr(self.arrays, f)) for f in fields}
        payload["__meta__"] = np.asarray(json.dumps(self.meta))
        return payload

    def save(self, path: str) -> str:
        np.savez_compressed(path, **self._payload())
        # np.savez appends .npz when missing — report the real path
        return path if path.endswith(".npz") else path + ".npz"

    def save_to_bytes(self, buf) -> None:
        """Serialize into a writable binary file-like (the registry
        publishes artifacts as bytes)."""
        np.savez_compressed(buf, **self._payload())

    @classmethod
    def load(cls, path: str) -> "PredictorArtifact":
        """Load a packed artifact, refusing with an actionable message a
        corrupt or truncated file, a future format version and a missing
        field set."""
        try:
            z = np.load(path, allow_pickle=False)
        except Exception as e:
            _refuse(path, "is not a readable packed predictor artifact — the file is "
                    "corrupt, truncated, or not an artifact; re-pack it with "
                    "PredictorArtifact.save / POST /models", e)
        with z:
            return cls._from_npz(z, path)

    @classmethod
    def load_bytes(cls, blob: bytes) -> "PredictorArtifact":
        """Load from in-memory ``.npz`` bytes (registry blobs, POST /models
        bodies) with ``load``'s refusals."""
        try:
            z = np.load(io.BytesIO(blob), allow_pickle=False)
        except Exception as e:
            _refuse("artifact bytes", "are not a readable packed predictor artifact — "
                    "corrupt or truncated upload", e)
        with z:
            return cls._from_npz(z, "<bytes>")

    @classmethod
    def _from_npz(cls, z, origin: str) -> "PredictorArtifact":
        if "__meta__" not in z:
            Log.fatal("%s is not a packed predictor artifact (no __meta__ entry); pack the "
                      "model with PredictorArtifact.save", origin)
        try:
            meta = json.loads(str(z["__meta__"]))
        except Exception as e:
            _refuse(origin, "carries an unreadable __meta__ header — the artifact is "
                    "corrupt; re-pack it", e)
        version = int(meta.get("format_version", -1))
        if version > max(SUPPORTED_VERSIONS):
            Log.fatal(
                "%s was written by a NEWER lightgbm_tpu (artifact format_version %d, this "
                "build supports <= %d) — upgrade this serving process, or re-pack the "
                "model with this build", origin, version, max(SUPPORTED_VERSIONS))
        if version not in SUPPORTED_VERSIONS:
            Log.fatal("%s uses unsupported artifact format_version %s (supported: %s) — "
                      "re-pack the model with PredictorArtifact.save", origin, version,
                      "/".join(str(v) for v in SUPPORTED_VERSIONS))
        want_flavor = {QUANT_FORMAT_VERSION: "quantized",
                       LINEAR_FORMAT_VERSION: "linear"}.get(version)
        if want_flavor is not None and meta.get("flavor") != want_flavor:
            Log.fatal("%s claims artifact format_version %d but flavor %r (expected %r) — "
                      "the header is inconsistent; re-pack it", origin, version,
                      meta.get("flavor"), want_flavor)
        field_set = {QUANT_FORMAT_VERSION: QTreeArrays.FIELDS,
                     LINEAR_FORMAT_VERSION: PackedLinearTreeArrays.FIELDS}.get(
                         version, PackedTreeArrays.FIELDS)
        missing = [f for f in field_set if f not in z]
        if missing:
            Log.fatal("Artifact %s is missing tree arrays %s — the file is truncated or "
                      "from an incompatible writer; re-pack it", origin, missing)
        try:
            fields = {f: z[f] for f in field_set}
        except Exception as e:  # a torn member: zipfile CRC error mid-read
            _refuse(origin, "fails while reading its tree arrays — the file is corrupt; "
                    "re-pack it", e)
        if version == QUANT_FORMAT_VERSION:
            arrays = QTreeArrays(levels=int(meta.get("levels", 0)),
                                 leaf_dtype=str(meta.get("leaf_dtype", "float16")), **fields)
        elif version == LINEAR_FORMAT_VERSION:
            arrays = PackedLinearTreeArrays(**fields)
        else:
            arrays = PackedTreeArrays(**fields)
        try:
            return cls(arrays, meta)
        except ValueError as e:
            _refuse(origin, "holds inconsistent tree arrays — re-pack it", e)

    # -- checks --------------------------------------------------------
    def validate(self) -> "PredictorArtifact":
        self.arrays.validate()
        required = META_KEYS
        if self.flavor == "quantized":
            required = META_KEYS + QUANT_META_KEYS
        elif self.flavor == "linear":
            required = META_KEYS + LINEAR_META_KEYS
        for key in required:
            if key not in self.meta:
                Log.fatal("Artifact metadata is missing %r", key)
        t = self.arrays.split_feature.shape[0]
        if t != int(self.meta["num_trees"]):
            Log.fatal("Artifact metadata says %s trees but arrays hold %d",
                      self.meta["num_trees"], t)
        k = int(self.meta["num_tree_per_iteration"])
        if k <= 0 or t % k != 0:
            Log.fatal("Artifact tree count %d is not a multiple of "
                      "num_tree_per_iteration %d", t, k)
        return self

    # -- conveniences --------------------------------------------------
    @property
    def num_class(self) -> int:
        return int(self.meta["num_class"])

    @property
    def num_tree_per_iteration(self) -> int:
        return int(self.meta["num_tree_per_iteration"])

    @property
    def num_features(self) -> int:
        return int(self.meta["num_features"])

    def device_bytes_estimate(self) -> int:
        """Bytes of tree state this artifact holds on the device once
        served (``PackedPredictor.device_bytes``), after tree-shape padding
        — computed from shapes alone, so admission control can refuse a
        model before anything reaches the device.  The exact and linear
        walks index with the int32 planes widened to int64; the quantized
        walk keeps its narrow planes."""
        from .compilecache import _LINEAR_TREE_ARG_FIELDS, _TREE_ARG_FIELDS, tree_shape_bucket

        a = self.arrays
        t, m = a.split_feature.shape
        L = a.leaf_value.shape[1]
        mb, lb = tree_shape_bucket(m), tree_shape_bucket(L)
        fields = {"quantized": QTreeArrays.NODE_FIELDS,
                  "linear": _LINEAR_TREE_ARG_FIELDS}.get(self.flavor, _TREE_ARG_FIELDS)
        total = 0
        for f in fields:
            arr = getattr(a, f)
            itemsize = np.dtype(arr.dtype).itemsize
            if self.flavor != "quantized" and np.dtype(arr.dtype) == np.int32:
                itemsize = 8
            if arr.ndim == 3:  # (T, L, K) coefficient planes
                total += t * lb * tree_shape_bucket(arr.shape[2]) * itemsize
            else:
                leafy = f in ("leaf_value", "leaf_const", "leaf_is_linear")
                total += t * (lb if leafy else mb) * itemsize
        return int(total)

    def make_objective(self):
        """The objective from its model-string form (``name key:value``)."""
        from ..objective import objective_from_string

        return objective_from_string(self.meta.get("objective", ""))


class PackedPredictor:
    """Device-side serving predictor over a ``PredictorArtifact``: the
    bucketed walk (exact, quantized or linear, following the artifact's
    flavor) with the objective's conversion in the same graph, and
    ``Booster.predict``'s output shapes.  ``device`` is the card unless it
    says ``cpu``.

    ``quantized=True`` asks for the int16 rank-quantized walk even over an
    exact artifact (quantized at construction); ``None`` follows the
    flavor.  The ``LIGHTGBM_TPU_QUANT_PREDICT`` pin overrides both: ``0``
    forces exact (a quantized artifact has no exact planes left, so it
    keeps serving quantized with a warning), ``1`` forces quantized (a
    linear artifact stays exact, with a warning)."""

    def __init__(self, artifact: PredictorArtifact, quantized: Optional[bool] = None,
                 device=None, shard: bool = False):
        from ..ops.qpredict import quant_predict_enabled
        from .compilecache import (BucketedLinearRawPredictor, BucketedQuantizedPredictor,
                                   BucketedRawPredictor)

        want = (artifact.flavor == "quantized") if quantized is None else bool(quantized)
        use_q = quant_predict_enabled(default=want)
        if use_q and artifact.flavor == "linear":
            Log.warning(
                "Quantized predict was requested but the artifact is linear-flavor (v3) — "
                "the quantized traversal has no coefficient planes; serving the exact "
                "linear path")
            use_q = False
        if use_q and artifact.flavor == "exact":
            artifact = artifact.quantize()
        elif not use_q and artifact.flavor == "quantized":
            Log.warning(
                "Quantized predict is pinned off (LIGHTGBM_TPU_QUANT_PREDICT=0 or "
                "quantized=False) but the artifact is quantized-flavor, which carries no "
                "exact planes — serving quantized; publish an exact (format_version 1) "
                "artifact to serve the bit-exact path")
            use_q = True
        self.artifact = artifact
        self.quantized = bool(use_q)
        self.objective = artifact.make_objective()
        kw = dict(objective=self.objective, device=device, shard=shard)
        k = artifact.num_tree_per_iteration
        if self.quantized:
            self.raw = BucketedQuantizedPredictor.from_qtree_arrays(artifact.arrays, k, **kw)
        elif artifact.flavor == "linear":
            self.raw = BucketedLinearRawPredictor.from_tree_arrays(
                artifact.arrays, k, num_features=artifact.num_features, **kw)
        else:
            self.raw = BucketedRawPredictor.from_tree_arrays(
                artifact.arrays, k, num_features=artifact.num_features, **kw)

    @property
    def device(self):
        return self.raw.device

    @property
    def device_bytes(self) -> int:
        """Bytes of stacked tree state on the device (after shape padding,
        the node indices widened to int64) — the admission unit of
        multi-model serving."""
        return self.raw.device_bytes

    @property
    def num_features(self) -> int:
        return self.artifact.num_features

    def warmup(self, max_rows: int, buckets: Optional[List[int]] = None) -> Dict:
        """Capture the bucket ladder through the full path (walk and
        conversion): a warmed predictor answers any request with zero new
        captures.  ``compiles`` counts the captures."""
        return self.raw.warmup(max_rows, self.num_features, buckets)

    def can_adopt(self, other: "PackedPredictor") -> bool:
        """True when ``other`` is of this predictor's shape class, so its
        arrays can replace this one's in place (``adopt``)."""
        return (self.quantized == other.quantized
                and self.artifact.flavor == other.artifact.flavor
                and self.raw.shape_key() == other.raw.shape_key())

    def adopt(self, other: "PackedPredictor") -> None:
        """Serve ``other``'s model from this predictor's buffers and graphs
        (a same-shape swap: no capture)."""
        self.raw.adopt(other.raw)
        self.artifact = other.artifact
        self.objective = other.objective

    def predict(self, data: np.ndarray, raw_score: bool = False) -> np.ndarray:
        """(N,) or (N, K) predictions, matching ``Booster.predict``."""
        data = np.asarray(data, np.float64)
        if data.ndim == 1:
            data = data.reshape(1, -1)
        if data.shape[1] < self.num_features:
            Log.fatal("Predict data has %d features but the model needs %d",
                      data.shape[1], self.num_features)
        out = self.raw.predict_scores(data, raw_score=raw_score)  # (K, N) f64
        return out[0] if out.shape[0] == 1 else out.T
