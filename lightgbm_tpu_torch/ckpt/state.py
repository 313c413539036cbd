"""Versioned training-state snapshots (``TrainState``) — PyTorch-port copy
of lightgbm_tpu/ckpt/state.py.

A checkpoint must reproduce training exactly, so the state is everything
the boosting loop reads across an iteration boundary:

  - the ensemble's trees in binary: stacked arrays, one entry per ``Tree``
    field, ``(T, M)`` / ``(T, L)`` padded (a text round trip through
    ``%g`` would not be bit-faithful), with the linear-leaf planes when a
    tree has them;
  - the training and validation score caches, float32;
  - every random stream: the bagging ``RandomState``, the feature_fraction
    ``Random``, DART's drop ``Random``, the mask grower's chained GOSS
    key (the partitioned trainer keeps none: it folds one base key with
    the global iteration);
  - the early-stopping bests and the iteration counter;
  - the partitioned trainer's row permutation (``pt_rowid``), which the
    JAX package needs; the port gathers canonical row order at every
    iteration, so its own trees do not depend on it;
  - config and dataset fingerprints: a resume refuses to run on a mismatch
    rather than train a different problem.

One uncompressed ``.npz`` with a ``__meta__`` JSON entry.  The array names,
meta keys and ``FORMAT_VERSION`` are the JAX package's, so a blob written
by either package loads in the other; the blob holds host arrays only and
carries no device: ``capture`` reads the card, ``restore`` writes to the
booster's device.

An out-of-core run records its chunk schedule (``ooc_schedule``, the JAX
package's string) and ``restore`` refuses a blob whose schedule is not
the run's.  Not ported yet: the multi-host canonical layout
(``merge_to_canonical`` / ``reshard_to_local``; waits for the port's
distributed training); ``restore`` refuses blobs that carry it.
"""

from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import zlib
from typing import Any, Dict, Optional

import numpy as np

from ..model.tree import Tree
from ..obs import tracer
from ..utils.log import Log

FORMAT_VERSION = 1

# Tree fields: (name, dtype, padded axis); "m" arrays hold num_leaves-1
# node records, "l" arrays num_leaves leaf records
_TREE_FIELDS = (
    ("left_child", np.int32, "m"),
    ("right_child", np.int32, "m"),
    ("split_feature_inner", np.int32, "m"),
    ("split_feature", np.int32, "m"),
    ("threshold_in_bin", np.int32, "m"),
    ("threshold", np.float64, "m"),
    ("decision_type", np.int8, "m"),
    ("default_value", np.float64, "m"),
    ("zero_bin", np.int32, "m"),
    ("default_bin_for_zero", np.int32, "m"),
    ("split_gain", np.float64, "m"),
    ("internal_value", np.float64, "m"),
    ("internal_count", np.int64, "m"),
    ("leaf_parent", np.int32, "l"),
    ("leaf_value", np.float64, "l"),
    ("leaf_count", np.int64, "l"),
)

# Config fields that may differ between a run and its resume (paths, task
# plumbing, run length, verbosity, topology): they never change an
# iteration's arithmetic, so the fingerprint leaves them out
_FP_VOLATILE = {
    "task", "config_file", "data", "valid_data", "input_model",
    "output_model", "output_result", "convert_model",
    "convert_model_language", "num_iterations", "num_iteration_predict",
    "snapshot_freq", "verbose", "num_threads", "is_save_binary_file",
    "is_predict_leaf_index", "is_predict_raw_score", "output_freq",
    "metric_freq", "machine_list_file", "local_listen_port", "time_out",
    "checkpoint_dir", "checkpoint_freq", "checkpoint_keep",
    "checkpoint_resume", "is_training_metric", "pred_early_stop",
    "pred_early_stop_freq", "pred_early_stop_margin",
    "ooc_prefetch_depth",
    "num_machines", "rebalance", "rebalance_threshold",
    "rebalance_patience", "rebalance_max_move_frac",
    "elastic_membership",
}


class CheckpointMismatch(RuntimeError):
    """Resume refused: the checkpoint was written by a different config or
    against a different dataset, or needs what the port lacks."""


# ----------------------------------------------------------------------
# fingerprints
# ----------------------------------------------------------------------
def config_fingerprint(config) -> str:
    """Digest of the configuration fields that change the arithmetic."""
    d = dataclasses.asdict(config)
    for key in _FP_VOLATILE:
        d.pop(key, None)
    blob = json.dumps(d, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def data_fingerprint_parts(binned_ds) -> Dict[str, int]:
    """The CRC32s of one dataset's bins and labels, their byte lengths and
    its shape (cached on the dataset: one pass over the bins a run, in
    64k-row blocks, so a memmapped cache is never read whole)."""
    cached = getattr(binned_ds, "_ckpt_fp_parts", None)
    if cached is not None:
        return dict(cached)
    binned = np.asarray(binned_ds.binned)
    crc_b = 0
    step = 65536
    for s in range(0, binned.shape[0], step):
        crc_b = zlib.crc32(np.ascontiguousarray(binned[s: s + step]).tobytes(), crc_b)
    label = binned_ds.metadata.label
    crc_l, len_l = 0, 0
    if label is not None:
        lab = np.ascontiguousarray(np.asarray(label)).tobytes()
        crc_l, len_l = zlib.crc32(lab), len(lab)
        # the whole fingerprint's CRC runs on over the labels
        binned_ds._ckpt_crc_all = zlib.crc32(lab, crc_b) & 0xFFFFFFFF
    else:
        binned_ds._ckpt_crc_all = crc_b & 0xFFFFFFFF
    parts = {
        "rows": int(binned.shape[0]), "cols": int(binned.shape[1]),
        "crc_binned": crc_b & 0xFFFFFFFF, "len_binned": int(binned.nbytes),
        "crc_label": crc_l & 0xFFFFFFFF, "len_label": int(len_l),
    }
    binned_ds._ckpt_fp_parts = dict(parts)
    return parts


def data_fingerprint(binned_ds) -> str:
    """``"<rows>x<cols>:<crc32 of the bins then the labels>"``, the JAX
    package's string."""
    parts = data_fingerprint_parts(binned_ds)
    return f"{parts['rows']}x{parts['cols']}:{binned_ds._ckpt_crc_all:08x}"


# ----------------------------------------------------------------------
# binary tree pack/unpack (a bit-exact round trip)
# ----------------------------------------------------------------------
def pack_trees(models) -> Dict[str, np.ndarray]:
    """List[Tree] -> stacked ``(T, M)`` / ``(T, L)`` arrays and per-tree
    scalars, prefixed ``tree_``; only the live slices mean anything, the
    padding is zero."""
    t = len(models)
    m = max(max((tr.num_leaves - 1 for tr in models), default=1), 1)
    li = max(max((tr.num_leaves for tr in models), default=2), 2)
    out: Dict[str, np.ndarray] = {
        "tree_num_leaves": np.asarray([tr.num_leaves for tr in models], np.int32),
        "tree_shrinkage": np.asarray([tr.shrinkage_rate for tr in models], np.float64),
    }
    for name, dtype, axis in _TREE_FIELDS:
        arr = np.zeros((t, m if axis == "m" else li), dtype)
        for i, tr in enumerate(models):
            n = tr.num_leaves
            k = max(n - 1, 1) if axis == "m" else n
            src = getattr(tr, name)
            arr[i, : min(k, len(src))] = src[: min(k, len(src))]
        out["tree_" + name] = arr
    if any(getattr(tr, "is_linear", False) for tr in models):
        out.update(_pack_linear(models, t, li))
    return out


def _pack_linear(models, t: int, li: int) -> Dict[str, np.ndarray]:
    """The linear-leaf planes, written only when a tree carries them (a
    constant-tree checkpoint keeps the plain key set)."""
    kmax = 1
    for tr in models:
        if getattr(tr, "is_linear", False):
            for fs in tr.leaf_features:
                kmax = max(kmax, len(fs))
    is_lin = np.zeros(t, np.int8)
    const = np.zeros((t, li), np.float64)
    leaf_lin = np.zeros((t, li), np.int8)
    cnt = np.zeros((t, li), np.int32)
    feat = np.zeros((t, li, kmax), np.int32)
    feat_inner = np.zeros((t, li, kmax), np.int32)
    coeff = np.zeros((t, li, kmax), np.float64)
    for i, tr in enumerate(models):
        if not getattr(tr, "is_linear", False):
            continue
        is_lin[i] = 1
        n = tr.num_leaves
        const[i, :n] = tr.leaf_const[:n]
        leaf_lin[i, :n] = tr.leaf_is_linear[:n]
        for lj in range(min(n, len(tr.leaf_features))):
            fs = tr.leaf_features[lj]
            cnt[i, lj] = len(fs)
            if fs:
                feat[i, lj, : len(fs)] = fs
                feat_inner[i, lj, : len(fs)] = tr.leaf_features_inner[lj]
                coeff[i, lj, : len(fs)] = tr.leaf_coeff[lj]
    return {
        "tree_is_linear": is_lin,
        "tree_leaf_const": const,
        "tree_leaf_is_linear": leaf_lin,
        "tree_leaf_feat_cnt": cnt,
        "tree_leaf_feat": feat,
        "tree_leaf_feat_inner": feat_inner,
        "tree_leaf_coeff": coeff,
    }


def unpack_trees(arrays: Dict[str, np.ndarray]):
    """The inverse of :func:`pack_trees`: ``Tree`` objects field for field."""
    num_leaves = np.asarray(arrays["tree_num_leaves"])
    shrinkage = np.asarray(arrays["tree_shrinkage"])
    models = []
    for i in range(len(num_leaves)):
        n = int(num_leaves[i])
        tree = Tree(max(n, 2))
        tree.num_leaves = n
        for name, dtype, axis in _TREE_FIELDS:
            k = max(n - 1, 1) if axis == "m" else n
            src = np.asarray(arrays["tree_" + name][i][:k], dtype)
            getattr(tree, name)[: len(src)] = src
        tree.shrinkage_rate = float(shrinkage[i])
        tree.has_categorical = bool(np.any(tree.decision_type[: max(n - 1, 1)] == 1))
        if "tree_is_linear" in arrays and int(arrays["tree_is_linear"][i]):
            tree.is_linear = True
            tree.leaf_const[:n] = np.asarray(arrays["tree_leaf_const"][i][:n], np.float64)
            tree.leaf_is_linear[:n] = np.asarray(arrays["tree_leaf_is_linear"][i][:n]) != 0
            cnt = np.asarray(arrays["tree_leaf_feat_cnt"][i], np.int64)
            tree.leaf_features, tree.leaf_features_inner, tree.leaf_coeff = [], [], []
            for lj in range(n):
                c = int(cnt[lj])
                tree.leaf_features.append(tuple(int(v) for v in arrays["tree_leaf_feat"][i][lj][:c]))
                tree.leaf_features_inner.append(
                    tuple(int(v) for v in arrays["tree_leaf_feat_inner"][i][lj][:c]))
                tree.leaf_coeff.append(
                    tuple(np.asarray(arrays["tree_leaf_coeff"][i][lj][:c], np.float64)))
        models.append(tree)
    return models


# ----------------------------------------------------------------------
# TrainState
# ----------------------------------------------------------------------
class TrainState:
    """One process's complete training state at an iteration boundary."""

    def __init__(self, meta: Dict[str, Any], py: Dict[str, Any],
                 arrays: Dict[str, np.ndarray]):
        self.meta = dict(meta)
        self.py = dict(py)
        self.arrays = dict(arrays)

    @property
    def iteration(self) -> int:
        return int(self.meta["iteration"])

    def to_bytes(self) -> bytes:
        payload = dict(self.arrays)
        payload["__meta__"] = np.asarray(json.dumps({"meta": self.meta, "py": self.py},
                                                    default=str))
        buf = io.BytesIO()
        np.savez(buf, **payload)
        return buf.getvalue()

    @classmethod
    def from_bytes(cls, blob: bytes) -> "TrainState":
        with np.load(io.BytesIO(blob), allow_pickle=False) as z:
            if "__meta__" not in z:
                raise ValueError("not a TrainState blob (no __meta__)")
            header = json.loads(str(z["__meta__"]))
            arrays = {k: z[k] for k in z.files if k != "__meta__"}
        meta = header["meta"]
        if int(meta.get("format_version", -1)) != FORMAT_VERSION:
            raise ValueError(f"unsupported TrainState format_version "
                             f"{meta.get('format_version')} (supported: {FORMAT_VERSION})")
        return cls(meta, header["py"], arrays)


# ----------------------------------------------------------------------
# capture / restore
# ----------------------------------------------------------------------
def capture(booster, extra_py: Optional[Dict[str, Any]] = None) -> TrainState:
    """Snapshot a live ``Booster`` into a :class:`TrainState` (state.py:398).

    Reads only: the card's tensors are copied to the host, nothing
    changes.  ``extra_py`` carries the callbacks' state taken at the same
    boundary."""
    b = booster.boosting
    with tracer.span("ckpt.capture"):
        arrays, py = b.export_train_state()
        arrays.update(pack_trees(b.models))
        meta = {
            "format_version": FORMAT_VERSION,
            "iteration": int(b.iter),
            "boosting_type": type(b).__name__.lower(),
            "num_models": len(b.models),
            "num_tree_per_iteration": int(b.num_tree_per_iteration),
            "num_data": int(b.num_data),
            "config_fingerprint": config_fingerprint(b.config),
            "data_fingerprint": data_fingerprint(b.train_set),
            "data_fingerprint_parts": data_fingerprint_parts(b.train_set),
            "num_valid": len(b.valid_scores),
            "best_iteration": int(getattr(booster, "best_iteration", -1)),
        }
        ooc = getattr(b, "ooc", None)
        if ooc is not None:
            # the chunk schedule's identity (the JAX package's string)
            meta["ooc_schedule"] = ooc.schedule_fingerprint()
        if extra_py:
            py.update(extra_py)
    return TrainState(meta, py, arrays)


def restore(booster, state: TrainState) -> TrainState:
    """Load a :class:`TrainState` into a freshly built ``Booster`` (the same
    params and dataset, its validation sets already added; state.py:438).
    Refuses a config or dataset mismatch, and what the port cannot resume
    yet."""
    b = booster.boosting
    if "world_size" in state.meta:
        raise CheckpointMismatch(
            f"checkpoint holds the canonical layout of a {state.meta['world_size']}-process "
            "run; resuming it waits for the port's distributed training")
    cfp, dfp = config_fingerprint(b.config), data_fingerprint(b.train_set)
    if state.meta["config_fingerprint"] != cfp:
        raise CheckpointMismatch(
            "checkpoint was written under a different training config "
            f"(checkpoint {state.meta['config_fingerprint']}, run {cfp}); "
            "refusing to resume — clear the checkpoint directory to start over")
    if state.meta["data_fingerprint"] != dfp:
        raise CheckpointMismatch(
            "checkpoint was written against a different dataset "
            f"(checkpoint {state.meta['data_fingerprint']}, run {dfp}); refusing to resume")
    want_bt = type(b).__name__.lower()
    if state.meta["boosting_type"] != want_bt:
        raise CheckpointMismatch(
            f"checkpoint boosting type {state.meta['boosting_type']} != {want_bt}")
    if int(state.meta["num_valid"]) != len(b.valid_scores):
        raise CheckpointMismatch(
            f"checkpoint has {state.meta['num_valid']} valid sets, "
            f"run registered {len(b.valid_scores)}")
    ooc = getattr(b, "ooc", None)
    want_sched = state.meta.get("ooc_schedule")
    have_sched = ooc.schedule_fingerprint() if ooc is not None else None
    if want_sched != have_sched:
        raise CheckpointMismatch(
            f"checkpoint out-of-core chunk schedule {want_sched!r} != this run's "
            f"{have_sched!r}; resuming on another streaming grid is refused — rerun with "
            "the original out_of_core/ooc_chunk_rows settings")
    with tracer.span("ckpt.restore", iter=state.iteration):
        b.models = unpack_trees(state.arrays)
        b.import_train_state(state.arrays, state.py)
        bi = int(state.meta.get("best_iteration", -1))
        if bi > 0:
            booster.best_iteration = bi
    tracer.event("ckpt.restored", iter=state.iteration, num_models=len(b.models))
    Log.info("Resumed training state at iteration %d (%d trees)", state.iteration,
             len(b.models))
    return state
