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
the run's.

A run over several processes saves one canonical container in global
row order (``merge_to_canonical``: the ranks' row arrays concatenated in
rank order, the global dataset fingerprint combined from the ranks' CRC
parts with ``crc32_combine``), which any world resumes by slicing it
(``reshard_to_local``; ckpt/manager.py drives both).
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
    "metric_freq", "machine_list_file", "machines", "local_listen_port", "time_out",
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


# the global fingerprint from the shards' parts: under pre_partition the
# global rows are the ranks' shards in rank order, so zlib's identity
# crc(A||B) = combine(crc(A), crc(B), len(B)) gives it without any rank
# seeing another's rows
def _gf2_matrix_times(mat, vec: int) -> int:
    out = 0
    i = 0
    while vec:
        if vec & 1:
            out ^= mat[i]
        vec >>= 1
        i += 1
    return out


def _gf2_matrix_square(square, mat) -> None:
    for n in range(32):
        square[n] = _gf2_matrix_times(mat, mat[n])


def crc32_combine(crc1: int, crc2: int, len2: int) -> int:
    """zlib's crc32_combine: the CRC of A||B from ``crc32(A)``,
    ``crc32(B)`` and ``len(B)`` (GF(2) matrix powers of the polynomial
    over len2 zero bytes)."""
    if len2 <= 0:
        return crc1 & 0xFFFFFFFF
    even = [0] * 32
    odd = [0] * 32
    odd[0] = 0xEDB88320  # the CRC-32 polynomial, reflected
    row = 1
    for n in range(1, 32):
        odd[n] = row
        row <<= 1
    _gf2_matrix_square(even, odd)
    _gf2_matrix_square(odd, even)
    crc1 &= 0xFFFFFFFF
    while True:
        _gf2_matrix_square(even, odd)
        if len2 & 1:
            crc1 = _gf2_matrix_times(even, crc1)
        len2 >>= 1
        if len2 == 0:
            break
        _gf2_matrix_square(odd, even)
        if len2 & 1:
            crc1 = _gf2_matrix_times(odd, crc1)
        len2 >>= 1
        if len2 == 0:
            break
    return (crc1 ^ (crc2 & 0xFFFFFFFF)) & 0xFFFFFFFF


def combine_fingerprint_parts(parts) -> str:
    """Rank-ordered shard parts -> the fingerprint of their concatenated
    rows (``data_fingerprint`` of the global dataset)."""
    parts = [dict(p) for p in parts]
    rows = sum(int(p["rows"]) for p in parts)
    cols = int(parts[0]["cols"]) if parts else 0
    crc_b = 0
    for p in parts:
        if int(p["cols"]) != cols:
            raise CheckpointMismatch(f"shard column counts disagree: {cols} vs {p['cols']}")
        crc_b = crc32_combine(crc_b, int(p["crc_binned"]), int(p["len_binned"]))
    crc_l, len_l = 0, 0
    for p in parts:
        crc_l = crc32_combine(crc_l, int(p["crc_label"]), int(p["len_label"]))
        len_l += int(p["len_label"])
    crc = crc32_combine(crc_b, crc_l, len_l)
    return f"{rows}x{cols}:{crc & 0xFFFFFFFF:08x}"


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
    Refuses a config or dataset mismatch, as the JAX package's does (a
    canonical multi-process container is sliced to this rank first, by
    ckpt/manager.py)."""
    b = booster.boosting
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


# ----------------------------------------------------------------------
# the canonical layout of a run over several processes
# ----------------------------------------------------------------------
def merge_to_canonical(states) -> TrainState:
    """The ranks' ``TrainState``s (rank order) -> one container in global
    row order (JAX state.py:529): row arrays concatenated in rank order;
    the replicated state (trees, feature_fraction stream) from rank 0; the
    per-rank state (the bagging stream, the early-stopping bests, the
    callbacks) kept per rank, so that a resume in the same partition is
    byte-identical."""
    if not states:
        raise ValueError("merge_to_canonical needs at least one state")
    base = states[0]
    iters = {int(s.meta["iteration"]) for s in states}
    if len(iters) != 1:
        raise CheckpointMismatch(
            f"cannot merge rank states from divergent iterations: {sorted(iters)}")
    nv = int(base.meta["num_valid"])
    shard_rows = [int(s.meta["num_data"]) for s in states]
    parts = []
    for r, s in enumerate(states):
        p = s.meta.get("data_fingerprint_parts")
        if not p:
            raise ValueError(f"rank {r} state lacks data_fingerprint_parts; cannot derive the "
                             "global dataset fingerprint")
        parts.append(p)
    valid_shard = [[int(np.asarray(s.arrays[f"valid_scores_{i}"]).shape[1]) for s in states]
                   for i in range(nv)]
    arrays = dict(base.arrays)
    arrays["scores"] = np.concatenate([np.asarray(s.arrays["scores"]) for s in states], axis=1)
    arrays["select"] = np.concatenate([np.asarray(s.arrays["select"]) for s in states], axis=0)
    for i in range(nv):
        arrays[f"valid_scores_{i}"] = np.concatenate(
            [np.asarray(s.arrays[f"valid_scores_{i}"]) for s in states], axis=1)
    arrays.pop("bag_rng_keys", None)
    for r, s in enumerate(states):
        arrays[f"bag_rng_keys_r{r}"] = np.asarray(s.arrays["bag_rng_keys"], np.uint32)
    py = dict(base.py)
    py["per_rank"] = {
        str(r): {"py": {k: v for k, v in s.py.items() if k != "per_rank"},
                 "best_iteration": int(s.meta.get("best_iteration", -1))}
        for r, s in enumerate(states)}
    meta = dict(base.meta)
    meta.pop("data_fingerprint_parts", None)
    meta["world_size"] = len(states)
    meta["shard_rows"] = shard_rows
    meta["valid_shard_rows"] = valid_shard
    meta["num_data"] = int(sum(shard_rows))
    meta["data_fingerprint"] = combine_fingerprint_parts(parts)
    return TrainState(meta, py, arrays)


def reshard_to_local(state: TrainState, rank: int, shard_rows, valid_shard_rows,
                     local_fp: str, bag_seed: int = 0) -> TrainState:
    """A canonical container sliced to one rank of the current world
    (JAX state.py:589): ``shard_rows`` / ``valid_shard_rows`` are the
    current contiguous partition in rank order (the caller has checked
    the global fingerprint).  The same partition restores the rank's own
    bagging stream, bests and callbacks exactly; another one reslices the
    row arrays and reseeds the bagging stream from (``bag_seed``, the
    iteration, the rank)."""
    meta = dict(state.meta)
    saved_rows = [int(x) for x in meta.get("shard_rows", [])]
    saved_valid = [[int(x) for x in v] for v in meta.get("valid_shard_rows", [])]
    shard_rows = [int(x) for x in shard_rows]
    valid_shard_rows = [[int(x) for x in v] for v in valid_shard_rows]
    total = sum(shard_rows)
    if total != int(meta["num_data"]):
        raise CheckpointMismatch(f"checkpoint holds {meta['num_data']} global rows but the "
                                 f"current topology partitions {total}")
    for i, v in enumerate(valid_shard_rows):
        if i < len(saved_valid) and sum(v) != sum(saved_valid[i]):
            raise CheckpointMismatch(f"valid set {i} holds {sum(saved_valid[i])} global rows "
                                     f"but the current topology partitions {sum(v)}")
    same_partition = saved_rows == shard_rows and saved_valid == valid_shard_rows
    start = sum(shard_rows[:rank])
    stop = start + shard_rows[rank]
    with tracer.span("ckpt.reshard", rank=rank, saved_world=int(meta.get("world_size", 1)),
                     world=len(shard_rows), same_partition=same_partition):
        arrays: Dict[str, np.ndarray] = {}
        for key, val in state.arrays.items():
            if key == "scores":
                arrays[key] = np.asarray(val)[:, start:stop]
            elif key == "select":
                arrays[key] = np.asarray(val)[start:stop]
            elif key.startswith("valid_scores_"):
                i = int(key[len("valid_scores_"):])
                vs = sum(valid_shard_rows[i][:rank])
                arrays[key] = np.asarray(val)[:, vs:vs + valid_shard_rows[i][rank]]
            elif key.startswith("bag_rng_keys_r"):
                continue  # the per-rank streams, below
            else:
                arrays[key] = val
        py = {k: v for k, v in state.py.items() if k != "per_rank"}
        if same_partition:
            pr = (state.py.get("per_rank") or {}).get(str(rank))
            if pr is not None:
                py = dict(pr["py"])
                meta["best_iteration"] = int(pr.get("best_iteration", -1))
            arrays["bag_rng_keys"] = np.asarray(state.arrays[f"bag_rng_keys_r{rank}"],
                                                np.uint32)
        else:
            rs = np.random.RandomState([int(bag_seed) & 0xFFFFFFFF,
                                        int(meta["iteration"]) & 0xFFFFFFFF, int(rank)])
            st = rs.get_state()
            arrays["bag_rng_keys"] = np.asarray(st[1], np.uint32)
            py["bag_rng"] = [str(st[0]), int(st[2]), int(st[3]), float(st[4])]
            py["need_re_bagging"] = True
        meta["num_data"] = shard_rows[rank]
        meta["data_fingerprint"] = local_fp
        for key in ("world_size", "shard_rows", "valid_shard_rows"):
            meta.pop(key, None)
    return TrainState(meta, py, arrays)
