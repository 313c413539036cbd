"""Parameter handling — the counterpart of the reference's config layer
(include/LightGBM/config.h, src/io/config.cpp).

The reference splits parameters into nested sub-config structs
(IOConfig/TreeConfig/BoostingConfig/ObjectiveConfig/MetricConfig/
NetworkConfig wired into OverallConfig).  Here a single flat dataclass holds
every parameter under its canonical name — the layering in the reference is
an artifact of C++ struct ownership, not semantics — while the alias table
(config.h:359–487) and the unknown-parameter rejection are reproduced
exactly so that `lgb.train(params=...)` dicts written for the reference work
unchanged.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from .utils.log import Log

# Alias -> canonical name. Parity with config.h:361-443.
PARAM_ALIASES: Dict[str, str] = {
    "config": "config_file",
    "nthread": "num_threads",
    "random_seed": "seed",
    "num_thread": "num_threads",
    "boosting": "boosting_type",
    "boost": "boosting_type",
    "application": "objective",
    "app": "objective",
    "train_data": "data",
    "train": "data",
    "model_output": "output_model",
    "model_out": "output_model",
    "model_input": "input_model",
    "model_in": "input_model",
    "predict_result": "output_result",
    "prediction_result": "output_result",
    "valid": "valid_data",
    "test_data": "valid_data",
    "test": "valid_data",
    "is_sparse": "is_enable_sparse",
    "enable_sparse": "is_enable_sparse",
    "pre_partition": "is_pre_partition",
    "tranining_metric": "is_training_metric",
    "train_metric": "is_training_metric",
    "ndcg_at": "ndcg_eval_at",
    "eval_at": "ndcg_eval_at",
    "min_data_per_leaf": "min_data_in_leaf",
    "min_data": "min_data_in_leaf",
    "min_child_samples": "min_data_in_leaf",
    "min_sum_hessian_per_leaf": "min_sum_hessian_in_leaf",
    "min_sum_hessian": "min_sum_hessian_in_leaf",
    "min_hessian": "min_sum_hessian_in_leaf",
    "min_child_weight": "min_sum_hessian_in_leaf",
    "num_leaf": "num_leaves",
    "sub_feature": "feature_fraction",
    "colsample_bytree": "feature_fraction",
    "num_iteration": "num_iterations",
    "num_tree": "num_iterations",
    "num_round": "num_iterations",
    "num_trees": "num_iterations",
    "num_rounds": "num_iterations",
    "num_boost_round": "num_iterations",
    "sub_row": "bagging_fraction",
    "subsample": "bagging_fraction",
    "subsample_freq": "bagging_freq",
    "shrinkage_rate": "learning_rate",
    "tree": "tree_learner",
    "tree_learner_type": "tree_learner",
    "tree_type": "tree_learner",
    "num_machine": "num_machines",
    "local_port": "local_listen_port",
    "two_round_loading": "use_two_round_loading",
    "two_round": "use_two_round_loading",
    "mlist": "machine_list_file",
    "is_save_binary": "is_save_binary_file",
    "save_binary": "is_save_binary_file",
    "early_stopping_rounds": "early_stopping_round",
    "early_stopping": "early_stopping_round",
    "verbosity": "verbose",
    "header": "has_header",
    "label": "label_column",
    "weight": "weight_column",
    "group": "group_column",
    "query": "group_column",
    "query_column": "group_column",
    "ignore_feature": "ignore_column",
    "blacklist": "ignore_column",
    "categorical_feature": "categorical_column",
    "cat_column": "categorical_column",
    "cat_feature": "categorical_column",
    "predict_raw_score": "is_predict_raw_score",
    "predict_leaf_index": "is_predict_leaf_index",
    "raw_score": "is_predict_raw_score",
    "leaf_index": "is_predict_leaf_index",
    "min_split_gain": "min_gain_to_split",
    "topk": "top_k",
    "reg_alpha": "lambda_l1",
    "reg_lambda": "lambda_l2",
    "num_classes": "num_class",
    "unbalanced_sets": "is_unbalance",
    "bagging_fraction_seed": "bagging_seed",
    "use_quantized_grad": "quantized_training",
    "linear_trees": "linear_tree",
    "monotone_constraint": "monotone_constraints",
    "mc": "monotone_constraints",
}


@dataclass
class Config:
    """All canonical parameters with reference defaults (config.h:85–290)."""

    # --- task / global (OverallConfig)
    task: str = "train"
    seed: int = 0
    num_threads: int = 0
    boosting_type: str = "gbdt"
    objective: str = "regression"
    metric: List[str] = field(default_factory=list)
    tree_learner: str = "serial"
    device: str = "tpu"  # reference default "cpu"; here TPU is the device story
    config_file: str = ""
    convert_model_language: str = ""

    # --- IO (IOConfig, config.h:87–148)
    max_bin: int = 255
    num_class: int = 1
    data_random_seed: int = 1
    data: str = ""
    valid_data: List[str] = field(default_factory=list)
    snapshot_freq: int = 100
    output_model: str = "LightGBM_model.txt"
    output_result: str = "LightGBM_predict_result.txt"
    convert_model: str = "gbdt_prediction.cpp"
    input_model: str = ""
    verbose: int = 1
    num_iteration_predict: int = -1
    is_pre_partition: bool = False
    is_enable_sparse: bool = True
    sparse_threshold: float = 0.8
    use_two_round_loading: bool = False
    is_save_binary_file: bool = False
    enable_load_from_binary_file: bool = True
    bin_construct_sample_cnt: int = 200000
    is_predict_leaf_index: bool = False
    is_predict_raw_score: bool = False
    min_data_in_bin: int = 5
    max_conflict_rate: float = 0.0
    enable_bundle: bool = True
    has_header: bool = False
    label_column: str = ""
    weight_column: str = ""
    group_column: str = ""
    ignore_column: str = ""
    categorical_column: str = ""
    pred_early_stop: bool = False
    pred_early_stop_freq: int = 10
    pred_early_stop_margin: float = 10.0
    # --- fault tolerance (ckpt/; TPU-specific extension).  The CLI
    # writes full training-state checkpoints at snapshot_freq (real
    # resume, not just a model dump); checkpoint_freq overrides the
    # cadence, checkpoint_dir the location (default: output_model's
    # directory), checkpoint_keep the rolling retention, and
    # checkpoint_resume is auto/true/false (auto resumes only an
    # interrupted run; see docs/CHECKPOINT.md).
    checkpoint_dir: str = ""
    checkpoint_freq: int = 0
    checkpoint_keep: int = 3
    checkpoint_resume: str = "auto"

    # --- malformed-input policy (data/reader.py; TPU-specific
    # extension).  'error' (default) fails loudly naming the file and
    # data-row number; 'skip' drops malformed/ragged rows, counts them
    # on the `data.bad_rows` obs counter, and stays bit-identical to
    # 'error' whenever no rows are bad.
    bad_row_policy: str = "error"

    # --- streaming ingest (data/ingest.py; TPU-specific extension).
    # stream_ingest: 'auto' streams text loads above the size threshold
    # (or always under use_two_round_loading), 'true'/'false' force;
    # the LIGHTGBM_TPU_STREAM_INGEST env knob overrides this param.
    stream_ingest: str = "auto"
    stream_chunk_rows: int = 0  # 0 = auto-size chunks (~32 MiB raw)

    # --- out-of-core training (boosting/ooc.py; TPU-specific
    # extension).  out_of_core: 'auto' streams the bin matrix from host
    # when its packed size exceeds the device budget
    # (LIGHTGBM_TPU_DEVICE_BUDGET or the backend's reported limit),
    # 'true'/'false' force; the LIGHTGBM_TPU_OOC env knob overrides.
    # ooc_chunk_rows: rows per streamed chunk (0 = auto ~64 MiB packed;
    # always rounded up to the histogram ROW_BLOCK for bit-identity).
    # ooc_prefetch_depth: in-flight host->device chunk buffers (2 =
    # double buffering) — this bounds peak device residency.
    out_of_core: str = "auto"
    ooc_chunk_rows: int = 0
    ooc_prefetch_depth: int = 2

    # --- quantized training (ops/qhist.py; TPU-specific extension
    # mirroring the reference's use_quantized_grad).  Off by default —
    # and OFF is bit-identical to builds without the feature.  On:
    # per-row grad/hess quantize to int16 levels under a per-iteration
    # global scale with stochastic rounding, histograms accumulate in
    # exact int32 (deterministic across row orders, chunkings and rank
    # counts), distributed histogram exchanges ship the 3x-smaller
    # int16 hist_q wire, and dequantization happens at split-scan time.
    # quantized_grad_bits: signed level width (2..15; 5 = QMAX 15).
    quantized_training: bool = False
    quantized_grad_bits: int = 5

    # --- leaf-model / split-constraint plug-ins (tree/strategy.py;
    # docs/TREES.md).  linear_tree fits per-leaf ridge least-squares
    # models over each leaf's path features (tree/linear.py) with
    # linear_lambda the ridge strength on the slope terms.
    # monotone_constraints is a per-feature +1/0/-1 direction surface:
    # a comma list ("+1,0,-1", one entry per raw feature) or a
    # {feature index or name: direction} dict.  Supported matrix:
    # linear_tree -> gbdt/goss boosting, f32 histograms,
    # tree_learner=serial or data on ONE process (in-memory or
    # out-of-core); monotone_constraints -> every learner except the
    # fused ptrainer (which declines and falls back, like quantized).
    linear_tree: bool = False
    linear_lambda: float = 0.0
    monotone_constraints: Any = ""

    # --- tree (TreeConfig, config.h:189–234)
    min_data_in_leaf: int = 20
    min_sum_hessian_in_leaf: float = 1e-3
    lambda_l1: float = 0.0
    lambda_l2: float = 0.0
    min_gain_to_split: float = 0.0
    num_leaves: int = 31
    feature_fraction_seed: int = 2
    feature_fraction: float = 1.0
    histogram_pool_size: float = -1.0
    max_depth: int = -1
    top_k: int = 20
    gpu_platform_id: int = -1
    gpu_device_id: int = -1
    gpu_use_dp: bool = False
    use_missing: bool = True

    # --- boosting (BoostingConfig, config.h:236–266)
    output_freq: int = 1
    is_training_metric: bool = False
    num_iterations: int = 100
    learning_rate: float = 0.1
    bagging_fraction: float = 1.0
    bagging_seed: int = 3
    bagging_freq: int = 0
    early_stopping_round: int = 0
    drop_rate: float = 0.1
    max_drop: int = 50
    skip_drop: float = 0.5
    xgboost_dart_mode: bool = False
    uniform_drop: bool = False
    drop_seed: int = 4
    top_rate: float = 0.2
    other_rate: float = 0.1
    boost_from_average: bool = True

    # --- objective (ObjectiveConfig, config.h:153–172)
    sigmoid: float = 1.0
    huber_delta: float = 1.0
    fair_c: float = 1.0
    gaussian_eta: float = 1.0
    poisson_max_delta_step: float = 0.7
    label_gain: List[float] = field(default_factory=list)
    max_position: int = 20
    is_unbalance: bool = False
    scale_pos_weight: float = 1.0

    # --- metric (MetricConfig, config.h:176–186)
    ndcg_eval_at: List[int] = field(default_factory=lambda: [1, 2, 3, 4, 5])
    metric_freq: int = 1

    # --- network (NetworkConfig, config.h:261–268)
    num_machines: int = 1
    local_listen_port: int = 12400
    time_out: int = 120
    machine_list_file: str = ""
    # --- hardened transport (parallel/net.py; TPU-specific extension,
    # docs/ROBUSTNESS.md).  network_timeout is the per-collective wait
    # window in SECONDS (the TPU-era replacement of the reference's
    # socket time_out, which is in minutes); a dead peer surfaces within
    # ~2x this bound.  network_retries bounds transient-error retries on
    # an exponential backoff; network_heartbeat_interval=0 auto-derives
    # (timeout/4, capped at 5 s).  Env vars LIGHTGBM_TPU_NET_TIMEOUT /
    # _NET_RETRIES / _NET_HEARTBEAT override these params.
    network_timeout: float = 120.0
    network_retries: int = 3
    network_heartbeat_interval: float = 0.0
    # --- straggler-aware shard rebalancing (parallel/shardplan.py;
    # docs/ROBUSTNESS.md).  Off by default: rebalance=False keeps the
    # exact static-shard behavior (zero extra collectives).  When on, a
    # rank whose EWMA compute time stays above rebalance_threshold x the
    # fleet median for rebalance_patience consecutive iterations
    # triggers a shard-boundary move at the next iteration boundary; at
    # most rebalance_max_move_frac of the global rows move per event.
    rebalance: bool = False
    rebalance_threshold: float = 1.5
    rebalance_patience: int = 3
    rebalance_max_move_frac: float = 0.25
    # --- live elastic membership (parallel/membership.py;
    # docs/ROBUSTNESS.md).  Off by default: elastic_membership=False
    # compiles the exact static-fleet path (jax.distributed transport,
    # documented bounded fail-fast on coordinator death).  When on, the
    # worker must have armed a MembershipRuntime (or set
    # LIGHTGBM_TPU_MEMBER_DIR) before Booster construction; collectives
    # then ride the shared-directory KV fleet, workers may join/leave
    # mid-run at iteration boundaries, and a dead member is evicted
    # (survivors resize via the in-RAM canonical merge/reshard path)
    # instead of the whole fleet exiting 75.
    elastic_membership: bool = False

    # --- derived
    is_parallel: bool = False
    is_parallel_find_bin: bool = False

    def copy(self) -> "Config":
        return dataclasses.replace(self)

    # ------------------------------------------------------------------
    @classmethod
    def from_params(cls, params: Optional[Dict[str, Any]]) -> "Config":
        cfg = cls()
        cfg.update(params or {})
        return cfg

    def update(self, params: Dict[str, Any]) -> None:
        canon = canonicalize_params(params)
        for key, value in canon.items():
            self._set_one(key, value)
        self._check_conflicts()

    def _set_one(self, key: str, value: Any) -> None:
        if key in ("metric",):
            self.metric = _parse_list(value, str)
            return
        if key in ("valid_data",):
            self.valid_data = _parse_list(value, str)
            return
        if key == "ndcg_eval_at":
            self.ndcg_eval_at = _parse_list(value, int)
            return
        if key == "label_gain":
            self.label_gain = _parse_list(value, float)
            return
        if key == "monotone_constraints":
            # two accepted forms (docs/TREES.md): comma list (one
            # direction per raw feature) or {feature: direction} dict;
            # python lists normalize to the comma form
            if isinstance(value, dict):
                self.monotone_constraints = dict(value)
            elif isinstance(value, (list, tuple)):
                self.monotone_constraints = ",".join(
                    str(int(v)) for v in value)
            else:
                self.monotone_constraints = str(value)
            return
        if not hasattr(self, key):
            Log.fatal("Unknown parameter: %s", key)
        cur = getattr(self, key)
        try:
            if isinstance(cur, bool):
                setattr(self, key, _parse_bool(key, value))
            elif isinstance(cur, int):
                setattr(self, key, int(value))
            elif isinstance(cur, float):
                setattr(self, key, float(value))
            else:
                setattr(self, key, str(value))
        except (TypeError, ValueError):
            Log.fatal("Parameter %s received an unparsable value \"%s\"", key, value)

    def _monotone_active(self) -> bool:
        """True when monotone_constraints names at least one nonzero
        direction (either surface form)."""
        mc = self.monotone_constraints
        if isinstance(mc, dict):
            return any(int(v) != 0 for v in mc.values())
        s = str(mc).strip()
        if not s:
            return False
        return any(p.strip() not in ("", "0") for p in s.split(","))

    def _check_conflicts(self) -> None:
        """CheckParamConflict (config.cpp): parallel learners imply
        is_parallel; bagging requires fraction<1 and freq>0; etc."""
        learner = self.tree_learner.lower()
        if learner not in ("serial", "data", "feature", "voting"):
            Log.fatal(
                "tree_learner must be one of serial/data/feature/voting, "
                "got %s", self.tree_learner)
        if learner in ("feature", "data", "voting") and self.num_machines > 1:
            self.is_parallel = True
        else:
            self.is_parallel = False
        if learner == "data" or learner == "voting":
            self.is_parallel_find_bin = self.is_parallel
        if self.top_k < 1:
            Log.fatal("top_k must be >= 1 for voting-parallel, got %d",
                      self.top_k)
        if (learner in ("voting", "feature")
                and str(self.out_of_core).lower() in ("true", "1", "on",
                                                      "yes")):
            Log.fatal(
                "tree_learner=%s cannot run with out_of_core=true: "
                "the %s needs the full resident bin matrix. Streaming "
                "supports tree_learner=serial (single process) or "
                "tree_learner=data (each rank streams its own row "
                "shard). Set out_of_core=false (or auto) or switch to "
                "tree_learner=data.",
                learner,
                "voting learner's per-node elected-histogram exchange"
                if learner == "voting"
                else "feature-parallel learner's column blocks")
        if self.num_leaves < 2:
            Log.fatal("num_leaves must be >= 2, got %d", self.num_leaves)
        if not (0.0 < self.feature_fraction <= 1.0):
            Log.fatal("feature_fraction must be in (0, 1], got %s", self.feature_fraction)
        if not (0.0 < self.bagging_fraction <= 1.0):
            Log.fatal("bagging_fraction must be in (0, 1], got %s", self.bagging_fraction)
        if self.bad_row_policy not in ("error", "skip"):
            Log.fatal("bad_row_policy must be 'error' or 'skip', got %s",
                      self.bad_row_policy)
        if str(self.out_of_core).lower() not in (
                "auto", "true", "false", "1", "0", "on", "off", "yes", "no"):
            Log.fatal("out_of_core must be auto/true/false, got %s",
                      self.out_of_core)
        if self.ooc_chunk_rows < 0:
            Log.fatal(
                "ooc_chunk_rows must be >= 0 (0 = auto-size; any "
                "positive value is rounded up to a ROW_BLOCK multiple, "
                "per rank over that rank's shard rows under "
                "tree_learner=data), got %d", self.ooc_chunk_rows)
        if self.ooc_prefetch_depth < 1:
            Log.fatal(
                "ooc_prefetch_depth must be >= 1 (chunks in flight in "
                "each rank's prefetch ring), got %d",
                self.ooc_prefetch_depth)
        if not (2 <= self.quantized_grad_bits <= 15):
            # >15 would let a single row overflow the int16 wire plane;
            # <2 leaves no signed levels at all
            Log.fatal("quantized_grad_bits must be in [2, 15], got %d",
                      self.quantized_grad_bits)
        if self.linear_lambda < 0:
            Log.fatal(
                "linear_lambda must be >= 0 (ridge strength on the "
                "linear-leaf slope terms), got %s", self.linear_lambda)
        if self.linear_tree:
            # supported matrix (docs/TREES.md): linear leaves need f32
            # leaf sums and post-grow refits against the resident (or
            # serially streamed) row shard of ONE process
            matrix = ("linear_tree supports: boosting_type=gbdt/goss, "
                      "quantized_training=false, tree_learner=serial or "
                      "data on a single process (in-memory or "
                      "out_of_core serial streaming)")
            if self.quantized_training:
                Log.fatal(
                    "linear_tree=true cannot run with "
                    "quantized_training=true: the per-leaf least-squares "
                    "refit needs f32 gradient/hessian rows, not int16 "
                    "levels. %s.", matrix)
            if self.boosting_type.lower() == "dart":
                Log.fatal(
                    "linear_tree=true cannot run with boosting=dart: "
                    "DART's per-tree drop/renormalize rescales leaf "
                    "outputs after the fit, which would silently skew "
                    "the fitted slopes. %s.", matrix)
            if self.num_machines > 1:
                Log.fatal(
                    "linear_tree=true cannot run with num_machines=%d: "
                    "the leaf refit solves against rows the coordinator "
                    "does not hold. %s.", self.num_machines, matrix)
        if self._monotone_active() and self.objective == "lambdarank":
            Log.fatal(
                "monotone_constraints cannot be combined with "
                "objective=lambdarank: listwise rank gradients are not "
                "per-row monotone in feature direction. Supported: "
                "row-wise objectives (regression/binary/multiclass/"
                "xentropy family) on every learner except the fused "
                "ptrainer (which declines and falls back).")
        if self.network_timeout <= 0:
            Log.fatal("network_timeout must be > 0, got %s", self.network_timeout)
        if self.network_retries < 0:
            Log.fatal("network_retries must be >= 0, got %d", self.network_retries)
        if self.rebalance_threshold <= 1.0:
            Log.fatal("rebalance_threshold must be > 1, got %s",
                      self.rebalance_threshold)
        if self.rebalance_patience < 1:
            Log.fatal("rebalance_patience must be >= 1, got %d",
                      self.rebalance_patience)
        if not (0.0 < self.rebalance_max_move_frac <= 1.0):
            Log.fatal("rebalance_max_move_frac must be in (0, 1], got %s",
                      self.rebalance_max_move_frac)
        if self.elastic_membership:
            if self.tree_learner not in ("data", "serial"):
                Log.fatal(
                    "elastic_membership=true requires tree_learner=data "
                    "(got %s): feature-parallel shards columns, and a "
                    "membership change re-partitions ROWS through the "
                    "canonical merge/reshard path.", self.tree_learner)
            if self.num_machines > 1:
                Log.fatal(
                    "elastic_membership=true cannot run with "
                    "num_machines=%d: the membership fleet replaces the "
                    "static socket world.", self.num_machines)
        Log.reset_level(self.verbose)


# canonical parameter names beyond the alias table; mirrors the
# parameter_set whitelist at config.h:444-474 (extended with TPU-specific
# names; unknown keys are rejected like the reference's Log::Fatal).
_EXTRA_ALLOWED = {
    "machine_list_filename",
    "data_filename",
    "valid_data_filenames",
    "poission_max_delta_step",  # reference's own typo, kept accepted
    "is_provide_training_metric",
}


def canonicalize_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """Alias resolution with canonical-name priority: an explicitly-passed
    canonical key wins over a value arriving via an alias
    (ParameterAlias::KeyAliasTransform, config.h:475-486)."""
    cfg_fields = {f.name for f in dataclasses.fields(Config)}
    out: Dict[str, Any] = {}
    aliased: Dict[str, Any] = {}
    for key, value in params.items():
        if value is None:
            continue
        if key in PARAM_ALIASES:
            aliased[PARAM_ALIASES[key]] = value
        elif key in cfg_fields or key in _EXTRA_ALLOWED:
            out[key] = value
        else:
            Log.fatal("Unknown parameter: %s", key)
    for key, value in aliased.items():
        out.setdefault(key, value)
    # normalize the reference's *_filename spellings
    if "machine_list_filename" in out:
        out.setdefault("machine_list_file", out.pop("machine_list_filename"))
    if "data_filename" in out:
        out["data"] = out.pop("data_filename")
    if "valid_data_filenames" in out:
        out["valid_data"] = out.pop("valid_data_filenames")
    if "is_provide_training_metric" in out:
        out["is_training_metric"] = out.pop("is_provide_training_metric")
    if "poission_max_delta_step" in out:
        out["poisson_max_delta_step"] = out.pop("poission_max_delta_step")
    return out


def _parse_bool(key: str, value: Any) -> bool:
    if isinstance(value, bool):
        return value
    v = str(value).lower()
    if v in ("true", "+", "1"):
        return True
    if v in ("false", "-", "0"):
        return False
    Log.fatal('Parameter %s should be "true"/"+" or "false"/"-", got "%s"', key, value)
    raise AssertionError  # unreachable


def _parse_list(value: Any, typ) -> list:
    if isinstance(value, (list, tuple)):
        return [typ(v) for v in value]
    s = str(value).strip()
    if not s:
        return []
    return [typ(v) for v in s.replace(",", " ").split()]


def params_to_str(params: Dict[str, Any]) -> str:
    """Serialize a param dict to 'k=v k=v' (basic.py param_dict_to_str)."""
    pairs = []
    for key, value in params.items():
        if isinstance(value, (list, tuple)):
            value = ",".join(str(v) for v in value)
        pairs.append(f"{key}={value}")
    return " ".join(pairs)
