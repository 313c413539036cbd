"""GBDT boosting loop — PyTorch counterpart of lightgbm_tpu/boosting/gbdt.py
in one process: init and routing onto one of the two tree learners,
boost-from-average, the iterations of each learner, validation sets and
their scores, metrics and the early-stopping bookkeeping, model text and
predict (src/boosting/gbdt.cpp TrainOneIter :381-495, AddValidDataset
:220-250, OutputMetric :516-622, model save/load :854-1008).

The learners, as the JAX package routes them (gbdt.py:313-392):

- the partitioned trainer (boosting/ptrainer.py), for every
  configuration its ``eligible`` takes: ``train_iters_partitioned``;
- the mask grower (ops/grow.py) for the rest — a custom objective,
  lambdarank, quantized training, more than 16 classes, multiclass GOSS,
  more than 256 bins, more than 512 columns, or ``LIGHTGBM_TPU_PGROW=0``
  — one iteration at a time
  (``_train_one_iter_mask``, gbdt.py:582-741): the objective's gradients
  of the (K, N) scores, GOSS's or bagging's row select, per class the
  feature_fraction mask, the optional quantization and one tree, whose
  leaf values then go onto the scores through the grower's ``leaf_id``.

``tree_learner=data|feature|voting`` in one process trains serially, with
the JAX package's warning (``_route_tree_learner``).  Over several
processes (parallel/distributed.py forms the world first) every mode
runs the host-driven learner of parallel/hostlearner.py over ``NetComm``
on the mask grower's iteration, as the JAX package does on a backend
without multi-process computations (gbdt.py:313-371): each rank's B8 /
B9 histograms of its own rows, the exchanges through the store.  The
label average, the quantization headroom, ranking's group padding and
the quantization scales are then global.

The tree strategies (tree/strategy.py, gbdt.py:235-258) run on the mask
grower, which the partitioned trainer leaves them to: monotone
constraints in its split search, and linear leaves fitted after each
tree's growth, before shrinkage (``_fit_linear_tree``, gbdt.py:893-987),
whose outputs then go onto the scores through the same partition.  Given
gradients (a custom objective) also train on the mask grower, on a
booster the partitioned trainer started too: its state is built at the
first such iteration from the band's scores, and the band is rewritten
from the scores before the next chunk (gbdt.py:582-588).

Both learners also serve the user API's later steps: rollback of the last
iteration (``rollback_one_iter``: on the partitioned trainer, K = 1
subtracts the last tree's positional delta through score_add, K > 1
rewrites the score band from the rolled-back scores), the hooks DART
(boosting/dart.py) drops trees through (``get_training_score``,
``_add_tree_to_train_scores``), and leaf-index and early-stopped
prediction.
"""

from __future__ import annotations

import time
import warnings
from types import SimpleNamespace
from typing import List

import numpy as np
import torch

from ..model.ensemble import stack_trees
from ..model.tree import Tree
from ..obs import fence, tracer
from ..obs.audit import audit
from ..obs.trace import total_compiles
from ..ops.grow import GrowParams, grow_tree
from ..ops.histogram import pack_bin_words
from ..ops.predict import (TreeArrays, predict_binned, predict_leaf, predict_raw,
                           predict_words, words_column)
from ..ops.qhist import local_absmax, max_rows_for, quantize_rows, scales_from_max
from ..ops.qpredict import QTrees, qpredict_scores, quant_predict_enabled, quantize_tree_arrays
from ..ops.split import FeatureMeta, SplitHyper
from ..tree.linear import (build_value_lut, leaf_path_features, linear_fit_stats,
                           linear_leaf_scores, pack_path_features, solve_linear_leaves)
from ..tree.strategy import TreeStrategy
from ..utils.log import Log
from ..utils.profiling import timetag
from ..utils.random import Random
from .pred_early_stop import (create_prediction_early_stop_instance, early_stop_type,
                              predict_with_early_stop, tree_outputs)


def _read_only_tensor(a: np.ndarray) -> torch.Tensor:
    """``torch.from_numpy`` of a host array that is only read (a binary
    cache's bins are a read-only memmap), without PyTorch's warning about
    arrays that are not writable."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return torch.from_numpy(a)


PARALLEL_LEARNERS = ("data", "feature", "voting")


def unsupported_feature(config):
    """The first configured feature neither of the port's tree learners
    runs yet, or None.  (What only the partitioned trainer declines goes
    to the mask grower: ptrainer.eligible.)"""
    if config.boosting_type.lower() not in ("gbdt", "goss", "dart"):
        return f"boosting={config.boosting_type}"
    return None


def _allgather_ints(values):
    """Each process's int64 ``values``, (P, len) in process order, over
    the store collectives (parallel/collect.py)."""
    from ..parallel import collect

    blobs = collect.allgather_bytes(np.asarray(values, np.int64).tobytes())
    return np.stack([np.frombuffer(b, np.int64) for b in blobs])


class GBDT:
    """The gradient-boosting loop (class GBDT, gbdt.h:24-258)."""

    supports_partitioned = True  # False in DART, whose drops run between iterations
    # out-of-core streaming (boosting/ooc.py) replays the mask grower's
    # split loop; DART opts out: its drops re-score dropped trees over the
    # whole matrix every iteration, which would multiply the passes
    supports_ooc = True

    def __init__(self, device="cpu"):
        self.device = torch.device(device)
        self.models: List[Tree] = []
        self.iter = 0
        self.num_init_iteration = 0
        self.num_init_trees = 0  # the leading trees of an initial model (continued training)
        self.boost_from_average_ = False
        self.train_set = None
        self.objective = None
        self.config = None
        self.max_feature_idx = 0
        self.label_idx = 0
        self.num_class = 1
        self.num_tree_per_iteration = 1
        self.feature_names: List[str] = []
        self.ptrainer = None
        self.learner = None  # the host-driven parallel learner (several processes)
        self.nproc = 1
        self.bins = None  # (N, F) bins on the device, which that learner reads
        self.words = None  # the mask grower's packed bin words (_init_mask_grower)
        self.ooc = None  # the out-of-core learner, which streams the words instead
        self.training_metrics = []
        self.valid_sets = []  # the BinnedDataset of each validation set
        self.valid_bins = []  # (N_i, F) bins of each validation set, on the device
        self.valid_scores = []  # (K, N_i) float32 scores of each validation set
        self.valid_metrics = []
        self.valid_names = []
        self.best_iter = []
        self.best_score = []
        self.best_msg = []
        self.strategy = TreeStrategy()
        self._value_lut = None  # (F, B) bin values of the linear fits, built at first use
        self._linear_k = None  # the fits' pinned coefficient width

    # ------------------------------------------------------------------
    def init(self, config, train_set, objective, training_metrics=()):
        """GBDT::Init + ResetTrainingData: the partitioned trainer where
        its ``eligible`` takes the configuration, else the mask grower."""
        from .ptrainer import PartitionedTrainer, eligible

        tracer.refresh_from_env()  # LIGHTGBM_TPU_TRACE may be set per run
        audit.refresh_from_env()  # LIGHTGBM_TPU_AUDIT, the split-decision trail
        # with a custom objective (objective=None) the class count comes
        # from config.num_class (gbdt.cpp ResetTrainingData: num_class_)
        num_tree = objective.num_tree_per_iteration if objective is not None else max(
            config.num_class, 1)
        if config.tree_learner.lower() in PARALLEL_LEARNERS:
            # the multi-process bootstrap comes before any device use
            from ..parallel import distributed

            distributed.ensure_initialized(config)
            self.nproc = distributed.process_count()
        why = unsupported_feature(config)
        if why:
            raise NotImplementedError(f"lightgbm_tpu_torch does not support {why} yet")
        self.config = config
        self.train_set = train_set
        self.objective = objective
        self.num_data = train_set.num_data
        self.num_class = config.num_class
        self.num_tree_per_iteration = num_tree
        self.max_feature_idx = train_set.num_total_features - 1
        self.label_idx = getattr(train_set, "label_idx", 0)
        self.feature_names = train_set.feature_names
        self.training_metrics = list(training_metrics)
        self.shrinkage_rate = config.learning_rate
        if objective is not None:
            md = train_set.metadata
            if md.query_boundaries is not None and self.nproc > 1:
                # every shard pads its queries to the global largest group
                # (gbdt.py:133-154), so the lambda matrices' shapes do not
                # depend on the world
                gs = np.diff(np.asarray(md.query_boundaries, np.int64))
                local_s = int(gs.max()) if len(gs) else 1
                md.pad_group_size = int(_allgather_ints([local_s]).max())
            objective.init(train_set.metadata, self.num_data)
        self.has_init_score = train_set.metadata.init_score is not None
        self.meta = FeatureMeta.from_dataset(train_set, device=self.device)
        self.hyper = SplitHyper.from_config(config)
        n_rows = self.num_data
        if config.quantized_training and self.nproc > 1:
            # the data-parallel merge sums every rank's rows into a bin
            n_rows = int(_allgather_ints([self.num_data]).sum())
        if config.quantized_training and n_rows > max_rows_for(config.quantized_grad_bits):
            # int32 accumulators sum up to n * QMAX (gbdt.py:195-228)
            Log.warning("quantized_training disabled: %d rows exceed the int32 "
                        "histogram-accumulator headroom (%d rows at quantized_grad_bits=%d); "
                        "training on f32 gradients", n_rows,
                        max_rows_for(config.quantized_grad_bits), config.quantized_grad_bits)
            config.quantized_training = False
        # after the headroom check, so the strategy sees its decline
        self.strategy = TreeStrategy.from_config(config, train_set)
        # the mask grower's random streams (gbdt.py init: the bagging
        # RandomState, the feature_fraction LCG), made here so that a
        # checkpoint carries them whichever learner runs
        self.bag_rng = np.random.RandomState(config.bagging_seed)
        self.feature_rng = Random(config.feature_fraction_seed)
        ooc_rows = self._resolve_out_of_core(config, train_set)
        host_mode = self._route_tree_learner(config, ooc_rows)
        if host_mode:
            declined = f"tree_learner={host_mode} over {self.nproc} processes"
        elif ooc_rows:
            declined = "out-of-core training"
        elif self.supports_partitioned:
            declined = eligible(config, train_set, objective, num_tree)
        else:
            declined = f"boosting={config.boosting_type}"
        init = (np.asarray(train_set.metadata.init_score, np.float32).reshape(num_tree, -1)
                if self.has_init_score else None)  # (K, N) or the class-major K*N layout
        if declined is None:
            self.ptrainer = PartitionedTrainer(train_set, config, objective, self.meta,
                                               self.hyper, self.device)
            for k in range(num_tree if init is not None else 0):
                self.ptrainer.add_score(init[k], k)
            self.scores = self.ptrainer._scores()
            Log.info("Using partitioned tree learner on %s", self.device)
        else:
            self._init_mask_grower(init, ooc_rows=ooc_rows, keep_bins=bool(host_mode))
            if host_mode:
                from ..parallel import HostParallelLearner, NetComm
                from ..parallel.comm import thread_comm

                self.learner = HostParallelLearner(
                    host_mode, thread_comm() or NetComm(), self.grow_params, top_k=config.top_k,
                    quantized=config.quantized_training,
                    quant_bits=config.quantized_grad_bits, quant_seed=config.seed)
                Log.info("Using host-driven %s-parallel learner over %d processes on %s",
                         host_mode, self.nproc, self.device)
            else:
                Log.info("Using the mask-based tree learner on %s (the partitioned one "
                         "declines %s)", self.device, declined)

    def _route_tree_learner(self, config, ooc_rows: int) -> str:
        """The tree-learner dispatch, in the JAX package's branch order
        (gbdt.py:259-380): an elastic fleet (no membership runtime exists,
        so the knob is ignored, gbdt.py:121-126), then out of core, then
        the parallel learners.  Over several processes every parallel
        mode is the host-driven learner over ``NetComm`` (the JAX rule for
        a backend without multi-process computations); its mode is
        returned.  In one process ``tree_learner=data`` out of core
        streams serially and the parallel learners fall back to serial:
        "" is returned and the serial learners take the run exactly as at
        ``tree_learner=serial``.  Every rank takes the same branch."""
        if config.elastic_membership:
            Log.warning("elastic_membership=true ignored: no adopted MembershipRuntime "
                        "(lightgbm_tpu_torch has no membership runtime yet: queue A2c)")
        learner = config.tree_learner.lower()
        if ooc_rows:
            if learner == "data" and self.nproc > 1:
                raise NotImplementedError(
                    f"lightgbm_tpu_torch does not support tree_learner=data with out-of-core "
                    f"streaming over {self.nproc} processes yet (queue A2c: "
                    "boosting/oocdist.py)")
            if learner == "data":
                Log.warning("tree_learner=data requested with out-of-core streaming but only "
                            "one process is attached; streaming serially")
        elif learner in PARALLEL_LEARNERS:
            if self.nproc > 1:
                return learner
            Log.warning("tree_learner=%s requested but only one device is visible; falling "
                        "back to serial", learner)
        return ""

    def _resolve_out_of_core(self, config, train_set) -> int:
        """The out-of-core chunk rows, or 0 to train in memory (JAX
        gbdt.py:167-199): only the serial mask grower streams; a tree
        learner or boosting type that cannot is refused when streaming is
        forced and trains in memory under ``auto``."""
        from .ooc import resolve_out_of_core

        on, chunk_rows, why = resolve_out_of_core(config, train_set, self.device)
        unsupported = None
        if config.tree_learner.lower() not in ("serial", "data"):
            unsupported = (f"tree_learner={config.tree_learner} (streaming supports serial, "
                           "or data with per-rank shards)")
        elif not self.supports_ooc:
            unsupported = f"boosting type {type(self).__name__}"
        if on and unsupported:
            if "forced" in why:
                Log.fatal("out_of_core=true is not supported with %s (out-of-core training "
                          "replays the mask grower's split loop)", unsupported)
            Log.warning("out-of-core auto-routing (%s) skipped: not supported with %s; "
                        "training in-memory", why, unsupported)
            return 0
        if on:
            Log.info("Out-of-core routing: %s", why)
        return chunk_rows if on else 0

    def _init_mask_grower(self, init, scores=None, ooc_rows: int = 0,
                          keep_bins: bool = False) -> None:
        """The mask grower's device state: the packed bin words (or, with
        ``ooc_rows``, the out-of-core learner that streams them in chunks of
        that many rows), labels, weights, (K, N) scores (``scores``, or
        zeros plus ``init``) and the row select.  ``keep_bins`` keeps the
        (N, F) bins on the device too, which the host-driven parallel
        learner packs a tree at a time."""
        ts, cfg, dev = self.train_set, self.config, self.device
        binned = np.asarray(ts.binned)
        bits = 8 if binned.dtype == np.uint8 else 16
        if not ooc_rows:
            bins = _read_only_tensor(binned if bits == 8 else binned.astype(np.int32)).to(dev)
            self.words = pack_bin_words(bins, 32 // bits, bits)
            self.bins = bins if keep_bins else None
            del bins
        self.grow_params = GrowParams(
            num_leaves=int(cfg.num_leaves), num_bins=int(ts.max_num_bin),
            max_depth=int(cfg.max_depth), use_missing=bool(cfg.use_missing),
            has_categorical=bool(self.meta.is_categorical.any()), bits=bits,
            monotone=self.strategy.split_gain.monotone)
        if ooc_rows:
            from .ooc import OocTrainer

            self.ooc = OocTrainer(ts, cfg, self.grow_params, ooc_rows, dev)
        md = ts.metadata
        self.label_t = torch.from_numpy(np.asarray(md.label, np.float32)).to(dev)
        self.weight_t = (None if md.weights is None else
                         torch.from_numpy(np.asarray(md.weights, np.float32)).to(dev))
        if scores is not None:
            self.scores = scores
        else:
            self.scores = torch.zeros((self.num_tree_per_iteration, self.num_data),
                                      dtype=torch.float32, device=dev)
            if init is not None:
                self.scores += torch.from_numpy(init).to(dev)
        self.select = torch.ones(self.num_data, dtype=torch.float32, device=dev)
        self.is_bagging = cfg.bagging_fraction < 1.0 and cfg.bagging_freq > 0
        self.full_feature_mask = torch.ones(ts.num_features, dtype=torch.float32, device=dev)
        self.iter_seconds = []  # wall time of each iteration (device-synced)
        self.searches = {}  # the grower's captured split searches (CUDA graphs)

    def add_valid(self, valid_set, valid_metrics, name: str, init_scores=None):
        """GBDT::AddValidDataset (gbdt.cpp:220-250): the set's (unbundled)
        bins go to the device, its scores start from its init score (plus
        ``init_scores``, an initial model's (K, N) raw predictions of its
        rows) and replay the trees this booster trained.  An initial
        model's trees, read from model text, carry no bin thresholds, so
        they enter only through ``init_scores``."""
        vb = _read_only_tensor(np.ascontiguousarray(valid_set.binned)).to(self.device)
        k = self.num_tree_per_iteration
        vs = torch.zeros((k, valid_set.num_data), dtype=torch.float32, device=self.device)
        init_score = valid_set.metadata.init_score
        if init_score is not None:
            vs += torch.from_numpy(np.asarray(init_score, np.float32).reshape(k, -1)).to(
                self.device)
        if init_scores is not None:
            vs += torch.from_numpy(np.asarray(init_scores, np.float32)).to(self.device)
        trained = self.models[self.num_init_trees:]
        if trained:
            for kk in range(k):
                arrays = stack_trees(trained[kk::k])
                vs[kk] += predict_binned(vb, arrays, self._lut_of(arrays))
        self.valid_sets.append(valid_set)
        self.valid_bins.append(vb)
        self.valid_scores.append(vs)
        self.valid_metrics.append(list(valid_metrics))
        self.valid_names.append(name)
        self.best_iter.append([0] * len(valid_metrics))
        self.best_score.append([-np.inf] * len(valid_metrics))
        self.best_msg.append([""] * len(valid_metrics))

    def add_init_scores(self, init: np.ndarray) -> None:
        """scores += the (K, N) float32 ``init`` (continued training's
        scores of the initial model), before the first iteration: the
        partitioned trainer takes them through score_add while its matrix
        is still in original row order."""
        if self.ptrainer is None:
            self.scores += torch.from_numpy(np.ascontiguousarray(init, np.float32)).to(
                self.device)
            return
        for k in range(self.num_tree_per_iteration):
            self.ptrainer.add_score(init[k], k)
        self.scores = self.ptrainer._scores()

    def refresh_config(self) -> None:
        """Re-derive the config-dependent state after a parameter reset
        (callback.reset_parameter; the reference's ResetConfig)."""
        self.hyper = SplitHyper.from_config(self.config)
        if self.ptrainer is not None:
            self.ptrainer.hyper = self.hyper
            self.ptrainer.config = self.config
        self.shrinkage_rate = self.config.learning_rate

    # ------------------------------------------------------------------
    # checkpoints (ckpt/state.py; gbdt.py:1628-1700)
    def export_train_state(self):
        """Everything the next iteration reads beyond the config, the
        dataset and the trees: the (K, N) training scores and each
        validation set's, the row select, the bagging and feature_fraction
        streams, the early-stopping bests.  Returns (numpy arrays, a
        JSON-serializable dict), under the JAX package's names; the
        card's tensors are copied to the host here.  The partitioned
        trainer adds its row permutation, which only the JAX package's
        trainer reads; its own select is ones (its bagging draws are
        keyed by the iteration)."""
        K = self.num_tree_per_iteration
        mask = self._mask_grower_ready()
        arrays = {
            "scores": self.scores.cpu().numpy().astype(np.float32, copy=True),
            "select": (self.select.cpu().numpy().astype(np.float32, copy=True) if mask
                       else np.ones(self.num_data, np.float32)),
        }
        for i, vs in enumerate(self.valid_scores):
            arrays[f"valid_scores_{i}"] = vs.cpu().numpy().astype(np.float32, copy=True)
        st = self.bag_rng.get_state()
        arrays["bag_rng_keys"] = np.asarray(st[1], np.uint32)
        py = {
            "iter": int(self.iter),
            "num_init_iteration": int(self.num_init_iteration),
            "num_init_trees": int(self.num_init_trees),
            "boost_from_average": bool(self.boost_from_average_),
            "shrinkage_rate": float(self.shrinkage_rate),
            "bag_rng": [str(st[0]), int(st[2]), int(st[3]), float(st[4])],
            "feature_rng": self.feature_rng.get_state(),
            "need_re_bagging": False,
            "best_iter": [list(b) for b in self.best_iter],
            "best_score": [list(b) for b in self.best_score],
            "best_msg": [list(b) for b in self.best_msg],
            "class_need_train": [True] * K,
            "class_default_output": [0.0] * K,
            "mask_grower": mask,
        }
        if self.ptrainer is not None:
            arrays["pt_rowid"] = self.ptrainer.export_perm()
        return arrays, py

    def import_train_state(self, arrays, py) -> None:
        """The inverse of :meth:`export_train_state`, into a booster built
        with the same config and data (``self.models`` is restored first,
        by ckpt/state.py).  Tensors go to this booster's device.  On the
        partitioned trainer the band's score channels are zeroed and
        marked dirty: the next chunk writes the restored scores into them
        exactly (sync_scores_from: 0 + target)."""
        dev = self.device
        self.iter = int(py["iter"])
        self.num_init_iteration = int(py["num_init_iteration"])
        self.num_init_trees = int(py.get("num_init_trees", self.num_init_iteration
                                         * self.num_tree_per_iteration))
        self.boost_from_average_ = bool(py["boost_from_average"])
        self.shrinkage_rate = float(py["shrinkage_rate"])
        self.scores = torch.from_numpy(np.array(arrays["scores"], np.float32)).to(dev)
        if py.get("mask_grower") and not self._mask_grower_ready():
            # a partitioned booster that had turned to the mask grower
            # (update with a custom objective)
            self._init_mask_grower(None, scores=self.scores)
        if self._mask_grower_ready():
            self.select = torch.from_numpy(np.array(arrays["select"], np.float32)).to(dev)
        for i in range(len(self.valid_scores)):
            self.valid_scores[i] = torch.from_numpy(
                np.array(arrays[f"valid_scores_{i}"], np.float32)).to(dev)
        name, pos, has_gauss, cached = py["bag_rng"]
        self.bag_rng.set_state((str(name), np.asarray(arrays["bag_rng_keys"], np.uint32),
                                int(pos), int(has_gauss), float(cached)))
        self.feature_rng.set_state(py["feature_rng"])
        self.best_iter = [list(map(int, b)) for b in py["best_iter"]]
        self.best_score = [list(map(float, b)) for b in py["best_score"]]
        self.best_msg = [list(map(str, b)) for b in py["best_msg"]]
        if self.learner is not None:
            # the learner keys its quantized rounding by the trees grown
            # (one a class an iteration, empty ones included): re-anchored
            # so that a resumed run rounds as one that never stopped
            self.learner._qiter = self.iter * self.num_tree_per_iteration - 1
        if self.ptrainer is not None:
            self.ptrainer.import_perm(arrays.get("pt_rowid"))

    def _mask_grower_ready(self) -> bool:
        """The mask grower's state exists (resident words or the
        out-of-core learner)."""
        return self.words is not None or self.ooc is not None

    # ------------------------------------------------------------------
    def _boost_from_average(self):
        """gbdt.cpp:381-399 + LabelAverage (:349-379)."""
        if (not self.models and self.config.boost_from_average and not self.has_init_score
                and self.num_class <= 1 and self.objective is not None
                and self.objective.boost_from_average):
            label = np.asarray(self.train_set.metadata.label)
            if self.nproc > 1:
                # the global label average (GBDT::LabelAverage's Allreduce,
                # gbdt.cpp:349-379; JAX gbdt.py:494-503): every rank boosts
                # from the mean over all rows
                from ..parallel import collect

                sums = np.stack([np.frombuffer(b, np.float64) for b in collect.allgather_bytes(
                    np.asarray([label.sum(), float(len(label))], np.float64).tobytes())])
                init_score = float(sums[:, 0].sum() / max(sums[:, 1].sum(), 1.0))
            else:
                init_score = float(np.mean(label))
            if self.ptrainer is not None:
                self.ptrainer.add_score(np.float32(init_score))
                self.scores = self.ptrainer._scores()
            else:
                self.scores += float(np.float32(init_score))
            self.valid_scores = [vs + np.float32(init_score) for vs in self.valid_scores]
            self.models.append(Tree.constant(init_score))
            self.boost_from_average_ = True
            Log.info("Start training from score %f", init_score)

    def train_iters(self, num_iters: int, is_eval: bool = False) -> bool:
        """Run ``num_iters`` boosting iterations on the configured learner.
        Returns True when training should stop: no tree found a split, or
        (with ``is_eval``) the config's ``early_stopping_round`` fired.
        ``engine.train`` evaluates through its callbacks instead;
        ``is_eval`` is the reference CLI's loop (application.cpp), which
        the port does not have yet."""
        if self.ptrainer is not None:
            return self.train_iters_partitioned(num_iters, is_eval)
        for _ in range(max(num_iters, 0)):
            if self._train_one_iter_mask():
                return True
            if is_eval and self.eval_and_check_early_stopping():
                return True
        return False

    def train_iters_partitioned(self, num_iters: int, is_eval: bool = False) -> bool:
        """``train_iters`` on the partitioned trainer: one chunk of
        iterations."""
        if num_iters <= 0:
            return False
        self._boost_from_average()
        K, pt = self.num_tree_per_iteration, self.ptrainer
        if pt.score_dirty:
            pt.sync_scores_from(self.scores)
        n_sec, c0 = len(pt.iter_seconds), total_compiles()
        with timetag.phase("tree"):
            trees, self.scores, n_done = pt.train_chunk(num_iters, self.shrinkage_rate,
                                                        self.iter)
        if tracer.enabled:
            # each iteration's record from the CUDA-event seconds that the
            # chunk's one read carried: tracing adds no sync to the chunk
            # (the chunk's graph captures count on its first iteration)
            for t, secs in enumerate(pt.iter_seconds[n_sec:n_sec + n_done]):
                leaves = sum(r.num_splits + (r.num_splits > 0) for r in trees[t])
                tracer.emit_iter(self.iter + t, secs, {"fused_chunk": secs},
                                 compiles=total_compiles() - c0 if t == 0 else 0,
                                 leaves=int(leaves), trees=K, mode="fused")
        chunk_trees = [[] for _ in range(K)]
        for t, iter_trees in enumerate(trees):
            for k, res in enumerate(iter_trees):
                if res.num_splits > 0:
                    tree = Tree.from_grow_result(res, self.train_set)
                    tree.shrinkage(self.shrinkage_rate)
                    audit.record_tree(self.iter + t, k, res, tree)
                    chunk_trees[k].append(tree)
                else:
                    tree = Tree(2)  # a class with no split: an empty tree keeps alignment
                self.models.append(tree)
        # the validation scores advance once per chunk and class, by one
        # traversal of the chunk's stacked trees
        with timetag.phase("valid_score"):
            for k in range(K):
                self._add_to_valid_scores(chunk_trees[k], k)
        self.iter += n_done
        if n_done < num_iters:
            Log.warning("Stopped training because there are no more leaves that meet "
                        "the split requirements.")
            return True
        if is_eval:
            return self.eval_and_check_early_stopping()
        return False

    def _add_to_valid_scores(self, trees: List[Tree], k: int) -> None:
        """Class k's validation scores += the trees' outputs (one
        traversal of the stacked trees per set)."""
        if trees and self.valid_bins:
            arrays = stack_trees(trees)
            for vb, vs in zip(self.valid_bins, self.valid_scores):
                vs[k] += predict_binned(vb, arrays, self._lut_of(arrays))

    def _add_tree_to_train_scores(self, tree: Tree, k: int) -> None:
        """Class k's training scores += the tree's outputs, by a traversal
        of the training set's bins (rollback and DART, where the grower's
        partition no longer matches the tree; gbdt.py:874-891).  The mask
        grower walks its packed bin words; the partitioned trainer, whose
        matrix holds bundles in the last tree's row order, walks the host
        bins in row chunks copied to the device."""
        arrays = stack_trees([tree])
        lut = self._lut_of(arrays)
        if self.ooc is not None:
            # out of core: the walk is per row, so streaming it is exact
            self.ooc.add_tree_scores(self.scores[k], arrays, lut)
            return
        if self.ptrainer is None:
            bits = self.grow_params.bits
            self.scores[k] += predict_words(self.words, 32 // bits, bits, arrays, lut)
            return
        binned = self.train_set.binned
        step = 1 << 22
        for lo in range(0, self.num_data, step):
            part = binned[lo:lo + step]
            part = torch.from_numpy(part if part.dtype == np.uint8 else part.astype(np.int32))
            self.scores[k, lo:lo + step] += predict_binned(part.to(self.device), arrays, lut)

    def rollback_one_iter(self) -> None:
        """GBDT::RollbackOneIter (gbdt.cpp:497-514; gbdt.py:1013-1035): the
        last iteration's trees leave the model, the training and every
        validation set's scores.  On the partitioned trainer with K = 1
        the band loses the last tree's positional delta (score_add) while
        the matrix still holds that tree's row order; otherwise the
        trees are walked over the training bins and the band is rewritten
        from those scores before the next chunk."""
        if self.iter <= 0:
            return
        K = self.num_tree_per_iteration
        last = self.models[-K:]
        for tree in last:
            tree.shrinkage(-1.0)
        pt = self.ptrainer
        if pt is not None and pt.rollback_last():
            self.scores = pt._scores()
        else:
            for k, tree in enumerate(last):
                self._add_tree_to_train_scores(tree, k)
            if pt is not None:
                pt.score_dirty = True
        for k, tree in enumerate(last):
            self._add_to_valid_scores([tree], k)
        del self.models[-K:]
        self.iter -= 1

    def train_one_iter_custom(self, gradients, hessians) -> bool:
        """One iteration on the mask grower from gradients and hessians
        given by the caller (a custom objective, ``fobj``), (N,) or the
        class-major (K*N,) of K trees; True when no tree found a split
        (GBDT::TrainOneIter with gradients, gbdt.py:554-603).  On a
        booster the partitioned trainer started, the scores come from the
        band unless the band lags them, the mask grower's state is built
        at the first such iteration, and the band is marked to be
        rewritten from the scores (B5 per class) before the next chunk."""
        pt = self.ptrainer
        if pt is not None:
            if not pt.score_dirty:
                self.scores = pt._scores()
            if self.words is None:
                self._init_mask_grower(None, scores=self.scores)
        shape = (self.num_tree_per_iteration, self.num_data)
        grad = torch.from_numpy(np.asarray(gradients, np.float32).reshape(shape))
        hess = torch.from_numpy(np.asarray(hessians, np.float32).reshape(shape))
        stop = self._train_one_iter_mask(grad.to(self.device), hess.to(self.device))
        if pt is not None:
            pt.score_dirty = True
            pt._last_delta = None
        return stop

    # ------------------------------------------------------------------
    # the mask grower's iteration (gbdt.py:582-741, the serial branch)
    def _train_one_iter_mask(self, grad=None, hess=None) -> bool:
        """One boosting iteration on the mask grower, on the objective's
        gradients or the (K, N) ``grad`` and ``hess`` given; True when no
        class found a split (its empty trees are then dropped).  With
        tracing on, the iteration is a trace record whose phases are the
        JAX package's (gbdt.py:616-690), each fenced on the card."""
        t0 = time.perf_counter()
        self._boost_from_average()
        K, L = self.num_tree_per_iteration, self.grow_params.num_leaves
        grown = False
        leaves_grown = 0
        comm = getattr(self.learner, "comm", None)
        bytes_before = comm.ledger_total() if comm is not None else 0
        # the host-driven learner quantizes itself, from the global maxima
        quantize = self.config.quantized_training and self.learner is None
        with tracer.iteration(self.iter) as irec:
            with timetag.phase("boosting"):
                if grad is None:
                    grad, hess = self._get_gradients()
                fence((grad, hess))
            with timetag.phase("bagging"):
                grad, hess = self._adjust_gradients(grad, hess)
                self._bagging(self.iter)
                fence(self.select)
            for k in range(K):
                feature_mask = self._feature_mask()
                with timetag.phase("tree"):
                    gk, hk, qscale = grad[k], hess[k], None
                    if quantize:
                        gk, hk, qscale = self._quantize_class(gk, hk, k)
                    if self.learner is not None:
                        gr = self.learner.grow(self.bins, gk, hk, self.select, feature_mask,
                                               self.meta, self.hyper)
                    elif self.ooc is not None:
                        gr = self.ooc.grow(gk, hk, self.select, feature_mask, self.meta,
                                           self.hyper, qscale=qscale, searches=self.searches)
                    else:
                        gr = grow_tree(self.words, gk, hk, self.select, feature_mask,
                                       self.meta, self.hyper, self.grow_params, qscale=qscale,
                                       searches=self.searches)
                    fence(gr.leaf_id)
                if gr.num_splits > 0:
                    grown = True
                    leaves_grown += gr.num_splits + 1
                    tree = Tree.from_grow_result(gr, self.train_set)
                    if self.strategy.leaf_fit.linear:
                        # fitted before shrinkage, which then scales the
                        # coefficients and the intercept together
                        self._fit_linear_tree(tree, gr, gk, hk)
                    tree.shrinkage(self.shrinkage_rate)
                    audit.record_tree(self.iter, k, gr, tree)
                    if self.strategy.split_gain.constrained and tracer.enabled:
                        # splits on constrained features took the clipped
                        # gain path of ops/split.py
                        mono = self.strategy.split_gain.monotone
                        tracer.counter("tree.monotone_clip", float(sum(
                            1 for f in gr.rec_feat[:gr.num_splits] if mono[int(f)] != 0)))
                    with timetag.phase("train_score"):
                        if tree.is_linear and tree.leaf_is_linear[:tree.num_leaves].any():
                            self._add_linear_train_scores(tree, gr, k)
                        else:
                            # scores[k] += leaf value of each row's leaf (ops/predict.py
                            # add_leaf_outputs: the grower's leaf_id is the partition)
                            lv = np.zeros(L, np.float32)
                            lv[:tree.num_leaves] = tree.leaf_value[:tree.num_leaves]
                            self.scores[k] += torch.from_numpy(lv).to(self.device)[
                                gr.leaf_id.long()]
                        fence(self.scores)
                    with timetag.phase("valid_score"):
                        self._add_to_valid_scores([tree], k)
                        fence(self.valid_scores)
                else:
                    tree = Tree(2)  # an empty tree keeps the classes aligned
                self.models.append(tree)
            if irec is not None:
                irec["leaves"] = leaves_grown
                irec["trees"] = K
                if self.is_bagging:
                    irec["bagged_rows"] = int(self.select.sum())
                if comm is not None:
                    irec["net_bytes"] = comm.ledger_total() - bytes_before
        if not grown:
            Log.warning("Stopped training because there are no more leaves that meet "
                        "the split requirements.")
            del self.models[len(self.models) - K:]
            return True
        self.iter += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.iter_seconds.append(time.perf_counter() - t0)
        return False

    # ------------------------------------------------------------------
    # linear leaves (tree/linear.py; gbdt.py:893-1011)
    def _linear_lut(self) -> torch.Tensor:
        """The (F, B) float32 bin-value table on the device that every
        linear fit and binned walk reads, built at first use."""
        if self._value_lut is None:
            lut = build_value_lut(self.train_set, int(self.train_set.max_num_bin))
            self._value_lut = torch.from_numpy(lut).to(self.device)
        return self._value_lut

    def _lut_of(self, arrays: dict):
        """The value table when the stacked ``arrays`` carry linear
        planes, else None."""
        return self._linear_lut() if "leaf_feat_inner" in arrays else None

    def _linear_kmax(self) -> int:
        """The coefficient width every fit pads to: min(num_leaves - 1,
        numerical features, max_depth when set), at least 1."""
        if self._linear_k is None:
            k = min(self.grow_params.num_leaves - 1,
                    int((~self.meta.is_categorical).sum()))
            if self.config.max_depth > 0:
                k = min(k, self.config.max_depth)
            self._linear_k = max(k, 1)
        return self._linear_k

    def _fit_linear_tree(self, tree: Tree, gr, gk, hk) -> None:
        """Per-leaf ridge models of a freshly grown tree, before shrinkage:
        the normal equations over the selected rows on the device, the
        batched solve on the host (one read; card and CPU then solve the
        same float32 matrices alike), the models set on ``tree``."""
        with tracer.span("tree.leaf_fit", leaves=tree.num_leaves):
            self._fit_linear_leaves(tree, gr, gk, hk)

    def _fit_linear_leaves(self, tree: Tree, gr, gk, hk) -> None:
        L = self.grow_params.num_leaves
        is_cat = self.meta.is_categorical.cpu().numpy()
        paths = leaf_path_features(gr, is_cat)
        fi, fv = pack_path_features(paths, L, k_max=self._linear_kmax())
        bits = self.grow_params.bits
        if self.ooc is not None:
            a, b = self.ooc.folder.fold_linear_stats(gk, hk, self.select, gr.leaf_id, fi, fv,
                                                     self._linear_lut(), L)
        else:
            a, b = linear_fit_stats(words_column(self.words, 32 // bits, bits), gk, hk,
                                    self.select, gr.leaf_id, fi, fv, self._linear_lut(), L)
        w, ok = solve_linear_leaves(a.cpu(), b.cpu(), fv, gr.leaf_cnt,
                                    self.strategy.leaf_fit.linear_lambda,
                                    self.hyper.lambda_l2)
        w = w.numpy()
        tree.set_linear_models(paths, w[:, 1:], w[:, 0], ok.numpy(), self.train_set)

    def _add_linear_train_scores(self, tree: Tree, gr, k: int) -> None:
        """scores[k] += a (shrunk) linear tree's outputs at the rows of the
        grower's partition: linear leaves their model at the bins'
        values, the others their constant."""
        arrays = stack_trees([tree])
        dev = self.device
        planes = [torch.from_numpy(np.asarray(arrays[f][0])).to(dev) for f in
                  ("leaf_feat_inner", "leaf_feat_valid", "leaf_coeff", "leaf_const",
                   "leaf_value", "leaf_is_linear")]
        planes[0] = planes[0].to(torch.int64)
        if self.ooc is not None:
            self.ooc.folder.fold_linear_scores(self.scores[k], gr.leaf_id, *planes,
                                               self._linear_lut())
            return
        bits = self.grow_params.bits
        self.scores[k] += linear_leaf_scores(words_column(self.words, 32 // bits, bits),
                                             gr.leaf_id, *planes, self._linear_lut())

    def _get_gradients(self):
        """(K, N) gradients and hessians of the current scores
        (objective_->GetGradients, gbdt.cpp:692-700); an objective that is
        not row-local (lambdarank) takes the scores of every row at once
        (gbdt.py:540-547)."""
        score = self.get_training_score()
        if self.num_tree_per_iteration == 1:
            if self.objective.rowwise:
                g, h = self.objective.gradients_rowwise(score[0], self.label_t, self.weight_t)
            else:
                g, h = self.objective.get_gradients(score[0])
            return g[None], h[None]
        return self.objective.gradients_rowwise_all(score, self.label_t, self.weight_t)

    def get_training_score(self):
        """The (K, N) scores the gradients are taken at; DART drops its
        trees here first (GetTrainingScore, gbdt.py:549-551)."""
        return self.scores

    def _adjust_gradients(self, grad, hess):
        """Hook for GOSS's re-weighting (boosting/goss.py); identity here."""
        return grad, hess

    def _bagging(self, iter_: int) -> None:
        """Re-sample the 0/1 row select every bagging_freq iterations
        (GBDT::Bagging, gbdt.cpp:275-334; gbdt.py:517-525): a
        RandomState(bagging_seed) permutation's first rows."""
        if not self.is_bagging or iter_ % self.config.bagging_freq != 0:
            return
        bag_cnt = int(self.config.bagging_fraction * self.num_data)
        perm = self.bag_rng.permutation(self.num_data)
        mask = np.zeros(self.num_data, np.float32)
        mask[perm[:bag_cnt]] = 1.0
        self.select = torch.from_numpy(mask).to(self.device)

    def _feature_mask(self) -> torch.Tensor:
        """The (F,) feature_fraction mask of one tree
        (SerialTreeLearner::BeforeTrain, serial_tree_learner.cpp:236-262;
        gbdt.py:527-538), from the LCG of utils/random.py."""
        frac = self.config.feature_fraction
        f = self.train_set.num_features
        if frac >= 1.0:
            return self.full_feature_mask
        idx = self.feature_rng.sample(f, max(1, int(f * frac)))
        mask = np.zeros(f, np.float32)
        mask[idx] = 1.0
        return torch.from_numpy(mask).to(self.device)

    def _quantize_class(self, gk, hk, k: int):
        """Class k's (N,) grad/hess as int16 levels and their (2,) scales
        (gbdt.py:829-860): the scales from the abs-maxima over the
        selected rows, the rounding keyed by the seed, the iteration and
        the class."""
        bits = self.config.quantized_grad_bits
        mx = local_absmax(gk, hk, self.select).cpu().numpy()
        qscale = scales_from_max(mx[0], mx[1], bits)
        # keyed by the global iteration, which a checkpoint restores: the
        # JAX package's parallel learners key theirs by a tree counter
        # that import_train_state must re-anchor (_qiter); this needs none
        seed = (int(self.config.seed) * 2654435761 + self.iter * 97 + k * 131071
                + 1) & 0xFFFFFFFF
        gq, hq = quantize_rows(gk, hk, qscale, seed, bits)
        return gq, hq, qscale

    # ------------------------------------------------------------------
    def eval_and_check_early_stopping(self) -> bool:
        """EvalAndCheckEarlyStopping + OutputMetric (gbdt.cpp:516-622):
        with ``early_stopping_round`` set, drops the trees after the best
        iteration and returns True once no validation metric improved
        for that many iterations."""
        best_msg = self._output_metric(self.iter)
        if not best_msg:
            return False
        es_round = self.config.early_stopping_round
        Log.info("Early stopping at iteration %d, the best iteration round is %d", self.iter,
                 self.iter - es_round)
        Log.info("Output of best iteration round:\n%s", best_msg)
        del self.models[len(self.models) - es_round * self.num_tree_per_iteration:]
        return True

    def _eval_metric(self, m, score: torch.Tensor):
        """One metric on the device-resident (K, N) scores, given as (N,)
        when single-class; an error raises."""
        return m.eval(score[0] if score.shape[0] == 1 else score, self.objective)

    def _output_metric(self, iter_: int) -> str:
        """OutputMetric (gbdt.cpp:577-622): logs the training and
        validation metrics every ``output_freq`` iterations and keeps each
        validation metric's best score and iteration; returns the best
        iteration's message once one metric has not improved for
        ``early_stopping_round`` iterations, else ""."""
        es_round = self.config.early_stopping_round
        need_output = (iter_ % self.config.output_freq) == 0
        msg_parts = []
        ret = ""
        if need_output:
            for m in self.training_metrics:
                for name, val in self._eval_metric(m, self.scores):
                    line = f"Iteration:{iter_}, training {name} : {val:g}"
                    Log.info("%s", line)
                    if es_round > 0:
                        msg_parts.append(line)
        meet = []
        if need_output or es_round > 0:
            for i, metrics in enumerate(self.valid_metrics):
                for j, m in enumerate(metrics):
                    results = self._eval_metric(m, self.valid_scores[i])
                    for name, val in results:
                        line = f"Iteration:{iter_}, valid_{i + 1} {name} : {val:g}"
                        if need_output:
                            Log.info("%s", line)
                        if es_round > 0:
                            msg_parts.append(line)
                    if not ret and es_round > 0:
                        cur = (1.0 if m.bigger_is_better else -1.0) * results[-1][1]
                        if cur > self.best_score[i][j]:
                            self.best_score[i][j] = cur
                            self.best_iter[i][j] = iter_
                            meet.append((i, j))
                        elif iter_ - self.best_iter[i][j] >= es_round:
                            ret = self.best_msg[i][j]
        msg = "\n".join(msg_parts)
        for i, j in meet:
            self.best_msg[i][j] = msg
        return ret

    def train_score_host(self) -> np.ndarray:
        """The (K, N) raw training scores, float64 on the host."""
        return self.scores.double().cpu().numpy()

    def valid_score_host(self, i: int) -> np.ndarray:
        """The (K, N_i) raw scores of validation set ``i``, float64."""
        return self.valid_scores[i].double().cpu().numpy()

    def get_eval_at(self, data_idx: int):
        """GBDT::GetEvalAt: [(name, value, bigger_is_better), ...] of the
        training set (0) or validation set ``data_idx - 1``."""
        if data_idx == 0:
            score, metrics = self.scores, self.training_metrics
        else:
            score, metrics = self.valid_scores[data_idx - 1], self.valid_metrics[data_idx - 1]
        return [(name, val, m.bigger_is_better)
                for m in metrics for name, val in self._eval_metric(m, score)]

    # ------------------------------------------------------------------
    @property
    def num_trees(self) -> int:
        return len(self.models)

    def current_iteration(self) -> int:
        return self.iter + self.num_init_iteration

    def _used_models(self, num_iteration: int = -1):
        num_used = len(self.models)
        if num_iteration > 0:
            ni = num_iteration + (1 if self.boost_from_average_ else 0)
            num_used = min(ni * self.num_tree_per_iteration, num_used)
        return self.models[:num_used]

    def predict_raw_scores(self, data: np.ndarray, num_iteration: int = -1) -> np.ndarray:
        """(K, N) raw scores over raw (unbinned) features; class k sums the
        trees i with i % K == k."""
        models = self._used_models(num_iteration)
        k = self.num_tree_per_iteration
        if not models:
            return np.zeros((k, data.shape[0]))
        if quant_predict_enabled():
            if not any(getattr(t, "is_linear", False) for t in models):
                q, trees = self._quantized_trees(models, k)
                return qpredict_scores(data, q, trees, num_class=k)
            Log.warning("LIGHTGBM_TPU_QUANT_PREDICT=1 ignored: quantized serving does not "
                        "support linear-leaf models; serving exact")
        arrays = TreeArrays.from_stacked(stack_trees(models), self.device)
        return predict_raw(data, arrays, num_class=k)

    def _quantized_trees(self, models, k: int):
        """``LIGHTGBM_TPU_QUANT_PREDICT=1``: the int16 rank-quantized host
        record of ``models`` (ops/qpredict.py; routing exact, leaves
        float16, ``drift_bound`` bounds the output) and its node planes on
        the booster's device, cached per (len(models), k, linear) and the
        trees themselves."""
        key = (len(models), k, False)
        cached = getattr(self, "_qtrees", None)
        if (cached is None or cached[0] != key
                or any(a is not b for a, b in zip(cached[2], models))):
            q = quantize_tree_arrays(SimpleNamespace(**stack_trees(models)),
                                     num_features=int(self.max_feature_idx) + 1)
            cached = (key, (q, QTrees(q, self.device)), list(models))
            self._qtrees = cached
        return cached[1]

    def predict(self, data: np.ndarray, num_iteration: int = -1, raw_score: bool = False,
                pred_leaf: bool = False, config=None) -> np.ndarray:
        """(N,) or, for K > 1, (N, K) predictions; with ``pred_leaf`` the
        (N, T) int32 leaf of each row in each tree.  ``config`` (default:
        the booster's) carries the prediction early stop
        (gbdt.py:1845-1887)."""
        data = np.asarray(data, np.float64)
        config = config if config is not None else self.config
        models = self._used_models(num_iteration)
        if pred_leaf:
            if not models:
                return np.zeros((data.shape[0], 0), np.int32)
            arrays = TreeArrays.from_stacked(stack_trees(models), self.device)
            return predict_leaf(data, arrays).T.to(torch.int32).cpu().numpy()
        if config is not None and config.pred_early_stop and models:
            raw = self._predict_early_stop(data, models, config)
        else:
            raw = self.predict_raw_scores(data, num_iteration)
        if not raw_score and self.objective is not None:
            score = torch.as_tensor(raw, dtype=torch.float32, device=self.device)
            raw = self.objective.convert_output(score).double().cpu().numpy()
        return raw[0] if raw.shape[0] == 1 else raw.T

    def _predict_early_stop(self, data, models, config) -> np.ndarray:
        """(K, N) float64 raw scores with the margin exit
        (prediction_early_stop.cpp, application/predictor.hpp)."""
        K = self.num_tree_per_iteration
        inst = create_prediction_early_stop_instance(
            early_stop_type(K, self.objective), int(config.pred_early_stop_freq),
            float(config.pred_early_stop_margin))
        leaves = predict_leaf(data, TreeArrays.from_stacked(stack_trees(models), self.device))
        return predict_with_early_stop(tree_outputs(leaves, models, data), K,
                                       inst).cpu().numpy()

    def sub_model_name(self) -> str:
        return "tree"

    # ------------------------------------------------------------------
    def save_model_to_string(self, num_iteration: int = -1) -> str:
        """GBDT::SaveModelToString (gbdt.cpp:854-898) — the JAX package's
        text, byte for byte."""
        parts = [self.sub_model_name(), f"num_class={self.num_class}",
                 f"num_tree_per_iteration={self.num_tree_per_iteration}",
                 f"label_index={self.label_idx}", f"max_feature_idx={self.max_feature_idx}"]
        if self.objective is not None:
            parts.append(f"objective={self.objective.to_string()}")
        if self.boost_from_average_:
            parts.append("boost_from_average")
        parts.append("feature_names=" + " ".join(self.feature_names))
        if self.train_set is not None:
            parts.append("feature_infos=" + " ".join(self.train_set.feature_infos()))
        parts.append("")
        for i, tree in enumerate(self._used_models(num_iteration)):
            parts.append(f"Tree={i}")
            parts.append(tree.to_string())
        parts.append("")
        parts.append("feature importances:")
        for name, cnt in self.feature_importance_pairs():
            parts.append(f"{name}={cnt}")
        return "\n".join(parts) + "\n"

    def load_model_from_string(self, model_str: str) -> None:
        """GBDT::LoadModelFromString (gbdt.cpp:912-1008)."""
        self.models = []
        header, _, rest = model_str.partition("Tree=")
        kv = {}
        for line in header.splitlines():
            if "=" in line:
                k, _, v = line.partition("=")
                kv[k.strip()] = v.strip()
        for key in ("num_class", "label_index", "max_feature_idx"):
            if key not in kv:
                Log.fatal("Model file doesn't specify %s", key)
        self.num_class = int(kv["num_class"])
        self.num_tree_per_iteration = int(kv.get("num_tree_per_iteration", self.num_class))
        self.label_idx = int(kv["label_index"])
        self.max_feature_idx = int(kv["max_feature_idx"])
        self.boost_from_average_ = "boost_from_average" in header.splitlines()
        self.objective_name_loaded = kv.get("objective", "")
        self.feature_names = kv.get("feature_names", "").split()
        if rest:
            for blk in ("Tree=" + rest).split("Tree="):
                blk = blk.strip()
                if not blk or blk.startswith("feature importances"):
                    continue
                body = blk.partition("\n")[2].split("\nfeature importances:")[0]
                self.models.append(Tree.from_string(body))
        self.num_init_iteration = len(self.models) // max(self.num_tree_per_iteration, 1)
        self.iter = 0

    def feature_importance_pairs(self):
        """Split-count importance (GBDT::FeatureImportance), sorted
        descending, nonzero only."""
        imp = np.zeros(self.max_feature_idx + 1, np.int64)
        for tree in self.models:
            for s in range(tree.num_leaves - 1):
                if tree.split_gain[s] > 0:
                    imp[tree.split_feature[s]] += 1
        names = self.feature_names or [f"Column_{i}" for i in range(self.max_feature_idx + 1)]
        pairs = [(names[i], int(imp[i])) for i in range(len(imp)) if imp[i] > 0]
        pairs.sort(key=lambda p: -p[1])
        return pairs

    def feature_importance(self, importance_type: str = "split") -> np.ndarray:
        """(F,) float64 importance of every original feature over all the
        trees held: splits with a positive gain counted (``"split"``) or
        their gains summed (``"gain"``) (gbdt.py:1990-2000)."""
        imp = np.zeros(self.max_feature_idx + 1, np.float64)
        for tree in self.models:
            for s in range(tree.num_leaves - 1):
                if tree.split_gain[s] > 0:
                    imp[tree.split_feature[s]] += (tree.split_gain[s]
                                                   if importance_type == "gain" else 1)
        return imp
