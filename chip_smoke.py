#!/usr/bin/env python3
"""Smoke run of lightgbm_tpu_torch on one NVIDIA Hopper card.

    python3 chip_smoke.py                 # the full run (one card)
    python3 chip_smoke.py --rows 1000000 --iters 3 --small-rows 20000 \
        --repeat-iters 3                  # a shorter Higgs cell

Phases (any failure raises, and the script exits non-zero without a
result line):
  1. device: needs torch.cuda; prints the card's name and power limit;
  2. build: compiles the CUDA kernels from lightgbm_tpu_torch/csrc;
  3. kernels: calls each kernel's wrapper at its path's shapes and holds
     it against its plain PyTorch version on the same inputs; times the
     kernel (and the library call, where there is one) as the median of
     5 bursts of 10 launches between two CUDA events, and the plain
     version one call at a time; split_stream and score_add also print
     their single-call time.  Binary path: --rows x 28 features, 64 bins
     (update_channels, and update_and_root_hist with a select and a GOSS
     multiplier, among them).  Multiclass path: the covertype cell's
     bundled training matrix (12 EFB columns, 63 bins, K=7 score
     channels, 40 channels); then update_and_root_hist and
     update_multi_and_hists on edge cases (UPDATE_EDGES: rows below and
     past one staged chunk, an all-zero select, every row in one bin,
     4-bit bins, weights, feature tiles, K=2, K=16, one-vs-all with
     is_unbalance, 16-bit words of up to 9600 bins, and a row for each
     regression objective); their single-call
     times are in the result line, their shared-memory floors in the
     log.  Then update_and_root_hist (a delta; a select with GOSS's
     multiplier) and update_channels with each regression objective
     (L1, Huber at huber_delta 0.3, Fair, Poisson: B1's and B10's
     compile-time kinds), unweighted and weighted, at --rows x 28, 64
     bins against the plain versions, timed beside binary (the kernels
     line's B1 and B10 entries carry them under "kinds").  Mask grower: hist_segment and
     hist_segment_q at --rows x 28, 64 bins, over a sub-range with
     unselected rows, at 1M rows of 512 bins (16-bit words), and on edge
     cases (no row, one row, every row selected, every row in one bin,
     range ends not multiples of 4, 600 features) with their
     selected-row tallies; the
     quantized levels of the card against the CPU's; split_stream and
     level_stream at 1M rows x 28 features of 256 bins (features tiled
     over the grid, as at max_bin=255), unselected rows among them;
  4. small end to end (while a background thread makes and bins the
     higgs-10.5M and mslr-web10k-shaped data; the CPU halves of the
     sampled, mask-grower, objective and lambdarank checks train in
     CPU_WORKERS spawned worker processes beside the card's halves):
     --small-rows x 28 (binary, 255 leaves) and 30,000
     Covertype-shaped rows (K=7, 31 leaves, 2 iterations) trained on the card and on
     the CPU (plain versions) — splits, predictions and AUC / multi
     logloss must agree; then --small-rows x 28 at learning_rate=0.5,
     31 leaves, 6 iterations with bagging and feature_fraction and 4
     with GOSS, on both, with the bagging masks compared; then on the
     mask grower (31 leaves) quantized binary and quantized L2 on
     --small-rows x 28 (5 iterations) and multiclass GOSS on the 30,000
     Covertype-shaped rows (4 iterations at learning_rate 0.5: 2 warm-up,
     2 sampled); then each regression objective on --small-rows x 28 (31
     leaves, 1 iteration) and Huber with GOSS (4 iterations at
     learning_rate 0.5)
     on the fused path, 0 differing splits required; then lambdarank on
     the mask grower on ~20k documents of 170 mslr-web10k-shaped queries
     (2 iterations); then the API's paths (phase_small_api) on the
     binary and K=7 boosters above: init_model continuing them by 2
     iterations, an LGBMClassifier fit whose model text must equal
     lgt.train's, DART on the mask grower (31 leaves, 6 iterations, the
     drop indices of each equal), and rollback_one_iter then update() at
     K=1 (the delta off the band through score_add) and K=7 (the band
     rewritten), each card against CPU; then the tree strategies
     (phase_small_strategies) on the same binned rows, 31 leaves, 3
     iterations on the mask grower, card against CPU: linear trees
     (binary, L2; the same linear leaves, coefficients within 1e-4
     relative), monotone constraints on the 4 features of largest
     |corr(x, y)| (binary on float32 and on quantized gradients), and 3
     fused iterations, 2 update(fobj=logistic) on the mask grower and
     one more fused iteration (the band rewritten from the scores
     through score_add, the training scores within 1e-5 of predict);
  5. "higgs-10.5M" at full width: Higgs-shaped binary data (--rows plus a
     500k held-out set), max_bin=63, num_leaves=255, learning_rate=0.1,
     min_data_in_leaf=1, min_sum_hessian_in_leaf=100, --iters
     iterations; prints s/iter (the stream's time between an
     iteration's boundary events) beside the chunk's wall over its
     iterations, held-out AUC, peak memory and the launch counts of
     every kernel (and split_stream's rows and launches with rows: the
     fused grower's fallback splits), then, per iteration, the ms
     between its events, its host syncs (sync debug mode "warn") and
     its launches by kernel; one fused tree replayed under sync debug
     mode "error" (0 host syncs a tree) and a 2-iteration chunk's host
     syncs (1); the tree's device ms as one graph replay and with
     every level and phase-2 step empty (its fixed cost); then a run
     with the level grower off (so split_stream carries every split) and
     a repeat of the main run's first --repeat-iters iterations, to show
     whether two runs give byte-identical trees; then split_stream alone
     (given device scalars, as the fused grower launches it) at the
     cell's mean tail segment (its rows over its launches that had
     rows), against the plain version, with its device time a call
     given device scalars, host ints and a count of 0;
  5b. "higgs-10.5M-bagging": the same binned data and tree parameters
     with feature_fraction=0.9, bagging_fraction=0.8, bagging_freq=5
     (LightGBM's examples/python-guide/simple_example.py), the 500k
     held-out rows as a validation set with metric auc and
     binary_logloss, early_stopping_rounds=5, 20 iterations; prints
     s/iter, the validation AUC, the last evals_result entries,
     best_iteration and peak memory;
  5c. "higgs-10.5M-goss": the same with boosting=goss, top_rate=0.2,
     other_rate=0.1, 20 iterations (10 warm-up, 10 sampled at
     learning_rate 0.1); prints s/iter of each kind, the held-out AUC
     and update_channels' launches;
  5c'. the regression cells: the Higgs cell's binned data and
     parameters with objective regression_l1, huber (huber_delta 0.3),
     fair and poisson, the 0/1 labels as targets, 3 iterations each on
     the fused path; prints s/iter, the objective's metric on the 500k
     held-out rows, peak memory and the host syncs of a tree (replayed
     under "error") and of a chunk;
  5d. "higgs-10.5M-quantized": the Higgs cell's binned data and
     parameters with use_quantized_grad (5 bits) on the mask grower, 20
     iterations; prints s/iter, the held-out AUC (within 0.005 of the
     Higgs cell's), peak memory, hist_segment_q's launches, a 3-iteration
     profiler window and the host syncs of one more iteration;
  5e. the API at full width (phase_api) on the Higgs cell's data, its
     500k held-out rows and the main run's booster: an LGBMClassifier
     with TRAIN_PARAMS' config fits 10 estimators on the first 1M rows
     with an eval set and early stopping (its trees byte-identical to
     lgt.train's on the same rows); lgt.train continues the main booster
     by 5 iterations through init_model on the first 2.1M rows of the
     cell's bins (its first 20 trees byte-identical); rollback_one_iter
     then update() (the
     training scores on 100k rows within 1e-4 of predict, the regrown
     tree's splits against the popped one's); pred_leaf (leaf values
     summing to the raw prediction within 1e-5) and the prediction early
     stop (freq 5, margin 1.0: rows exiting early, |dAUC|, ms); the
     feature importances; 3-fold cv of those 2.1M rows (three boosters of
     1.4M rows on the card at once, 2 rounds; the logloss mean must
     fall every round);
     DART (10 iterations on the mask grower, trees dropped each
     iteration, held-out AUC, host syncs of an iteration);
  5f. the tree strategies at full width (phase_strategies) on the Higgs
     cell's binned data and parameters, 5 iterations each on the mask
     grower: "higgs-10.5M-linear" (linear_tree; one update() at a time,
     the fit's ms a tree by CUDA events, the share of linear leaves,
     the host syncs of the last iteration) and "higgs-10.5M-monotone"
     (the 6 features of largest |corr(x, y)| constrained by its sign; a
     sweep of 200 held-out rows x 32 values of each constrained feature,
     whose worst signed step must be >= -1e-6); s/iter, held-out AUC
     (> 0.6), peak memory and hist_segment's launches of each;
  5g. "higgs-10.5M-cli" (phase_cli): the command line at full width.
     The main run's binned training set saved with Dataset.save_binary
     (its size and seconds) and the first 100k held-out rows written as
     a CSV with a header; then, each a `python -m lightgbm_tpu_torch` process
     on the card: task=train from a .conf with the main run's parameters,
     data=the cache, valid_data=the CSV, metric=auc, --iters iterations,
     a checkpoint every 5 iterations, LIGHTGBM_TPU_TRACE and
     LIGHTGBM_TPU_METRICS set, sent SIGTERM once its log shows iteration
     8 (it must flush a checkpoint, log "preempted" and exit 0 without a
     model), then `python -m lightgbm_tpu_torch resume` with the same
     arguments (it resumes from that checkpoint; its trees byte-identical
     to the main run's; wall, s/iter, peak device and host memory, and
     both processes' launch counts from their logs; `report --json` of
     the two traces must count --iters iteration records; each
     checkpoint's size and capture, serialize and write seconds from the
     traces, and the restore's), then side by side task=predict of the
     CSV (within 1e-5 relative of the in-process Booster.predict of the
     file; its AUC within 1e-4 of the main model's on those rows) and
     task=ingest of the CSV with stream_ingest=true in 25k-row chunks
     (bins and mappers equal to the in-memory Dataset(csv)'s); the
     native parser must have parsed the CSV in every process;
  5h. "higgs-10.5M-serve" (phase_serve): serving on the card.  The main
     model packed as v1 (exact) and v2 (quantized), a 1,000-tree
     artifact (its 20 trees 50 times, leaf values / 50, held against
     ops/predict.predict_raw), the small linear model as v3 and the
     small K=7 model; each PackedPredictor warmed at 4096 rows (one CUDA
     graph per bucket), then 200 predicts of 1-4096 rows with no new
     capture; exact: the walk's leaves equal pred_leaf's and the scores
     within 1e-6 relative of Booster.predict; quantized: the same leaves,
     scores within drift_bound; p50/p99 ms and rows/s at 1, 128 and 2048
     rows, and the host's part of a 128-row request.  Then `python -m
     lightgbm_tpu_torch serve` with a registry: 8 client threads send the
     first 200k held-out rows in requests of 1-2048 rows (every answer
     within 1e-6 of Booster.predict, the AUC the main model's on them;
     latency, rows/s,
     the mean coalesced batch, /metrics, captures after warmup 0, peak
     device memory); a second pass over 150k rows during which a
     same-shape retrain (leaf values x 1.1) is published: 0 failed
     requests, each answer its version's, the swap in place with 0
     captures; a third (2 clients, requests of 1-64 of the first 20k
     rows, repeated until it answers) during which the 1,000-tree
     artifact (leaf values x 0.9/50, another shape class) is published:
     0 failed, each answer its version's, one capture a bucket beside the
     live graphs; SIGTERM with two requests
     in flight: /readyz 503, both answered within 1e-6 of the 1,000-tree
     model, exit 0.  Serving launches none of the ten kernels;
  5i. "higgs-10.5M-ooc" (phase_ooc, after 5d): the Higgs cell's binned
     data and parameters on the mask grower with the bin matrix
     streamed (out_of_core=true, ~64 MiB chunks through the pinned
     ring), float and quantized, 2 iterations each, model text
     byte-identical to the resident mask grower's; then
     out_of_core=auto with LIGHTGBM_TPU_DEVICE_BUDGET below the packed
     bins (1 iteration, routing must engage); s/iter, streamed GB/s,
     overlap_pct, passes and chunks a tree, peak memory against the
     resident run's, a 256 MiB pinned copy's GB/s and the pass's bound,
     the staging copy's GB/s at 1 and 8 threads.  In phase 3 B8/B9's
     carry mode at --rows x 28 folded over the plan's chunks against
     one resident launch and the plain carry (phase_kernels_carry);
  5j. "higgs-10.5M-fleet" (phase_fleet, after 5h): the main model on two
     `python -m lightgbm_tpu_torch serve` replicas sharing a registry,
     behind `python -m lightgbm_tpu_torch fleet backends=...`; 4
     closed-loop clients (1-64 held-out rows a request) for 6 s while a
     retrain is published through the proxy and a replica SIGKILLed (0
     failed, each answer its version's, the survivor on v2); then the
     replica restarted with a 300 ms LIGHTGBM_TPU_SERVE_FAULT delay (its
     breaker opens, hedges win, 0 failed);
  5k. "higgs-10.5M-parallel" (phase_parallel, after 5j): the host-driven
     learners (parallel/hostlearner.py) over 4 LocalComm rank threads on
     the card, on the main cell's bins cut to PARALLEL_ROWS rows, one
     tree a mode (data, feature, voting at top_k 14 and 5, quantized
     data): feature equal to the serial grower, voting(2k >= F) to data
     and the quantized tree at 1 rank to 4, bitwise; each mode's splits
     and ledgers against the same mode on the CPU (run by the CPU-half
     workers beside phase 5's fused cells); ms a tree, bytes by
     purpose, B8/B9 launches and selected rows;
  5l. "higgs-10.5M-factory" (phase_factory): the training factory on
     Higgs-shaped CSV parts: a cold cycle, a clean append canaried on a
     replica pinned to the candidate behind a FleetProxy under
     closed-loop clients and promoted (its model text equal to lgt.train
     of the staged rows with the same init_model), a shuffled-label
     append rolled back by the eval gate; beside that last cycle, `python
     -m lightgbm_tpu_torch factory` SIGKILLed after two checkpoints and
     run again (it resumes and publishes once);
  5m. "higgs-10.5M-distributed" (phase_distributed, after 5l): training
     over two rank processes on the one card (`python -m
     lightgbm_tpu_torch train`, a machine list on 127.0.0.1), on the main
     cell's first DIST_ROWS rows as CSV shards, DIST_ITERS iterations in
     data, feature, voting (top_k 14) and quantized data: feature equal to
     the serial mask grower, voting to data, data and quantized to
     LocalComm rank threads in this process on the ranks' saved bins
     (texts and ledgers), bitwise; rank 1 killed mid-run (rank 0 exits
     75 within 2 x DIST_TIMEOUT + 10 s, the rerun resumes to the same
     model), a wedged rank 1 (rank 0 exits 74), `report merge` of two
     traces; ms a tree, bytes, allgathers and wait share, bootstrap s,
     device MiB, the ranks' B8/B9 launches;
  5n. "higgs-10.5M-elastic" (phase_elastic, after 5m): member fleets
     (`python -m lightgbm_tpu_torch.factory.member_worker`, ELASTIC_WIDTH:
     20,000 integer-valued rows x 28 features of 63 values, 255 leaves,
     quantized binary) coordinating through fleet directories: a fleet of
     one; a churn run (a SIGTERM leave, a SIGKILL, a joiner) and a
     coordinator SIGKILL, whose finishers train the fleet of one's bytes;
     a rebalance drill (member 0 slowed by a collective delay fault,
     rows moved, the trees unchanged); rank-sharded out of core (two CLI
     ranks on the main cell's first 20,000 rows, ooc_chunk_rows 4,096,
     equal to LocalComm rank threads in memory, a 2-rank checkpoint
     resumed at 3 ranks to the same bytes); `factory spot` (its cost and
     zero lost iterations); ms a tree, resize pauses, bytes by purpose,
     rows moved, streamed GB/s and stall share, start to first
     iteration, the card's used MiB, B9 launches in every process;
  4b. (after the tree strategies, phase_small_ckpt) resume on the card:
     K=7 on 30,000 Covertype-shaped rows (31 leaves, 4 iterations), GOSS
     (6, learning_rate 0.5), DART (6) and quantized binary (5) on
     --small-rows x 28, each trained uninterrupted, then with a
     checkpoint every 2 or 3 iterations and killed mid-run, then resumed:
     the resumed model text must be byte-identical;
  5*. after phase 5's sync checks, the same with tracing on (a fused tree
     replayed under "error", a 2-iteration chunk) and GBDT.train_iters(2)
     with tracing off and on: tracing must add no host sync;
  6. "covertype-581k" at full width: Covertype-shaped data (581,012 rows,
     54 columns: 10 integer numeric, a 4-column and a 40-column one-hot,
     7 classes at Covertype's counts), the first 464,809 train and the
     last 116,203 are held out; objective=multiclass, the Higgs cell's
     training parameters, 12 iterations (20 before PR 15); prints s/iter,
     held-out multi_logloss and accuracy, peak memory, launches and the
     idle share (with update_multi_and_hists' device ms a launch and an
     iteration, as higgs-10.5M's window gives update_and_root_hist's),
     the seven tree graphs' pool, the host syncs of a tree of every
     class (under "error") and of a chunk, and a tree's device ms;
     then a 2-iteration one-vs-all run at 31 leaves, and one tree grown
     with root_hist=None (hist_segments with the level grower on,
     hist_dyn off) against the tree of update_multi_and_hists's class-0
     histogram.
  6b. "covertype-581k-goss": the covertype cell's data and parameters with
     boosting=goss (top_rate 0.2, other_rate 0.1) on the mask grower, 12
     iterations (10 warm-up, 2 sampled; cut from 20 to keep the run in time);
     prints s/iter of each kind,
     held-out multi_logloss and accuracy, hist_segment's launches, and
     a one-iteration profiler window.
  6c. "mslr-web10k-shaped": lambdarank on the mask grower at MSLR-WEB10K
     Fold1's training size (723,412 documents in 6,000 queries of mean
     ~120 and up to 900 documents, 136 features, labels 0-4) with a
     2,000-query validation set, the Higgs cell's parameters with
     ndcg_eval_at=1,3,5,10, 10 iterations; prints s/iter, the gradient
     pass's device ms, the validation ndcg@k beside a random order's,
     peak memory and hist_segment's launches and selected rows.
  7. hist_segment on the covertype cell's training bins and
     hist_segment_q at --rows x 28, each with its cell's mean selected
     rows per launch in this run (the kernels' device-side tally over
     their launches) scattered at random, against the plain versions:
     ms a launch in bursts and single, bound, and each cell's
     device ms an iteration in them from its profiler window.
Every driven path starts with the launch counts at 0 and reads them at
its end.  The line before last is a JSON object with one entry per
kernel; the last line is {"ok": true, "device": {...}}.
"""

import argparse
import collections
import concurrent.futures
import glob
import io
import json
import os
import shutil
import signal
import subprocess
import sys
import time
import traceback

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores (data sheet)
# shared memory: 132 SMs x 128 bytes a clock at the 1.98 GHz boost clock
# (H100 SXM data sheet and the Hopper tuning guide)
SMEM_BYTES_PER_S = 132 * 128 * 1.98e9
TRAIN_PARAMS = dict(objective="binary", max_bin=63, num_leaves=255, learning_rate=0.1,
                    min_data_in_leaf=1, min_sum_hessian_in_leaf=100, verbose=-1)
COV_PARAMS = dict(TRAIN_PARAMS, objective="multiclass", num_class=7)
REPLACES = {
    "update_and_root_hist": "lightgbm_tpu/ops/pkernels.py:542",
    "update_multi_and_hists": "lightgbm_tpu/ops/pkernels.py:700",
    "level_stream": "lightgbm_tpu/ops/pkernels.py:1309",
    "split_stream": "lightgbm_tpu/ops/pkernels.py:1378",
    "score_add": "lightgbm_tpu/ops/pkernels.py:825",
    "hist_dyn": "lightgbm_tpu/ops/pkernels.py:349",
    "hist_segments": "lightgbm_tpu/ops/histogram_pallas.py:360",
    "update_channels": "lightgbm_tpu/ops/pkernels.py:1565",
    "hist_segment": "lightgbm_tpu/ops/histogram_pallas.py:191",
    "hist_segment_q": "lightgbm_tpu/ops/histogram_pallas.py:479",
}
SOURCES = {
    "update_and_root_hist": "lightgbm_tpu_torch/csrc/update_hist.cu",
    "update_multi_and_hists": "lightgbm_tpu_torch/csrc/update_multi_hist.cu",
    "level_stream": "lightgbm_tpu_torch/csrc/partition_hist.cu",
    "split_stream": "lightgbm_tpu_torch/csrc/partition_hist.cu",
    "score_add": "lightgbm_tpu_torch/csrc/score_add.cu",
    "hist_dyn": "lightgbm_tpu_torch/csrc/segment_hist.cu",
    "hist_segments": "lightgbm_tpu_torch/csrc/segment_hist.cu",
    "update_channels": "lightgbm_tpu_torch/csrc/update_channels.cu",
    "hist_segment": "lightgbm_tpu_torch/csrc/segment_hist.cu",
    "hist_segment_q": "lightgbm_tpu_torch/csrc/segment_hist.cu",
}
KERNEL_NAMES = ("update_and_root_hist", "update_multi_and_hists", "level_stream",
                "split_stream", "score_add", "hist_dyn", "hist_segments", "update_channels",
                "hist_segment", "hist_segment_q")
# simple_example.py's sampling (LightGBM v2.0 examples/python-guide)
BAG_PARAMS = dict(TRAIN_PARAMS, feature_fraction=0.9, bagging_fraction=0.8, bagging_freq=5)
GOSS_PARAMS = dict(TRAIN_PARAMS, boosting="goss", top_rate=0.2, other_rate=0.1)
SAMPLED_ITERS = 20
SMALL_SAMPLED_ITERS = 6  # the small bagging phase: bagging_freq=5 redraws at iteration 5
# the mask grower's cells: LightGBM >= 4.0's use_quantized_grad at the JAX
# default of 5 bits, and GOSS on the multiclass cell
QUANT_PARAMS = dict(TRAIN_PARAMS, use_quantized_grad=True)
COV_GOSS_PARAMS = dict(COV_PARAMS, boosting="goss", top_rate=0.2, other_rate=0.1)
MASK_ITERS = 20
# covertype-581k-goss: 10 warm-up iterations (1 / learning_rate) and 2
# sampled (cut from 20 to keep the run inside its time limit)
COV_GOSS_ITERS = 12
# the regression objectives of B1 and B10 (csrc/common.cuh ObjKind) with
# the parameters their phases train with: huber_delta 0.3 puts the Higgs
# 0/1 targets' rows on both sides of the delta; poisson is the last kind
# registered, so its kernels take B1's last four shared-memory slots
OBJ_KINDS = (("regression_l1", {}), ("huber", {"huber_delta": 0.3}), ("fair", {}),
             ("poisson", {}))
OBJ_ITERS = 3  # the full-width regression cells (cut from 5 to make room for the API's paths)
# mslr-web10k-shaped (MSLR-WEB10K Fold1's training set: 723,412 documents
# in 6,000 queries, 136 features, labels 0-4) and a 2,000-query
# validation set; LightGBM's GPU-Performance.rst runs MS-LTR this way
MSLR_DOCS, MSLR_QUERIES, MSLR_VALID_QUERIES, MSLR_FEATURES = 723_412, 6_000, 2_000, 136
MSLR_MAX_QUERY = 900
MSLR_LABEL_SHARE = (0.52, 0.32, 0.13, 0.02, 0.01)  # labels 0-4, mostly 0 and 1
RANK_PARAMS = dict(TRAIN_PARAMS, objective="lambdarank", metric="ndcg",
                   ndcg_eval_at=[1, 3, 5, 10])
RANK_ITERS = 10
RANK_SMALL_QUERIES, RANK_SMALL_ITERS = 170, 2  # ~20k documents, card against CPU
SMALL_MASK_ITERS, SMALL_MASK_LEAVES = 5, 31  # the mask grower's card-vs-CPU phases
SMALL_GOSS_ITERS = 4  # at learning_rate 0.5: 2 warm-up and 2 sampled iterations
SMALL_OBJ_ITERS = 1  # each regression objective card vs CPU (2 before PR 12, 3 before PR 10)
# the fused card-vs-CPU checks of sampling and of the regression
# objectives grow 31-leaf trees (255 before PR 11): the CPU runs the
# fused tree's static structure eagerly, L-1 steps a tree, so this cuts
# their CPU halves several-fold while every kernel of the path still runs
SMALL_CHECK_LEAVES = 31
# Covertype (UCI, Blackard & Dean 1998): rows per class, and the ranges of
# the 10 integer columns (Elevation, Aspect, Slope, the hydrology
# distances, roadways, the three hillshades, fire points)
COV_CLASS_COUNTS = (211_840, 283_301, 35_754, 2_747, 9_493, 17_367, 20_510)
COV_NUMERIC = ((1859, 3858), (0, 360), (0, 66), (0, 1397), (-173, 601), (0, 7117),
               (0, 254), (0, 254), (0, 254), (0, 7173))
COV_TRAIN_ROWS = 464_809  # the first 80 %; the last 116,203 are held out
COV_ITERS = 12  # 20 before PR 15 (cut to make room for phase_ooc and phase_fleet)
COV_SMALL_ROWS, COV_SMALL_ITERS = 30_000, 2  # the multiclass card-vs-CPU phase
# the API's paths: LGBMClassifier's arguments for TRAIN_PARAMS'
# config, and the depth of each path
SKLEARN_PARAMS = dict(num_leaves=255, max_bin=63, learning_rate=0.1, min_child_samples=1,
                      min_child_weight=100)
API_SMALL_ITERS, SMALL_DART_ITERS = 2, 6  # init_model's 2 + 2; DART card vs CPU
# the small DART phase drops more often than the defaults (drop_rate 0.1,
# skip_drop 0.5), so six iterations drop trees to compare
SMALL_DART_PARAMS = dict(TRAIN_PARAMS, boosting="dart", num_leaves=SMALL_MASK_LEAVES,
                         drop_rate=0.5, skip_drop=0.2)
# the estimator's fit cut from 10 to 6 estimators
API_CLF_ITERS, API_CONT_ITERS, API_CV_ITERS, API_DART_ITERS = 6, 5, 2, 10
API_CV_FOLDS = 2  # cut from 5, then 3, for time (PERF.md §4 lists the cuts)
# rows of the full-width API paths (cut from the cell's 10.5M): the
# estimator bins its first 1M (binning 10.5M took ~35 s of its fit);
# init_model, rollback and cv take the first 2.1M of the cell's bins
API_CLF_ROWS, API_SUB_ROWS = 1_000_000, 2_100_000
# the tree strategies: linear leaves (LightGBM's linear_tree) and
# monotone constraints, card against CPU and at full width
LINEAR_PARAMS = dict(TRAIN_PARAMS, linear_tree=True)
SMALL_STRAT_ITERS, STRAT_ITERS = 3, 5
# checkpoints: the CLI's checkpoint every 5 iterations, SIGTERM once its
# log shows iteration 8; the small resume cases (name, params, rows of
# phase_small's data or the Covertype-shaped ones, iterations,
# checkpoint_freq, killed past iteration, the kernels each must launch)
CLI_CKPT_FREQ, CLI_PREEMPT_AT = 5, 8
# the CLI's CSV: the first 100k held-out rows (cut from 500k), streamed
# by task=ingest in 4 chunks a pass
CLI_CSV_ROWS, CLI_INGEST_CHUNK = 100_000, 25_000
SMALL_CKPT_CASES = (
    ("multiclass K=7", dict(COV_PARAMS, num_leaves=SMALL_CHECK_LEAVES), "cov", 4, 2, 2,
     ("update_multi_and_hists", "score_add")),
    ("goss", dict(GOSS_PARAMS, learning_rate=0.5, num_leaves=SMALL_CHECK_LEAVES), "higgs", 6,
     3, 4, ("update_and_root_hist", "update_channels", "score_add")),
    ("dart", SMALL_DART_PARAMS, "higgs", 6, 3, 4, ("hist_segment",)),
    ("quantized", dict(QUANT_PARAMS, num_leaves=SMALL_MASK_LEAVES), "higgs", 5, 2, 3,
     ("hist_segment_q",)),
)
DeviceEvent = collections.namedtuple("DeviceEvent", "key count self_device_time_total")
_TASK_SEED = 20260730  # bench.py: the task's informative weights never vary
_N_INFORM = 8


def make_higgs_shaped(n_rows, n_features=28, seed=7):
    """bench.py make_higgs_shaped: a few informative features plus noise,
    mildly non-linear decision surface; ``seed`` draws the rows only."""
    w = np.random.RandomState(_TASK_SEED).randn(_N_INFORM)
    rng = np.random.RandomState(seed)
    X = rng.randn(n_rows, n_features).astype(np.float32)
    margin = X[:, :_N_INFORM] @ w + 0.5 * X[:, 0] * X[:, 1] - 0.3 * X[:, 2] ** 2
    prob = 1.0 / (1.0 + np.exp(-margin / margin.std()))
    y = (rng.rand(n_rows) < prob).astype(np.float32)
    return X, y


def make_covertype_shaped(seed=13):
    """Covertype-shaped data: 581,012 rows of 10 integer columns over
    Covertype's ranges, a one-hot over 4 (wilderness) and over 40 (soil)
    columns, and 7 classes at Covertype's counts.  The label is a fixed
    function of the features plus seeded noise: a latent score (elevation
    first, the other columns, a soil and a wilderness effect) is ranked,
    and the classes take consecutive blocks of the ranking in the order
    of their mean elevation in Covertype, so every class has exactly its
    count.  Returns (X (N, 54) float32, y (N,) float32 class index)."""
    n = sum(COV_CLASS_COUNTS)
    rng = np.random.RandomState(seed)
    task = np.random.RandomState(_TASK_SEED)
    X = np.zeros((n, 54), np.float32)
    for j, (lo, hi) in enumerate(COV_NUMERIC):
        X[:, j] = np.clip(np.rint(rng.normal((lo + hi) / 2, (hi - lo) / 6, n)), lo, hi)
    wild = rng.choice(4, n, p=[0.45, 0.05, 0.44, 0.06])
    soil = rng.choice(40, n, p=0.8 * task.dirichlet(np.ones(40)) + 0.2 / 40)
    X[np.arange(n), 10 + wild] = 1.0
    X[np.arange(n), 14 + soil] = 1.0
    z = (X[:, :10] - X[:, :10].mean(0)) / X[:, :10].std(0)
    w = task.randn(10) * 0.3
    w[0] = 1.5
    latent = (z @ w + 0.4 * z[:, 1] * z[:, 6] + task.randn(40)[soil] * 0.6
              + task.randn(4)[wild] * 0.5 + 0.5 * rng.randn(n))
    order = np.argsort(latent, kind="stable")
    y = np.empty(n, np.float32)
    pos = 0
    for c in (3, 2, 5, 4, 1, 0, 6):  # Cottonwood/Willow lowest ... Krummholz highest
        y[order[pos:pos + COV_CLASS_COUNTS[c]]] = c
        pos += COV_CLASS_COUNTS[c]
    return X, y


def make_mslr_shaped(n_queries, seed, n_docs=None):
    """MSLR-WEB10K-shaped ranking data: ``n_queries`` query sizes from a
    lognormal of mean ~120 capped at MSLR_MAX_QUERY (summing to
    ``n_docs`` when given), 136 float32 features of which the first 20
    carry a document's relevance (the rest noise), and 0-4 labels from a
    seeded latent score per query plus a document signal and noise, cut
    at MSLR_LABEL_SHARE's quantiles.  Returns (X, labels, sizes)."""
    rng = np.random.RandomState(seed)
    sizes = np.clip(np.rint(rng.lognormal(4.55, 0.7, n_queries)), 1, MSLR_MAX_QUERY)
    sizes = sizes.astype(np.int64)
    if n_docs is not None:
        sizes = np.clip(np.rint(sizes * n_docs / sizes.sum()), 1, MSLR_MAX_QUERY).astype(
            np.int64)
        while sizes.sum() != n_docs:  # one document at a time onto (off) random queries
            step = 1 if sizes.sum() < n_docs else -1
            i = rng.randint(n_queries)
            if 1 <= sizes[i] + step <= MSLR_MAX_QUERY:
                sizes[i] += step
    n = int(sizes.sum())
    query = np.repeat(np.arange(n_queries), sizes)
    signal = rng.randn(n).astype(np.float32)
    latent = (rng.randn(n_queries) * 0.7)[query] + signal + 0.8 * rng.randn(n)
    cuts = np.quantile(latent, np.cumsum(MSLR_LABEL_SHARE)[:-1])
    y = np.searchsorted(cuts, latent).astype(np.float32)
    X = rng.randn(n, MSLR_FEATURES).astype(np.float32)
    X[:, :20] += signal[:, None] * np.linspace(1.0, 0.2, 20, dtype=np.float32)
    return X, y, sizes


def multi_logloss(y, prob):
    """Mean negative log probability of the true class (multi_logloss)."""
    p = np.clip(prob[np.arange(len(y)), np.asarray(y, np.int64)], 1e-15, 1.0)
    return float(-np.mean(np.log(p)))


def prior_entropy():
    """multi_logloss of predicting Covertype's class frequencies."""
    p = np.asarray(COV_CLASS_COUNTS, np.float64) / sum(COV_CLASS_COUNTS)
    return float(-(p * np.log(p)).sum())


def driven(name, fn, required):
    """Run one path of the port with every launch count set to 0 first;
    returns (fn's result, the path's counts) and fails if a kernel in
    ``required`` was never launched."""
    from lightgbm_tpu_torch.ops import pkernels as pk

    pk.reset_launch_counts()
    res = fn()
    counts = pk.launch_counts()
    log(f"path {name}: launches {json.dumps(counts)}")
    for k in required:
        assert counts[k] > 0, f"{k} was not launched on the {name} path"
    return res, counts


def auc(y, p):
    """Rank AUC with tied scores sharing their average rank."""
    y = np.asarray(y) > 0
    _, inv, cnt = np.unique(p, return_inverse=True, return_counts=True)
    first = np.concatenate([[0], np.cumsum(cnt)[:-1]])
    ranks = (first + (cnt + 1) / 2.0)[inv]
    npos = y.sum()
    nneg = y.size - npos
    return float((ranks[y].sum() - npos * (npos + 1) / 2.0) / (npos * nneg))


def log(*a):
    print(*a, flush=True)


def time_cuda(fn, reps, warmup=1, burst=1):
    """Median milliseconds of one call of ``fn`` over ``reps`` bursts of
    ``burst`` calls, each burst between one pair of CUDA events.  With
    ``burst=1`` a reading also holds the host's time to enqueue the call;
    a burst of launches shows the device's rate when the host keeps
    ahead of it."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(burst):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / burst)
    return float(np.median(times))


def device_events(prof):
    """The profiler window's device activity (kernels, copies, memsets)
    summed by name: [(key, count, self_device_time_total in µs)], as
    ``key_averages()`` gives a device event's, read from the raw events
    (key_averages builds a Python object an event: 47-92 s for the
    covertype cells' windows of ~10^6 device operations)."""
    import torch

    total = collections.defaultdict(lambda: [0, 0])
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            t = total[e.name()]
            t[0] += 1
            t[1] += e.duration_ns()
    return [DeviceEvent(k, c, ns / 1e3) for k, (c, ns) in total.items() if ns > 0]


def device_split(fn, calls=5):
    """{kernel: device ms a call} of ``fn`` from torch.profiler (the
    device's activity only): a kernel's mean over the launches the
    profiler recorded, times its launches a call (the recorded ones over
    ``calls``, rounded up: a window can lose a launch, see
    profile_iters)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key.split("(")[0][-40:]:
            round(e.self_device_time_total / 1e3 / e.count * -(-e.count // calls), 4)
            for e in device_events(prof)}


def burst_ms(fn):
    """A kernel row's time: the median of 5 bursts of 10 launches."""
    return time_cuda(fn, 5, burst=10)


def sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def rel_err(a, b):
    """max |a - b| over max(max |b|, 1): (relative, absolute)."""
    d = float((a.double() - b.double()).abs().max())
    return d / max(float(b.double().abs().max()), 1.0), d


HIST_TOL = 1e-5


def check_hist(name, hk, hr):
    """Kernel histogram against the plain version's.  Counts are integers
    below 2^24, exact in any order: bit-equal.  The g and h sums, each
    channel relative to its largest bin, within HIST_TOL: both versions
    sum in float64 and round once, in different orders, so they are
    bit-equal unless a sum lies within ~1e-16 of a float32 rounding
    boundary; the line reports whether they were."""
    import torch

    assert torch.equal(hk[..., 2], hr[..., 2]), f"{name}: histogram counts differ"
    (eg, ag), (eh, ah) = rel_err(hk[..., 0], hr[..., 0]), rel_err(hk[..., 1], hr[..., 1])
    log(f"  {name} hist: g rel err {eg:.3e}, h rel err {eh:.3e} (tol {HIST_TOL:g}); "
        f"counts bit-equal; sums bit-equal {torch.equal(hk, hr)}")
    assert eg <= HIST_TOL and eh <= HIST_TOL, f"{name}: histogram differs from plain"
    return max(ag, ah)


# ----------------------------------------------------------------------
def finish_bounds(out):
    """bound_ms / bound_by from each entry's bytes and operations."""
    for v in out.values():
        t_bytes = v.pop("bytes") / PEAK_BYTES_PER_S * 1e3
        t_ops = v.pop("ops") / PEAK_F32_OPS_PER_S * 1e3
        v["bound_ms"] = max(t_bytes, t_ops)
        v["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    return out


def smem_floor_ms(adds):
    """The least time of ``adds`` float64 read-add-writes in shared memory:
    16 bytes each over SMEM_BYTES_PER_S."""
    return adds * 16 / SMEM_BYTES_PER_S * 1e3


def split_work(cnt, C, F, B):
    """split_stream's bytes and operations for a segment of ``cnt`` rows:
    each row's C channels read and written once, both (F, B, 3) float32
    histograms written; the predicate (~6 ops) and 3 adds per feature."""
    return dict(bytes=cnt * C * 4 * 2 + 2 * F * B * 3 * 4, ops=cnt * (6 + 3 * F))


def phase_split_tail(cnt, dev, seed=23):
    """split_stream given device scalars (the fused grower's launch) at the
    tail's mean segment size (``cnt`` rows, the higgs-10.5M cell's
    split_stream rows over its launches that had rows), 28 features and
    64 bins, against the plain version; its burst and single-call times
    and, given device scalars, host ints and a count of 0, its device
    time a call; its bound at that size."""
    import torch

    from lightgbm_tpu_torch.ops import pkernels as pk

    F, B, n = 28, 64, 4 * cnt + 4096
    rng = np.random.default_rng(seed)
    lay = pk.PLayout(F)
    P = pk.pack_matrix(rng.integers(0, B, size=(n, F), dtype=np.uint8), lay, device=dev)
    pk.f32_row(P, lay.G, n).copy_(torch.randn(n, device=dev))
    pk.f32_row(P, lay.H, n).copy_(torch.rand(n, device=dev))
    args, kw = (1001, cnt, 3, 8, 0, 0, 30, 0), dict(num_features=F, num_bins=B, bits=8)
    dargs = [torch.tensor(v, device=dev) for v in args]  # the fused grower's launch
    Pk, Pr = P.clone(), P.clone()
    _, nk, lk, rk = pk.split_stream(Pk, *dargs, **kw)
    _, nr, lr, rr = pk.split_stream_ref(Pr, *args, **kw)
    sync(dev)
    assert int(nk) == int(nr) and torch.equal(Pk, Pr), "split_stream differs at the tail size"
    err = max(check_hist("split_stream tail left", lk, lr),
              check_hist("split_stream tail right", rk, rr))
    ms = burst_ms(lambda: pk.split_stream(Pk, *dargs, **kw))
    single = time_cuda(lambda: pk.split_stream(Pk, *dargs, **kw), 20)
    host = burst_ms(lambda: pk.split_stream(Pk, *args, **kw))
    none = [dargs[0], torch.zeros_like(dargs[1]), *dargs[2:]]
    plain = time_cuda(lambda: pk.split_stream_ref(Pr, *args, **kw), 3)
    # device ms a call, summed over its kernels (in a graph replay the
    # wrapper's host time is gone; a burst of this small launch measures it)
    dev_ms = {what: sum(device_split(fn).values()) for what, fn in (
        ("device scalars", lambda: pk.split_stream(Pk, *dargs, **kw)),
        ("host ints", lambda: pk.split_stream(Pk, *args, **kw)),
        ("count 0", lambda: pk.split_stream(Pk, *none, **kw)))}
    res = finish_bounds({"x": split_work(cnt, lay.C, F, B)})["x"]
    log(f"kernel split_stream (device scalars) at the tail's mean segment of {cnt} rows: matrix "
        f"bit-identical; {ms:.4f} ms a launch in bursts (the wrapper's host time: the device "
        f"waits for it), {single:.4f} ms single, given host ints {host:.4f} ms; device ms a "
        f"call {json.dumps({k: round(v, 4) for k, v in dev_ms.items()})} (count 0: a phase-2 "
        f"step that takes no fallback); plain {plain:.2f} ms, bound {res['bound_ms']:.4f} ms "
        f"({res['bound_by']}), max abs err {err:.3e}")
    del P, Pk, Pr
    return dict(tail_rows=cnt, tail_ms=ms, tail_single_ms=single, tail_plain_ms=plain,
                tail_bound_ms=res["bound_ms"], tail_host_int_ms=host,
                tail_device_ms=dev_ms["device scalars"], tail_host_int_device_ms=dev_ms["host ints"],
                empty_device_ms=dev_ms["count 0"])


def phase_feature_tiles(rows, dev, seed=29):
    """split_stream and level_stream (given device scalars and a device
    table, as the fused grower launches them) at 28 features of 256 bins, where
    both children's cells outgrow one block's shared memory and the
    features are tiled over the grid (max_bin=255 on the main path):
    ``rows`` rows over many row tiles, 30 % of them unselected, against
    the plain versions."""
    import torch

    from lightgbm_tpu_torch.ops import pkernels as pk

    F, B = 28, 256
    rng = np.random.default_rng(seed)
    lay = pk.PLayout(F)
    P = pk.pack_matrix(rng.integers(0, B, size=(rows, F), dtype=np.uint8), lay, device=dev)
    pk.f32_row(P, lay.G, rows).copy_(torch.randn(rows, device=dev))
    pk.f32_row(P, lay.H, rows).copy_(torch.rand(rows, device=dev))
    pk.f32_row(P, lay.SEL, rows).copy_((torch.rand(rows, device=dev) < 0.7).float())
    kw = dict(num_features=F, num_bins=B, bits=8)
    args = (37, rows - 100, 5, 16, 0, 0, 140, 0)
    Pk, Pr = P.clone(), P.clone()
    _, nk, lk, rk = pk.split_stream(Pk, *[torch.tensor(v, device=dev) for v in args], **kw)
    _, nr, lr, rr = pk.split_stream_ref(Pr, *args, **kw)
    sync(dev)
    assert int(nk) == int(nr) and torch.equal(Pk, Pr), "split_stream differs at 256 bins"
    err = max(check_hist("split_stream 256 bins left", lk, lr),
              check_hist("split_stream 256 bins right", rk, rr))
    tab = np.asarray([[0, rows // 3, 0, 8, 0, 0, 100, 0, 0, 256, 0, 0],
                      [rows // 3, 5, 2, 0, 0, 0, 7, 1, 0, 256, 0, 0],
                      [rows // 3 + 5, rows - rows // 3 - 5, 6, 24, 3, 3, 200, 0, 0, 256, 0, 0]])
    Pk, Pr = P.clone(), P.clone()
    tab_d = torch.from_numpy(np.concatenate([tab, tab[:1]])).to(dev)
    _, nlk, hk = pk.level_stream(Pk, tab_d, torch.tensor(3, device=dev), smax=4, **kw)
    _, nlr, hr = pk.level_stream_ref(Pr, tab, 3, smax=4, **kw)
    sync(dev)
    assert torch.equal(nlk.cpu(), nlr.cpu()) and torch.equal(Pk, Pr), \
        "level_stream differs at 256 bins"
    err = max(err, check_hist("level_stream 256 bins", hk, hr))
    log(f"kernels split_stream and level_stream at {rows} x {F} features, {B} bins (feature "
        f"tiles), {pk.partition_blocks([rows], pk.partition_tile(rows, 132))[0]} row tiles: "
        f"matrices bit-identical, counts bit-equal, max abs err {err:.3e}")
    del P, Pk, Pr


def check_channels(name, Pk, Pr, rows, gh_rows):
    """The kernel's matrix against the plain version's: gradient rows
    within 1e-6 relative (expf vs torch.exp), every other row and the
    tail bit-equal."""
    import torch

    err = 0.0
    for r in range(Pk.shape[0]):
        if r in gh_rows:
            e, _ = rel_err(Pk[r, :rows].view(torch.float32), Pr[r, :rows].view(torch.float32))
            err = max(err, e)
        elif not torch.equal(Pk[r], Pr[r]):
            raise AssertionError(f"{name}: channel {r} differs from plain")
    assert torch.equal(Pk[:, rows:], Pr[:, rows:]), f"{name} wrote the tail"
    log(f"kernel {name}: grad/hess rel err {err:.3e} (tol 1e-6)")
    assert err <= 1e-6
    return err


def phase_kernels(rows, dev, seed=11):
    """Each kernel against its plain version on the card, at the main
    path's shapes.  Returns {name: {...measurements}}."""
    import torch

    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.io.dataset import Metadata
    from lightgbm_tpu_torch.objective import create_objective
    from lightgbm_tpu_torch.ops import pkernels as pk

    F, B = 28, 64
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, B, size=(rows, F), dtype=np.uint8)
    label = (rng.random(rows) < 0.5).astype(np.float32)
    lay = pk.PLayout(F)
    P0 = pk.pack_matrix(bins, lay, label=label, device=dev)
    del bins
    obj = create_objective(Config.from_params({"objective": "binary"}))
    md = Metadata(rows)
    md.set_label(label)
    obj.init(md, rows)
    delta = torch.from_numpy(rng.standard_normal(rows).astype(np.float32) * 0.1).to(dev)
    out = {}
    C, W = lay.C, lay.W

    # ---- update_and_root_hist
    Pk, Pr = P0.clone(), P0.clone()
    kw = dict(num_rows=rows, num_features=F, num_bins=B, bits=8)
    _, hk = pk.update_and_root_hist(Pk, lay, obj, delta=delta, **kw)
    _, hr = pk.update_and_root_hist_ref(Pr, lay, obj, delta=delta, **kw)
    sync(dev)
    chan_err = 0.0
    for r in range(C):
        if r in (lay.G, lay.H):
            e, _ = rel_err(Pk[r, :rows].view(torch.float32), Pr[r, :rows].view(torch.float32))
            chan_err = max(chan_err, e)
        elif not torch.equal(Pk[r], Pr[r]):
            raise AssertionError(f"update_and_root_hist: channel {r} differs from plain")
    assert torch.equal(Pk[:, rows:], Pr[:, rows:]), "update_and_root_hist wrote the tail"
    log(f"kernel update_and_root_hist: grad/hess rel err {chan_err:.3e} (tol 1e-6)")
    assert chan_err <= 1e-6
    habs = check_hist("update_and_root_hist", hk, hr)
    ms = burst_ms(lambda: pk.update_and_root_hist(Pk, lay, obj, delta=delta, **kw))
    single = time_cuda(lambda: pk.update_and_root_hist(Pk, lay, obj, delta=delta, **kw), 10)
    plain = time_cuda(lambda: pk.update_and_root_hist_ref(Pr, lay, obj, delta=delta, **kw), 3)
    # reads W words + score, label, weight, delta; writes g, h, score
    nbytes = rows * 4 * (W + 4 + 3) + F * B * 3 * 4
    # the logloss gradient (~12 ops with its exp) and 3 adds per feature
    nops = rows * (12 + 3 * F)
    out["update_and_root_hist"] = dict(max_abs_err=habs, ms=ms, single_ms=single, plain_ms=plain,
                                       bytes=nbytes, ops=nops, library_ms=None)
    log(f"  update_and_root_hist at {rows} x {F}, {B} bins: {ms:.4f} ms a launch in bursts, "
        f"{single:.4f} ms single, plain {plain:.2f} ms; shared-memory floor "
        f"{smem_floor_ms(rows * F * 3):.4f} ms")
    P0 = Pk.clone()  # fresh g/h channels for the partition kernels
    del Pk, Pr

    # ---- update_channels (GOSS's prep pass: score += delta, fresh g/h)
    Pk, Pr = P0.clone(), P0.clone()
    pk.update_channels(Pk, lay, obj, delta=delta, num_rows=rows)
    pk.update_channels_ref(Pr, lay, obj, delta=delta, num_rows=rows)
    sync(dev)
    assert torch.equal(Pk, Pr), "update_channels differs from plain"
    log("kernel update_channels: matrix bit-identical (score, g, h; tail untouched)")
    ms = burst_ms(lambda: pk.update_channels(Pk, lay, obj, delta=delta, num_rows=rows))
    plain = time_cuda(lambda: pk.update_channels_ref(Pr, lay, obj, delta=delta, num_rows=rows),
                      3)
    # reads score, label, delta; writes score, g, h: 4 B per row each
    out["update_channels"] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain, bytes=rows * 4 * 6,
                                  ops=rows * 12, library_ms=None)

    # ---- update_and_root_hist with a select and GOSS's multiplier
    sel = (torch.rand(rows, device=dev) < 0.3).float()
    mul = torch.where(torch.rand(rows, device=dev) < 0.5, 8.5, 1.0).float()
    Pk, Pr = P0.clone(), P0.clone()
    _, hk = pk.update_and_root_hist(Pk, lay, obj, sel=sel, mul=mul, **kw)
    _, hr = pk.update_and_root_hist_ref(Pr, lay, obj, sel=sel, mul=mul, **kw)
    sync(dev)
    assert torch.equal(Pk, Pr), "update_and_root_hist (sel, mul): channels differ from plain"
    check_hist("update_and_root_hist (sel, mul)", hk, hr)
    ms = burst_ms(lambda: pk.update_and_root_hist(Pk, lay, obj, sel=sel, mul=mul, **kw))
    log(f"kernel update_and_root_hist (sel, mul): channels bit-identical; {ms:.4f} ms")
    out["update_and_root_hist"]["sel_mul_ms"] = ms
    # the rest of a sampled GOSS iteration's prep pass: the |g*h| ranking
    # and the rest's draw at GOSS_PARAMS' rates (one call of goss_select)
    from lightgbm_tpu_torch.boosting.ptrainer import goss_select
    from lightgbm_tpu_torch.utils import threefry

    gscore = (pk.f32_row(Pk, lay.G, rows) * pk.f32_row(Pk, lay.H, rows)).abs()
    top, other = int(rows * GOSS_PARAMS["top_rate"]), int(rows * GOSS_PARAMS["other_rate"])
    key = threefry.fold_in(threefry.fold_in(threefry.PRNGKey(0), 2), 10)
    ms = time_cuda(lambda: goss_select(gscore, top, other / (rows - top), (rows - top) / other,
                                       key), 5)
    log(f"  GOSS selection (stable sort of |g*h|, threefry draw) at {rows} rows: {ms:.4f} ms")
    del Pk, Pr, sel, mul, gscore

    # ---- level_stream: empty, tiny unaligned, chunk-aligned and large
    # segments, numerical / categorical / zero-bin remap / EFB remap
    q, T = rows // 16, 16 * pk.PART_CHUNK
    a = -(-4 * q // T) * T  # chunk-aligned start
    specs = [  # (start, cnt, feat, thr, zero_bin, dbz, cat, off_lo, off_hi, bias)
        (0, q, 3, 31, 0, 0, 0, 0, 256, 0),
        (q, 0, 5, 10, 0, 0, 0, 0, 256, 0),  # empty
        (q + 3, 7, 7, 15, 0, 0, 0, 0, 256, 0),  # tiny, unaligned
        (q + 10, a - q - 10, 0, 7, 5, 11, 0, 0, 256, 0),  # zero-bin remap
        (a, 3 * T, 2, 9, 0, 0, 0, 0, 256, 0),  # chunk-aligned
        (a + 3 * T, 2 * q, 10, 4, 0, 0, 1, 0, 256, 0),  # categorical
        (a + 3 * T + 2 * q, 4 * q - 1, 12, 20, 0, 3, 0, 3, 40, 1),  # EFB range remap
        (a + 3 * T + 6 * q, rows - (a + 3 * T + 6 * q), 27, 50, 0, 0, 0, 0, 256, 0),
    ]  # one column before the last segment belongs to no segment
    tab = np.asarray([[s, c, f // 4, (f % 4) * 8, zb, dbz, thr, cat, lo, hi, bias, 0]
                      for s, c, f, thr, zb, dbz, cat, lo, hi, bias in specs], np.int64)
    nseg, smax = len(specs), 16
    Pk, Pr, Ph = P0.clone(), P0.clone(), P0.clone()
    lkw = dict(num_features=F, num_bins=B, bits=8, smax=smax)
    # the fused grower's launch: the table and n_active on the card (the
    # rows past n_active hold a copy of the first, which must be ignored)
    tab_d = torch.from_numpy(np.concatenate([tab, np.repeat(tab[:1], smax - nseg, 0)])).to(dev)
    nseg_d = torch.tensor(nseg, device=dev)
    _, nlk, hk = pk.level_stream(Pk, tab_d, nseg_d, **lkw)
    _, nlr, hr = pk.level_stream_ref(Pr, torch.from_numpy(tab), nseg, **lkw)
    _, nlh, hh = pk.level_stream(Ph, tab, nseg, **lkw)  # a host table, uploaded
    sync(dev)
    assert torch.equal(nlk.cpu(), nlr.cpu()), "level_stream: left counts differ"
    # the partition is stable in both versions: rows, order and every
    # channel are bit-identical, and untouched columns stay so
    assert torch.equal(Pk, Pr), "level_stream: partitioned matrix differs from plain"
    assert torch.equal(Ph, Pk) and torch.equal(nlh, nlk), "level_stream: host table differs"
    log(f"kernel level_stream (device table): nl {nlk[:nseg].tolist()}; matrix bit-identical "
        f"(and with a host table)")
    habs = max(check_hist("level_stream", hk, hr), check_hist("level_stream host table", hh, hr))
    ms = burst_ms(lambda: pk.level_stream(Pk, tab_d, nseg_d, **lkw))
    plain = time_cuda(lambda: pk.level_stream_ref(Pr, torch.from_numpy(tab), nseg, **lkw), 3)
    active = int(tab[:, 1].sum())
    # every active row's C channels read and written once; the predicate
    # (~6 ops) and 3 adds per feature for the histograms
    out["level_stream"] = dict(max_abs_err=habs, ms=ms, plain_ms=plain,
                               bytes=active * C * 4 * 2 + nseg * 2 * F * B * 3 * 4,
                               ops=active * (6 + 3 * F), library_ms=None)

    # ---- split_stream: the root segment of the main path (all rows)
    Pk, Pr, Ph = P0.clone(), P0.clone(), P0.clone()
    skw = dict(num_features=F, num_bins=B, bits=8)
    args = (0, rows, 1, 16, 0, 0, 31, 0)
    dargs = [torch.tensor(v, device=dev) for v in args]  # the fused grower's launch
    _, nk, lk, rk = pk.split_stream(Pk, *dargs, **skw)
    _, nr, lr, rr = pk.split_stream_ref(Pr, *args, **skw)
    _, nh, lh, rh = pk.split_stream(Ph, *args, **skw)  # host ints, by value
    sync(dev)
    assert int(nk) == int(nr) == int(nh), "split_stream: left counts differ"
    assert torch.equal(Pk, Pr), "split_stream: partitioned matrix differs from plain"
    assert torch.equal(Ph, Pk), "split_stream: host ints partition otherwise"
    log(f"kernel split_stream (device scalars): nl {int(nk)}; matrix bit-identical (and given "
        f"host ints)")
    al = max(check_hist("split_stream left", lk, lr), check_hist("split_stream host left", lh, lr))
    ar = max(check_hist("split_stream right", rk, rr),
             check_hist("split_stream host right", rh, rr))
    ms = burst_ms(lambda: pk.split_stream(Pk, *dargs, **skw))
    single = time_cuda(lambda: pk.split_stream(Pk, *dargs, **skw), 10)
    host = burst_ms(lambda: pk.split_stream(Pk, *args, **skw))
    plain = time_cuda(lambda: pk.split_stream_ref(Pr, *args, **skw), 3)
    split = device_split(lambda: pk.split_stream(Pk, *dargs, **skw))
    log(f"  split_stream at {rows} rows: {ms:.4f} ms a launch in bursts, {single:.4f} ms "
        f"single; given host ints {host:.4f} ms; device ms a call by kernel {split}")
    out["split_stream"] = dict(max_abs_err=max(al, ar), ms=ms, single_ms=single, plain_ms=plain,
                               **split_work(rows, C, F, B), library_ms=None)

    # ---- score_add
    Pk, Pr = P0.clone(), P0.clone()
    pk.score_add(Pk, lay, delta, num_rows=rows)
    pk.score_add_ref(Pr, lay, delta, num_rows=rows)
    sync(dev)
    assert torch.equal(Pk, Pr), "score_add differs from plain"
    log("kernel score_add: bit-identical")
    srow = pk.f32_row(Pr, lay.SCORE, rows)
    # the kernel and Tensor.add_ on the same row, one burst of each in
    # turns, so both medians span the same stretch of the card's state
    kern_fn, lib_fn = (lambda: pk.score_add(Pk, lay, delta, num_rows=rows),
                       lambda: srow.add_(delta))
    turns = [(time_cuda(kern_fn, 1, burst=10), time_cuda(lib_fn, 1, burst=10))
             for _ in range(10)]
    ms, lib = (float(np.median([t[i] for t in turns])) for i in (0, 1))
    single = time_cuda(kern_fn, 20)
    lib_single = time_cuda(lib_fn, 20)
    plain = time_cuda(lambda: pk.score_add_ref(Pr, lay, delta, num_rows=rows), 5)
    log(f"  score_add at {rows} rows: {ms:.4f} ms a launch in bursts (10 bursts of 10, in "
        f"turns with Tensor.add_), {single:.4f} ms single; Tensor.add_ {lib:.4f} ms in "
        f"bursts, {lib_single:.4f} ms single")
    out["score_add"] = dict(max_abs_err=0.0, ms=ms, single_ms=single, plain_ms=plain,
                            bytes=rows * 12, ops=rows, library_ms=lib,
                            library_single_ms=lib_single)
    del P0, Pk, Pr
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return finish_bounds(out)


def _multi_objective(name, K, label, weight=None, **extra):
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.io.dataset import Metadata
    from lightgbm_tpu_torch.objective import create_objective

    params = dict(extra, objective=name, **({"num_class": K} if K > 1 else {}))
    obj = create_objective(Config.from_params(params))
    md = Metadata(len(label))
    md.set_label(label)
    if weight is not None:
        md.set_weights(weight)
    obj.init(md, len(label))
    return obj


# B1 / B2 edge cases: (what, rows, features, bins, bits, K, objective,
# extra parameters, weights, select (None: the matrix's own, 0.0: all
# zero, "rand": 30 % of rows, with a GOSS multiplier for K = 1), every row
# in one bin).  A block stages 256 rows at a time, so 1, 31 and 257 rows
# lie below one chunk or just past it, and 100,003 is no multiple of it.
UPDATE_EDGES = [
    ("1 row", 1, 28, 64, 8, 1, "binary", {}, False, None, False),
    ("31 rows", 31, 28, 64, 8, 1, "binary", {}, False, None, False),
    ("257 rows", 257, 28, 64, 8, 1, "regression", {}, False, None, False),
    ("100,003 rows", 100_003, 28, 64, 8, 1, "binary", {}, False, None, False),
    ("all-zero select", 100_003, 28, 64, 8, 1, "binary", {}, False, 0.0, False),
    ("every row in one bin", 100_003, 28, 64, 8, 1, "binary", {}, False, None, True),
    ("4-bit bins", 100_003, 28, 16, 4, 1, "binary", {}, False, "rand", False),
    ("weights", 100_003, 28, 64, 8, 1, "binary", {}, True, "rand", False),
    ("300 features x 256 bins, feature tiles", 20_000, 300, 256, 8, 1, "binary", {}, True,
     "rand", False),
    ("K=2 softmax, 257 rows", 257, 12, 63, 8, 2, "multiclass", {}, False, None, False),
    ("K=7 softmax, 31 rows", 31, 12, 63, 8, 7, "multiclass", {}, False, None, False),
    ("K=7 all-zero select", 10_007, 12, 63, 8, 7, "multiclass", {}, False, 0.0, False),
    ("K=7 every row in one bin", 10_007, 12, 63, 8, 7, "multiclass", {}, False, None, True),
    ("K=16 feature tiles", 100_003, 28, 64, 8, 16, "multiclass", {}, True, "rand", False),
    ("K=5 one-vs-all is_unbalance, weights", 20_011, 11, 16, 4, 5, "multiclassova",
     {"is_unbalance": True}, True, None, False),
    # 16-bit words: B1's one-feature tiles in narrowed stripes (4000 bins)
    # and in tight ones with a short chunk (9600); B2's at K=16 in tight
    # stripes (800 bins)
    ("16-bit words, 4000 bins", 20_000, 2, 4000, 16, 1, "binary", {}, True, "rand", False),
    ("16-bit words, 9600 bins", 20_000, 2, 9600, 16, 1, "binary", {}, True, "rand", False),
    ("K=16 16-bit words, 800 bins", 20_000, 3, 800, 16, 16, "multiclass", {}, True, "rand",
     False),
    # the regression objectives (B1's compile-time kinds)
    ("L1, weights", 100_003, 28, 64, 8, 1, "regression_l1", {}, True, "rand", False),
    ("Huber delta 0.3, 257 rows", 257, 28, 64, 8, 1, "huber", {"huber_delta": 0.3}, False,
     None, False),
    ("Huber delta 0.3, weights, feature tiles", 20_000, 300, 256, 8, 1, "huber",
     {"huber_delta": 0.3}, True, "rand", False),
    ("Fair, 4-bit bins", 100_003, 28, 16, 4, 1, "fair", {"fair_c": 0.7}, False, "rand", False),
    ("Poisson, weights, every row in one bin", 100_003, 28, 64, 8, 1, "poisson", {}, True,
     None, True),
]


def phase_update_edges(dev, seed=41):
    """update_and_root_hist (B1, K = 1) and update_multi_and_hists (B2)
    against their plain versions on UPDATE_EDGES; B1 also with
    with_hist=False (the same channel writes).  Channels bit-identical
    but the gradient rows (1e-6 relative), the columns past the rows
    untouched, histograms as check_hist."""
    import torch

    from lightgbm_tpu_torch.ops import pkernels as pk

    rng = np.random.default_rng(seed)
    sums_equal, err = True, 0.0
    for what, n, F, B, bits, K, name, extra, weighted, sel, one_bin in UPDATE_EDGES:
        lay = pk.PLayout(F, num_score=K, bits=bits)
        bins = (np.full((n, F), 5, np.uint16) if one_bin
                else rng.integers(0, B, (n, F)).astype(np.uint16))
        label = ((rng.random(n) < 0.4) if K == 1 else rng.integers(0, K, n)).astype(np.float32)
        weight = (rng.random(n) + 0.5).astype(np.float32) if weighted else None
        # pack_matrix takes uint8 bins (the trainer's); 16-bit words by hand
        P = pk.pack_matrix(bins.astype(np.uint8) if bits < 16 else np.zeros((n, F), np.uint8),
                           lay, label=label, weight=weight, device=dev)
        if bits == 16:
            words = np.pad(bins, ((0, 0), (0, 2 * lay.W - F))).astype(np.uint32)
            P[:lay.W, :n] = torch.from_numpy(
                (words[:, 0::2] | words[:, 1::2] << 16).view(np.int32).T.copy()).to(dev)
        for k in range(K):
            pk.f32_row(P, lay.SCORE + k, n).copy_(torch.randn(n, device=dev))
        pk.f32_row(P, lay.SEL, n).copy_((torch.rand(n, device=dev) < 0.85).float())
        obj = _multi_objective(name, K, label, weight, **extra)
        kw = dict(num_rows=n, num_features=F, num_bins=B, bits=bits)
        if sel is None:
            args = {}
        elif sel == 0.0:
            args = dict(sel=torch.zeros(n, device=dev))
        else:
            args = dict(sel=(torch.rand(n, device=dev) < 0.3).float())
            if K == 1:
                args["mul"] = torch.where(torch.rand(n, device=dev) < 0.5, 8.5, 1.0).float()
        if K == 1:
            args["delta"] = 0.1 * torch.randn(n, device=dev)
            kern, ref, gh = pk.update_and_root_hist, pk.update_and_root_hist_ref, {lay.G, lay.H}
        else:
            kern, ref = pk.update_multi_and_hists, pk.update_multi_and_hists_ref
            gh = {r for k in range(K) for r in (lay.g_row(k), lay.h_row(k))}
        Pk, Pr = P.clone(), P.clone()
        _, hk = kern(Pk, lay, obj, **args, **kw)
        _, hr = ref(Pr, lay, obj, **args, **kw)
        sync(dev)
        for r in range(lay.C):
            if r in gh:
                e, _ = rel_err(Pk[r, :n].view(torch.float32), Pr[r, :n].view(torch.float32))
                assert e <= 1e-6, f"{kern.__name__} {what}: gradient row {r} differs"
            else:
                assert torch.equal(Pk[r], Pr[r]), f"{kern.__name__} {what}: channel {r} differs"
        assert torch.equal(Pk[:, n:], P[:, n:]), f"{kern.__name__} {what} wrote the tail"
        hk, hr = hk.reshape(-1, F, B, 3), hr.reshape(-1, F, B, 3)
        for k in range(hk.shape[0]):
            assert torch.equal(hk[k, ..., 2], hr[k, ..., 2]), f"{what}: counts differ"
            (eg, ag), (eh, ah) = (rel_err(hk[k, ..., c], hr[k, ..., c]) for c in (0, 1))
            assert eg <= HIST_TOL and eh <= HIST_TOL, f"{kern.__name__} {what}: sums differ"
            err = max(err, ag, ah)
        sums_equal = sums_equal and torch.equal(hk, hr)
        if K == 1:
            Pn = P.clone()
            _, none = kern(Pn, lay, obj, with_hist=False, **args, **kw)
            sync(dev)
            assert none is None and torch.equal(Pn, Pk), f"{what}: with_hist=False differs"
        del P, Pk, Pr
    log(f"kernels update_and_root_hist and update_multi_and_hists: {len(UPDATE_EDGES)} edge "
        f"cases match the plain versions (channels, tail untouched; counts bit-equal; sums "
        f"bit-equal {sums_equal}, max abs err {err:.3e}); with_hist=False writes the same "
        f"channels")


def phase_kernels_objectives(rows, dev, seed=43):
    """update_and_root_hist (B1: a delta, and a select with GOSS's
    multiplier) and update_channels (B10: a delta and a select) with each
    regression objective, unweighted and weighted, against the plain
    versions at rows x 28, 64 bins (the 0/1 targets of the Higgs cells,
    scores spread around them); binary beside them as the yardstick.
    Channels as check_channels (reported bit-equal or not), histograms as
    check_hist, update_channels' matrix bit-identical.  Returns {kind:
    measurements} for B1 and for B10, the times unweighted in bursts."""
    import torch

    from lightgbm_tpu_torch.ops import pkernels as pk

    F, B = 28, 64
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, B, size=(rows, F), dtype=np.uint8)
    label = (rng.random(rows) < 0.5).astype(np.float32)
    weight = (rng.random(rows) + 0.5).astype(np.float32)
    lay = pk.PLayout(F)
    P0 = pk.pack_matrix(bins, lay, label=label, weight=weight, device=dev)
    del bins
    pk.f32_row(P0, lay.SCORE, rows).copy_(0.5 * torch.randn(rows, device=dev) + 0.5)
    delta = 0.1 * torch.randn(rows, device=dev)
    sel = (torch.rand(rows, device=dev) < 0.3).float()
    mul = torch.where(torch.rand(rows, device=dev) < 0.5, 8.5, 1.0).float()
    kw = dict(num_rows=rows, num_features=F, num_bins=B, bits=8)
    b1, b10 = {}, {}
    for name, extra in (("binary", {}),) + OBJ_KINDS:
        e1 = e10 = 0.0
        bit_equal = True
        for weighted in (False, True):
            what = f"{name}{', weighted' if weighted else ''}"
            obj = _multi_objective(name, 1, label, weight if weighted else None, **extra)
            for args in (dict(delta=delta), dict(sel=sel, mul=mul)):
                Pk, Pr = P0.clone(), P0.clone()
                _, hk = pk.update_and_root_hist(Pk, lay, obj, **args, **kw)
                _, hr = pk.update_and_root_hist_ref(Pr, lay, obj, **args, **kw)
                sync(dev)
                label_args = "delta" if "delta" in args else "sel, mul"
                check_channels(f"update_and_root_hist [{what}; {label_args}]", Pk, Pr, rows,
                               {lay.G, lay.H})
                bit_equal = bit_equal and torch.equal(Pk, Pr)
                e1 = max(e1, check_hist(f"update_and_root_hist [{what}; {label_args}]", hk,
                                        hr))
            Pk, Pr = P0.clone(), P0.clone()
            pk.update_channels(Pk, lay, obj, delta=delta, sel=sel, num_rows=rows)
            pk.update_channels_ref(Pr, lay, obj, delta=delta, sel=sel, num_rows=rows)
            sync(dev)
            d = (pk.f32_row(Pk, lay.H, rows) - pk.f32_row(Pr, lay.H, rows)).abs().max()
            e10 = max(e10, float(d))
            assert torch.equal(Pk, Pr), f"update_channels [{what}] differs from plain"
            del Pk, Pr
        obj = _multi_objective(name, 1, label, None, **extra)
        Pk = P0.clone()
        ms = burst_ms(lambda: pk.update_and_root_hist(Pk, lay, obj, delta=delta, **kw))
        sm = burst_ms(lambda: pk.update_and_root_hist(Pk, lay, obj, sel=sel, mul=mul, **kw))
        ms10 = burst_ms(lambda: pk.update_channels(Pk, lay, obj, delta=delta, num_rows=rows))
        del Pk
        b1[name] = dict(max_abs_err=e1, ms=ms, sel_mul_ms=sm, channels_bit_equal=bit_equal)
        b10[name] = dict(max_abs_err=e10, ms=ms10)
        log(f"kernels of {name} (kind {obj.kernel_params()[0]}) at {rows} x {F}, {B} bins: "
            f"update_and_root_hist {ms:.4f} ms a launch in bursts, sel + mul {sm:.4f} ms, max "
            f"abs err {e1:.3e}, channels bit-equal {bit_equal}; update_channels {ms10:.4f} "
            f"ms, matrix bit-identical")
    log("B1 and B10 by objective against binary in this call (ms a launch): "
        + "; ".join(f"{k} {b1[k]['ms']:.4f} / {b10[k]['ms']:.4f}" for k in b1))
    del P0
    return b1, b10


def phase_kernels_multi(bds, dev, seed=5):
    """The multiclass path's kernels on the covertype cell's bundled
    training matrix (G=12 columns, BH=63 bins, K=7: 40 channels) against
    their plain versions: update_multi_and_hists (softmax and one-vs-all,
    and a K=16 x 28 x 64 matrix whose histogram needs feature tiles),
    hist_segments, hist_dyn, and level_stream over EFB-remapped segments.
    Returns {name: {...measurements}}."""
    import torch

    from lightgbm_tpu_torch.ops import pkernels as pk
    from lightgbm_tpu_torch.ops.pgrow import BundleMeta, _meta_table
    from lightgbm_tpu_torch.ops.split import FeatureMeta

    K = 7
    mat, label = bds.bundled, bds.metadata.label
    rows, G = mat.shape
    BH = int(bds.bundle.max_col_bin)
    lay = pk.PLayout(G, num_score=K)
    log(f"multiclass kernels: {rows} rows, G={G} columns of {BH} bins, K={K}, C={lay.C}")
    rng = np.random.default_rng(seed)
    P0 = pk.pack_matrix(mat, lay, label=label, device=dev)
    for k in range(K):
        pk.f32_row(P0, lay.SCORE + k, rows).copy_(
            torch.from_numpy(rng.standard_normal(rows).astype(np.float32)).to(dev))
    out = {}
    kw = dict(num_rows=rows, num_features=G, num_bins=BH)
    gh = {r for k in range(K) for r in (lay.g_row(k), lay.h_row(k))}

    # ---- update_multi_and_hists, softmax and one-vs-all
    for name in ("multiclass", "multiclassova"):
        obj = _multi_objective(name, K, label)
        Pk, Pr = P0.clone(), P0.clone()
        _, hk = pk.update_multi_and_hists(Pk, lay, obj, **kw)
        _, hr = pk.update_multi_and_hists_ref(Pr, lay, obj, **kw)
        sync(dev)
        check_channels(f"update_multi_and_hists {name}", Pk, Pr, rows, gh)
        habs = max(check_hist(f"update_multi_and_hists {name} class {k}", hk[k], hr[k])
                   for k in range(K))
        ms = burst_ms(lambda: pk.update_multi_and_hists(Pk, lay, obj, **kw))
        single = time_cuda(lambda: pk.update_multi_and_hists(Pk, lay, obj, **kw), 10)
        plain = time_cuda(lambda: pk.update_multi_and_hists_ref(Pr, lay, obj, **kw), 3)
        floor = smem_floor_ms(rows * G * (2 * K + 1))
        log(f"  update_multi_and_hists {name}: {ms:.4f} ms, single {single:.4f} ms, plain "
            f"{plain:.2f} ms; shared-memory floor {floor:.4f} ms")
        if name == "multiclass":
            P1 = Pk.clone()  # fresh g/h channels for the histogram kernels
            # reads W words + K scores + label + select, writes 2K channels
            out["update_multi_and_hists"] = dict(
                max_abs_err=habs, ms=ms, single_ms=single, plain_ms=plain,
                bytes=rows * 4 * (lay.W + K + 2 + 2 * K) + G * BH * (2 * K + 1) * 4,
                # softmax (~16 ops a class with its exp) and 2K+1 adds per column
                ops=rows * (16 * K + (2 * K + 1) * G), library_ms=None)
        else:
            out["update_multi_and_hists"]["ova_ms"] = ms
        del Pk, Pr

    # ---- the feature-tiled form: K=16 at 28 x 64 needs 236 KB of bins
    Kw, Fw, Bw, nw = 16, 28, 64, 200_000
    layw = pk.PLayout(Fw, num_score=Kw)
    labw = rng.integers(0, Kw, nw).astype(np.float32)
    Pw = pk.pack_matrix(rng.integers(0, Bw, size=(nw, Fw), dtype=np.uint8), layw, label=labw,
                        device=dev)
    objw = _multi_objective("multiclass", Kw, labw)
    Pk, Pr = Pw.clone(), Pw.clone()
    kww = dict(num_rows=nw, num_features=Fw, num_bins=Bw)
    _, hk = pk.update_multi_and_hists(Pk, layw, objw, **kww)
    _, hr = pk.update_multi_and_hists_ref(Pr, layw, objw, **kww)
    sync(dev)
    check_channels("update_multi_and_hists K=16 tiled", Pk, Pr, nw,
                   {r for k in range(Kw) for r in (layw.g_row(k), layw.h_row(k))})
    for k in (0, Kw - 1):
        check_hist(f"update_multi_and_hists K=16 class {k}", hk[k], hr[k])
    del Pw, Pk, Pr

    # ---- hist_segments: empty, tiny unaligned, one-row and large segments
    q = rows // 3
    segs = [(0, 0), (5, 1000), (1005, 1), (1006, q), (1006 + q, rows - 1006 - q)]
    tab = np.zeros((8, 2), np.int64)
    tab[:len(segs)] = segs
    hkw = dict(num_features=G, num_bins=BH, bits=8, rows=lay.class_rows(2), smax=8)
    hk = pk.hist_segments(P1, tab, len(segs), **hkw)
    hr = pk.hist_segments_ref(P1, tab, len(segs), **hkw)
    sync(dev)
    habs = max(check_hist(f"hist_segments segment {i}", hk[i], hr[i]) for i in range(len(segs)))
    ms = burst_ms(lambda: pk.hist_segments(P1, tab, len(segs), **hkw))
    plain = time_cuda(lambda: pk.hist_segments_ref(P1, tab, len(segs), **hkw), 3)
    log(f"  hist_segments: {ms:.4f} ms, plain {plain:.2f} ms")
    active = int(tab[:, 1].sum())
    # reads W words + g, h, select of every active row
    out["hist_segments"] = dict(max_abs_err=habs, ms=ms, plain_ms=plain,
                                bytes=active * 4 * (lay.W + 3) + len(segs) * G * BH * 3 * 4,
                                ops=active * (2 + 3 * G), library_ms=None)

    # ---- hist_dyn: the root segment (all rows), class 0
    dkw = dict(bits=8, rows=lay.class_rows(0))
    hk = pk.hist_dyn(P1, 0, rows, G, BH, **dkw)
    hr = pk.hist_dyn_ref(P1, 0, rows, G, BH, **dkw)
    sync(dev)
    habs = check_hist("hist_dyn", hk, hr)
    ms = burst_ms(lambda: pk.hist_dyn(P1, 0, rows, G, BH, **dkw))
    plain = time_cuda(lambda: pk.hist_dyn_ref(P1, 0, rows, G, BH, **dkw), 3)
    log(f"  hist_dyn: {ms:.4f} ms, plain {plain:.2f} ms")
    out["hist_dyn"] = dict(max_abs_err=habs, ms=ms, plain_ms=plain,
                           bytes=rows * 4 * (lay.W + 3) + G * BH * 3 * 4,
                           ops=rows * (2 + 3 * G), library_ms=None)

    # ---- level_stream on the K=7 layout over EFB-remapped segments:
    # a numerical column, a wilderness and two soil features (bundle
    # range remaps), an empty and a tiny unaligned segment
    meta = FeatureMeta.from_dataset(bds)
    mtab = _meta_table(meta, BundleMeta.build(bds.bundle, bds, bds.max_num_bin), meta.num_bins.shape[0], 8)
    names = bds.used_feature_map

    def seg_row(start, cnt, feat, thr):
        db, cat, col, lo, hi, bias = (int(v) for v in mtab[feat])
        return [start, cnt, col // 4, (col % 4) * 8, db, db, thr, cat, lo, hi, bias, 0]

    inner = {int(real): i for i, real in enumerate(names)}
    specs = [(0, q, inner[0], 30), (q, 0, inner[1], 10), (q + 3, 7, inner[10], 0),
             (q + 10, q, inner[14 + 29], 0), (2 * q + 10, rows - 2 * q - 10, inner[14 + 3], 0)]
    ltab = np.asarray([seg_row(*sp) for sp in specs], np.int64)
    assert (ltab[2:, 8] > 0).all(), "the one-hot segments are not bundle remaps"
    lkw = dict(num_features=G, num_bins=BH, bits=8, rows=lay.class_rows(3), smax=8)
    Pk, Pr = P1.clone(), P1.clone()
    _, nlk, hk = pk.level_stream(Pk, ltab, len(specs), **lkw)
    _, nlr, hr = pk.level_stream_ref(Pr, ltab, len(specs), **lkw)
    sync(dev)
    assert torch.equal(nlk.cpu(), nlr.cpu()), "level_stream C=40: left counts differ"
    assert torch.equal(Pk, Pr), "level_stream C=40: partitioned matrix differs from plain"
    habs = check_hist("level_stream C=40", hk, hr)
    ms = burst_ms(lambda: pk.level_stream(Pk, ltab, len(specs), **lkw))
    plain = time_cuda(lambda: pk.level_stream_ref(Pr, ltab, len(specs), **lkw), 3)
    active = int(ltab[:, 1].sum())
    lvl = finish_bounds({"x": dict(bytes=active * lay.C * 4 * 2 + len(specs) * 2 * G * BH * 12,
                                   ops=active * (6 + 3 * G))})["x"]
    log(f"kernel level_stream C={lay.C} EFB: nl {nlk[:len(specs)].tolist()}; matrix "
        f"bit-identical; {ms:.4f} ms, plain {plain:.2f} ms, bound {lvl['bound_ms']:.4f} ms "
        f"({lvl['bound_by']}), max abs err {habs:.3e}")
    del P0, P1, Pk, Pr
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return finish_bounds(out)


def hist_rows(bins, g, h, sel, quantized, per=4, bits=8):
    """(packed matrix, kernel, plain version) of B9 (quantized) or B8."""
    from lightgbm_tpu_torch.ops import histogram as th

    if quantized:
        return (th.pack_columns_q(bins, g, h, sel, per, bits), th.hist_segment_q,
                th.hist_segment_q_ref)
    return th.pack_columns(bins, g, h, sel, per, bits), th.hist_segment, th.hist_segment_ref


def check_mask_hist(name, hk, hr):
    """B9 bit-identical to its plain version, B8 as check_hist; returns
    the max abs error."""
    import torch

    if hk.dtype == torch.int32:
        assert torch.equal(hk, hr), f"{name} differs from plain"
        return 0.0
    return check_hist(name, hk, hr)


def hist_work(n_range, n_sel, W, F, B):
    """B8/B9's bytes and operations: the select word of every column of
    the range; W words, g and h of each selected row; the (F, B, 3)
    output; 3 adds per feature of each selected row."""
    return dict(bytes=n_range * 4 + n_sel * 4 * (W + 2) + F * B * 3 * 4, ops=n_sel * 3 * F)


def phase_hist_edges(dev, n=100_000, seed=31):
    """B8 and B9 against their plain versions on edge cases: no row, one
    row and every row selected, every row in one bin, a range whose ends
    are not multiples of 4, and 600 features of 64 bins (the float64
    cells need feature tiles); 54 features, 10 of 63 bins and 44 one-hot
    columns of two, like the covertype cell's.  Then 16-bit words of many
    bins: 28 features of 1024 bins (tiles of a few features) and 3 of
    9600 (tiles of one feature, a short staged chunk)."""
    import torch

    from lightgbm_tpu_torch.ops import histogram as th

    rng = np.random.default_rng(seed)
    F, B = 54, 63
    bins = np.zeros((n, F), np.uint8)
    bins[:, :10] = rng.integers(0, B, (n, 10))
    bins[np.arange(n), 10 + rng.integers(0, 44, n)] = 1
    g = rng.standard_normal(n, dtype=np.float32)
    h = rng.random(n, dtype=np.float32)
    qg, qh = rng.integers(-15, 16, n).astype(np.int16), rng.integers(1, 16, n).astype(np.int16)
    some = rng.random(n) < 0.4
    one = np.zeros(n, bool)
    one[n // 3] = True
    wide = rng.integers(0, 64, (n, 600)).astype(np.uint8)
    # (what, bins, bins' count, selected, lo, hi)
    cases = [("no row selected", bins, B, np.zeros(n, bool), 0, n),
             ("one row", bins, B, one, 0, n),
             ("every row", bins, B, np.ones(n, bool), 0, n),
             ("every row in one bin", np.full((n, F), 5, np.uint8), B, np.ones(n, bool), 0, n),
             ("ends not multiples of 4", bins, B, some, 3, n - 5),
             ("600 features x 64 bins, feature tiles", wide, 64, some, 1, n - 2)]
    for nf, nb in ((28, 1024), (3, 9600)):
        cases.append((f"{nf} features x {nb} bins, 16-bit words",
                      rng.integers(0, nb, (n, nf)).astype(np.int32), nb, some, 1, n - 2))
    for quantized in (False, True):
        for what, b, nb, sel, lo, hi in cases:
            per, bits = (4, 8) if b.dtype == np.uint8 else (2, 16)
            P, kern, ref = hist_rows(
                torch.from_numpy(b).to(dev),
                *(torch.from_numpy(x).to(dev) for x in ((qg, qh) if quantized else (g, h))),
                torch.from_numpy(sel.astype(np.float32)).to(dev), quantized, per, bits)
            nf = b.shape[1]
            before = th.selected_rows()[kern.__name__]
            hk = kern(P, lo, hi, nf, nb, per, bits)
            hr = ref(P, lo, hi, nf, nb, per, bits)
            sync(dev)
            check_mask_hist(f"{kern.__name__} {what}", hk, hr)
            tally = th.selected_rows()[kern.__name__] - before
            assert tally == int(sel[lo:hi].sum()), f"{kern.__name__} {what}: tally {tally}"
            del P
    log(f"kernel hist_segment and hist_segment_q: {len(cases)} edge cases each match the plain "
        f"versions (B9 bit-identical), selected-row tallies exact")


def phase_kernels_mask(rows, dev, seed=17):
    """The mask grower's kernels on the column-packed layout
    (ops/histogram.py) against their plain versions: hist_segment (B8)
    and hist_segment_q (B9) at rows x 28 features, 64 bins (8-bit words),
    over a sub-range with 40 % of the rows unselected, then at a 16-bit
    layout (uint16 bins, 512 bins, 1M rows), then on edge cases; and the
    quantized levels of the same gradients on the card against the
    CPU's.  Returns {name: {...measurements}}, the wide row's under
    ``wide_*`` (phase_mask_paths times the paths' shapes)."""
    import torch

    from lightgbm_tpu_torch.ops import histogram as th
    from lightgbm_tpu_torch.ops import qhist

    F, B = 28, 64
    rng = np.random.default_rng(seed)
    g = rng.standard_normal(rows, dtype=np.float32)
    h = np.abs(rng.standard_normal(rows, dtype=np.float32))
    sel = (rng.random(rows) < 0.6).astype(np.float32)
    # quantize_rows on the card and on the CPU: the same levels
    sc = qhist.scales_from_max(np.abs(g).max(), h.max())
    gd, hd = torch.from_numpy(g).to(dev), torch.from_numpy(h).to(dev)
    qg, qh = qhist.quantize_rows(gd, hd, sc, 12345)
    cg, ch = qhist.quantize_rows(torch.from_numpy(g), torch.from_numpy(h), sc, 12345)
    same = torch.equal(qg.cpu(), cg) and torch.equal(qh.cpu(), ch)
    log(f"quantize_rows at {rows} rows: card levels bit-equal to the CPU's: {same}")
    assert same, "the card's quantized levels differ from the CPU's"
    bins = torch.from_numpy(rng.integers(0, B, size=(rows, F), dtype=np.uint8)).to(dev)
    seld = torch.from_numpy(sel).to(dev)
    lo, hi = 1000, rows - 777
    nsel = int(sel[lo:hi].sum())
    W = th.num_words(F, 4)
    out = {}
    for quantized in (False, True):
        P, kern, ref = hist_rows(bins, *((qg, qh) if quantized else (gd, hd)), seld, quantized)
        name = kern.__name__
        hk = kern(P, lo, hi, F, B)
        hr = ref(P, lo, hi, F, B)
        sync(dev)
        habs = check_mask_hist(name, hk, hr)
        ms = burst_ms(lambda: kern(P, lo, hi, F, B))
        plain = time_cuda(lambda: ref(P, lo, hi, F, B), 3)
        wide = finish_bounds({"x": hist_work(hi - lo, nsel, W, F, B)})["x"]
        log(f"  {name} at {rows} x {F}, [{lo}, {hi}), {nsel} rows selected: {ms:.4f} ms, "
            f"plain {plain:.2f} ms, bound {wide['bound_ms']:.4f} ms ({wide['bound_by']})")
        out[name] = dict(max_abs_err=habs, wide_ms=ms, wide_plain_ms=plain,
                         wide_bound_ms=wide["bound_ms"], library_ms=None)
        del P
    del bins
    # the 16-bit layout of more than 256 bins (float64 cells in feature tiles)
    n16, B16 = min(rows, 1_000_000), 512
    bins = torch.from_numpy(rng.integers(0, B16, size=(n16, F)).astype(np.int32)).to(dev)
    for quantized in (False, True):
        gh = (qg, qh) if quantized else (gd, hd)
        P, kern, ref = hist_rows(bins, gh[0][:n16], gh[1][:n16], seld[:n16], quantized, per=2,
                                 bits=16)
        hk = kern(P, 3, n16, F, B16, 2, 16)
        hr = ref(P, 3, n16, F, B16, 2, 16)
        sync(dev)
        check_mask_hist(f"{kern.__name__} 16-bit", hk, hr)
        ms = burst_ms(lambda: kern(P, 3, n16, F, B16, 2, 16))
        log(f"kernel {kern.__name__} 16-bit ({n16} x {F}, {B16} bins): matches the plain "
            f"version; {ms:.4f} ms")
        del P
    del bins, gd, hd, qg, qh, seld
    phase_hist_edges(dev)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def phase_mask_paths(cov_ds, rows, dev, sel8, sel9, seed=37):
    """B8 and B9 at their paths' shapes, against their plain versions:
    B8 on the covertype cell's 464,809 training rows x 54 features (its
    own bins), B9 on rows x 28 quantized levels of 64 bins, each with
    ``sel8`` / ``sel9`` rows selected at random (the cells' mean selected
    rows per launch in this run).  Returns {name: {ms, single_ms,
    plain_ms, bound, ...}}."""
    import torch

    from lightgbm_tpu_torch.ops import histogram as th

    rng = np.random.default_rng(seed)
    out = {}
    for quantized, n, sel in ((False, cov_ds.num_data, sel8), (True, rows, sel9)):
        if quantized:
            F, B = 28, 64
            bins = torch.from_numpy(rng.integers(0, B, (n, F), dtype=np.uint8)).to(dev)
            g = torch.from_numpy(rng.integers(-15, 16, n).astype(np.int16)).to(dev)
            h = torch.from_numpy(rng.integers(1, 16, n).astype(np.int16)).to(dev)
        else:
            F, B = cov_ds.num_features, int(cov_ds.max_num_bin)
            bins = torch.from_numpy(cov_ds.binned).to(dev)
            g = torch.from_numpy(rng.standard_normal(n, dtype=np.float32)).to(dev)
            h = torch.from_numpy(rng.random(n, dtype=np.float32)).to(dev)
        mask = np.zeros(n, np.float32)
        mask[rng.permutation(n)[:sel]] = 1.0
        P, kern, ref = hist_rows(bins, g, h, torch.from_numpy(mask).to(dev), quantized)
        del bins, g, h
        name = kern.__name__
        hk = kern(P, 0, n, F, B)
        hr = ref(P, 0, n, F, B)
        sync(dev)
        habs = check_mask_hist(f"{name} at its path's shape", hk, hr)
        ms = burst_ms(lambda: kern(P, 0, n, F, B))
        single = time_cuda(lambda: kern(P, 0, n, F, B), 10)
        plain = time_cuda(lambda: ref(P, 0, n, F, B), 3)
        res = finish_bounds({"x": dict(hist_work(n, sel, th.num_words(F, 4), F, B),
                                       max_abs_err=habs, ms=ms, single_ms=single,
                                       plain_ms=plain, library_ms=None)})["x"]
        log(f"kernel {name} at its path's shape ({n} x {F}, {B} bins, {sel} rows selected): "
            f"{ms:.4f} ms (single {single:.4f}), plain "
            f"{plain:.2f} ms, bound {res['bound_ms']:.4f} ms ({res['bound_by']}), max abs err "
            f"{habs:.3e}")
        res.update(path_rows=n, path_selected=sel)
        out[name] = res
        del P
        torch.cuda.empty_cache()
    return out


def model_splits(text):
    """Per tree: (split_feature, threshold, split_gain) lists."""
    trees, cur = [], {}
    for line in text.splitlines():
        for key in ("split_feature", "threshold", "split_gain"):
            if line.startswith(key + "="):
                cur[key] = line.split("=", 1)[1].split()
        if line.startswith("shrinkage=") and cur:
            trees.append(cur)
            cur = {}
    return trees


# the small checks' CPU halves that need nothing of the card's run go to
# this many spawned worker processes, one torch thread each, which train
# while the card trains; meanwhile this process keeps SMALL_MAIN_THREADS
# torch threads, so that with the background data thread no core is
# oversubscribed (with all 8, beside the workers and that thread, the
# K=7 CPU half of phase_small_multi ran 7.5 times slower)
CPU_WORKERS, CPU_WORKER_THREADS, SMALL_MAIN_THREADS = 2, 1, 4
SMALL_SWITCH_S = 0.0005  # the GIL's switch interval meanwhile (Python's default 0.005)
_CPU_DATA = {}


def _cpu_worker_init(here, threads):
    """A CPU-half worker's start: the repo importable, few torch threads."""
    import torch

    if here not in sys.path:
        sys.path.insert(0, here)
    torch.set_num_threads(threads)


def _cpu_data(key, small_rows):
    """(the Dataset, the rows to predict) of a small check, made in the
    worker from the seeds the card's half uses: "small" (phase_small's
    rows, binned with TRAIN_PARAMS first as there), "small_l2" (its L2
    targets), "sampled", "cov" (COV_SMALL_ROWS Covertype-shaped rows) and
    "rank" (RANK_SMALL_QUERIES mslr-web10k-shaped queries).  Cached."""
    import lightgbm_tpu_torch as lgt

    if key not in _CPU_DATA:
        if key == "small":
            X, y = make_higgs_shaped(small_rows, seed=3)
            ds = lgt.Dataset(X, label=y)
            ds.construct(TRAIN_PARAMS)
            X = ds.data  # what phase_small_mask and phase_small_objectives read
        elif key == "small_l2":
            X = _cpu_data("small", small_rows)[0].data
            ds = lgt.Dataset(X, label=small_l2_targets(X))
        elif key == "sampled":
            X, y = make_higgs_shaped(small_rows, seed=5)
            ds = lgt.Dataset(X, label=y)
        elif key == "cov":
            Xc, yc = make_covertype_shaped()
            X = Xc[:COV_SMALL_ROWS]
            ds = lgt.Dataset(X, label=yc[:COV_SMALL_ROWS])
        else:
            X, y, sizes = make_mslr_shaped(RANK_SMALL_QUERIES, seed=51)
            ds = lgt.Dataset(X, label=y, group=sizes)
        _CPU_DATA[key] = (ds, X if key == "rank" else X[:50_000])
    return _CPU_DATA[key]


def _cpu_half(case, small_rows):
    """The CPU half of one small card-vs-CPU check, in a worker process:
    ``case`` (data key, params, iterations, the grower it must take:
    "fused", "mask" or None, whether to return the bagging draws)
    trained with device="cpu" (the plain versions).  Returns the model
    text, the predictions, the seconds, the launch counts and the draws."""
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.ops import pkernels as pk

    key, params, iters, grower, draws = case
    ds, rows = _cpu_data(key, small_rows)
    t0 = time.perf_counter()
    pk.reset_launch_counts()
    bst = lgt.train(params, ds, iters, device="cpu")
    out = dict(seconds=time.perf_counter() - t0, counts=pk.launch_counts(),
               text=bst.model_to_string(), pred=bst.predict(rows))
    pt = bst.boosting.ptrainer
    assert grower != "mask" or pt is None, f"{key}: the CPU run did not take the mask grower"
    assert grower != "fused" or pt is not None, f"{key}: the CPU run left the fused path"
    if draws:
        out["draws"] = [tuple(None if d is None else d.numpy() for d in pt._draws(it))
                        for it in range(iters)]
    return out


def small_cpu_cases():
    """{name: case} of the small checks whose CPU halves run in the
    workers (phase_small_sampled, phase_small_mask,
    phase_small_objectives, phase_small_rank)."""
    mask = dict(num_leaves=SMALL_MASK_LEAVES)
    check = dict(num_leaves=SMALL_CHECK_LEAVES)
    cases = {
        "bagging": ("sampled", dict(BAG_PARAMS, learning_rate=0.5, **check),
                    SMALL_SAMPLED_ITERS, None, True),
        "goss": ("sampled", dict(GOSS_PARAMS, learning_rate=0.5, **check), SMALL_GOSS_ITERS,
                 None, False),
        "quantized binary": ("small", dict(QUANT_PARAMS, **mask), SMALL_MASK_ITERS, "mask",
                             False),
        "quantized l2": ("small_l2", dict(QUANT_PARAMS, objective="regression", **mask),
                         SMALL_MASK_ITERS, "mask", False),
        "multiclass goss": ("cov", dict(COV_GOSS_PARAMS, learning_rate=0.5, **mask),
                            SMALL_GOSS_ITERS, "mask", False),
        "huber goss": ("small", dict(GOSS_PARAMS, objective="huber", huber_delta=0.3,
                                     learning_rate=0.5, **check), SMALL_GOSS_ITERS, "fused",
                       False),
        "lambdarank": ("rank", dict(RANK_PARAMS, metric="none"), RANK_SMALL_ITERS, "mask",
                       False),
    }
    for name, extra in OBJ_KINDS:
        cases[name] = ("small", dict(TRAIN_PARAMS, objective=name, **extra, **check),
                       SMALL_OBJ_ITERS, "fused", False)
    return cases


def start_small_cpu(small_rows):
    """Spawn the CPU-half workers and hand them every case of
    small_cpu_cases.  Returns (the pool, {name: future})."""
    import multiprocessing

    pool = concurrent.futures.ProcessPoolExecutor(
        CPU_WORKERS, mp_context=multiprocessing.get_context("spawn"),
        initializer=_cpu_worker_init, initargs=(HERE, CPU_WORKER_THREADS))
    futures = {name: pool.submit(_cpu_half, case, small_rows)
               for name, case in small_cpu_cases().items()}
    return pool, futures


def cpu_result(cpu, name, what, rows):
    """The worker's CPU half of check ``name``, logged as the card's half
    is; ``what`` names the rows and ``rows`` their count."""
    r = cpu[name].result()
    log(f"small {name} cpu: {rows} {what}, {r['seconds']:.1f} s (a CPU-half worker); "
        f"launches {json.dumps({k: v for k, v in r['counts'].items() if v})}")
    return r


def small_l2_targets(X):
    """phase_small_mask's L2 targets of phase_small's rows."""
    return (X[:, 0] - 0.5 * X[:, 1] + 0.3 * X[:, 2] * X[:, 3]).astype(np.float32)


def phase_small(rows, iters, dev):
    """The same training on the card and on the CPU (plain versions), from
    one binned Dataset.  Returns (X, y, the Dataset, {"cuda": booster,
    "cpu": booster}) for the API phase."""
    import lightgbm_tpu_torch as lgt

    X, y = make_higgs_shaped(rows, seed=3)
    Xv, yv = make_higgs_shaped(50_000, seed=4)
    out, boosters = {}, {}
    ds = lgt.Dataset(X, label=y)  # binned once, on the host, for both
    for name, d in (("cuda", dev), ("cpu", "cpu")):
        t0 = time.perf_counter()
        bst = lgt.train(TRAIN_PARAMS, ds, iters, device=d)
        boosters[name] = bst
        p = bst.predict(Xv)
        out[name] = (bst.model_to_string(), p, auc(yv, p))
        log(f"small {name}: {rows}x28, {iters} iterations, {time.perf_counter() - t0:.1f} s, "
            f"AUC {out[name][2]:.6f}")
    ndiff = compare_models("small cuda vs cpu", out["cpu"][0], out["cuda"][0])
    dpred = float(np.abs(out["cuda"][1] - out["cpu"][1]).max())
    dauc = abs(out["cuda"][2] - out["cpu"][2])
    log(f"small cuda vs cpu: {ndiff} split differences, max |dpred| {dpred:.3e} (tol 1e-3), "
        f"|dAUC| {dauc:.3e} (tol 1e-3)")
    assert dpred <= 1e-3 and dauc <= 1e-3
    return X, y, ds, boosters


def phase_small_sampled(rows, dev, cpu):
    """Bagging with feature_fraction, and GOSS, on the card and on the CPU
    (plain versions, in a CPU-half worker: ``cpu``) at learning_rate 0.5,
    SMALL_CHECK_LEAVES leaves: the same trees (or a first differing split
    that is a near-tie), and the same bagging masks."""
    import torch

    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.ops import pkernels as pk

    X, y = make_higgs_shaped(rows, seed=5)
    ds = lgt.Dataset(X, label=y)
    cases = small_cpu_cases()
    # bagging redraws at iteration bagging_freq = 5, so it runs 6; GOSS 4
    for name in ("bagging", "goss"):
        _, params, iters, _, _ = cases[name]
        t0 = time.perf_counter()
        pk.reset_launch_counts()
        bst = lgt.train(params, ds, iters, device=dev)
        log(f"small {name} cuda: {rows}x28, {iters} iterations, "
            f"{time.perf_counter() - t0:.1f} s; update_channels launches "
            f"{pk.launch_counts()['update_channels']}")
        ref = cpu_result(cpu, name, "rows x 28", rows)
        ndiff = compare_models(f"small {name} cuda vs cpu", ref["text"],
                               bst.model_to_string())
        dpred = float(np.abs(bst.predict(X[:50_000]) - ref["pred"]).max())
        log(f"small {name} cuda vs cpu: {ndiff} split differences, max |dpred| {dpred:.3e} "
            f"(tol 1e-3)")
        assert dpred <= 1e-3
        if name == "bagging":
            pt = bst.boosting.ptrainer
            same = all(torch.equal(pt._draws(it)[0].cpu(), torch.from_numpy(ref["draws"][it][0]))
                       and torch.equal(pt._draws(it)[1].cpu(),
                                       torch.from_numpy(ref["draws"][it][1]))
                       for it in range(iters))
            log(f"small bagging: bagging and feature masks of all {iters} iterations equal on "
                f"the card and the CPU: {same}")
            assert same, "the card's bagging masks differ from the CPU's"


def phase_small_mask(small_ds, Xc, yc, dev, cpu):
    """The mask grower on the card and on the CPU (plain versions, in a
    CPU-half worker: ``cpu``): quantized binary (on phase_small's binned
    Dataset) and quantized L2 on its rows x 28, and multiclass GOSS on
    COV_SMALL_ROWS Covertype-shaped rows (K=7, learning_rate 0.5: 2
    warm-up and 2 sampled iterations); 31 leaves.  The same trees (or a
    first differing split that is a near-tie) and predictions within
    1e-3."""
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.ops import pkernels as pk

    X = small_ds.data
    cases = small_cpu_cases()
    data = {"quantized binary": (X, small_ds, "hist_segment_q"),
            "quantized l2": (X, lgt.Dataset(X, label=small_l2_targets(X)), "hist_segment_q"),
            "multiclass goss": (Xc[:COV_SMALL_ROWS], lgt.Dataset(
                Xc[:COV_SMALL_ROWS], label=yc[:COV_SMALL_ROWS]), "hist_segment")}
    for name, (Xs, ds, kernel) in data.items():
        _, params, iters, _, _ = cases[name]
        t0 = time.perf_counter()
        pk.reset_launch_counts()
        bst = lgt.train(params, ds, iters, device=dev)
        assert bst.boosting.ptrainer is None, f"{name} did not take the mask grower"
        text, pred = bst.model_to_string(), bst.predict(Xs[:50_000])
        log(f"small {name} cuda: {len(Xs)} rows, {iters} iterations, "
            f"{time.perf_counter() - t0:.1f} s; {kernel} launches "
            f"{pk.launch_counts()[kernel]}")
        ref = cpu_result(cpu, name, "rows", len(Xs))
        ndiff = compare_models(f"small {name} cuda vs cpu", ref["text"], text)
        dpred = float(np.abs(pred - ref["pred"]).max())
        log(f"small {name} cuda vs cpu: {ndiff} split differences, max |dpred| {dpred:.3e} "
            f"(tol 1e-3); model text byte-identical {text == ref['text']}")
        assert dpred <= 1e-3


def phase_small_objectives(ds, dev, cpu):
    """Each regression objective on the fused path, on phase_small's binned
    Dataset (the Higgs 0/1 targets as regression targets, TRAIN_PARAMS at
    SMALL_CHECK_LEAVES leaves, SMALL_OBJ_ITERS iterations), then Huber
    with GOSS at learning_rate 0.5 (update_channels from iteration 2 on),
    on the card and on the CPU (plain versions, in a CPU-half worker:
    ``cpu``): 0 differing splits (both sides take the correctly rounded
    exp, no FMA, histograms rounded once) and predictions within 1e-3."""
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.ops import pkernels as pk

    X, rows = ds.data, ds.num_data()
    cases = small_cpu_cases()
    for name in [n for n, _ in OBJ_KINDS] + ["huber goss"]:
        _, params, n_iter, _, _ = cases[name]
        t0 = time.perf_counter()
        pk.reset_launch_counts()
        bst = lgt.train(params, ds, n_iter, device=dev)
        assert bst.boosting.ptrainer is not None, f"{name} left the fused path"
        counts = pk.launch_counts()
        text, pred = bst.model_to_string(), bst.predict(X[:50_000])
        log(f"small {name} cuda: {rows}x28, {n_iter} iterations, "
            f"{time.perf_counter() - t0:.1f} s; update_and_root_hist launches "
            f"{counts['update_and_root_hist']}, update_channels {counts['update_channels']}")
        if dev.type == "cuda" and "goss" in name:
            assert counts["update_channels"] > 0, "GOSS ran no update_channels"
        ref = cpu_result(cpu, name, "rows x 28", rows)
        ndiff = compare_models(f"small {name} cuda vs cpu", ref["text"], text)
        dpred = float(np.abs(pred - ref["pred"]).max())
        same = trees_text(text) == trees_text(ref["text"])
        log(f"small {name} cuda vs cpu: {ndiff} split differences, max |dpred| {dpred:.3e} "
            f"(tol 1e-3); model text byte-identical {same}")
        assert ndiff == 0, f"small {name}: the card's splits differ from the CPU's"
        assert dpred <= 1e-3


def phase_small_rank(dev, cpu):
    """Lambdarank on the mask grower, RANK_SMALL_QUERIES queries of the
    mslr-web10k-shaped data (~20k documents), on the card and on the CPU
    (plain versions, in a CPU-half worker: ``cpu``): the same trees or a
    first differing split that is a near-tie (the pair sums' float order
    differs between the two), and predictions within 1e-3."""
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.ops import pkernels as pk

    X, y, sizes = make_mslr_shaped(RANK_SMALL_QUERIES, seed=51)
    ds = lgt.Dataset(X, label=y, group=sizes)
    _, params, iters, _, _ = small_cpu_cases()["lambdarank"]
    t0 = time.perf_counter()
    pk.reset_launch_counts()
    bst = lgt.train(params, ds, iters, device=dev)
    assert bst.boosting.ptrainer is None, "lambdarank left the mask grower"
    text, pred = bst.model_to_string(), bst.predict(X)
    log(f"small lambdarank cuda: {len(y)} documents in {len(sizes)} queries, "
        f"{iters} iterations, {time.perf_counter() - t0:.1f} s; hist_segment "
        f"launches {pk.launch_counts()['hist_segment']}")
    ref = cpu_result(cpu, "lambdarank", "documents", len(y))
    ndiff = compare_models("small lambdarank cuda vs cpu", ref["text"], text)
    dpred = float(np.abs(pred - ref["pred"]).max())
    log(f"small lambdarank cuda vs cpu: {ndiff} split differences, max |dpred| {dpred:.3e} "
        f"(tol 1e-3)")
    assert dpred <= 1e-3


def phase_small_api(small, multi_boosters, dev):
    """The API's new paths on the card and on the CPU (plain versions), on
    phase_small's --small-rows x 28 rows and boosters (TRAIN_PARAMS,
    --small-iters iterations) and phase_small_multi's K=7 boosters:
    init_model continuation (API_SMALL_ITERS more iterations), an
    LGBMClassifier fit whose model text must equal lgt.train's, DART on
    the mask grower (SMALL_MASK_LEAVES leaves, drop indices equal each
    iteration), and rollback_one_iter then update() on the fused path at
    K=1 (the delta off the band through score_add) and K=7 (the band
    rewritten).  Each card-vs-CPU check: 0 differing splits or a first
    differing split that is a near-tie.  Returns the card's launch
    counts of these paths."""
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.ops import pkernels as pk

    X, y, ds, boosters = small
    counts = []

    def both(name, fn, required=()):
        out = {}
        for where, d in (("cuda", dev), ("cpu", "cpu")):
            t0 = time.perf_counter()
            if where == "cuda":
                out[where], c = driven(f"small {name}", lambda: fn(where, d), required)
                counts.append(c)
            else:
                out[where] = fn(where, d)
            log(f"small {name} {where}: {time.perf_counter() - t0:.1f} s")
        return out

    # init_model: phase_small's boosters continued
    cont = both("init_model", lambda where, d: lgt.train(
        TRAIN_PARAMS, ds, API_SMALL_ITERS, init_model=boosters[where],
        device=d), ("update_and_root_hist", "score_add"))
    texts = {w: b.model_to_string() for w, b in cont.items()}
    ndiff = compare_models("small init_model cuda vs cpu", texts["cpu"], texts["cuda"])
    first = trees_text(boosters["cuda"].model_to_string())
    log(f"small init_model: {cont['cuda'].current_iteration()} iterations, {ndiff} split "
        f"differences; the initial model's trees kept: "
        f"{trees_text(cont['cuda'].model_to_string(len(model_splits(first)))) == first}")
    assert trees_text(cont["cuda"].model_to_string(len(model_splits(first)))) == first

    # LGBMClassifier with TRAIN_PARAMS: lgt.train's model text
    clf = lgt.LGBMClassifier(**SKLEARN_PARAMS, n_estimators=len(model_splits(first)),
                             device=dev).fit(X, y)
    same = clf.booster_.model_to_string() == boosters["cuda"].model_to_string()
    log(f"small LGBMClassifier on the card: model text equal to lgt.train's: {same}")
    assert same, "LGBMClassifier's model differs from lgt.train's"

    # DART on the mask grower, one update at a time
    def dart(where, d):
        b = lgt.Booster(SMALL_DART_PARAMS, ds, device=d)
        drops = []
        for _ in range(SMALL_DART_ITERS):
            b.update()
            drops.append(list(b.boosting.drop_index))
        return b, drops

    dd = both("dart", dart, ("hist_segment",))
    assert dd["cuda"][0].boosting.ptrainer is None
    ndiff = compare_models("small dart cuda vs cpu", dd["cpu"][0].model_to_string(),
                           dd["cuda"][0].model_to_string())
    log(f"small dart: drop indices by iteration {dd['cuda'][1]} on the card, equal on the CPU: "
        f"{dd['cuda'][1] == dd['cpu'][1]}; {ndiff} split differences")
    assert dd["cuda"][1] == dd["cpu"][1], "DART's drops differ between the card and the CPU"
    assert any(dd["cuda"][1]), "no tree was dropped"

    # rollback then update, K=1 and K=7, on the boosters trained above
    for name, bsts in (("binary", boosters), ("multiclass", multi_boosters)):
        def roll(where, d, bsts=bsts):
            b = bsts[where]
            pt = b.boosting.ptrainer
            b.rollback_one_iter()
            dirty = pt.score_dirty
            b.update()
            return b, dirty

        rr = both(f"rollback {name}", roll, ("score_add",))
        ndiff = compare_models(f"small rollback {name} cuda vs cpu",
                               rr["cpu"][0].model_to_string(), rr["cuda"][0].model_to_string())
        log(f"small rollback {name}: band rewritten (K > 1) {rr['cuda'][1]}; {ndiff} split "
            f"differences after the update")
        assert rr["cuda"][1] == (name == "multiclass")
    return counts


def near_tie(ga, gb):
    """Two split gains are a near-tie when they agree within 1e-3
    relative.  Returns (near-tie, relative difference)."""
    rel = abs(ga - gb) / max(abs(ga), abs(gb), 1e-30)
    return rel <= 1e-3, rel


def trees_text(text):
    """A model's text without its feature importances, which count the
    splits of every tree the booster holds even when ``num_iteration``
    cuts the trees written (as the JAX package does)."""
    return text.split("feature importances:")[0]


def tree_blocks(text):
    """A model's trees as text, without its header (a model loaded from
    text writes no feature_infos) and its feature importances."""
    return trees_text(text)[text.index("Tree=0"):]


def compare_models(what, text_a, text_b):
    """Split differences of two models' trees; the first differing split
    must be a near-tie.  Returns the number of differing splits."""
    ta, tb = model_splits(text_a), model_splits(text_b)
    assert len(ta) == len(tb), f"{what}: {len(ta)} vs {len(tb)} trees"
    ndiff, first = 0, None
    for ti, (a, b) in enumerate(zip(ta, tb)):
        for i, fa, fb, xa, xb in zip(range(10**9), a["split_feature"], b["split_feature"],
                                     a["threshold"], b["threshold"]):
            if (fa, xa) != (fb, xb):
                ndiff += 1
                if first is None:
                    first = (ti, i, float(a["split_gain"][i]), float(b["split_gain"][i]))
    if first is not None:
        ti, i, ga, gb = first
        ok, rel = near_tie(ga, gb)
        log(f"{what}: first differing split: tree {ti} node {i}, gains {ga!r} vs {gb!r} "
            f"(rel {rel:.3e}); near-tie: {ok}")
        assert ok, f"{what}: a split differs and is not a near-tie"
    return ndiff


def phase_small_multi(X, y, rows, iters, dev):
    """Multiclass on Covertype-shaped rows, on the card and on the CPU
    (plain versions): splits, probabilities and multi_logloss agree."""
    import lightgbm_tpu_torch as lgt

    Xv, yv = X[-50_000:], y[-50_000:]
    out, boosters = {}, {}
    ds = lgt.Dataset(X[:rows], label=y[:rows])
    params = dict(COV_PARAMS, num_leaves=SMALL_CHECK_LEAVES)
    for name, d in (("cuda", dev), ("cpu", "cpu")):
        t0 = time.perf_counter()
        bst = lgt.train(params, ds, iters, device=d)
        boosters[name] = bst
        prob = bst.predict(Xv)
        out[name] = (bst.model_to_string(), prob, multi_logloss(yv, prob))
        log(f"small multiclass {name}: {rows}x54, K=7, {SMALL_CHECK_LEAVES} leaves, {iters} "
            f"iterations, "
            f"{time.perf_counter() - t0:.1f} s, multi_logloss {out[name][2]:.6f}")
    ndiff = compare_models("small multiclass cuda vs cpu", out["cpu"][0], out["cuda"][0])
    dprob = float(np.abs(out["cuda"][1] - out["cpu"][1]).max())
    dll = abs(out["cuda"][2] - out["cpu"][2])
    log(f"small multiclass cuda vs cpu: {ndiff} split differences, max |dprob| {dprob:.3e} "
        f"(tol 1e-3), |d multi_logloss| {dll:.3e} (tol 1e-3)")
    assert dprob <= 1e-3 and dll <= 1e-3
    return boosters


def _tree_splits(res):
    """(feature, threshold bin, gain) per split of a PTreeResult."""
    res = res.to_host()
    n = res.num_splits
    return list(zip(res.rec_feat[:n].tolist(), res.rec_thr[:n].tolist(),
                    res.rec_gain[:n].tolist()))


def phase_covertype(ds, Xv, yv, iters, dev):
    """The multiclass main path at full width ("covertype-581k").
    Returns the launch counts of its two counted paths."""
    import torch

    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.ops import pkernels as pk
    from lightgbm_tpu_torch.ops.pgrow import grow_tree_partitioned

    bds = ds.construct(COV_PARAMS)
    sizes = sorted(len(g) for g in bds.bundle.groups)
    log(f"covertype: bundle of {bds.bundle.num_cols} columns (group sizes {sizes}), "
        f"max {bds.bundle.max_col_bin} bins per column")
    assert bds.bundle.num_cols == 12 and sizes == [1] * 10 + [4, 40], "unexpected bundling"

    def run(params, n_iter):
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        bst = lgt.train(params, ds, n_iter, device=dev)
        sync(dev)
        return bst, time.perf_counter() - t

    (bst, wall), counts = driven("covertype-581k", lambda: run(COV_PARAMS, iters),
                                 ("update_multi_and_hists", "level_stream", "split_stream",
                                  "score_add"))
    pt = bst.boosting.ptrainer
    its = pt.iter_seconds
    s_iter = float(np.median(its[1:])) if len(its) > 1 else float(its[0])
    chunk_wall, n_done = pt.chunk_seconds[-1]
    prob = bst.predict(Xv)
    ll = multi_logloss(yv, prob)
    acc = float(np.mean(np.argmax(prob, axis=1) == yv))
    peak = torch.cuda.max_memory_allocated() / 2**30 if dev.type == "cuda" else float("nan")
    pool = graph_pool_gib(pt)
    log(f"covertype: {iters} iterations ({bst.num_trees} trees) in {wall:.2f} s; s/iter "
        f"{s_iter:.4f} (iter_seconds, median after the first; first {its[0]:.3f} s); the "
        f"chunk's wall over its iterations {chunk_wall / n_done:.4f} s; held-out "
        f"multi_logloss {ll:.6f} (prior entropy {prior_entropy():.6f}), accuracy {acc:.6f}; "
        f"peak device memory {peak:.2f} GiB; {len(pt.trees.graphs)} tree graphs, their "
        f"shared pool {'not found' if pool is None else f'{pool:.3f} GiB'}")
    steps, t = {"train": round(wall, 2)}, time.perf_counter()
    syncs = fused_grower_syncs(pt, dev)
    costs = tree_costs(pt, dev)
    steps["syncs_and_replays"], t = round(time.perf_counter() - t, 2), time.perf_counter()
    assert prob.shape == (len(yv), 7) and np.all(np.isfinite(prob))
    assert ll < prior_entropy(), "held-out multi_logloss is not below the class prior's"
    # one iteration is 7 trees, as many launches as ~7 binary iterations
    # (the profiler's processing of a two-iteration window took ~40 s; a
    # window that loses B2's one launch records 0 of 1, which
    # profile_iters logs, and B2's device time is then not measured)
    prof = profile_iters(ds, dev, COV_PARAMS, n_iter=1, bst=bst) if dev.type == "cuda" else None
    steps["profile"], t = round(time.perf_counter() - t, 2), time.perf_counter()

    # one-vs-all at SMALL_CHECK_LEAVES leaves: its K=7 tree graphs' capture,
    # ~30 s at 255 leaves, scales with the leaves' fixed steps
    ova_params = dict(COV_PARAMS, objective="multiclassova", num_leaves=SMALL_CHECK_LEAVES)
    (ova, wall), _ = driven("covertype-581k one-vs-all", lambda: run(ova_params, 2),
                            ("update_multi_and_hists", "level_stream", "score_add"))
    pv = ova.predict(Xv)
    log(f"covertype one-vs-all: {SMALL_CHECK_LEAVES} leaves, 2 iterations in {wall:.2f} s; "
        f"held-out accuracy "
        f"{float(np.mean(np.argmax(pv, axis=1) == yv)):.6f}")
    assert pv.shape == (len(yv), 7) and np.all(np.isfinite(pv))
    del ova
    steps["one_vs_all"], t = round(time.perf_counter() - t, 2), time.perf_counter()

    # one tree from the trained state: its root histogram from
    # update_multi_and_hists (class 0), then built by the grower itself
    pt._canonical_order()
    lay, params = pt.layout, pt.params
    p, hists = pk.update_multi_and_hists(pt.p.clone(), lay, pt.objective, num_rows=pt.num_rows,
                                         num_features=params.cols, num_bins=params.bins_hist,
                                         bits=params.bits)
    args = (pt.feature_mask, pt.meta, pt.hyper)
    want, _ = grow_tree_partitioned(p.clone(), *args, params, hists[0], rows=lay.class_rows(0),
                                    bmeta=pt.bmeta)

    def grow_without_root():
        return [grow_tree_partitioned(p.clone(), *args, params._replace(levelwise=lw), None,
                                      rows=lay.class_rows(0), bmeta=pt.bmeta)[0]
                for lw in (True, False)]

    got, c_root = driven("root_hist=None", grow_without_root, ("hist_segments", "hist_dyn"))
    for what, res in zip(("hist_segments (level grower on)", "hist_dyn (level grower off)"),
                         got):
        a, b = _tree_splits(want), _tree_splits(res)
        first = next((i for i, (x, y) in enumerate(zip(a, b)) if x[:2] != y[:2]), None)
        log(f"root_hist=None via {what}: {int(res.num_splits)} splits vs {int(want.num_splits)}; "
            f"first differing split: {first}")
        if first is not None:
            ok, rel = near_tie(a[first][2], b[first][2])
            log(f"  gains {a[first][2]!r} vs {b[first][2]!r} (rel {rel:.3e}); near-tie: {ok}")
            assert ok, f"root_hist=None via {what}: a split differs beyond a near-tie"
        else:
            assert int(res.num_splits) == int(want.num_splits)
    steps["root_hist_none"] = round(time.perf_counter() - t, 2)
    log(f"covertype: seconds by step {json.dumps(steps)}")
    del bst, pt, p, hists
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return [counts, c_root], dict(s_iter=s_iter, logloss=ll, accuracy=acc, peak_gib=peak,
                                  profile=prof, syncs=syncs, tree_ms=costs, pool_gib=pool)


# the device kernel that each counted wrapper launches once a call, as
# the profiler names it; hist_segment's also counts hist_dyn's launches
# (hist_segments launches it once a segment)
RECORDED_AS = {
    "update_and_root_hist": "upd_hist_kernel<lgbt::SingleUpd",
    "update_multi_and_hists": "upd_hist_kernel<lgbt::MultiUpd",
    "level_stream": "part_scatter_kernel<1>",
    "split_stream": "part_scatter_kernel<2>",
    "score_add": "score_add_kernel",
    "update_channels": "update_channels_kernel<",
    "hist_segment": "seg_hist_kernel<false,",
    "hist_segment_q": "seg_hist_kernel<true,",
}


def profile_iters(ds, dev, params=TRAIN_PARAMS, n_iter=3, top=12, bst=None):
    """Device busy share of steady training iterations, and the device
    time by kernel, from torch.profiler.  The first iteration runs before
    the window (or ``bst``, a booster already trained on the card, goes
    on: its tree graphs are captured); the window ends in a synchronize."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.ops import pkernels as pk

    own = bst is None
    if own:
        bst = lgt.Booster(params, ds, device=dev)
        bst.boosting.train_iters(1)
    sync(dev)
    # the device's activity only: host-side events would triple what the
    # tables below have to sort, and the wall clock gives the host's time
    before = {k.__name__: k.launches for k in pk.KERNELS}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        bst.boosting.train_iters(n_iter)
        sync(dev)
        wall_us = (time.perf_counter() - t) * 1e6
    ran = {k.__name__: k.launches - before[k.__name__] for k in pk.KERNELS}

    def dev_us(e):
        return e.self_device_time_total

    t = time.perf_counter()
    # device-side events only (kernels, copies, memsets): a host op's own
    # device total would count its kernels a second time
    evs = sorted(device_events(prof), key=dev_us, reverse=True)
    busy = sum(dev_us(e) for e in evs)
    if busy == 0:
        log("profile: the profiler recorded no device time; busy share not measured")
        return None
    log(f"profile: {n_iter} iterations, wall {wall_us / 1e3:.1f} ms, device busy "
        f"{busy / 1e3:.1f} ms ({100 * busy / wall_us:.1f}%), idle {100 - 100 * busy / wall_us:.1f}% "
        f"(the profiler's tables took {time.perf_counter() - t:.1f} s); "
        f"{sum(e.count for e in evs) / n_iter:.0f} device operations per iteration")
    for e in evs[:top]:
        log(f"  {dev_us(e) / 1e3:9.2f} ms {e.count:7d} calls  {e.key[:90]}")
    # the partition kernels by form (csrc/partition_hist.cu PartForm):
    # <1> level_stream's table, <2> split_stream given device scalars, <0>
    # split_stream given host ints; and their plan kernel
    part = {form: sum(dev_us(e) for e in evs if "part_" in e.key and f"<{form}>" in e.key)
            for form in "012"}
    plan = sum(dev_us(e) for e in evs if "part_plan_kernel" in e.key)
    log(f"profile: partition kernels an iteration: level_stream {part['1'] / 1e3 / n_iter:.2f} "
        f"ms, split_stream {(part['2'] + part['0']) / 1e3 / n_iter:.2f} ms, their plans "
        f"{plan / 1e3 / n_iter:.2f} ms of {busy / 1e3 / n_iter:.2f} ms busy")
    # each wrapper's launches that the window recorded (the launches of
    # the one kernel RECORDED_AS names) against those its counter saw
    recorded = {name: sum(e.count for e in evs if key in e.key)
                for name, key in RECORDED_AS.items()}
    ran["hist_segment"] += ran["hist_dyn"]
    if ran["hist_segments"]:  # a launch a segment: not comparable
        del recorded["hist_segment"]
    gaps = {k: f"{recorded[k]} of {ran[k]}" for k in recorded if recorded[k] != ran[k]}
    log(f"profile: launches recorded against launches counted: "
        + (f"MISMATCH {json.dumps(gaps)}" if gaps else "all equal") + " "
        + json.dumps({k: [recorded[k], ran[k]] for k in recorded}))
    # a wrapper's device time in the window: its kernels' recorded sum
    # over the recorded calls and over the iterations.  csrc/segment_hist.cu
    # (both launches of a call): a first template argument true is
    # hist_segment_q, false the float histograms (hist_segment, hist_dyn,
    # hist_segments).  csrc/update_hist.cuh by update policy: a call is
    # one upd_hist_kernel (and, feature-tiled, one upd_only_kernel first)
    seg = {}
    for name, key, parts in (
            ("float", "hist_segment", ("seg_hist_kernel<false", "seg_compact_kernel<false")),
            ("quantized", "hist_segment_q", ("seg_hist_kernel<true", "seg_compact_kernel<true")),
            ("update_and_root_hist", "update_and_root_hist", ("SingleUpd",)),
            ("update_multi_and_hists", "update_multi_and_hists", ("MultiUpd",))):
        ms = sum(dev_us(e) for e in evs if any(x in e.key for x in parts)) / 1e3
        calls = sum(e.count for e in evs if RECORDED_AS[key] in e.key)
        # a kernel the window recorded no call of has no device time here
        # (None: not measured), not 0
        seg[name] = dict(ms_iter=ms / n_iter if calls else None, calls=calls, ran=ran[key],
                         ms_call=ms / calls if calls else None)
        if calls:
            log(f"profile: {name}: {ms / n_iter:.4f} ms an iteration over {calls} recorded "
                f"calls ({ran[key]} counted), {ms / calls:.4f} ms a call")
    if own:
        del bst
        torch.cuda.empty_cache()
    return seg


def device_window(w):
    """A kernel's numbers from its cell's profile window, as the window
    recorded them: device ms an iteration (the recorded sum over the
    window's iterations) and a launch (over the recorded launches), and
    the launches recorded beside those counted."""
    return dict(device_ms_per_iter=w["ms_iter"], device_ms_per_launch=w["ms_call"],
                device_launches_recorded=w["calls"], device_launches_counted=w["ran"])


def _is_sync(w) -> bool:
    """A warning of sync debug mode "warn" for one synchronizing call (its
    first use in a process also warns that the mode is a prototype)."""
    text = str(w.message)
    return "synchroniz" in text and "debug mode" not in text


def count_syncs(fn):
    """(fn's result, the host syncs PyTorch reported while it ran): sync
    debug mode "warn", one warning a synchronizing call."""
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            res = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return res, sum(_is_sync(w) for w in caught)


def traced_iterations(fn):
    """Run ``fn`` (training on the card) in sync debug mode "warn", noting
    each chunk iteration's boundary (PartitionedTrainer's _ChunkRun.mark):
    returns (fn's result, one row per iteration: {kernel: launches} and
    host syncs, the host syncs after the last boundary (the chunk's read),
    all the run's host syncs)."""
    import warnings

    import torch

    from lightgbm_tpu_torch.boosting import ptrainer
    from lightgbm_tpu_torch.ops import pkernels as pk

    marks, mark = [], ptrainer._ChunkRun.mark

    def noted(run, t):
        marks.append((t, {k.__name__: k.launches for k in pk.KERNELS}, len(caught)))
        mark(run, t)

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        ptrainer._ChunkRun.mark = noted
        torch.cuda.set_sync_debug_mode("warn")
        try:
            res = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
            ptrainer._ChunkRun.mark = mark
    syncs = [i for i, w in enumerate(caught) if _is_sync(w)]
    rows = []
    for (t, la, wa), (u, lb, wb) in zip(marks, marks[1:]):
        if u == t + 1:
            rows.append(dict(launches={k: lb[k] - la[k] for k in la if lb[k] != la[k]},
                             syncs=sum(wa <= i < wb for i in syncs)))
    end = marks[-1][2] if marks else 0
    return res, rows, sum(i >= end for i in syncs), len(syncs)


def fused_grower_syncs(pt, dev, lr=0.1):
    """One fused tree of every class, replayed from its graph under sync
    debug mode "error" (any host sync raises), and the host syncs of a
    2-iteration chunk.  Returns (syncs a tree, syncs a chunk)."""
    import torch

    from lightgbm_tpu_torch.ops import pkernels as pk

    pt._canonical_order()
    lay, prm = pt.layout, pt.params
    kw = dict(num_rows=pt.num_rows, num_features=prm.cols, num_bins=prm.bins_hist,
              bits=prm.bits)
    if pt.K > 1:
        _, roots = pk.update_multi_and_hists(pt.p, lay, pt.objective, **kw)
    else:
        _, roots = pk.update_and_root_hist(pt.p, lay, pt.objective, **kw)
        roots = roots[None]
    sync(dev)
    torch.cuda.set_sync_debug_mode("error")
    try:
        for k in range(pt.K):
            pt.trees.grow(pt.p, pt.feature_mask, pt.hyper, roots[k],
                          lay.class_rows(k) if pt.K > 1 else None)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    sync(dev)
    _, chunk = count_syncs(lambda: pt.train_chunk(2, lr, 100))
    log(f"fused grower, K={pt.K}: {pt.K} trees replayed under sync debug mode \"error\": 0 host "
        f"syncs a tree; a 2-iteration chunk: {chunk} host sync(s) (one read at its end)")
    return 0, chunk


def traced_syncs(bst, dev, chunk_syncs):
    """fused_grower_syncs again with tracing on (LIGHTGBM_TPU_TRACE's
    tracer), and the host syncs of GBDT.train_iters(2) (the chunk, its
    trees and, with tracing on, its two iter records) with tracing off,
    then on: tracing must add none."""
    from lightgbm_tpu_torch.obs import tracer
    from lightgbm_tpu_torch.obs.report import load_trace

    gbdt = bst.boosting
    _, off = count_syncs(lambda: gbdt.train_iters(2))
    path = os.path.join(HERE, "build", "chip_trace", "syncs.jsonl")
    tracer.configure(path)
    try:
        tree, chunk = fused_grower_syncs(gbdt.ptrainer, dev)
        _, on = count_syncs(lambda: gbdt.train_iters(2))
    finally:
        tracer.close()
    its = [r for r in load_trace(path) if r.get("ev") == "iter"]
    log(f"tracing on: a fused tree replay {tree} host syncs, a 2-iteration chunk {chunk} "
        f"(off: {chunk_syncs}); GBDT.train_iters(2) {on} host syncs (off: {off}), "
        f"{len(its)} iter records, wall_s {[r['wall_s'] for r in its]}")
    assert tree == 0 and chunk == chunk_syncs and on == off and len(its) == 2


def tree_costs(pt, dev):
    """Device ms of one tree's graph replay (class 0) on a fresh root, and
    of the same graph with an all-zero feature mask: no split anywhere,
    so every level and phase-2 step is empty (the fixed cost of the
    tree's static structure)."""
    import torch

    from lightgbm_tpu_torch.ops import pkernels as pk

    pt._canonical_order()
    lay, prm = pt.layout, pt.params
    kw = dict(num_rows=pt.num_rows, num_features=prm.cols, num_bins=prm.bins_hist,
              bits=prm.bits)
    if pt.K > 1:
        _, root = pk.update_multi_and_hists(pt.p, lay, pt.objective, **kw)
        rows = lay.class_rows(0)
    else:
        _, root = pk.update_and_root_hist(pt.p, lay, pt.objective, **kw)
        root, rows = root[None], None
    p0 = pt.p.clone()
    out = {}
    for what, fmask in (("full", pt.feature_mask), ("empty", torch.zeros_like(pt.feature_mask))):
        def grow():
            pt.p.copy_(p0)
            return pt.trees.grow(pt.p, fmask, pt.hyper, root[0], rows)
        copy = time_cuda(lambda: pt.p.copy_(p0), 3)
        out[what] = time_cuda(grow, 3) - copy
    del p0
    log(f"fused tree (K={pt.K}, class 0) as one graph replay: {out['full']:.3f} ms of device "
        f"time; with every level and phase-2 step empty (all-zero feature mask) "
        f"{out['empty']:.3f} ms: the fixed cost of the tree's static structure")
    return out


def graph_pool_gib(pt):
    """GiB of device memory in the segments of the trainer's graph pool
    (torch.cuda.memory_snapshot), or None where no segment names it."""
    import torch

    want = tuple(pt.trees.pool)
    sizes = [s["total_size"] for s in torch.cuda.memory_snapshot()
             if tuple(s.get("segment_pool_id", ())) == want]
    return sum(sizes) / 2**30 if sizes else None


def prep_higgs(rows):
    """The higgs-10.5M data: ``rows`` training rows binned with
    TRAIN_PARAMS and 500,000 held out.  Host work only, so main() runs it
    on a background thread beside the small phases.  Returns ((the
    Dataset, held-out X, held-out y), seconds)."""
    import lightgbm_tpu_torch as lgt

    t0 = time.perf_counter()
    X, y = make_higgs_shaped(rows + 500_000, seed=7)
    Xv, yv = X[rows:], y[rows:]
    X, y = X[:rows], y[:rows]
    ds = lgt.Dataset(X, label=y)
    ds.construct(TRAIN_PARAMS)
    return (ds, Xv, yv), time.perf_counter() - t0


def phase_full(data, iters, dev, repeat_iters):
    """The binary main path at full width ("higgs-10.5M") on prep_higgs's
    ``data`` (a future).  Returns the launch counts of the main run."""
    import torch

    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.ops import histogram as th
    from lightgbm_tpu_torch.ops import pkernels as pk

    t0 = time.perf_counter()
    (ds, Xv, yv), prep_s = data.result()
    rows = ds.num_data()
    log(f"full: data {rows}x28 + 500000 held out, binned in {prep_s:.1f} s on a background "
        f"thread beside the small phases (waited {time.perf_counter() - t0:.1f} s for it)")

    def run(n_iter):
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        bst = lgt.train(TRAIN_PARAMS, ds, n_iter, device=dev)
        sync(dev)
        return bst, time.perf_counter() - t

    ((bst, wall), per_iter, end_syncs, run_syncs), counts = driven(
        "higgs-10.5M", lambda: traced_iterations(lambda: run(iters)),
        ("update_and_root_hist", "level_stream", "split_stream", "score_add"))
    tally = th.selected_rows()
    main_text = bst.model_to_string()  # before the checks below train on
    pt = bst.boosting.ptrainer
    its = pt.iter_seconds
    s_iter = float(np.median(its[1:])) if len(its) > 1 else float(its[0])
    chunk_wall, n_done = pt.chunk_seconds[-1]
    pred = bst.predict(Xv)
    a = auc(yv, pred)
    peak = torch.cuda.max_memory_allocated() / 2**30 if dev.type == "cuda" else float("nan")
    log(f"full: {iters} iterations in {wall:.2f} s; s/iter {s_iter:.4f} (iter_seconds: the "
        f"stream's time between an iteration's boundary events, median after the first; "
        f"first {its[0]:.3f} s); the chunk's wall over its iterations {chunk_wall / n_done:.4f} "
        f"s; held-out AUC {a:.6f}; peak device memory {peak:.2f} GiB; launches "
        f"{json.dumps(counts)}")
    trees = counts["update_and_root_hist"]
    log(f"full: phase 2's fallback split_stream took rows at {tally['split_stream_taken']} of "
        f"its {counts['split_stream']} launches ({tally['split_stream_taken'] / trees:.1f} a "
        f"tree), {tally['split_stream']} rows; host syncs of the whole run {run_syncs}, "
        f"{end_syncs} after the chunk's last boundary (its one read)")
    for t, (row, sec) in enumerate(zip(per_iter, its)):
        log(f"  iteration {t}: {1e3 * sec:.2f} ms between its events, host syncs "
            f"{row['syncs']}, launches {json.dumps(row['launches'])}")
    syncs = fused_grower_syncs(pt, dev)
    traced_syncs(bst, dev, syncs[1])
    costs = tree_costs(pt, dev)
    assert np.all(np.isfinite(pred)) and pred.shape == (yv.shape[0],)
    assert 0.6 < a <= 1.0, "held-out AUC out of range"

    os.environ["LIGHTGBM_TPU_LEVELGROW"] = "0"
    try:
        pk.reset_launch_counts()
        bst0, wall0 = run(2)
        c0 = pk.launch_counts()
    finally:
        del os.environ["LIGHTGBM_TPU_LEVELGROW"]
    log(f"full, level grower off: 2 iterations in {wall0:.2f} s; launches {json.dumps(c0)}; "
        f"same 2 trees as the level grower: "
        f"{trees_text(bst0.model_to_string()) == trees_text(bst.model_to_string(2))}")
    assert c0["split_stream"] > 0 and c0["level_stream"] == 0
    del bst0
    prof = profile_iters(ds, dev, bst=bst) if dev.type == "cuda" else None

    bst2, _ = run(repeat_iters)
    same = trees_text(bst2.model_to_string()) == trees_text(bst.model_to_string(repeat_iters))
    log(f"full: a repeat run of {repeat_iters} iterations gives byte-identical model text: "
        f"{same}")
    del bst2
    return counts, dict(s_iter=s_iter, auc=a, peak_gib=peak, deterministic=same,
                        iter_seconds=its, profile=prof, syncs=syncs, tree_ms=costs,
                        tail_rows=tally["split_stream"] // max(tally["split_stream_taken"], 1),
                        main_text=main_text), (ds, Xv, yv)


def phase_sampled(ds, Xv, yv, dev, higgs_its):
    """The sampled cells on the Higgs cell's binned data: bagging with a
    validation set and early stopping, then GOSS; ``higgs_its`` are the
    unsampled cell's iteration times, the yardstick at the same
    iterations.  Returns the launch counts of both paths."""
    import torch

    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.model.ensemble import stack_trees
    from lightgbm_tpu_torch.ops.predict import predict_binned

    t0 = time.perf_counter()
    dv = lgt.Dataset(Xv, label=yv, reference=ds)
    dv.construct()
    log(f"sampled: the {len(yv)} held-out rows binned with the training mappers in "
        f"{time.perf_counter() - t0:.1f} s")

    def run(params, **kw):
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        bst = lgt.train(params, ds, SAMPLED_ITERS, device=dev, verbose_eval=False, **kw)
        sync(dev)
        peak = torch.cuda.max_memory_allocated() / 2**30 if dev.type == "cuda" else float("nan")
        return bst, time.perf_counter() - t, peak

    path = ("update_and_root_hist", "level_stream", "split_stream", "score_add")
    ev = {}
    (bst, wall, peak), c_bag = driven(
        "higgs-10.5M-bagging",
        lambda: run(dict(BAG_PARAMS, metric=["auc", "binary_logloss"]), valid_sets=[dv],
                    valid_names=["heldout"], early_stopping_rounds=5, evals_result=ev), path)
    its = bst.boosting.ptrainer.iter_seconds
    s_iter = float(np.median(its[1:]))
    last = {m: v[-1] for m, v in ev["heldout"].items()}
    a = last["auc"]
    pred_auc = auc(yv, bst.predict(Xv, num_iteration=-1))
    log(f"higgs-10.5M-bagging: {bst.current_iteration()} iterations in {wall:.2f} s; s/iter "
        f"{s_iter:.4f} (training only, median after the first; first {its[0]:.3f} s; the whole "
        f"train() call {wall / len(its):.4f} s per iteration, set-up and validation included); "
        f"held-out AUC {a:.6f} (rank AUC of "
        f"predict {pred_auc:.6f}); last evals_result {json.dumps(last)}; best_iteration "
        f"{bst.best_iteration}, best_score {json.dumps(bst.best_score)}; peak device memory "
        f"{peak:.2f} GiB; higgs-10.5M's s/iter in this run {np.median(higgs_its[1:]):.4f}")
    assert 0.6 < a <= 1.0 and abs(a - pred_auc) <= 1e-4, "held-out AUC out of range"
    assert 1 <= bst.best_iteration <= bst.current_iteration()
    # one iteration's validation pass, in its two parts
    g = bst.boosting
    t = time.perf_counter()
    predict_binned(g.valid_bins[0], stack_trees(g.models[-1:]))
    sync(dev)
    t_trav = time.perf_counter() - t
    t = time.perf_counter()
    bst.eval_valid()
    t_eval = time.perf_counter() - t
    log(f"higgs-10.5M-bagging: one iteration's validation pass: the last tree over the "
        f"{len(yv)} held-out bins {1e3 * t_trav:.1f} ms, the two metrics {1e3 * t_eval:.1f} ms")
    bag = dict(s_iter=s_iter, auc=a, best_iteration=bst.best_iteration, peak_gib=peak)
    del bst, g

    (bst, wall, peak), c_goss = driven(
        "higgs-10.5M-goss", lambda: run(GOSS_PARAMS), path + ("update_channels",))
    its = bst.boosting.ptrainer.iter_seconds
    warm = bst.boosting.ptrainer.goss_constants()[3]
    s_warm, s_samp = float(np.median(its[1:warm])), float(np.median(its[warm:]))
    # the unsampled cell at the same iterations: its trees also grow
    # slower as boosting goes on, so warm-up against sampled alone
    # would mix that in
    h_warm, h_late = (float(np.median(v)) if len(v) else float("nan")
                      for v in (higgs_its[1:warm], higgs_its[warm:]))
    pred = bst.predict(Xv)
    a = auc(yv, pred)
    log(f"higgs-10.5M-goss: {SAMPLED_ITERS} iterations in {wall:.2f} s; s/iter warm-up "
        f"{s_warm:.4f} (median of iterations 1-{warm - 1}), sampled {s_samp:.4f} (median of "
        f"iterations {warm}-{len(its) - 1}); higgs-10.5M at the same iterations {h_warm:.4f} "
        f"and {h_late:.4f}; held-out AUC {a:.6f}; update_channels launches "
        f"{c_goss['update_channels']} (expected {SAMPLED_ITERS - warm}); peak device memory "
        f"{peak:.2f} GiB")
    assert np.all(np.isfinite(pred)) and 0.6 < a <= 1.0, "held-out AUC out of range"
    assert c_goss["update_channels"] == SAMPLED_ITERS - warm
    del bst
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    goss = dict(s_warm=s_warm, s_sampled=s_samp, auc=a, peak_gib=peak)
    return [c_bag, c_goss], dict(bagging=bag, goss=goss)


def phase_full_objectives(ds, Xv, yv, dev):
    """The regression cells on the Higgs cell's binned data and
    parameters (TRAIN_PARAMS with each regression objective; the 0/1
    labels as targets, as the reference's examples/regression does with
    its Higgs subset), OBJ_ITERS iterations each on the fused path:
    s/iter (the stream's time between iteration events), the objective's
    own metric on the 500k held-out rows, peak memory, and the host syncs
    of a tree (replayed under sync debug mode "error") and of a chunk.
    Returns (each cell's launch counts, {objective: numbers})."""
    import torch

    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.io.dataset import Metadata
    from lightgbm_tpu_torch.metric import create_metric

    md = Metadata(len(yv))
    md.set_label(yv)
    all_counts, res = [], {}
    for name, extra in OBJ_KINDS:
        params = dict(TRAIN_PARAMS, objective=name, **extra)

        def run():
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            bst = lgt.train(params, ds, OBJ_ITERS, device=dev)
            sync(dev)
            return bst, time.perf_counter() - t

        (bst, wall), counts = driven(f"higgs-10.5M-{name}", run,
                                     ("update_and_root_hist", "level_stream", "split_stream",
                                      "score_add"))
        pt = bst.boosting.ptrainer
        its = pt.iter_seconds
        s_iter = float(np.median(its[1:]))
        peak = torch.cuda.max_memory_allocated() / 2**30 if dev.type == "cuda" else float("nan")
        raw = bst.predict(Xv, raw_score=True)
        metric = create_metric(name, Config.from_params(params))
        metric.init(md, len(yv))
        value = metric.eval(torch.from_numpy(raw), bst.boosting.objective)[0][1]
        base = metric.eval(torch.full((len(yv),), float(bst.boosting.models[0].leaf_value[0]),
                                      dtype=torch.float64), bst.boosting.objective)[0][1]
        chunk = fused_grower_syncs(pt, dev)[1] if dev.type == "cuda" else None
        log(f"higgs-10.5M-{name}: {OBJ_ITERS} iterations in {wall:.2f} s; s/iter {s_iter:.4f} "
            f"(median after the first; first {its[0]:.3f} s); held-out {metric.name} "
            f"{value:.6f} (the label mean alone: {base:.6f}); peak device memory {peak:.2f} "
            f"GiB; host syncs 0 a tree, {chunk} a chunk; launches {json.dumps(counts)}")
        assert np.all(np.isfinite(raw)) and raw.shape == (len(yv),)
        assert np.isfinite(value), f"{name}: the held-out {metric.name} is not finite"
        assert chunk in (1, None), f"{name}: a chunk read the card {chunk} times"
        all_counts.append(counts)
        res[name] = dict(s_iter=s_iter, metric=value, peak_gib=peak, chunk_syncs=chunk)
        del bst, pt
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return all_counts, res


def prep_mslr():
    """The mslr-web10k-shaped data, binned with RANK_PARAMS, and its
    validation set.  Host work only (main() runs it on a background
    thread).  Returns ((the Dataset, the validation Dataset, labels,
    validation labels, query sizes, validation query sizes), seconds)."""
    import lightgbm_tpu_torch as lgt

    t0 = time.perf_counter()
    X, y, sizes = make_mslr_shaped(MSLR_QUERIES, seed=61, n_docs=MSLR_DOCS)
    Xv, yv, vsizes = make_mslr_shaped(MSLR_VALID_QUERIES, seed=62)
    ds = lgt.Dataset(X, label=y, group=sizes)
    ds.construct(RANK_PARAMS)
    dv = lgt.Dataset(Xv, label=yv, group=vsizes, reference=ds)
    dv.construct()
    return (ds, dv, y, yv, sizes, vsizes), time.perf_counter() - t0


def phase_rank(data, dev):
    """"mslr-web10k-shaped": lambdarank on the mask grower at MSLR-WEB10K
    Fold1's training size (723,412 documents in 6,000 queries, 136
    features) with a 2,000-query validation set, RANK_PARAMS, RANK_ITERS
    iterations, on prep_mslr's ``data`` (a future): s/iter, the gradient
    pass's device ms, ndcg@1,3,5,10 on the validation set against a
    random order's, peak memory, and B8's launches and selected rows.
    Returns the path's launch counts and its numbers."""
    import torch

    import lightgbm_tpu_torch as lgt

    t0 = time.perf_counter()
    (ds, dv, y, yv, sizes, vsizes), prep_s = data.result()
    log(f"mslr-web10k-shaped: {len(y)} documents in {len(sizes)} queries (mean "
        f"{sizes.mean():.1f}, largest {sizes.max()}), {MSLR_FEATURES} features, labels 0-4 "
        f"{np.bincount(y.astype(np.int64), minlength=5).tolist()}; validation {len(yv)} "
        f"documents in {len(vsizes)} queries; built and binned in {prep_s:.1f} s on a "
        f"background thread (waited {time.perf_counter() - t0:.1f} s for it)")
    ev = {}

    def run():
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        bst = lgt.train(RANK_PARAMS, ds, RANK_ITERS, valid_sets=[dv], valid_names=["valid"],
                        evals_result=ev, verbose_eval=False, device=dev)
        sync(dev)
        return bst, time.perf_counter() - t

    (bst, wall), counts = driven("mslr-web10k-shaped", run, ("hist_segment",))
    g = bst.boosting
    assert g.ptrainer is None, "lambdarank left the mask grower"
    its = g.iter_seconds
    s_iter = float(np.median(its[1:]))
    peak = torch.cuda.max_memory_allocated() / 2**30 if dev.type == "cuda" else float("nan")
    obj = g.objective
    grad_ms = time_cuda(lambda: obj.get_gradients(g.scores[0]), 3)
    buckets = obj._state(g.scores.device)[0]
    last = {k: v[-1] for k, v in ev["valid"].items()}
    rnd = dict(g.valid_metrics[0][0].eval(torch.rand(len(yv), dtype=torch.float64)))
    log(f"mslr-web10k-shaped: {RANK_ITERS} iterations in {wall:.2f} s; s/iter {s_iter:.4f} "
        f"(wall of a mask-grower iteration, device-synced; median after the first; first "
        f"{its[0]:.3f} s, validation not included); the lambdarank gradient pass "
        f"{grad_ms:.3f} ms on the card ({len(buckets)} buckets of at most "
        f"{obj.pair_budget} pair elements); validation {json.dumps(last)}, a random order "
        f"{json.dumps(rnd)}; peak device memory {peak:.2f} GiB; hist_segment launches "
        f"{counts['hist_segment']}, selected rows {counts['hist_segment_rows']} "
        f"({counts['hist_segment_rows'] // max(counts['hist_segment'], 1)} a launch)")
    assert list(last) == ["ndcg@1", "ndcg@3", "ndcg@5", "ndcg@10"]
    assert all(np.isfinite(v) and last[k] > rnd[k] for k, v in last.items()), \
        "validation NDCG not above a random order's"
    del bst, g, obj, ds, dv
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return counts, dict(s_iter=s_iter, grad_ms=grad_ms, ndcg=last, random_ndcg=rnd,
                        peak_gib=peak)


def phase_quantized(ds, Xv, yv, dev, higgs_auc):
    """"higgs-10.5M-quantized": the Higgs cell's binned data and parameters
    with use_quantized_grad (5 bits) on the mask grower.  Returns the
    path's launch counts and its numbers."""
    import torch

    import lightgbm_tpu_torch as lgt

    def run():
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        bst = lgt.train(QUANT_PARAMS, ds, MASK_ITERS, device=dev)
        sync(dev)
        return bst, time.perf_counter() - t

    (bst, wall), counts = driven("higgs-10.5M-quantized", run, ("hist_segment_q",))
    assert bst.boosting.ptrainer is None
    its = bst.boosting.iter_seconds
    s_iter = float(np.median(its[1:]))
    pred = bst.predict(Xv)
    a = auc(yv, pred)
    peak = torch.cuda.max_memory_allocated() / 2**30 if dev.type == "cuda" else float("nan")
    splits = sum(t.num_leaves - 1 for t in bst.boosting.models)
    log(f"higgs-10.5M-quantized: {MASK_ITERS} iterations in {wall:.2f} s; s/iter {s_iter:.4f} "
        f"(median after the first; first {its[0]:.3f} s); {splits} splits; held-out AUC "
        f"{a:.6f} (higgs-10.5M {higgs_auc:.6f}); peak device memory {peak:.2f} GiB; "
        f"hist_segment_q launches {counts['hist_segment_q']}")
    assert np.all(np.isfinite(pred)) and 0.6 < a <= 1.0, "held-out AUC out of range"
    assert abs(a - higgs_auc) <= 0.005, "quantized AUC strays from the float32 cell's"
    if dev.type == "cuda":
        # the host syncs of one more iteration: PyTorch warns at each
        # implicit one (a read-back, a copy that waits for the stream)
        import warnings

        n0 = len(bst.boosting.models)
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                bst.boosting.train_iters(1)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        nsync = sum(_is_sync(w) for w in caught)
        log(f"higgs-10.5M-quantized: one more iteration ({bst.boosting.models[-1].num_leaves - 1}"
            f" splits, {len(bst.boosting.models) - n0} tree) made {nsync} implicit host syncs")
        split_search_times(bst.boosting)
    del bst
    prof = profile_iters(ds, dev, QUANT_PARAMS) if dev.type == "cuda" else None
    return counts, dict(s_iter=s_iter, auc=a, peak_gib=peak, profile=prof)


def split_search_times(gbdt, reps=50):
    """Host-clock milliseconds of one split's search of two children,
    read back as the grower reads it: the captured CUDA graph against the
    same PyTorch operations run eagerly, on the last tree's inputs."""
    import torch

    from lightgbm_tpu_torch.ops import grow

    search = next(iter(gbdt.searches.values()))
    hyper, params, quantized = search.args
    hist, sums, fmask, qs = (t.clone() for t in (search.hist, search.sums, search.fmask,
                                                    search.qs))

    def eager():
        return grow._best_rows(hist, sums, search.meta, hyper, fmask, params, quantized,
                               qs).cpu()

    def graph():
        return search(hist[0], hist[1], sums, fmask, qs).cpu()

    assert torch.equal(eager(), graph()), "the captured split search differs from eager"
    out = {}
    for name, fn in (("eager", eager), ("graph", graph), ("graph", graph), ("eager", eager)):
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        out.setdefault(name, []).append((time.perf_counter() - t) / reps * 1e3)
    log(f"split search of two children (host clock, read back; eager, graph, graph, eager): "
        f"eager {out['eager']} ms, CUDA graph {out['graph']} ms; results equal")


def phase_covertype_goss(ds, Xv, yv, dev):
    """"covertype-581k-goss": the covertype cell's data and parameters with
    boosting=goss at LightGBM's default rates, on the mask grower (K=7).
    Returns the path's launch counts and its numbers."""
    import torch

    import lightgbm_tpu_torch as lgt

    def run():
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        bst = lgt.train(COV_GOSS_PARAMS, ds, COV_GOSS_ITERS, device=dev)
        sync(dev)
        return bst, time.perf_counter() - t

    (bst, wall), counts = driven("covertype-581k-goss", run, ("hist_segment",))
    assert bst.boosting.ptrainer is None and type(bst.boosting).__name__ == "GOSS"
    its = bst.boosting.iter_seconds
    warm = int(1.0 / COV_GOSS_PARAMS["learning_rate"])
    s_warm, s_samp = float(np.median(its[1:warm])), float(np.median(its[warm:]))
    prob = bst.predict(Xv)
    ll = multi_logloss(yv, prob)
    acc = float(np.mean(np.argmax(prob, axis=1) == yv))
    peak = torch.cuda.max_memory_allocated() / 2**30 if dev.type == "cuda" else float("nan")
    log(f"covertype-581k-goss: {COV_GOSS_ITERS} iterations ({bst.num_trees} trees) in {wall:.2f} "
        f"s; s/iter warm-up {s_warm:.4f} (median of iterations 1-{warm - 1}), sampled "
        f"{s_samp:.4f} (median of iterations {warm}-{len(its) - 1}); held-out multi_logloss "
        f"{ll:.6f} (prior entropy {prior_entropy():.6f}), accuracy {acc:.6f}; peak device "
        f"memory {peak:.2f} GiB; hist_segment launches {counts['hist_segment']}")
    assert prob.shape == (len(yv), 7) and np.all(np.isfinite(prob))
    assert ll < prior_entropy(), "held-out multi_logloss is not below the class prior's"
    del bst
    prof = None
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        prof = profile_iters(ds, dev, COV_GOSS_PARAMS, n_iter=1)
    return counts, dict(s_warm=s_warm, s_sampled=s_samp, logloss=ll, accuracy=acc,
                        peak_gib=peak, profile=prof)


def phase_api(higgs, main_text, dev):
    """The API's new paths at full width, on the higgs-10.5M data (its
    500k held-out rows) with TRAIN_PARAMS and the main run's model
    (``main_text``, loaded as a Booster on the card): an LGBMClassifier
    fit on the first API_CLF_ROWS rows with an eval set and early
    stopping (trees byte-identical to lgt.train's on the same rows),
    init_model continuation of bst on the first API_SUB_ROWS rows
    (sharing the cell's bins), rollback_one_iter then update(), API_CV_FOLDS-fold cv
    of those rows, DART, pred_leaf and the prediction early stop, and the
    feature importances.  Returns the launch counts of its paths and its
    numbers."""
    import torch

    import lightgbm_tpu_torch as lgt

    ds, Xv, yv = higgs
    X, y = ds.data, ds.get_label()
    sub = ds.subset(np.arange(min(API_SUB_ROWS, len(y))))
    bst = lgt.Booster(model_str=main_text, device=dev)
    n_main = bst.current_iteration()
    counts, res = [], {}

    def peak_reset():
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()

    def peak():
        return torch.cuda.max_memory_allocated() / 2**30 if dev.type == "cuda" else float("nan")

    fused = ("update_and_root_hist", "level_stream", "split_stream", "score_add")

    # 1. the scikit-learn estimator
    n_fit = min(API_CLF_ROWS, len(y))

    def fit():
        peak_reset()
        t = time.perf_counter()
        clf = lgt.LGBMClassifier(**SKLEARN_PARAMS, n_estimators=API_CLF_ITERS, device=dev)
        clf.fit(X[:n_fit], y[:n_fit], eval_set=[(Xv, yv)], early_stopping_rounds=5)
        sync(dev)
        return clf, time.perf_counter() - t

    (clf, wall), c = driven("higgs-10.5M LGBMClassifier", fit, fused)
    counts.append(c)
    n_clf = clf.booster_.current_iteration()
    want = lgt.train(TRAIN_PARAMS, lgt.Dataset(X[:n_fit], label=y[:n_fit]), n_clf, device=dev)
    same = tree_blocks(clf.booster_.model_to_string()) == tree_blocks(want.model_to_string())
    del want
    a = auc(yv, clf.predict_proba(Xv)[:, 1])
    log(f"higgs-10.5M LGBMClassifier: fit {API_CLF_ITERS} estimators on the first {n_fit} rows "
        f"with an eval set and early_stopping_rounds=5 in {wall:.2f} s (binning included); "
        f"{n_clf} iterations, best_iteration_ {clf.best_iteration_}; its trees byte-identical "
        f"to lgt.train's on the same rows: {same}; predict_proba AUC {a:.6f}; peak device "
        f"memory {peak():.2f} GiB")
    assert same, "the estimator's trees differ from lgt.train's"
    res["clf"] = dict(wall=wall, auc=a)
    del clf

    # 2. continued training from the main run's booster
    def cont():
        peak_reset()
        t = time.perf_counter()
        b = lgt.train(TRAIN_PARAMS, sub, API_CONT_ITERS, init_model=bst, device=dev)
        sync(dev)
        return b, time.perf_counter() - t

    (b2, wall), c = driven("higgs-10.5M init_model", cont, fused)
    counts.append(c)
    kept = tree_blocks(b2.model_to_string(n_main)) == tree_blocks(main_text)
    a = auc(yv, b2.predict(Xv))
    log(f"higgs-10.5M init_model: {n_main} + {API_CONT_ITERS} iterations on the first "
        f"{sub.num_data()} rows in {wall:.2f} s (the initial model's predictions of the "
        f"training rows included); its first {n_main} trees "
        f"byte-identical to the main run's: {kept}; AUC after {b2.current_iteration()} "
        f"iterations {a:.6f}; score_add launches {c['score_add']} (the initial scores, then "
        f"each chunk's settle); peak device memory {peak():.2f} GiB")
    assert kept and 0.6 < a <= 1.0
    res["init_model"] = dict(wall=wall, auc=a, score_add=c["score_add"])

    # 3. rollback, then one more iteration
    rows = np.random.default_rng(1).choice(sub.num_data(), min(100_000, sub.num_data()),
                                           replace=False)
    n_it = b2.current_iteration()
    before = b2.model_to_string()

    def roll():
        b2.rollback_one_iter()
        sc = b2.boosting.scores[0].cpu().numpy()[rows]
        b2.update()
        return sc, b2.boosting.scores[0].cpu().numpy()[rows]

    (sc_roll, sc_upd), c = driven("higgs-10.5M rollback", roll, ("score_add",))
    counts.append(c)
    d_roll = float(np.abs(sc_roll - b2.predict(X[rows], raw_score=True,
                                               num_iteration=n_it - 1)).max())
    d_upd = float(np.abs(sc_upd - b2.predict(X[rows], raw_score=True)).max())
    ndiff = compare_models("higgs-10.5M rollback: the regrown tree vs the popped one", before,
                           b2.model_to_string())
    log(f"higgs-10.5M rollback: the last tree's delta off the band through score_add "
        f"(launches {c['score_add']} with the update's settle); the training scores on "
        f"{len(rows)} rows against predict(num_iteration={n_it - 1}) max |d| {d_roll:.3e} (tol "
        f"1e-4); after the update against predict() {d_upd:.3e}; the regrown tree: {ndiff} "
        f"split differences from the popped one")
    assert d_roll <= 1e-4 and d_upd <= 1e-4
    res["rollback"] = dict(d_roll=d_roll, d_update=d_upd, split_diffs=ndiff)

    # 6. pred_leaf and the prediction early stop, on the main run's booster
    t = time.perf_counter()
    leaves = bst.predict(Xv, pred_leaf=True)
    t_leaf = time.perf_counter() - t
    s_leaf = np.zeros(len(yv))
    for i, tree in enumerate(bst.boosting.models):
        s_leaf += tree.leaf_value[leaves[:, i]]
    t = time.perf_counter()
    raw = bst.predict(Xv, raw_score=True)
    t_full = time.perf_counter() - t
    d_leaf = float(np.abs(s_leaf - raw).max())
    es = dict(pred_early_stop=True, pred_early_stop_freq=5, pred_early_stop_margin=1.0)
    t = time.perf_counter()
    raw_es = bst.predict(Xv, raw_score=True, **es)
    t_es = time.perf_counter() - t
    early = float(np.mean(np.abs(raw_es - raw) > 1e-6))
    d_auc = abs(auc(yv, raw_es) - auc(yv, raw))
    log(f"higgs-10.5M pred_leaf: {leaves.shape} int32 in {1e3 * t_leaf:.1f} ms; the leaf values "
        f"at those indices sum to predict(raw_score=True) within {d_leaf:.3e} (tol 1e-5); "
        f"pred_early_stop (freq 5, margin 1.0): {100 * early:.2f} % of the rows exit early, "
        f"|dAUC| {d_auc:.3e} against the full prediction; {1e3 * t_es:.1f} ms against "
        f"{1e3 * t_full:.1f} ms")
    assert leaves.shape == (len(yv), n_main) and d_leaf <= 1e-5
    res["pred"] = dict(leaf_ms=1e3 * t_leaf, early_share=early, d_auc=d_auc,
                       es_ms=1e3 * t_es, full_ms=1e3 * t_full)

    # 7. feature importances
    split_imp, gain_imp = bst.feature_importance("split"), bst.feature_importance("gain")
    n_splits = sum(t.num_leaves - 1 for t in bst.boosting.models)
    gains_ok = bool(np.all(np.isfinite(gain_imp)) and np.all(gain_imp >= 0))
    log(f"higgs-10.5M importances: split counts sum to {int(split_imp.sum())} of {n_splits} "
        f"splits; gains finite and >= 0: {gains_ok}")
    assert int(split_imp.sum()) == n_splits and gains_ok
    del b2
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # 4. API_CV_FOLDS-fold cv of API_SUB_ROWS rows: a booster a fold on the card at once
    def run_cv():
        peak_reset()
        t = time.perf_counter()
        r = lgt.cv(TRAIN_PARAMS, sub, API_CV_ITERS, nfold=API_CV_FOLDS, seed=0,
                   return_cvbooster=True,
                   device=dev)
        sync(dev)
        return r, time.perf_counter() - t

    (r, wall), c = driven("higgs-10.5M cv", run_cv, fused)
    counts.append(c)
    folds = r.pop("cvbooster")
    means = r["binary_logloss-mean"]
    firsts = [b.boosting.ptrainer.chunk_seconds[0][0] for b in folds]
    laters = [s for b in folds for s, _ in b.boosting.ptrainer.chunk_seconds[1:]]
    capture = float(np.median(firsts) - np.median(laters))
    log(f"higgs-10.5M cv: {API_CV_FOLDS} folds of {folds[0].boosting.num_data} training rows, "
        f"{API_CV_ITERS} rounds in {wall:.2f} s ({wall / API_CV_ITERS:.2f} s a round, subsets "
        f"and set-up included); a fold's iteration {np.median(laters):.4f} s (chunk wall), its "
        f"first {np.median(firsts):.3f} s (graph capture ~{capture:.3f} s); binary_logloss-mean "
        f"{[round(m, 6) for m in means]}, -stdv {[round(v, 6) for v in r['binary_logloss-stdv']]};"
        f" peak device memory {peak():.2f} GiB")
    assert len(folds) == API_CV_FOLDS and all(b.boosting.ptrainer is not None for b in folds)
    assert all(m1 < m0 for m0, m1 in zip(means, means[1:])), "the cv logloss did not fall"
    res["cv"] = dict(wall=wall, s_round=wall / API_CV_ITERS, peak_gib=peak(),
                     capture_s=capture, logloss=means[-1])
    del folds, r
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # 5. DART at full width, one update at a time
    def dart():
        peak_reset()
        b = lgt.Booster(dict(TRAIN_PARAMS, boosting="dart"), ds, device=dev)
        drops = []
        for _ in range(API_DART_ITERS - 1):
            b.update()
            drops.append(len(b.boosting.drop_index))
        _, nsync = count_syncs(lambda: b.update())
        drops.append(len(b.boosting.drop_index))
        sync(dev)
        return b, drops, nsync

    (bd, drops, nsync), c = driven("higgs-10.5M DART", dart, ("hist_segment",))
    counts.append(c)
    assert bd.boosting.ptrainer is None
    its = bd.boosting.iter_seconds
    s_iter = float(np.median(its[1:]))
    a = auc(yv, bd.predict(Xv))
    log(f"higgs-10.5M DART: {API_DART_ITERS} iterations on the mask grower, s/iter {s_iter:.4f} "
        f"(median after the first; first {its[0]:.3f} s); trees dropped by iteration {drops}; "
        f"held-out AUC {a:.6f}; hist_segment launches {c['hist_segment']}; the last iteration "
        f"({bd.boosting.models[-1].num_leaves - 1} splits, {drops[-1]} trees dropped) made "
        f"{nsync} host syncs; peak device memory {peak():.2f} GiB")
    assert np.isfinite(a) and 0.6 < a <= 1.0, "DART's held-out AUC out of range"
    res["dart"] = dict(s_iter=s_iter, auc=a, drops=drops, syncs=nsync, peak_gib=peak())
    del bd
    return counts, res


def monotone_directions(X, y, k, rows=1_000_000):
    """The +1/-1 directions of the ``k`` features with the largest
    |corr(x, y)| (over the first ``rows`` rows), each by its correlation's
    sign, 0 for the rest: users constrain the features whose direction
    they know."""
    Xs, ys = X[:rows], y[:rows]
    corr = np.array([np.corrcoef(Xs[:, j], ys)[0, 1] for j in range(X.shape[1])])
    mono = [0] * X.shape[1]
    for j in np.argsort(-np.abs(corr))[:k]:
        mono[j] = int(np.sign(corr[j]))
    return mono


def logistic_fobj(preds, data):
    """The binary logloss's gradients as a custom objective."""
    p = 1.0 / (1.0 + np.exp(-np.asarray(preds, np.float64)))
    return p - data.get_label(), p * (1.0 - p)


def linear_coeff_err(models_a, models_b):
    """Max relative difference of two models' leaf coefficients, tree by
    tree (each tree's largest |coefficient| the scale), and whether their
    leaf_is_linear agree."""
    err, same = 0.0, True
    for a, b in zip(models_a, models_b):
        same &= bool(np.array_equal(a.leaf_is_linear[:a.num_leaves],
                                    b.leaf_is_linear[:b.num_leaves]))
        ca = np.concatenate([np.asarray(c, np.float64) for c in a.leaf_coeff] + [np.zeros(0)])
        cb = np.concatenate([np.asarray(c, np.float64) for c in b.leaf_coeff] + [np.zeros(0)])
        if ca.shape == cb.shape and ca.size:
            err = max(err, float(np.abs(ca - cb).max() / max(np.abs(cb).max(), 1e-30)))
        elif ca.shape != cb.shape:
            same = False
    return err, same


def phase_small_strategies(small, dev):
    """The tree strategies on the card against the CPU (plain versions) on
    phase_small's --small-rows x 28 rows, 31 leaves, SMALL_STRAT_ITERS
    iterations: linear trees (binary, L2), monotone constraints on 4
    features (binary, float32 and quantized), then 3 fused iterations and
    2 ``update(fobj=)`` (the custom trees on the mask grower) and one more
    fused iteration, whose chunk rewrites the band through score_add.
    Returns the card's launch counts of each path and the card's linear
    binary model text (phase_serve packs it as a v3 artifact)."""
    import lightgbm_tpu_torch as lgt

    X, y, ds, _ = small
    y_l2 = (X[:, 0] - 0.5 * X[:, 1] + 0.3 * X[:, 2] * X[:, 3]).astype(np.float32)
    leaves = dict(num_leaves=SMALL_MASK_LEAVES)
    mono = monotone_directions(X, y, 4)
    cases = (("linear binary", dict(LINEAR_PARAMS, **leaves), ds, "hist_segment"),
             ("linear l2", dict(LINEAR_PARAMS, objective="regression", **leaves),
              lgt.Dataset(X, label=y_l2), "hist_segment"),
             ("monotone binary", dict(TRAIN_PARAMS, monotone_constraints=mono, **leaves), ds,
              "hist_segment"),
             ("monotone quantized", dict(QUANT_PARAMS, monotone_constraints=mono, **leaves), ds,
              "hist_segment_q"))
    counts = []
    for name, params, d_s, kernel in cases:
        out = {}
        for where, d in (("cuda", dev), ("cpu", "cpu")):
            t0 = time.perf_counter()
            bst, c = driven(f"small {name} {where}",
                            lambda: lgt.train(params, d_s, SMALL_STRAT_ITERS, device=d),
                            (kernel,) if where == "cuda" else ())
            if where == "cuda":
                counts.append(c)
            assert bst.boosting.ptrainer is None, f"{name} did not take the mask grower"
            out[where] = (bst, bst.predict(X[:50_000]))
            log(f"small {name} {where}: {len(X)}x28, {SMALL_STRAT_ITERS} iterations, "
                f"{time.perf_counter() - t0:.1f} s")
        (bc, pc), (bp, pp) = out["cuda"], out["cpu"]
        if name == "linear binary":
            linear_text = bc.model_to_string()
        ndiff = compare_models(f"small {name} cuda vs cpu", bp.model_to_string(),
                               bc.model_to_string())
        dpred = float(np.abs(pc - pp).max())
        msg = f"small {name} cuda vs cpu: {ndiff} split differences, max |dpred| {dpred:.3e} " \
              f"(tol 1e-3)"
        if params.get("linear_tree"):
            err, same = linear_coeff_err(bc.boosting.models, bp.boosting.models)
            lin = sum(int(t.leaf_is_linear[:t.num_leaves].sum()) for t in bc.boosting.models)
            msg += (f"; leaf_is_linear equal {same} ({lin} linear leaves); coefficients max rel "
                    f"diff {err:.3e} (tol 1e-4)")
            assert ndiff > 0 or (same and err <= 1e-4), f"{name}: the linear leaves differ"
        log(msg)
        assert dpred <= 1e-3

    # update(fobj=) on a booster the partitioned trainer started
    params = dict(TRAIN_PARAMS, **leaves)
    out = {}
    for where, d in (("cuda", dev), ("cpu", "cpu")):
        def custom():
            b = lgt.train(params, ds, 3, device=d, keep_training_booster=True)
            for _ in range(2):
                b.update(fobj=logistic_fobj)
            return b

        b, c = driven(f"small fobj on a fused booster {where}", custom,
                      ("update_and_root_hist", "hist_segment") if where == "cuda" else ())
        assert b.boosting.ptrainer is not None and b.boosting.ptrainer.score_dirty
        _, c2 = driven(f"small fused iteration after fobj {where}", b.update,
                       ("score_add",) if where == "cuda" else ())
        if where == "cuda":
            counts += [c, c2]
        drift = float(np.abs(b.boosting.scores[0].cpu().numpy()[:50_000]
                             - b.predict(X[:50_000], raw_score=True)).max())
        out[where] = (b, drift, c2["score_add"])
    ndiff = compare_models("small fobj on a fused booster cuda vs cpu",
                           out["cpu"][0].model_to_string(), out["cuda"][0].model_to_string())
    dpred = float(np.abs(out["cuda"][0].predict(X[:50_000])
                         - out["cpu"][0].predict(X[:50_000])).max())
    log(f"small fobj on a fused booster: 3 fused iterations, 2 update(fobj=logistic) on the "
        f"mask grower, 1 fused iteration; cuda vs cpu: {ndiff} split differences, max |dpred| "
        f"{dpred:.3e} (tol 1e-3); the card's training scores against predict max |d| "
        f"{out['cuda'][1]:.3e} (tol 1e-5); score_add launches of the last fused iteration "
        f"{out['cuda'][2]} (the band rewritten from the scores, then the chunk's settle)")
    assert dpred <= 1e-3 and out["cuda"][1] <= 1e-5 and out["cuda"][2] >= 2
    return counts, linear_text


def phase_small_ckpt(small_ds, Xc, yc, dev):
    """Resume on the card (SMALL_CKPT_CASES): each case trained without a
    checkpoint, then with a checkpoint every ``freq`` iterations and
    killed (a callback raising at the first boundary past iteration
    ``at``, before the manager saves there, so the iterations since the
    last checkpoint are lost), then resumed in the same directory; the
    resumed model text must be byte-identical to the uninterrupted
    one's.  K=7 on COV_SMALL_ROWS Covertype-shaped rows,
    the others on phase_small's binned Dataset.  Returns the launch counts
    of each case's three runs."""
    import tempfile

    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.ckpt import CheckpointStore

    class Kill(Exception):
        pass

    cov = lgt.Dataset(Xc[:COV_SMALL_ROWS], label=yc[:COV_SMALL_ROWS])
    counts = []
    for name, params, data, iters, freq, at, required in SMALL_CKPT_CASES:
        ds = cov if data == "cov" else small_ds

        def killer(env, at=at):
            if env.model.boosting.iter > at:
                raise Kill()
        killer.order = 35  # before the checkpoint manager (40)

        def run(params=params, ds=ds, iters=iters, freq=freq, killer=killer):
            t0 = time.perf_counter()
            full = lgt.train(params, ds, iters, device=dev).model_to_string()
            t1 = time.perf_counter()
            with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "build")) as d:
                try:
                    lgt.train(params, ds, iters, device=dev, checkpoint_dir=d,
                              checkpoint_freq=freq, callbacks=[killer])
                    raise RuntimeError("the killed run finished")
                except Kill:
                    pass
                step = max(CheckpointStore(d).steps())
                t2 = time.perf_counter()
                res = lgt.train(params, ds, iters, device=dev, checkpoint_dir=d,
                                checkpoint_freq=freq).model_to_string()
                t3 = time.perf_counter()
            return full == res, step, (t1 - t0, t2 - t1, t3 - t2)

        (same, step, secs), c = driven(f"small ckpt {name}", run, required)
        counts.append(c)
        log(f"small ckpt {name}: {iters} iterations, a checkpoint every {freq}, killed past "
            f"iteration {at}, resumed from iteration {step}: model text byte-identical to the "
            f"uninterrupted run's: {same} (runs {secs[0]:.1f} / {secs[1]:.1f} / "
            f"{secs[2]:.1f} s)")
        assert same, f"the resumed {name} run differs from the uninterrupted one"
        assert step == at // freq * freq
    return counts


def _cli(args, cwd, timeout=600, env=None):
    """``python -m lightgbm_tpu_torch`` with ``args`` in ``cwd`` (the
    checkout's package, on the card; ``env`` added to the environment);
    returns (stdout, wall seconds) and fails on a non-zero exit."""
    env = dict(os.environ, PYTHONPATH=HERE, **(env or {}))
    t = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "lightgbm_tpu_torch", *args], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=timeout)
    wall = time.perf_counter() - t
    if out.returncode != 0:
        log(out.stdout[-4000:], out.stderr[-4000:])
        raise RuntimeError(f"python -m lightgbm_tpu_torch {' '.join(args)}: exit "
                           f"{out.returncode}")
    return out.stdout, wall


def _cli_preempted(args, cwd, env, at, timeout=900):
    """``_cli`` that sends SIGTERM once the process's log shows iteration
    ``at``; the process must flush a checkpoint and exit 0 ("preempted").
    Returns (stdout, wall seconds, the seconds from the signal to the
    exit)."""
    import signal
    import threading

    env = dict(os.environ, PYTHONPATH=HERE, **env)
    t = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "lightgbm_tpu_torch", *args], cwd=cwd,
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    watchdog = threading.Timer(timeout, proc.kill)
    watchdog.start()
    lines, t_sig = [], None
    try:
        for line in proc.stdout:
            lines.append(line)
            if t_sig is None and f"finished iteration {at}" in line:
                proc.send_signal(signal.SIGTERM)
                t_sig = time.perf_counter()
        rc = proc.wait()
    finally:
        watchdog.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    out, end = "".join(lines), time.perf_counter()
    if rc != 0 or t_sig is None or "preempted" not in out:
        log(out[-4000:])
        raise RuntimeError(f"the preempted CLI run: exit {rc}, signal sent {t_sig is not None}")
    return out, end - t, end - t_sig


def _ckpt_records(trace):
    """Each checkpoint of a trace: its iteration, bytes and the capture,
    serialize and write seconds (the ckpt.capture and ckpt.serialize
    spans, the ckpt.saved event's write_s), and the restore's seconds."""
    from lightgbm_tpu_torch.obs.report import load_trace

    recs = load_trace(trace)
    cap = [r["dur_s"] for r in recs if r.get("name") == "ckpt.capture"]
    ser = [r["dur_s"] for r in recs if r.get("name") == "ckpt.serialize"]
    saved = [r for r in recs if r.get("name") == "ckpt.saved"]
    rows = [dict(iter=r["iter"], bytes=r["bytes"], capture_s=c, serialize_s=z,
                 write_s=r["write_s"]) for r, c, z in zip(saved, cap, ser)]
    restore = [r["dur_s"] for r in recs if r.get("name") == "ckpt.restore"]
    return rows, restore, recs


def _logged(stdout, prefix):
    """The rest of each ``[Info]``/``[Debug]`` line of the CLI's log that
    starts with ``prefix``."""
    return [line.split("] ", 2)[2][len(prefix):] for line in stdout.splitlines()
            if line.startswith("[LightGBM-TPU]") and line.split("] ", 2)[-1].startswith(prefix)]


def phase_cli(higgs, main_text, iters, dev):
    """"higgs-10.5M-cli": the command line at full width on the Higgs
    cell's data.  The main run's binned training set saved as a binary
    cache; the first CLI_CSV_ROWS held-out rows written as a CSV with a
    header; then,
    each a ``python -m lightgbm_tpu_torch`` process on the card:
    task=train from a .conf with TRAIN_PARAMS (data=the cache,
    valid_data=the CSV, metric=auc, --iters iterations, a checkpoint every
    CLI_CKPT_FREQ iterations, LIGHTGBM_TPU_TRACE and LIGHTGBM_TPU_METRICS
    set), sent SIGTERM once its log shows iteration CLI_PREEMPT_AT (it
    must flush a checkpoint and exit 0, "preempted"), then ``resume``,
    which finishes the run from that checkpoint (its trees byte-identical
    to the main run's; ``report --json`` of the two traces counts --iters
    iteration records; each checkpoint's size and capture, serialize and
    write seconds logged), task=predict of the CSV (within
    1e-5 relative of the in-process Booster.predict of the same file; its
    AUC within 1e-4 of the main model's on those rows) and task=ingest of
    the CSV with stream_ingest=true in chunks of CLI_INGEST_CHUNK rows
    (bins and mappers equal to the in-memory Dataset(csv)'s); the native
    parser must have parsed the CSV in each.
    Returns the training processes' launch counts (their logs') and the
    phase's numbers."""
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.data.reader import parser_blocks
    from lightgbm_tpu_torch.ops import pkernels as pk

    ds, Xv, yv = higgs
    Xv, yv = Xv[:CLI_CSV_ROWS], yv[:CLI_CSV_ROWS]
    main_auc = auc(yv, lgt.Booster(model_str=main_text, device=dev).predict(Xv))
    work = os.path.join(HERE, "build", "chip_cli")
    os.makedirs(work, exist_ok=True)
    cache, csv = os.path.join(work, "higgs.train.bin"), os.path.join(work, "higgs.valid.csv")
    res = {}
    t = time.perf_counter()
    ds.save_binary(cache)
    res["save_binary_s"] = time.perf_counter() - t
    res["cache_mib"] = os.path.getsize(cache) / 2**20
    t = time.perf_counter()
    np.savetxt(csv, np.column_stack([yv, Xv]), fmt="%.9g", delimiter=",", comments="",
               header=",".join(["label"] + [f"f{i}" for i in range(Xv.shape[1])]))
    res["csv_write_s"] = time.perf_counter() - t
    log(f"cli: save_binary of the {ds.num_data()}x28 training set {res['save_binary_s']:.2f} s, "
        f"{res['cache_mib']:.1f} MiB; the {len(yv)}-row CSV written in {res['csv_write_s']:.2f} s "
        f"({os.path.getsize(csv) / 2**20:.1f} MiB)")
    conf = os.path.join(work, "train.conf")
    with open(conf, "w") as f:
        f.write("task = train\n" + "".join(f"{k} = {v}\n" for k, v in TRAIN_PARAMS.items())
                + f"data = {cache}\nvalid_data = {csv}\nheader = true\nmetric = auc\n"
                f"num_trees = {iters}\noutput_model = model.txt\n")
    native = "the native parser"

    pk.reset_launch_counts()  # the counts below are the training processes' own
    ck = os.path.join(work, "ck")
    shutil.rmtree(ck, ignore_errors=True)
    if os.path.exists(os.path.join(work, "model.txt")):
        os.remove(os.path.join(work, "model.txt"))
    traces = [os.path.join(work, f"{w}.jsonl") for w in ("train", "resume")]
    prom = os.path.join(work, "train.prom")
    args = [f"config={conf}", "verbosity=2", f"checkpoint_dir={ck}",
            f"checkpoint_freq={CLI_CKPT_FREQ}"]
    out1, wall1, exit_s = _cli_preempted(
        args, work, dict(LIGHTGBM_TPU_TRACE=traces[0], LIGHTGBM_TPU_METRICS=prom),
        CLI_PREEMPT_AT)
    step = int(_logged(out1, "Training preempted: checkpoint flushed at iteration ")[0].split(
        ";")[0])
    assert not os.path.exists(os.path.join(work, "model.txt")), "the preempted run finished"
    out2, wall2 = _cli(["resume"] + args, work,
                       env=dict(LIGHTGBM_TPU_TRACE=traces[1], LIGHTGBM_TPU_METRICS=prom))
    resumed = int(_logged(out2, "Resuming training from checkpoint at iteration ")[0])
    out, wall = out1 + out2, wall1 + wall2
    c1, c2 = (json.loads(_logged(o, "Kernel launches: ")[0]) for o in (out1, out2))
    counts = {k: c1[k] + c2[k] for k in c1}
    log(f"path higgs-10.5M-cli: launches {json.dumps(counts)} (the preempted process "
        f"{json.dumps(c1)}, the resumed one {json.dumps(c2)})")
    with concurrent.futures.ThreadPoolExecutor(2) as ex:  # the two reports side by side
        reports = [json.loads(o.strip().splitlines()[-1]) for o, _ in ex.map(
            lambda tr: _cli(["report", tr, "--json"], work), traces)]
    n_iter_recs = sum(r["iterations"] for r in reports)
    ckpts, restore_s, recs1 = _ckpt_records(traces[0])
    ckpts2, restore_s, recs2 = _ckpt_records(traces[1])
    ckpts += ckpts2
    from lightgbm_tpu_torch.obs.metrics import parse_text_format

    prom_text = open(prom).read()
    mirrored = parse_text_format(prom_text)["lightgbm_tpu_ckpt_bytes_total"]["samples"]
    log(f"higgs-10.5M-cli preemption: SIGTERM after iteration {CLI_PREEMPT_AT} (the log's), "
        f"checkpoint flushed at iteration {step}, the process exited {exit_s:.2f} s after the "
        f"signal; resume restored iteration {resumed} in {restore_s[0]:.3f} s (ckpt.restore); "
        f"report --json: {reports[0]['iterations']} + {reports[1]['iterations']} = "
        f"{n_iter_recs} iteration records (limit {iters}); the resumed process's metrics "
        f"dump: lightgbm_tpu_ckpt_bytes_total {json.dumps(mirrored)}")
    for c in ckpts:
        log(f"  checkpoint at iteration {c['iter']}: {c['bytes']} bytes "
            f"({c['bytes'] / 2**20:.1f} MiB); capture {c['capture_s']:.3f} s, serialize "
            f"{c['serialize_s']:.3f} s, write {c['write_s']:.3f} s")
    assert step >= CLI_PREEMPT_AT and resumed == step and n_iter_recs == iters
    assert reports[1]["last_iter"] == iters - 1 and reports[0]["last_iter"] == step - 1
    assert [c["iter"] for c in ckpts] == sorted(
        set(list(range(CLI_CKPT_FREQ, step, CLI_CKPT_FREQ)) + [step]
            + list(range((step // CLI_CKPT_FREQ + 1) * CLI_CKPT_FREQ, iters + 1,
                         CLI_CKPT_FREQ))))
    res["preempt"] = dict(step=step, exit_s=exit_s, restore_s=restore_s[0], checkpoints=ckpts)
    for k in ("update_and_root_hist", "level_stream", "split_stream", "score_add"):
        assert counts[k] > 0, f"{k} was not launched on the higgs-10.5M-cli path"
    its = [float(x.split()[0]) for x in _logged(out, "") if "seconds elapsed, finished" in x]
    assert len(its) == iters, f"{len(its)} iterations logged"
    aucs = [float(x.split(": ")[-1]) for x in _logged(out, "Iteration:") if "auc" in x]
    text = open(os.path.join(work, "model.txt")).read()
    same = tree_blocks(text) == tree_blocks(main_text)
    res.update(wall=wall, s_iter=float(np.median(its[1:])), first_iter=its[0],
               device_gib=float(_logged(out, "Peak device memory ")[0].split()[0]),
               host_gib=float(_logged(out, "Peak host memory ")[0].split()[0]), valid_auc=aucs[-1])
    log(f"higgs-10.5M-cli task=train: {iters} iterations from the cache, the CSV as a "
        f"validation set, in {wall:.2f} s (the two processes: start, load, train, write; "
        f"{wall1:.2f} s preempted, {wall2:.2f} s resumed); s/iter "
        f"{res['s_iter']:.4f} (the stream's time between an iteration's events, median after "
        f"the first; first {its[0]:.3f} s); validation auc {aucs[-1]:.6f}; peak device memory "
        f"{res['device_gib']:.3f} GiB, peak host memory {res['host_gib']:.3f} GiB; trees "
        f"byte-identical to the main run's: {same}")
    assert same, "the resumed CLI run's trees differ from the main run's"
    assert native in out, "the training process did not parse the CSV with the native parser"

    # task=predict and task=ingest of the CSV: two processes side by side
    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        ingest = ex.submit(_cli, [f"config={conf}", "task=ingest", f"data={csv}",
                                  "stream_ingest=true", f"stream_chunk_rows={CLI_INGEST_CHUNK}",
                                  "verbosity=2"], work)
        out, wall = _cli(["task=predict", f"data={csv}", "header=true",
                          "input_model=model.txt", "output_result=pred.txt"], work)
        ingest_out, ingest_wall = ingest.result()
    assert native in out, "the prediction process did not use the native parser"
    pred = np.loadtxt(os.path.join(work, "pred.txt"))
    t = time.perf_counter()
    inproc = lgt.Booster(model_str=text, device=dev).predict(csv, data_has_header=True)
    inproc_s = time.perf_counter() - t
    rel = float(np.max(np.abs(pred - inproc) / np.maximum(np.abs(inproc), 1e-30)))
    a = auc(yv, pred)
    res.update(predict_wall=wall, predict_rel=rel, predict_auc=a)
    log(f"higgs-10.5M-cli task=predict: {len(pred)} rows in {wall:.2f} s (the process, beside "
        f"task=ingest's); "
        f"in-process Booster.predict of the file {inproc_s:.2f} s; max relative difference "
        f"{rel:.2e} (limit 1e-5, %g keeps six digits); AUC of the file {a:.6f}, the main "
        f"model's on these rows {main_auc:.6f}")
    assert pred.shape == (len(yv),) and np.all(np.isfinite(pred))
    assert rel <= 1e-5 and abs(a - main_auc) <= 1e-4

    out, wall = ingest_out, ingest_wall
    assert native in out, "the ingest process did not use the native parser"
    report = json.loads(_logged(out, "Finished ingest: ")[0])
    t = time.perf_counter()
    mem = lgt.Dataset(csv, params=dict(TRAIN_PARAMS, header=True, stream_ingest="false"))
    mem = mem.construct()
    mem_s = time.perf_counter() - t
    streamed = lgt.Dataset(csv + ".bin").construct()
    same_bins = bool(np.array_equal(np.asarray(streamed.binned), mem.binned))
    same_mappers = ([m.to_string() for m in streamed.bin_mappers]
                    == [m.to_string() for m in mem.bin_mappers])
    res.update(ingest_wall=wall, ingest_report=report)
    log(f"higgs-10.5M-cli task=ingest: {report['rows']} rows streamed in {report['wall_s']} s "
        f"({report['chunks_pass1']} + {report['chunks_pass2']} chunks of {report['chunk_rows']} "
        f"rows, host RSS {report['rss_start_mb']} MB at the start, {report['rss_peak_mb']} MB at "
        f"the peak), the process {wall:.2f} s (beside task=predict's); the "
        f"in-memory Dataset(csv) {mem_s:.2f} s; bins equal {same_bins}, mappers equal "
        f"{same_mappers}; parser blocks in this process {json.dumps(parser_blocks())}")
    assert same_bins and same_mappers, "the streamed cache differs from the in-memory load"
    assert parser_blocks().get("native"), "the native parser did not run in this process"
    return counts, res


SERVE_BATCHES = (1, 128, 2048)  # bench.py _bench_serving's batch sizes
SERVE_TILES = 50  # the 1,000-tree artifact: the main model's 20 trees 50 times
SERVE_CLIENTS = 8
SERVE_MIXED = 200  # mixed-size predicts a warmed predictor answers with no capture
SERVE_HTTP_ROWS = 200_000  # the first HTTP pass: the first held-out rows (cut from 500k)
SERVE_SWAP_ROWS = 150_000  # the hot-swap pass: the first held-out rows again
# the pass that swaps in another shape class: 2 clients send requests of
# 1-64 rows (the first 20k held-out rows, again until the new model
# answers), so the batcher keeps replaying while the new ladder is
# captured; with 8 clients of 1-2048 rows the captures took ~16 s, the
# capture thread waiting for the GIL behind the handler threads' parsing
SERVE_RESHAPE_CLIENTS, SERVE_RESHAPE_ROWS, SERVE_RESHAPE_MAX = 2, 20_000, 64


def _scaled_artifact(art, factor, tiles=1):
    """``art``'s trees ``tiles`` times, every leaf value times ``factor``
    (a retrain of the same shape class when ``tiles`` is 1)."""
    from lightgbm_tpu_torch.serve import PredictorArtifact

    fields = {f: np.tile(np.asarray(getattr(art.arrays, f)), (tiles, 1))
              for f in type(art.arrays).FIELDS}
    fields["leaf_value"] = (fields["leaf_value"] * np.float32(factor)).astype(np.float32)
    return PredictorArtifact(type(art.arrays)(**fields),
                             dict(art.meta, num_trees=art.meta["num_trees"] * tiles))


def _median_ms(fn, reps=50):
    ms = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        ms.append(1e3 * (time.perf_counter() - t))
    return ms


def _batch_times(pred, X, reps=50):
    """p50 / p99 ms of one ``predict`` (host rows in, host rows out: the
    encoding, the copy in, the replay, the copy out) and rows/s at its
    p50, by batch size."""
    out = {}
    for bs in SERVE_BATCHES:
        lo = iter(range(0, reps * 997, 997))
        ms = _median_ms(lambda: pred.predict(X[next(lo) % (len(X) - bs):][:bs]), reps)
        p50 = float(np.percentile(ms, 50))
        out[bs] = dict(p50_ms=round(p50, 4), p99_ms=round(float(np.percentile(ms, 99)), 4),
                       rows_per_s=round(bs / p50 * 1e3, 1))
    return out


def _in_process(name, art, X, exact_raw, dev, leaves=None, leaves_of=None, bound=None):
    """A PackedPredictor on the card: warmup(4096)'s captures, then
    SERVE_MIXED predicts of 1-4096 rows with no new capture; its raw
    scores against ``exact_raw`` (within ``bound``, else 1e-6 relative)
    and, with ``leaves``, the walk's leaves; times by batch size."""
    from lightgbm_tpu_torch.obs.trace import total_compiles
    from lightgbm_tpu_torch.serve import PackedPredictor

    p = PackedPredictor(art, device=dev)
    t = time.perf_counter()
    warm = p.warmup(4096)
    warm_s = time.perf_counter() - t
    rng = np.random.default_rng(11)
    c0 = total_compiles()
    for n in rng.integers(1, 4097, SERVE_MIXED):
        lo = int(rng.integers(0, len(X) - n))
        p.predict(X[lo:lo + n])
    captures = total_compiles() - c0
    raw = p.predict(X[:len(exact_raw)], raw_score=True)
    dmax = float(np.abs(raw - exact_raw).max())
    rel = dmax / max(float(np.abs(exact_raw).max()), 1e-30)
    same = None
    if leaves is not None:
        same = bool(np.array_equal(leaves_of(p, X[:len(leaves)]), leaves))
    res = dict(warmup_captures=warm["compiles"], warmup_s=round(warm_s, 3),
               buckets=len(warm["buckets"]), levels=p.raw.levels,
               captures_after_warmup=captures, max_abs_err=dmax, max_rel_err=rel,
               leaves_equal=same, device_mib=round(p.device_bytes / 2**20, 3),
               batches=_batch_times(p, X))
    if bound is not None:
        res["drift_bound"] = bound
    log(f"serve {name}: {json.dumps(res)}")
    assert captures == 0, f"{name}: {captures} captures after warmup"
    assert (dmax <= bound) if bound is not None else (rel <= 1e-6), f"{name}: scores off"
    assert same is not False, f"{name}: the walk's leaves differ from pred_leaf's"
    return p, res


def _http(port, path, body=None, timeout=120):
    import urllib.error
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body,
                                 method="POST" if body is not None else "GET")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _jsonl(rows):
    return ("\n".join(json.dumps(r) for r in rows.tolist()) + "\n").encode()


def _answers(body):
    return np.asarray(json.loads(b"[" + body.strip().replace(b"\n", b",") + b"]"), np.float64)


def _traffic(port, X, seed, on_request=None, until_version=None, clients=SERVE_CLIENTS,
             max_rows=2048):
    """``clients`` threads send the rows of ``X`` in requests of
    1-``max_rows`` rows (sizes drawn from ``seed``, bodies encoded before the clock
    starts, answers decoded after it stops).  With ``until_version`` they
    go round the requests again (at most 20 rounds) until an answer of
    that version has come back.  Returns (the request cuts, each answer's
    (cut, version, predictions), client latencies in ms, failures, wall
    seconds)."""
    import threading

    rng = np.random.default_rng(seed)
    cuts, lo = [], 0
    while lo < len(X):
        n = int(rng.integers(1, max_rows + 1))
        cuts.append((lo, min(len(X), lo + n)))
        lo += n
    bodies = [_jsonl(X[a:b]) for a, b in cuts]
    answers, lat, fails, seen = [], [], [], set()
    lock = threading.Lock()
    todo = iter(range(len(cuts) * (1 if until_version is None else 20)))

    def client():
        while True:
            with lock:
                j = next(todo, None)
                if j is not None and j >= len(cuts) and until_version in seen:
                    j = None
            if j is None:
                return
            if on_request is not None:
                on_request(j, len(cuts))
            i = j % len(cuts)
            t = time.perf_counter()
            code, hdr, body = _http(port, "/predict", bodies[i])
            ms = 1e3 * (time.perf_counter() - t)
            with lock:
                lat.append(ms)
                if code == 200:
                    seen.add(int(hdr["X-Model-Version"]))
                    answers.append((i, int(hdr["X-Model-Version"]), body))
                else:
                    fails.append((i, code, body[:200]))

    t = time.perf_counter()
    threads = [threading.Thread(target=client) for _ in range(clients)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    wall = time.perf_counter() - t
    return cuts, [(i, v, _answers(b)) for i, v, b in answers], lat, fails, wall


def _free_port():
    from lightgbm_tpu_torch.serve.fleet import _free_ports

    return _free_ports(1)[0]


def phase_serve(higgs, main_text, small_texts, cov_rows, dev):
    """"higgs-10.5M-serve": serving on the card.  The main model (20 trees
    x 255 leaves, 28 features) packed as v1 (exact) and v2 (quantized), a
    1,000-tree artifact (the 20 trees 50 times, leaf values / 50), the
    small linear model as v3 and the small K=7 model: each warmed at 4096
    rows in process, SERVE_MIXED mixed-size predicts with no capture,
    leaves and scores checked, p50/p99 by batch size, and the host's part
    of a request.  Then `python -m lightgbm_tpu_torch serve` with a
    registry: SERVE_CLIENTS clients send the first SERVE_HTTP_ROWS
    held-out rows in requests of 1-2048 rows (every answer against
    Booster.predict, the AUC against the main model's on them); a second
    pass over SERVE_SWAP_ROWS rows
    during which a same-shape retrain (leaf values x 1.1) is published (in
    place, 0 captures); a third (SERVE_RESHAPE_*) during which the
    1,000-tree artifact (leaf values x 0.9/50) is published (another shape
    class: its ladder captured in the background while the live graphs
    replay); SIGTERM with two
    30,000-row requests in flight."""
    import signal
    import threading

    import torch

    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.model.ensemble import split_hi_lo
    from lightgbm_tpu_torch.obs.metrics import parse_text_format
    from lightgbm_tpu_torch.ops.predict import _leaves_raw, predict_raw
    from lightgbm_tpu_torch.ops.qpredict import drift_bound, qleaves
    from lightgbm_tpu_torch.serve import PackedPredictor, PredictorArtifact
    from lightgbm_tpu_torch.serve.registry import ModelRegistry
    from lightgbm_tpu_torch.serve.server import _parse_rows

    _, Xv, yv = higgs
    X = np.asarray(Xv, np.float64)
    res = {}
    bst = lgt.Booster(model_str=main_text, device=dev)
    t = time.perf_counter()
    art = PredictorArtifact.from_booster(bst)
    qart = art.quantize()
    big = _scaled_artifact(art, 1.0 / SERVE_TILES, SERVE_TILES)
    res["pack_s"] = round(time.perf_counter() - t, 3)
    n_chk = 100_000
    leaves = bst.predict(X[:n_chk], pred_leaf=True)
    exact_raw = bst.predict(X[:n_chk], raw_score=True)

    def exact_leaves(p, rows):
        planes = [torch.from_numpy(a).to(dev) for a in split_hi_lo(rows)]
        return _leaves_raw(planes, p.raw.trees, levels=p.raw.levels).T.cpu().numpy()

    def quant_leaves(p, rows):
        codes = torch.from_numpy(p.raw._host_input(rows)).to(dev)
        return qleaves(codes, p.raw.trees, p.raw.levels).T.cpu().numpy()

    _, res["exact_20"] = _in_process("exact 20 trees", art, X, exact_raw, dev, leaves,
                                     exact_leaves)
    qp, res["quantized_20"] = _in_process("quantized 20 trees", qart, X, exact_raw, dev,
                                          leaves, quant_leaves,
                                          drift_bound(art.arrays.leaf_value))
    big_raw = predict_raw(X[:n_chk], big.arrays.to_device(dev))[0]
    _, res["exact_1000"] = _in_process("exact 1000 trees", big, X, big_raw, dev)
    _, res["quantized_1000"] = _in_process("quantized 1000 trees", big.quantize(), X, big_raw,
                                           dev, bound=drift_bound(big.arrays.leaf_value))
    for key, text, rows in (("linear_v3", small_texts["linear"], X[:50_000]),
                            ("multiclass_k7", small_texts["k7"], cov_rows)):
        b = lgt.Booster(model_str=text, device=dev)
        a = PredictorArtifact.from_booster(b)
        p = PackedPredictor(a, device=dev)
        warm = p.warmup(4096)
        want, got = b.predict(rows), p.predict(rows)
        err = float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))
        res[key] = dict(format_version=a.meta["format_version"], flavor=a.flavor,
                        warmup_captures=warm["compiles"], rows=len(rows), max_rel_err=err,
                        shape=list(got.shape))
        log(f"serve {key}: {json.dumps(res[key])}")
        assert err <= 1e-6, f"{key}: {err:.3e} relative from Booster.predict"
    # the host's part of a 128-row request
    body = _jsonl(X[:128])
    res["host_ms_128_rows"] = {
        name: round(float(np.median(_median_ms(fn))), 4) for name, fn in (
            ("parse_rows", lambda: _parse_rows(body)),
            ("split_hi_lo", lambda: split_hi_lo(X[:128])),
            ("quantize_data", lambda: qp.raw._host_input(X[:128])))}
    log(f"serve host ms of a 128-row request: {json.dumps(res['host_ms_128_rows'])}")

    # ---- over HTTP: a server process with a registry
    work = os.path.join(HERE, "build", "chip_serve")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    model = art.save(os.path.join(work, "higgs.npz"))
    reg = os.path.join(work, "registry")
    port = _free_port()
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "lightgbm_tpu_torch", "serve",
                             f"model={model}", f"registry={reg}", f"port={port}",
                             "max_queue_rows=65536", "registry_poll_ms=100"]
                            + (["device=cpu"] if dev.type == "cpu" else []), cwd=work,
                            env=dict(os.environ, PYTHONPATH=HERE), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    lines = []
    reader = threading.Thread(target=lambda: lines.extend(proc.stdout), daemon=True)
    reader.start()
    try:
        while True:
            try:
                if _http(port, "/readyz", timeout=5)[0] == 200:
                    break
            except OSError:
                pass
            if proc.poll() is not None or time.perf_counter() - t0 > 240:
                raise RuntimeError("serve did not become ready:\n" + "".join(lines)[-4000:])
            time.sleep(0.1)
        ready_s = time.perf_counter() - t0
        st0 = json.loads(_http(port, "/stats")[2])
        exp = {1: bst.predict(X)}
        scaled = _scaled_artifact(art, 1.1)
        sraw = torch.as_tensor(predict_raw(X, scaled.arrays.to_device(dev)),
                               dtype=torch.float32, device=dev)
        exp[2] = bst.boosting.objective.convert_output(sraw).double().cpu().numpy()[0]

        def check(cuts, answers):
            worst, versions, preds = 0.0, collections.Counter(), np.empty(cuts[-1][1])
            for i, ver, out in answers:
                a, b = cuts[i]
                versions[ver] += 1
                worst = max(worst, float(np.abs(out - exp[ver][a:b]).max()))
                preds[a:b] = out
            return worst, dict(versions), preds

        Xh = X[:SERVE_HTTP_ROWS]
        main_auc = auc(yv[:len(Xh)], exp[1][:len(Xh)])  # the main model's on these rows
        cuts, answers, lat, fails, wall = _traffic(port, Xh, 2026)
        assert not fails, f"failed requests: {fails[:5]}"
        worst, versions, preds = check(cuts, answers)
        http_auc = auc(yv[:len(Xh)], preds)
        st = json.loads(_http(port, "/stats")[2])
        b = st["batcher"]
        fams = parse_text_format(_http(port, "/metrics")[2].decode())
        res["http"] = dict(
            ready_s=round(ready_s, 2), requests=len(cuts), rows=len(Xh), clients=SERVE_CLIENTS,
            wall_s=round(wall, 3), rows_per_s=round(len(Xh) / wall, 1),
            latency_p50_ms=round(float(np.percentile(lat, 50)), 3),
            latency_p99_ms=round(float(np.percentile(lat, 99)), 3),
            mean_batch_rows=round(b["rows"] / max(b["batches"], 1), 2), batches=b["batches"],
            failed=len(fails), versions=versions, max_abs_err=worst, auc=http_auc,
            main_auc=main_auc, auc_equal=http_auc == main_auc,
            warmup_captures=st0["compiles"]["predict_compiles"],
            captures_after_warmup=(st["compiles"]["graph_captures"]
                                   - st0["compiles"]["graph_captures"]),
            device_peak_mib=round(st["device_peak_bytes"] / 2**20, 2),
            metrics_families=len(fams),
            metrics_latency_count=fams["lightgbm_tpu_serve_latency_seconds"]["samples"][
                "lightgbm_tpu_serve_latency_seconds_count"])
        log(f"serve http: {json.dumps(res['http'])}")
        assert worst <= 1e-6, f"an HTTP answer is {worst:.3e} from Booster.predict"
        assert res["http"]["captures_after_warmup"] == 0
        assert abs(http_auc - main_auc) <= 1e-9, (http_auc, main_auc)

        # a same-shape retrain published mid-traffic
        published = threading.Lock()
        state = {}

        def publish(i, n):
            if i >= n * 3 // 10 and "v" not in state and published.acquire(blocking=False):
                state["at"] = i
                state["v"] = ModelRegistry(reg).publish(scaled)

        cuts, answers, lat, fails, wall = _traffic(port, X[:SERVE_SWAP_ROWS], 7, publish)
        assert not fails, f"failed requests across the swap: {fails[:5]}"
        worst, versions, _ = check(cuts, answers)
        for _ in range(300):
            st = json.loads(_http(port, "/stats")[2])
            if st["swap"]["swaps"] >= 1:
                break
            time.sleep(0.1)
        swap = st["swap"]["last"]
        res["swap"] = dict(requests=len(cuts), published_at=state.get("at"), versions=versions,
                           failed=len(fails), max_abs_err=worst, swap_ms=swap.get("swap_ms"),
                           in_place=swap.get("in_place"), new_captures=swap.get("new_compiles"),
                           latency_p99_ms=round(float(np.percentile(lat, 99)), 3),
                           captures_after_warmup=(st["compiles"]["graph_captures"]
                                                  - st0["compiles"]["graph_captures"]))
        log(f"serve swap: {json.dumps(res['swap'])}")
        assert worst <= 1e-6 and state["v"] == 2 and 2 in versions, res["swap"]
        assert swap["in_place"] and swap["new_compiles"] == 0
        assert res["swap"]["captures_after_warmup"] == 0

        # another shape class published mid-traffic: the 1,000-tree
        # artifact's ladder is captured beside the live predictor
        other = _scaled_artifact(art, 0.9 / SERVE_TILES, SERVE_TILES)
        n_other = max(SERVE_RESHAPE_ROWS, 30_000)  # the pass and the SIGTERM requests
        oraw = torch.as_tensor(predict_raw(X[:n_other], other.arrays.to_device(dev)),
                               dtype=torch.float32, device=dev)
        exp[3] = bst.boosting.objective.convert_output(oraw).double().cpu().numpy()[0]
        state.clear()
        published = threading.Lock()
        c_before = st["compiles"]["graph_captures"]

        def publish_other(i, n):
            if i >= n * 2 // 10 and "v" not in state and published.acquire(blocking=False):
                state["at"] = i
                state["v"] = ModelRegistry(reg).publish(other)

        cuts, answers, lat, fails, wall = _traffic(port, X[:SERVE_RESHAPE_ROWS], 8,
                                                   publish_other, until_version=3,
                                                   clients=SERVE_RESHAPE_CLIENTS,
                                                   max_rows=SERVE_RESHAPE_MAX)
        assert not fails, f"failed requests across the reshaping swap: {fails[:5]}"
        worst, versions, _ = check(cuts, answers)
        for _ in range(300):
            st = json.loads(_http(port, "/stats")[2])
            if st["swap"]["swaps"] >= 2:
                break
            time.sleep(0.1)
        swap = st["swap"]["last"]
        res["swap_other_shape"] = dict(
            requests=len(answers), clients=SERVE_RESHAPE_CLIENTS,
            published_at=state.get("at"), versions=versions,
            failed=len(fails), max_abs_err=worst, swap_ms=swap.get("swap_ms"),
            in_place=swap.get("in_place"), new_captures=swap.get("new_compiles"),
            buckets=st0["compiles"]["predict_compiles"],
            latency_p50_ms=round(float(np.percentile(lat, 50)), 3),
            latency_p99_ms=round(float(np.percentile(lat, 99)), 3),
            captures=st["compiles"]["graph_captures"] - c_before)
        log(f"serve swap to another shape: {json.dumps(res['swap_other_shape'])}")
        assert worst <= 1e-6 and state["v"] == 3 and 3 in versions, res["swap_other_shape"]
        assert not swap["in_place"] and swap["to_version"] == 3, swap
        assert swap["new_compiles"] == st0["compiles"]["predict_compiles"], swap
        assert res["swap_other_shape"]["captures"] == swap["new_compiles"]

        # SIGTERM with two requests in flight (their rows' parsing holds
        # them in the server's in-flight count)
        body = _jsonl(X[:30_000])
        got = []
        flight = [threading.Thread(target=lambda: got.append(_http(port, "/predict", body)))
                  for _ in range(2)]
        for th in flight:
            th.start()
        time.sleep(0.15)
        t_sig = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        ready = []
        for _ in range(200):
            try:
                ready.append(_http(port, "/readyz", timeout=5)[0])
            except OSError:
                break
            if ready[-1] == 503:
                break
            time.sleep(0.005)
        for th in flight:
            th.join(timeout=60)
        rc = proc.wait(timeout=60)
        exit_s = time.perf_counter() - t_sig
        reader.join(timeout=10)
        out = "".join(lines)
        res["sigterm"] = dict(readyz=ready, inflight=[c for c, _, _ in got], exit_code=rc,
                              exit_s=round(exit_s, 3), drained="drained and stopped" in out)
        log(f"serve sigterm: {json.dumps(res['sigterm'])}")
        assert 503 in ready and res["sigterm"]["inflight"] == [200, 200], res["sigterm"]
        assert rc == 0 and "drained and stopped" in out, out[-3000:]
        for _, _, body in got:
            assert np.abs(_answers(body) - exp[3][:30_000]).max() <= 1e-6
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    log("serve: " + json.dumps(res))
    return res


# ----------------------------------------------------------------------
# out of core (phase_ooc) and the serving fleet (phase_fleet)
OOC_ITERS = 2  # each streamed run and its resident twin (cut from 3)
OOC_AUTO_ITERS = 1  # the run that LIGHTGBM_TPU_DEVICE_BUDGET routes
FLEET_CLIENTS, FLEET_MAX_ROWS = 4, 64
FLEET_SECONDS, FLEET_FAULT_SECONDS = 6.0, 5.0
FLEET_FAULT = "delay:300"  # the restarted replica's LIGHTGBM_TPU_SERVE_FAULT
# with two replicas the fleet median is the mean of their two EWMAs, so a
# slow replica's EWMA never exceeds twice it: the latency breaker's k
# (3 by default) must be below 2 to open on one of two
FLEET_BREAKER_K = 1.5


def pinned_h2d_gbps(dev, mib=256, reps=5):
    """GB/s of one plain copy of ``mib`` MiB from pinned host memory to the
    card (the median of ``reps`` between two CUDA events)."""
    import torch

    if dev.type != "cuda":
        return float("nan")
    h = torch.empty(mib << 20, dtype=torch.uint8, pin_memory=True)
    d = torch.empty_like(h, device=dev)
    ms = time_cuda(lambda: d.copy_(h, non_blocking=True), reps)
    del h, d
    return (mib << 20) / (ms / 1e3) / 1e9


def staging_gbps(binned, dev, rows=2_400_256):
    """GB/s of the ring's staging copy of ``rows`` rows of ``binned`` into
    a pinned buffer (data/prefetch.py ``_stage``), by thread count: the
    median of 5."""
    import torch

    from lightgbm_tpu_torch.data import prefetch

    if dev.type != "cuda":
        return {}
    src = binned[:rows]
    dst = torch.empty(src.shape, dtype=torch.uint8, pin_memory=True).numpy()
    out = {}
    for k in (1, prefetch.STAGING_THREADS):
        ms = []
        for _ in range(5):
            t = time.perf_counter()
            prefetch._stage(dst, src, threads=k)
            ms.append(time.perf_counter() - t)
        out[k] = src.nbytes / float(np.median(ms)) / 1e9
    return out


def phase_kernels_carry(rows, chunk_rows, dev, seed=19):
    """B8 and B9's carry mode at the higgs width: rows x 28 features, 64
    bins, 60 % of the rows selected, folded over the out-of-core plan's
    chunks into one carry.  Finalized it must equal one resident launch
    over all the rows (B9 exactly, B8 after its single rounding), and the
    carry must equal the plain version's carry.  Times a carry-mode launch
    over one chunk against its plain version and bound.  Returns
    {name: {carry_*}}."""
    import torch

    from lightgbm_tpu_torch.data.prefetch import ChunkPlan
    from lightgbm_tpu_torch.ops import histogram as th

    F, B = 28, 64
    rng = np.random.default_rng(seed)
    bins = torch.from_numpy(rng.integers(0, B, size=(rows, F), dtype=np.uint8)).to(dev)
    g = torch.from_numpy(rng.standard_normal(rows, dtype=np.float32)).to(dev)
    h = torch.from_numpy(np.abs(rng.standard_normal(rows, dtype=np.float32))).to(dev)
    qg = torch.from_numpy(rng.integers(-15, 16, rows).astype(np.int16)).to(dev)
    qh = torch.from_numpy(rng.integers(1, 16, rows).astype(np.int16)).to(dev)
    sel = torch.from_numpy((rng.random(rows) < 0.6).astype(np.float32)).to(dev)
    plan = ChunkPlan(rows, chunk_rows)
    W = th.num_words(F, 4)
    out = {}
    for quantized in (False, True):
        P, kern, _ = hist_rows(bins, *((qg, qh) if quantized else (g, h)), sel, quantized)
        name = kern.__name__
        whole = kern(P, 0, rows, F, B)
        carry = th.new_carry(F, B, quantized, dev)
        plain = th.new_carry(F, B, quantized, dev)
        for lo, hi in plan.bounds:
            th.accumulate_histogram(carry, P, lo, hi, F, B)
            th._segment_hist_ref(P, lo, hi, F, B, 4, 8, None, quantized, carry=plain)
        folded = th.finalize_histogram(carry)
        sync(dev)
        equal_whole = bool(torch.equal(folded, whole))
        # against the plain carry: B9 exactly; B8's float64 sums of
        # millions of rows in another order differ in their last bits, so
        # its rounded histogram is held as every B8 is (check_hist)
        err = check_mask_hist(f"{name} carry", folded, th.finalize_histogram(plain))
        equal_plain = bool(torch.equal(carry, plain.to(carry.dtype)))
        lo, hi = plan.bounds[0]
        nsel = int(sel[lo:hi].sum())
        one = th.new_carry(F, B, quantized, dev)
        ms = burst_ms(lambda: th.accumulate_histogram(one, P, lo, hi, F, B))
        pms = time_cuda(lambda: th._segment_hist_ref(P, lo, hi, F, B, 4, 8, None, quantized,
                                                     carry=one), 3)
        work = hist_work(hi - lo, nsel, W, F, B)
        work["bytes"] += F * B * 3 * (4 if quantized else 8)  # the carry read and written
        bound = finish_bounds({"x": work})["x"]
        out[name] = dict(carry_ms=ms, carry_plain_ms=pms, carry_bound_ms=bound["bound_ms"],
                         carry_chunks=plan.num_chunks, carry_equal_whole=equal_whole,
                         carry_equal_plain=equal_plain, carry_max_abs_err=err)
        log(f"kernel {name} carry mode at {rows} x {F}, {plan.num_chunks} chunks of "
            f"{chunk_rows}: folded == one resident launch {equal_whole}, carry bit-equal to "
            f"the plain carry {equal_plain}; one chunk ({nsel} rows selected) {ms:.4f} ms, "
            f"plain {pms:.2f} ms, bound {bound['bound_ms']:.4f} ms ({bound['bound_by']})")
        assert equal_whole, f"{name}: the folded carry differs from one resident launch"
        assert equal_plain or not quantized, f"{name}: the carry differs from the plain one"
        del P
    return out


def phase_ooc(ds, dev):
    """"higgs-10.5M-ooc": the Higgs cell's binned data and parameters (255
    leaves, max_bin 63) on the mask grower with the bin matrix streamed
    (out_of_core=true, ooc_chunk_rows on auto: ~64 MiB chunks), float and
    quantized, OOC_ITERS iterations each, against the resident mask
    grower's run of the same parameters (LIGHTGBM_TPU_PGROW=0): the model
    text byte-identical.  Then out_of_core=auto with
    LIGHTGBM_TPU_DEVICE_BUDGET one byte below the packed bins: routing
    engages and gives the resident text.  Prints s/iter, the streamed
    GB/s, overlap_pct, passes and chunks a tree, peak device memory
    against the resident run's, and a plain 256 MiB pinned copy's GB/s
    with the pass's bound from it.  Returns the streamed paths' launch
    counts and the numbers."""
    import torch

    import lightgbm_tpu_torch as lgt

    res = {"h2d_pinned_gbps": pinned_h2d_gbps(dev)}
    binned = ds.construct(TRAIN_PARAMS)
    res["staging_gbps"] = staging_gbps(np.asarray(binned.binned), dev)
    packed = int(binned.num_data) * int(binned.num_features) * int(binned.binned.dtype.itemsize)
    counts = []

    def run(params, iters):
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        bst = lgt.train(params, ds, iters, device=dev)
        sync(dev)
        peak = torch.cuda.max_memory_allocated() / 2**30 if dev.type == "cuda" else float("nan")
        return bst, time.perf_counter() - t, peak

    env = {k: os.environ.get(k) for k in ("LIGHTGBM_TPU_PGROW", "LIGHTGBM_TPU_DEVICE_BUDGET",
                                          "LIGHTGBM_TPU_OOC")}
    os.environ["LIGHTGBM_TPU_PGROW"] = "0"
    os.environ.pop("LIGHTGBM_TPU_OOC", None)
    try:
        for kind, params, kernel in (("float", TRAIN_PARAMS, "hist_segment"),
                                     ("quantized", QUANT_PARAMS, "hist_segment_q")):
            rb, r_wall, r_peak = run(params, OOC_ITERS)
            assert rb.boosting.ooc is None and rb.boosting.ptrainer is None
            want, r_its = rb.model_to_string(), rb.boosting.iter_seconds
            del rb
            (ob, o_wall, o_peak), c = driven(f"higgs-10.5M-ooc {kind}", lambda: run(
                dict(params, out_of_core="true"), OOC_ITERS), (kernel,))
            counts.append(c)
            ooc = ob.boosting.ooc
            st = ooc.stats.as_dict()
            its = ob.boosting.iter_seconds
            passes = st["passes"] / OOC_ITERS
            pass_bytes = st["bytes"] / st["passes"]
            pass_ms = 1e3 * sum(its) / st["passes"]
            r = dict(s_iter=float(np.median(its[1:])), first_iter_s=its[0], wall_s=o_wall,
                     resident_s_iter=float(np.median(r_its[1:])), resident_wall_s=r_wall,
                     plan=ooc.plan.fingerprint(), depth=ooc.depth,
                     passes_a_tree=passes, chunks_a_tree=st["chunks"] / OOC_ITERS,
                     streamed_gbps=st["bytes"] / sum(its) / 1e9,
                     copy_gbps=st["bytes"] / st["copy_s"] / 1e9 if st["copy_s"] else None,
                     overlap_pct=st["overlap_pct"], fetch_s=st["fetch_s"],
                     stall_s=st["stall_s"], pass_ms=pass_ms,
                     pass_bound_ms=pass_bytes / (res["h2d_pinned_gbps"] * 1e9) * 1e3,
                     peak_gib=o_peak, resident_peak_gib=r_peak,
                     peak_inflight=st["peak_inflight"],
                     launches=c[kernel], same_text=ob.model_to_string() == want)
            res[kind] = r
            log(f"higgs-10.5M-ooc {kind}: {json.dumps(r)}")
            assert r["same_text"], f"the streamed {kind} model differs from the resident one"
            assert st["peak_inflight"] <= ooc.depth
            del ob
        # auto routing past a device budget just below the packed bins
        rb, _, _ = run(TRAIN_PARAMS, OOC_AUTO_ITERS)
        want = rb.model_to_string()
        del rb
        os.environ["LIGHTGBM_TPU_DEVICE_BUDGET"] = str(packed - 1)
        (ab, a_wall, _), c = driven("higgs-10.5M-ooc auto", lambda: run(
            dict(TRAIN_PARAMS, out_of_core="auto"), OOC_AUTO_ITERS), ("hist_segment",))
        counts.append(c)
        res["auto"] = dict(budget=packed - 1, packed_bytes=packed,
                           engaged=ab.boosting.ooc is not None, wall_s=a_wall,
                           chunk_rows=ab.boosting.ooc.plan.chunk_rows,
                           same_text=ab.model_to_string() == want)
        log(f"higgs-10.5M-ooc auto: {json.dumps(res['auto'])}")
        assert res["auto"]["engaged"] and res["auto"]["same_text"], res["auto"]
        del ab
    finally:
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    log("higgs-10.5M-ooc: " + json.dumps(res))
    return counts, res


def _gpu_used_mib():
    """The card's memory.used in MiB, as nvidia-smi reads it (its
    per-process table names no process inside a container)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=memory.used", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60).stdout
    return float(out.strip().splitlines()[0])


def _closed_loop(port, X, exp, seconds, seed, clients=FLEET_CLIENTS, on_tick=None):
    """``clients`` threads send requests of 1-FLEET_MAX_ROWS rows of ``X``
    (random offsets from ``seed``) for ``seconds``; each answer must carry
    one version and equal that version's predictions ``exp[v]`` within
    1e-6.  ``on_tick(elapsed)`` runs on the caller's thread meanwhile.
    Returns (answers by version, failures, latencies ms, rows, wall)."""
    import threading

    lock = threading.Lock()
    versions, fails, lat, nrows = collections.Counter(), [], [], [0]
    stop = time.monotonic() + seconds

    def client(k):
        rng = np.random.default_rng(seed + k)
        while time.monotonic() < stop:
            n = int(rng.integers(1, FLEET_MAX_ROWS + 1))
            a = int(rng.integers(0, len(X) - n))
            t = time.perf_counter()
            try:
                code, hdr, body = _http(port, "/predict", _jsonl(X[a:a + n]), timeout=60)
            except OSError as e:
                code, hdr, body = -1, {}, repr(e).encode()
            ms = 1e3 * (time.perf_counter() - t)
            err = None
            if code != 200:
                err = (code, body[:200])
            else:
                v = int(hdr.get("X-Model-Version", -1))
                if v not in exp:
                    err = ("version", v)
                elif np.abs(_answers(body) - exp[v][a:a + n]).max() > 1e-6:
                    err = ("answer", v)
            with lock:
                lat.append(ms)
                if err:
                    fails.append(err)
                else:
                    versions[v] += 1
                    nrows[0] += n

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(k,)) for k in range(clients)]
    for th in threads:
        th.start()
    while any(th.is_alive() for th in threads):
        if on_tick is not None:
            on_tick(time.perf_counter() - t0)
        time.sleep(0.05)
    for th in threads:
        th.join()
    return dict(versions), fails, lat, nrows[0], time.perf_counter() - t0


def _wait_http(port, path, proc, deadline_s, t0):
    """Seconds from ``t0`` until GET ``path`` answers 200."""
    while True:
        try:
            if _http(port, path, timeout=5)[0] == 200:
                return time.perf_counter() - t0
        except OSError:
            pass
        if proc.poll() is not None or time.perf_counter() - t0 > deadline_s:
            raise RuntimeError(f"port {port} never answered {path} (exit {proc.poll()})")
        time.sleep(0.05)


def phase_fleet(higgs, main_text, dev):
    """"higgs-10.5M-fleet": the main model (20 trees x 255 leaves) served by
    two `python -m lightgbm_tpu_torch serve` replicas on the one card,
    sharing a registry seeded with it, behind `python -m
    lightgbm_tpu_torch fleet backends=...`.  FLEET_CLIENTS closed-loop
    clients send requests of 1-FLEET_MAX_ROWS held-out rows for
    FLEET_SECONDS; meanwhile a same-shape retrain (leaf values x 1.1) is
    published through the proxy's /models and one replica is SIGKILLed:
    0 failed requests, every answer stamped with one version and within
    1e-6 of that version's predictions, the survivor on v2.  Then the
    killed replica is restarted on its port with LIGHTGBM_TPU_SERVE_FAULT
    = FLEET_FAULT: its breaker opens (/fleet/stats) and hedged requests
    carry the traffic, again with 0 failed.  Prints client p50/p99 and
    rows/s through the proxy, each replica's start (/healthz) and ready
    (/readyz) seconds and device memory (the growth of nvidia-smi's
    memory.used over both, halved, and each replica's own PyTorch
    peak)."""
    import signal

    import torch

    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.ops.predict import predict_raw
    from lightgbm_tpu_torch.serve import PredictorArtifact
    from lightgbm_tpu_torch.serve.fleet import _free_ports
    from lightgbm_tpu_torch.serve.registry import ModelRegistry

    _, Xv, _ = higgs
    X = np.asarray(Xv, np.float64)
    bst = lgt.Booster(model_str=main_text, device=dev)
    art = PredictorArtifact.from_booster(bst)
    retrain = _scaled_artifact(art, 1.1)
    sraw = torch.as_tensor(predict_raw(X, retrain.arrays.to_device(dev)), dtype=torch.float32,
                           device=dev)
    exp = {1: bst.predict(X),
           2: bst.boosting.objective.convert_output(sraw).double().cpu().numpy()[0]}
    work = os.path.join(HERE, "build", "chip_fleet")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    reg = os.path.join(work, "registry")
    ModelRegistry(reg).publish(art)
    ports = _free_ports(3)
    serve_args = [f"registry={reg}", "registry_poll_ms=100", "max_queue_rows=65536"] + (
        ["device=cpu"] if dev.type == "cpu" else [])
    env = dict(os.environ, PYTHONPATH=HERE)
    env.pop("LIGHTGBM_TPU_SERVE_FAULT", None)
    procs, logs = {}, {}

    def start(name, argv, extra_env=None):
        f = open(os.path.join(work, f"{name}.log"), "w")
        logs[name] = f
        procs[name] = subprocess.Popen([sys.executable, "-m", "lightgbm_tpu_torch"] + argv,
                                       cwd=work, env=dict(env, **(extra_env or {})), stdout=f,
                                       stderr=subprocess.STDOUT)
        return procs[name]

    res = {"replicas": {}}
    try:
        used0 = _gpu_used_mib() if dev.type == "cuda" else None
        t0 = time.perf_counter()
        for i in (0, 1):
            start(f"r{i}", ["serve", f"port={ports[i]}"] + serve_args)
        backends = ",".join(f"127.0.0.1:{p}" for p in ports[:2])
        start("proxy", ["fleet", f"backends={backends}", f"port={ports[2]}",
                        "health_poll_ms=200", "policy=rr", f"breaker_k={FLEET_BREAKER_K}"])
        for i in (0, 1):
            p = procs[f"r{i}"]
            res["replicas"][f"r{i}"] = dict(start_s=_wait_http(ports[i], "/healthz", p, 240, t0),
                                            ready_s=_wait_http(ports[i], "/readyz", p, 240, t0))
        res["proxy_start_s"] = _wait_http(ports[2], "/healthz", procs["proxy"], 120, t0)
        for _ in range(100):  # the proxy's prober has found both
            if json.loads(_http(ports[2], "/fleet/stats")[2])["healthy"] == 2:
                break
            time.sleep(0.1)
        if used0 is not None:  # the card's memory.used grew by both replicas' contexts
            res["replica_device_mib_each"] = (_gpu_used_mib() - used0) / 2
        for i in (0, 1):
            st = json.loads(_http(ports[i], "/stats")[2])
            res["replicas"][f"r{i}"]["torch_peak_mib"] = round(st["device_peak_bytes"] / 2**20, 2)
        log(f"fleet replicas: {json.dumps(res)}")

        # a same-shape retrain through the proxy, then a SIGKILL
        events = {}

        def tick(t):
            if t > 1.5 and "published" not in events:
                buf = io.BytesIO()
                retrain.save_to_bytes(buf)
                code, _, body = _http(ports[2], "/models", buf.getvalue())
                events["published"] = (round(t, 3), code, json.loads(body).get("version"))
            if t > 3.0 and "killed" not in events:
                procs["r0"].send_signal(signal.SIGKILL)
                events["killed"] = round(t, 3)

        versions, fails, lat, nrows, wall = _closed_loop(ports[2], X, exp, FLEET_SECONDS, 100,
                                                         on_tick=tick)
        procs["r0"].wait(timeout=60)
        surv = json.loads(_http(ports[1], "/stats")[2])
        res["swap_and_kill"] = dict(
            clients=FLEET_CLIENTS, requests=len(lat), rows=nrows, failed=len(fails),
            versions=versions, published=events.get("published"), killed_at=events.get("killed"),
            survivor_version=surv["model_version"], wall_s=round(wall, 3),
            rows_per_s=round(nrows / wall, 1),
            latency_p50_ms=round(float(np.percentile(lat, 50)), 3),
            latency_p99_ms=round(float(np.percentile(lat, 99)), 3))
        log(f"fleet swap and kill: {json.dumps(res['swap_and_kill'])}")
        assert not fails, f"failed requests: {fails[:5]}"
        assert events["published"][2] == 2 and 2 in versions, res["swap_and_kill"]
        assert surv["model_version"] == 2

        # the killed replica back on its port, wounded: every predict late.
        # The port came from the ephemeral range, so one of the clients'
        # connections can hold it as its local port for a moment: a start
        # that exits before it answers is logged and tried again
        t2 = time.perf_counter()
        for attempt in range(3):
            if attempt:
                logs["r0_fault"].close()
                with open(os.path.join(work, "r0_fault.log")) as f:
                    log(f"fleet: the restarted replica exited "
                        f"{procs['r0_fault'].returncode}; starting it again: "
                        f"{f.read()[-600:]!r}")
                time.sleep(1.0)
            start("r0_fault", ["serve", f"port={ports[0]}"] + serve_args,
                  {"LIGHTGBM_TPU_SERVE_FAULT": FLEET_FAULT})
            try:
                start_s = _wait_http(ports[0], "/healthz", procs["r0_fault"], 240, t2)
                break
            except RuntimeError:
                if procs["r0_fault"].poll() is None or attempt == 2:
                    raise
        restart = dict(start_s=start_s,
                       ready_s=_wait_http(ports[0], "/readyz", procs["r0_fault"], 240, t2))
        addr = f"127.0.0.1:{ports[0]}"
        for _ in range(100):  # the proxy's prober restores it
            st = json.loads(_http(ports[2], "/fleet/stats")[2])
            if all(b["healthy"] for b in st["backends"]):
                break
            time.sleep(0.1)
        picked0 = next(b for b in st["backends"] if b["addr"] == addr)["requests"]
        versions, fails, lat, nrows, wall = _closed_loop(ports[2], X, {2: exp[2]},
                                                         FLEET_FAULT_SECONDS, 200)
        st = json.loads(_http(ports[2], "/fleet/stats")[2])
        wounded = next(b for b in st["backends"] if b["addr"] == addr)
        res["fault"] = dict(
            spec=FLEET_FAULT, restart=restart, requests=len(lat), failed=len(fails),
            versions=versions, breaker=wounded["breaker"],
            wounded_attempts=wounded["requests"] - picked0,
            hedges=st["hedges"], open_breakers=st["open_breakers"],
            rows_per_s=round(nrows / wall, 1),
            latency_p50_ms=round(float(np.percentile(lat, 50)), 3),
            latency_p99_ms=round(float(np.percentile(lat, 99)), 3))
        log(f"fleet wounded replica: {json.dumps(res['fault'])}")
        assert not fails, f"failed requests with a wounded replica: {fails[:5]}"
        assert wounded["breaker"] and wounded["breaker"]["opens"] >= 1, res["fault"]
        assert st["hedges"]["launched"] >= 1 and st["hedges"]["wins"] >= 1, res["fault"]
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        for p in procs.values():
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        for f in logs.values():
            f.close()
    log("fleet: " + json.dumps(res))
    return res


# ----------------------------------------------------------------------
# the host-driven parallel learners (phase_parallel) and the training
# factory (phase_factory)
PARALLEL_ROWS = 15_000  # the main cell's first rows: 7 trees on the card, 5 on the CPU
PARALLEL_RANKS = 4
PARALLEL_MODES = (("data", {}), ("feature", {}), ("voting", {"top_k": 14}),
                  ("voting", {"top_k": 5}), ("data", {"quantized": True}))
FACTORY_PARTS = (40_000, 20_000, 60_000)  # cold, the clean append, the shuffled append
FACTORY_CLI_ROWS = 20_000  # the CLI's SIGKILL drill
# cut from 10 and 12 for time (PERF.md §4)
FACTORY_ROUNDS, FACTORY_CLI_ROUNDS = 6, 6
FACTORY_OBSERVE_S = 2.0


def _host_group(mode, shards, params, meta, hyper, dev, **kw):
    """One tree grown by ``len(shards)`` LocalComm ranks, a thread each, on
    ``dev``; each shard is (bins, grad, hess).  Returns the ranks'
    (GrowResult, ledger) and the wall seconds (the last read syncs)."""
    import threading

    from lightgbm_tpu_torch.parallel import HostParallelLearner, LocalGroup

    group = LocalGroup(len(shards))
    out, errs = [None] * len(shards), []
    fmask = torch_ones(meta.num_bins.shape[0], dev)

    def rank(r, comm):
        try:
            b, g, h = shards[r]
            gr = HostParallelLearner(mode, comm, params, **kw).grow(
                b, g, h, torch_ones(g.shape[0], dev), fmask, meta, hyper)
            out[r] = (gr, dict(comm.ledger))
        except BaseException as e:  # noqa: BLE001 - raised below
            errs.append(e)
            group.barrier.abort()

    t = time.perf_counter()
    threads = [threading.Thread(target=rank, args=(r, c), daemon=True)
               for r, c in enumerate(group.comms())]
    for th in threads:
        th.start()
    for th in threads:
        th.join(600)
        assert not th.is_alive(), f"a {mode} rank thread hung"
    if errs:
        raise errs[0]
    return out, time.perf_counter() - t


def torch_ones(n, dev):
    import torch

    return torch.ones(int(n), dtype=torch.float32, device=dev)


def _tree_fields(gr, skip=("leaf_id",)):
    """A GrowResult as host arrays, by field."""
    return {k: (v.cpu().numpy() if hasattr(v, "cpu") else np.asarray(v))
            for k, v in gr._asdict().items() if k not in skip}


def _same_tree(a, b, skip=("leaf_id",)):
    fa, fb = _tree_fields(a, skip), _tree_fields(b, skip)
    return all(np.array_equal(fa[k], fb[k]) for k in fa)


def _split_difference(a, b):
    """None when two trees' split records (leaf, feature, threshold,
    default bin) are equal; else (record, gain a, gain b, near-tie), the
    near-tie rule being gains within 1e-3 relative."""
    n = int(a.num_splits)
    fa, fb = _tree_fields(a), _tree_fields(b)
    if n != int(b.num_splits):
        return ("num_splits", n, int(b.num_splits), False)
    keys = ("rec_leaf", "rec_feat", "rec_thr", "rec_dbz")
    diff = [s for s in range(n) if any(fa[k][s] != fb[k][s] for k in keys)]
    if not diff:
        return None
    s = diff[0]
    ga, gb = float(fa["rec_gain"][s]), float(fb["rec_gain"][s])
    return (s, ga, gb, abs(ga - gb) <= 1e-3 * max(abs(ga), abs(gb)))


def parallel_inputs(ds, dev):
    """phase_parallel's inputs from the main cell's Dataset: its first
    PARALLEL_ROWS rows of bins, the boost-from-average gradients and
    hessians, the grower's parameters, the split hyperparameters and the
    feature metadata on ``dev``."""
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.ops.grow import GrowParams
    from lightgbm_tpu_torch.ops.split import FeatureMeta, SplitHyper

    binned = ds.construct(TRAIN_PARAMS)
    bins = np.ascontiguousarray(np.asarray(binned.binned)[:PARALLEL_ROWS])
    y = np.asarray(binned.metadata.label, np.float32)[:PARALLEL_ROWS]
    p = np.float32(y.mean())  # boost from average: the first tree's gradients
    grad = (p - y).astype(np.float32)
    hess = np.full(PARALLEL_ROWS, p * (np.float32(1) - p), np.float32)
    params = GrowParams(num_leaves=TRAIN_PARAMS["num_leaves"], num_bins=int(binned.max_num_bin),
                        has_categorical=False)
    hyper = SplitHyper.from_config(Config.from_params(TRAIN_PARAMS))
    return (bins, grad, hess), params, hyper, FeatureMeta.from_dataset(binned, device=dev)


def _parallel_shards(arrays, d, mode, ranks=PARALLEL_RANKS):
    """The ranks' (bins, grad, hess) on ``d``: row blocks, or every row
    for each rank in feature mode (its columns are sharded inside)."""
    import torch

    t = [torch.from_numpy(a).to(d) for a in arrays]
    if mode == "feature":
        return [t] * ranks
    c = np.linspace(0, len(arrays[0]), ranks + 1).astype(int)
    return [[a[c[r]:c[r + 1]] for a in t] for r in range(ranks)]


def _parallel_cpu_half(arrays, params, hyper, meta, mode, kw):
    """One mode of phase_parallel's CPU half, in a CPU-half worker: the
    mode over PARALLEL_RANKS rank threads on the CPU (plain versions).
    Returns (rank 0's tree, the ranks' ledgers, wall seconds)."""
    import torch

    cpu = torch.device("cpu")
    ranks, wall = _host_group(mode, _parallel_shards(arrays, cpu, mode), params, meta, hyper,
                              cpu, **kw)
    return ranks[0][0], [r[1] for r in ranks], wall


def parallel_mode_name(mode, kw):
    return mode + "".join(f" {k}={v}" for k, v in kw.items())


def start_parallel_cpu(pool, ds):
    """Hand phase_parallel's CPU half to the CPU-half workers of ``pool``,
    a task a mode (run_phases does so when the main cell's bins exist).
    Returns {mode name: future}."""
    import torch

    arrays, params, hyper, meta = parallel_inputs(ds, torch.device("cpu"))
    return {parallel_mode_name(mode, kw): pool.submit(_parallel_cpu_half, arrays, params,
                                                      hyper, meta, mode, kw)
            for mode, kw in PARALLEL_MODES}


def phase_parallel(ds, dev, cpu_half):
    """"higgs-10.5M-parallel": the host-driven learners (parallel/
    hostlearner.py) over PARALLEL_RANKS LocalComm ranks as threads on the
    one card, at the main cell's width (its bins cut to the first
    PARALLEL_ROWS rows, 28 features, max_bin 63, num_leaves 255,
    min_data_in_leaf 1, min_sum_hessian_in_leaf 100), one tree a mode from
    the boost-from-average gradients: data, feature, voting at top_k 14
    (2k >= F) and 5, and quantized data.  Holds feature == the serial
    grower on the card bitwise, voting(2k >= F) == data bitwise, the
    quantized tree equal at R = 1 and R = 4, each mode's split records
    equal to the same mode on the CPU (plain versions, run by the CPU-half
    workers: the futures ``cpu_half`` of start_parallel_cpu; or a near-tie
    first difference) and, where they are equal, the ledgers card against
    CPU.  Prints ms a tree by mode, bytes by purpose, and B8 / B9 launches
    and selected rows of the card path.  Returns the paths' counts."""
    from lightgbm_tpu_torch.ops.grow import grow_tree
    from lightgbm_tpu_torch.ops.histogram import pack_bin_words

    arrays, params, hyper, meta = parallel_inputs(ds, dev)
    bins = arrays[0]
    cuts = np.linspace(0, PARALLEL_ROWS, PARALLEL_RANKS + 1).astype(int)

    def shards(d, mode, ranks=PARALLEL_RANKS):
        return _parallel_shards(arrays, d, mode, ranks)

    res = {"rows": PARALLEL_ROWS, "ranks": PARALLEL_RANKS, "shard_rows": np.diff(cuts).tolist()}
    counts, card = [], {}
    for mode, kw in PARALLEL_MODES:
        name = parallel_mode_name(mode, kw)
        hk = "hist_segment_q" if kw.get("quantized") else "hist_segment"
        required = (hk,) if dev.type == "cuda" else ()  # a CPU rehearsal launches nothing
        (out, wall), c = driven(f"higgs-10.5M-parallel {name}", lambda: _host_group(
            mode, shards(dev, mode), params, meta, hyper, dev, **kw), required)
        counts.append(c)
        trees = [o[0] for o in out]
        assert all(_same_tree(trees[0], t) for t in trees[1:]), f"{name}: ranks disagree"
        cpu_tree, cpu_ledgers, cpu_wall = cpu_half[name].result()
        diff = _split_difference(trees[0], cpu_tree)
        same_ledgers = [o[1] for o in out] == cpu_ledgers
        card[name] = trees[0]
        r = dict(ms_a_tree=round(1e3 * wall, 3), cpu_ms_a_tree=round(1e3 * cpu_wall, 3),
                 splits=int(trees[0].num_splits), ledger=out[0][1],
                 ledger_total=sum(out[0][1].values()), launches=c[hk],
                 selected_rows=c[hk + "_rows"], cpu_split_difference=diff,
                 ledgers_equal_cpu=same_ledgers)
        res[name] = r
        log(f"higgs-10.5M-parallel {name}: {json.dumps(r)}")
        assert diff is None or diff[3], f"{name}: card and CPU trees differ: {diff}"
        assert diff is not None or same_ledgers, f"{name}: ledgers differ card against CPU"
    # the bitwise contracts on the card
    def serial_tree():
        b, g, h = shards(dev, "feature", 1)[0]
        t0 = time.perf_counter()
        gr = grow_tree(pack_bin_words(b), g, h, torch_ones(PARALLEL_ROWS, dev),
                       torch_ones(bins.shape[1], dev), meta, hyper, params)
        return gr, time.perf_counter() - t0

    (serial, wall), c = driven("higgs-10.5M-parallel serial", serial_tree,
                               ("hist_segment",) if dev.type == "cuda" else ())
    counts.append(c)
    res["serial_ms_a_tree"] = round(1e3 * wall, 3)
    res["feature_equals_serial"] = _same_tree(card["feature"], serial, skip=())
    res["voting_2k_equals_data"] = _same_tree(card["voting top_k=14"], card["data"])
    (q1, _), c = driven("higgs-10.5M-parallel quantized R=1", lambda: _host_group(
        "data", shards(dev, "data", 1), params, meta, hyper, dev, quantized=True),
        ("hist_segment_q",) if dev.type == "cuda" else ())
    counts.append(c)
    res["quantized_r1_equals_r4"] = _same_tree(q1[0][0], card["data quantized=True"])
    res["hist_payload_data_over_quantized"] = round(
        res["data"]["ledger"]["hist"] / res["data quantized=True"]["ledger"]["hist_q"], 3)
    log("higgs-10.5M-parallel: " + json.dumps(res))
    assert res["feature_equals_serial"], "feature mode differs from the serial grower"
    assert res["voting_2k_equals_data"], "voting with 2k >= F differs from data mode"
    assert res["quantized_r1_equals_r4"], "the quantized tree depends on the rank count"
    return counts, res


def _write_part(path, X, y):
    """A CSV part of the factory's data directory: the label first, then
    the features, ``%.6g``."""
    np.savetxt(path, np.column_stack([y, X]), delimiter=",", fmt="%.6g")


def _timed(res, key, fn):
    """``fn`` wrapped to add its wall seconds to ``res[key]`` (a list)."""
    def run(*a, **k):
        t = time.perf_counter()
        try:
            return fn(*a, **k)
        finally:
            res.setdefault(key, []).append(round(time.perf_counter() - t, 3))
    return run


def _factory_cli_drill(work, X, y, env, cpu_args, drill):
    """phase_factory's CLI drill: `python -m lightgbm_tpu_torch factory` on
    a fresh workdir over FACTORY_CLI_ROWS rows, SIGKILLed after two
    checkpoints, then run again: it must resume (its first checkpoint
    after the restart past iteration 1) and publish once.  Its processes
    go into ``drill["procs"]`` (phase_factory kills them if it fails
    first); ``drill["stop"]`` ends the wait for checkpoints.  Returns the
    drill's numbers."""
    import re
    import signal

    from lightgbm_tpu_torch.factory import FactoryState
    from lightgbm_tpu_torch.serve.registry import ModelRegistry

    cdir = os.path.join(work, "cli")
    os.makedirs(os.path.join(cdir, "data"))
    _write_part(os.path.join(cdir, "data", "part-000.csv"), X[:FACTORY_CLI_ROWS],
                y[:FACTORY_CLI_ROWS])
    cmd = [sys.executable, "-m", "lightgbm_tpu_torch", "factory",
           f"data={os.path.join(cdir, 'data')}", f"workdir={os.path.join(cdir, 'work')}",
           f"registry={os.path.join(cdir, 'registry')}", "max_cycles=1", "poll_ms=50",
           "debounce_ms=0", f"num_boost_round={FACTORY_CLI_ROUNDS}", "checkpoint_freq=1",
           "canary_fraction=0"] + [f"{k}={v}" for k, v in dict(TRAIN_PARAMS, verbose=1,
                                                               **cpu_args).items()]
    t = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=cdir, env=env, stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)
    drill["procs"].append(proc)
    try:
        ckpts = []
        while (time.perf_counter() - t < 240 and len(ckpts) < 2
               and not drill["stop"].is_set()):
            assert proc.poll() is None, "the factory CLI ended before the kill"
            ckpts = glob.glob(os.path.join(cdir, "work", "r*", "ckpt", "ckpt_*.npz"))
            time.sleep(0.01)
        assert len(ckpts) >= 2, "no checkpoints before the deadline"
        proc.send_signal(signal.SIGKILL)
        killed_s = round(time.perf_counter() - t, 3)
        assert proc.wait(timeout=30) == -signal.SIGKILL
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    mid = FactoryState.load(os.path.join(cdir, "work"))
    t = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=cdir, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT)
    drill["procs"].append(proc)
    try:
        text = proc.communicate(timeout=600)[0].decode(errors="replace")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, text[-3000:]
    saves = [int(m) for m in re.findall(r"Checkpoint saved at iteration (\d+)", text)]
    cli_reg = ModelRegistry(os.path.join(cdir, "registry"))
    done = FactoryState.load(os.path.join(cdir, "work"))
    out = dict(killed_after_s=killed_s, resume_s=round(time.perf_counter() - t, 3),
               first_checkpoint_after_restart=saves[0] if saves else None,
               versions=[m["version"] for m in cli_reg.list_models()],
               history=[(h["run_id"], h["verdict"]) for h in done.history],
               trees=cli_reg.load(1).meta["num_trees"])
    assert mid.run is not None and saves and saves[0] > 1, out
    assert out["versions"] == [1] and cli_reg.active_version() == 1, out
    assert out["history"] == [(mid.run["run_id"], "promoted")], out
    assert out["trees"] == FACTORY_CLI_ROUNDS, out
    return out


def phase_factory(dev):
    """"higgs-10.5M-factory": the training factory (factory/supervisor.py)
    on the card over a data directory of Higgs-shaped CSV parts (28
    features; FACTORY_PARTS rows: the cut) with the main cell's parameters
    and FACTORY_ROUNDS new rounds a retrain, checkpointed.  Cycle 1 trains
    cold and promotes.  Then one `python -m lightgbm_tpu_torch serve`
    replica on the card serves the registry behind an in-process
    FleetProxy under closed-loop clients; cycle 2 appends a part: the warm
    retrain is published inactive, canaried on a spawned replica pinned to
    it, and promoted; its model text must equal `lgt.train` of the same
    staged rows with the same init_model.  Cycle 3 appends a part whose
    labels are shuffled; its gate requires the candidate to beat the
    promoted model by 5 % on the shuffled rows (eval_max_rows, and
    metric_rel_tol -0.05:
    scored on its own training rows, label noise cannot make a candidate
    worse), so it rolls back and the quarantine records the reason.  From
    the end of cycle 2 on, beside cycle 3 (not beside the canary, whose
    device MiB is read), _factory_cli_drill runs the CLI's SIGKILL drill
    on a thread: it resumes and publishes once.  Holds 0
    failed client requests, each answer equal to its version's
    predictions, the verdicts and the state file.  Prints retrain s and
    publish ms a cycle, the canary's requests, errors and p99, the seconds
    from the append to the promotion, and the canary replica's device MiB.
    Returns the three cycles' launch counts."""
    import signal
    import threading

    import torch

    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.factory import FactoryState, FactorySupervisor
    from lightgbm_tpu_torch.serve.artifact import PackedPredictor
    from lightgbm_tpu_torch.serve.fleet import FleetProxy, _free_ports
    from lightgbm_tpu_torch.serve.registry import ModelRegistry

    work = os.path.join(HERE, "build", "chip_factory")
    shutil.rmtree(work, ignore_errors=True)
    data_dir, fdir, reg = (os.path.join(work, d) for d in ("data", "work", "registry"))
    os.makedirs(data_dir)
    cpu_args = {"device": "cpu"} if dev.type == "cpu" else {}
    params = dict(TRAIN_PARAMS, verbose=-1, **cpu_args)
    knobs = dict(num_boost_round=FACTORY_ROUNDS, checkpoint_freq=5, debounce_ms=0.0)
    X, y = make_higgs_shaped(sum(FACTORY_PARTS), seed=29)
    ends = np.cumsum(FACTORY_PARTS)
    parts = [os.path.join(data_dir, f"part-{i:03d}.csv") for i in range(3)]
    rows = X[:16].astype(np.float64)  # the clients' request (at most 16 rows: the warmup)
    body = _jsonl(rows)
    required = ("update_and_root_hist", "level_stream", "split_stream", "score_add") if (
        dev.type == "cuda") else ()
    res, counts, times = {"parts": list(FACTORY_PARTS), "rounds": FACTORY_ROUNDS}, [], {}

    def supervisor(proxy=None, **extra):
        sup = FactorySupervisor(data_dir, fdir, reg, params=dict(params), proxy=proxy,
                                **dict(knobs, **extra))
        sup._retrain = _timed(times, "retrain_s", sup._retrain)
        sup._publish = _timed(times, "publish_s", sup._publish)
        return sup

    t = time.perf_counter()
    _write_part(parts[0], X[:ends[0]], y[:ends[0]])
    res["write_s"] = round(time.perf_counter() - t, 3)
    v1, c = driven("higgs-10.5M-factory cold", supervisor(canary_fraction=0.0).run_cycle,
                   required)
    counts.append(c)
    assert v1["verdict"] == "promoted" and v1["version"] == 1 and not v1["warm_start"], v1
    v1_model = FactoryState.load(fdir).current["model_path"]

    port = _free_ports(1)[0]
    env = dict(os.environ, PYTHONPATH=HERE)
    env.pop("LIGHTGBM_TPU_SERVE_FAULT", None)
    serve_log = open(os.path.join(work, "replica.log"), "w")
    replica = subprocess.Popen(
        [sys.executable, "-m", "lightgbm_tpu_torch", "serve", f"port={port}", f"registry={reg}",
         "registry_poll_ms=100", "warmup_max_rows=16", "max_delay_ms=1"]
        + [f"{k}={v}" for k, v in cpu_args.items()],
        cwd=work, env=env, stdout=serve_log, stderr=subprocess.STDOUT)
    proxy, stop, threads = None, threading.Event(), []
    answers = collections.defaultdict(list)
    fails, lat = [], []
    lock = threading.Lock()

    def client():
        while not stop.is_set():
            t0 = time.perf_counter()
            try:
                code, hdr, out = _http(proxy.server_address[1], "/predict", body, timeout=60)
            except OSError as e:
                code, hdr, out = -1, {}, repr(e).encode()
            with lock:
                lat.append(1e3 * (time.perf_counter() - t0))
                if code != 200:
                    fails.append((code, out[:200]))
                else:
                    answers[int(hdr.get("X-Model-Version", -1))].append(_answers(out))

    drill, drill_thread = {"procs": [], "stop": threading.Event()}, None

    def run_drill():
        try:
            drill["res"] = _factory_cli_drill(work, X, y, env, cpu_args, drill)
        except BaseException as e:  # noqa: BLE001 - end_drill raises it
            drill["err"] = e

    def end_drill(kill):
        """Join the drill's thread, its processes killed first on ``kill``
        (this phase failed); without, re-raise the drill's failure."""
        if drill_thread is None:
            return
        if kill:
            drill["stop"].set()
            for p in drill["procs"]:
                if p.poll() is None:
                    p.kill()
        drill_thread.join(900)
        assert not drill_thread.is_alive(), "the factory CLI drill hung"
        if "err" in drill and not kill:
            raise drill["err"]

    try:
        t0 = time.perf_counter()
        res["replica_ready_s"] = _wait_http(port, "/readyz", replica, 240, t0)
        proxy = FleetProxy(("127.0.0.1", 0), [f"127.0.0.1:{port}"], health_poll_s=0.2,
                           retry_deadline_s=20.0)
        threading.Thread(target=proxy.serve_forever, args=(0.02,), daemon=True).start()
        threads = [threading.Thread(target=client, daemon=True) for _ in range(2)]
        for th in threads:
            th.start()

        # cycle 2: a clean append, canaried on a replica pinned to it
        _write_part(parts[1], X[ends[0]:ends[1]], y[ends[0]:ends[1]])
        appended = time.time()
        sup2 = supervisor(proxy=f"127.0.0.1:{proxy.server_address[1]}", canary_fraction=0.5,
                          observe_s=FACTORY_OBSERVE_S, min_requests=5, canary_warmup_rows=16)
        canary_mib = {}
        real_canary = sup2._canary

        def canary(version):
            base, done = _gpu_used_mib() if dev.type == "cuda" else 0.0, threading.Event()
            canary_mib["peak"] = base

            def sample():
                while not done.wait(0.2):
                    canary_mib["peak"] = max(canary_mib["peak"], _gpu_used_mib())

            th = threading.Thread(target=sample, daemon=True)
            if dev.type == "cuda":
                th.start()
            try:
                return real_canary(version)
            finally:
                done.set()
                if th.is_alive():
                    th.join()
                canary_mib["mib"] = canary_mib["peak"] - base

        sup2._canary = canary
        v2, c = driven("higgs-10.5M-factory warm", sup2.run_cycle, required)
        counts.append(c)
        res["append_to_promotion_s"] = round(v2["t_end"] - appended, 3)
        res["canary"] = dict(v2["detail"].get("canary", {}), replica_device_mib=canary_mib.get(
            "mib"))
        assert v2["verdict"] == "promoted" and v2["version"] == 2 and v2["warm_start"], v2
        assert res["canary"]["requests"] >= 5 and res["canary"]["errors"] == 0, res["canary"]
        assert proxy.stats()["canary"] is None
        deadline = time.monotonic() + 30
        while not answers.get(2) and time.monotonic() < deadline:  # the fleet swaps to v2
            time.sleep(0.1)
        # the CLI drill from here on, beside cycle 3: not beside the canary,
        # whose device MiB nvidia-smi reads
        drill_thread = threading.Thread(target=run_drill, daemon=True)
        drill_thread.start()

        # the promoted text against lgt.train of the same staged rows
        stage = os.path.join(work, "stage2.data")
        with open(stage, "wb") as out:
            for part in parts[:2]:
                with open(part, "rb") as f:
                    shutil.copyfileobj(f, out)
        p2 = dict(params, out_of_core="auto")
        want = lgt.train(p2, lgt.Dataset(stage, params=dict(p2)), FACTORY_ROUNDS,
                         init_model=v1_model, device=dev).model_to_string()
        res["promoted_equals_lgt_train"] = (
            open(FactoryState.load(fdir).current["model_path"]).read() == want)
        assert res["promoted_equals_lgt_train"], "the promoted model is not lgt.train's"

        # cycle 3: shuffled labels; the gate rolls back
        shuffled = np.random.default_rng(3).permutation(y[ends[1]:])
        _write_part(parts[2], X[ends[1]:], shuffled)
        v3, c = driven("higgs-10.5M-factory shuffled", supervisor(
            canary_fraction=0.0, metric_rel_tol=-0.05, metric_abs_tol=0.0,
            eval_max_rows=FACTORY_PARTS[2]).run_cycle, required)
        counts.append(c)
        res["rollback"] = dict(verdict=v3["verdict"], reason=v3.get("reason"),
                               eval=v3["detail"]["eval"])
        assert v3["verdict"] == "rolled_back" and "regressed" in v3["reason"], v3
        registry = ModelRegistry(reg)
        assert registry.quarantined() == {3: v3["reason"]} and registry.active_version() == 2
        state = FactoryState.load(fdir)
        assert [h["verdict"] for h in state.history] == ["promoted", "promoted", "rolled_back"]
    except BaseException:
        end_drill(kill=True)
        raise
    finally:
        stop.set()
        for th in threads:
            th.join(timeout=60)
        if proxy is not None:
            proxy.shutdown()
            proxy.server_close()
        replica.send_signal(signal.SIGTERM)
        try:
            replica.wait(timeout=30)
        except subprocess.TimeoutExpired:
            replica.kill()
            replica.wait()
        serve_log.close()
    try:
        expected = {v: PackedPredictor(ModelRegistry(reg).load(v), device=dev).predict(rows)
                    for v in answers}
        wrong = sum(int(np.abs(a - expected[v]).max() > 1e-6) for v, got in answers.items()
                    for a in got)
        res["clients"] = dict(requests=len(lat), failed=len(fails), wrong=wrong,
                              versions={v: len(a) for v, a in answers.items()},
                              p50_ms=round(float(np.percentile(lat, 50)), 3),
                              p99_ms=round(float(np.percentile(lat, 99)), 3))
        res.update(times)
        log(f"higgs-10.5M-factory cycles: {json.dumps(res)}")
        assert not fails and not wrong, res["clients"]
        assert set(answers) == {1, 2}, res["clients"]
    except BaseException:
        end_drill(kill=True)
        raise

    end_drill(kill=False)
    res["cli"] = drill["res"]
    log(f"higgs-10.5M-factory cli: {json.dumps(res['cli'])}")
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    log("higgs-10.5M-factory: " + json.dumps(res))
    return counts, res


# ----------------------------------------------------------------------
# training over several processes (phase_distributed)
DIST_ROWS = 20_000  # the main cell's first rows: 10,000 a rank (a split's host work sets a tree)
DIST_ITERS = 2  # cut from 3, for time
DIST_TIMEOUT = 3.0  # the drills' network_timeout, s
DIST_CALM_TIMEOUT = 10.0  # the four modes' (no fault: a busy host must not read as one)
DIST_WEDGE_AT = 20  # the wedged rank's stalled collective: in its first tree
DIST_MODES = (("data", "data", {}), ("feature", "feature", {}),
              ("voting", "voting", {"top_k": 14}),
              ("quantized", "data", {"quantized_training": "true"}))


class _Ranks:
    """``nranks`` (two) `python -m lightgbm_tpu_torch train` rank processes
    of one run, bootstrapped from a machine list on 127.0.0.1 with
    LIGHTGBM_TPU_PROCESS_ID; each logs to <tag>.rank<r>.log and traces to
    <tag>.rank<r>.jsonl in ``work``."""

    def __init__(self, work, tag, data, kw, extra=(), env=None, device="cuda",
                 rank0_ends=False, timeout=DIST_TIMEOUT, nranks=2, iters=DIST_ITERS):
        from lightgbm_tpu_torch.serve.fleet import _free_ports

        ports = _free_ports(nranks)
        # rank0_ends: once rank 0 has exited, rank 1 is killed (the wedge
        # drill's stalled rank would only find its coordinator gone)
        self.work, self.tag, self.t0 = work, tag, time.perf_counter()
        self.started = time.time()  # the host clock of the spawn (trace records' ts)
        self.rank0_ends = rank0_ends
        self.ends = [None] * nranks
        self.procs, self.logs = [], []
        machines = ",".join(f"127.0.0.1:{p}" for p in ports)
        for r in range(nranks):
            path = os.path.join(work, f"{tag}.rank{r}")
            self.logs.append(path + ".log")
            args = ["train", f"data={data[r]}", f"output_model={path}.model.txt",
                    f"machines={machines}", f"num_machines={nranks}",
                    "pre_partition=true", f"num_iterations={iters}",
                    f"network_timeout={timeout}", *[f"{k}={v}" for k, v in dict(
                        TRAIN_PARAMS, verbose=1, **kw).items()], *extra]
            if device == "cpu":  # a rehearsal on the CPU
                args.append("device=cpu")
            e = {k: v for k, v in os.environ.items() if not k.startswith("LIGHTGBM_TPU_")}
            e.update(PYTHONPATH=HERE, OMP_NUM_THREADS="1", LIGHTGBM_TPU_PROCESS_ID=str(r),
                     LIGHTGBM_TPU_TRACE=path + ".jsonl", **((env or {}).get(r, {})))
            with open(path + ".log", "w") as f:
                self.procs.append(subprocess.Popen(
                    [sys.executable, "-m", "lightgbm_tpu_torch", *args], cwd=work, env=e,
                    stdout=f, stderr=subprocess.STDOUT))

    def poll(self):
        """Note each rank's exit time; True when both have exited."""
        for r, p in enumerate(self.procs):
            if self.ends[r] is None and p.poll() is not None:
                self.ends[r] = time.perf_counter() - self.t0
        if self.rank0_ends and self.ends[0] is not None and self.ends[1] is None:
            self.kill()
        return all(e is not None for e in self.ends)

    def kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()

    def rcs(self):
        return [p.returncode for p in self.procs]

    def ranks(self):
        return range(len(self.procs))

    def log_text(self, r):
        with open(self.logs[r]) as f:
            return f.read()

    def trace(self, r):
        from lightgbm_tpu_torch.obs.report import load_trace

        return load_trace(os.path.join(self.work, f"{self.tag}.rank{r}.jsonl"), warn=False)

    def model(self, r):
        with open(os.path.join(self.work, f"{self.tag}.rank{r}.model.txt")) as f:
            return f.read()


def _wait_ranks(groups, timeout=300):
    """Wait until every group's ranks have exited (noting the times)."""
    t = time.perf_counter()
    while not all(g.poll() for g in groups):
        if time.perf_counter() - t > timeout:
            for g in groups:
                g.kill()
            raise RuntimeError(f"rank processes still running after {timeout} s: "
                               f"{[g.tag for g in groups]}")
        time.sleep(0.02)


def _require_ok(g, mode, device="cuda"):
    """Both ranks exited 0 on the card, over the bootstrapped world, with
    the host-driven learner: anything else is a fault, never a fallback."""
    for r in range(2):
        text = g.log_text(r)
        if g.rcs()[r] != 0:
            log(text[-4000:])
            raise RuntimeError(f"{g.tag} rank {r}: exit {g.rcs()[r]}")
        assert f"Distributed runtime up: rank {r} of 2" in text, f"{g.tag} rank {r}: no world"
        assert f"Using host-driven {mode}-parallel learner over 2 processes on {device}" in text, (
            f"{g.tag} rank {r}: not the host learner on the card")


def _collective_calls(trace):
    """The 1-based collective call of each checkpoint barrier of a rank's
    trace (its allgathers in the order they ran)."""
    n, out = 0, []
    for rec in trace:
        if rec.get("ev") == "span" and rec.get("name") == "net.allgather":
            n += 1
            if rec.get("parent") == "ckpt.barrier":
                out.append(n)
    return out, n


def _rank_numbers(g, r):
    """One rank's numbers from its trace and log: ms a tree (median of its
    iteration records), bootstrap s, allgathers, bytes by purpose (the
    learner's ledger and every collective's), launches, peak device MiB."""
    tr = g.trace(r)
    iters = [1e3 * rec["wall_s"] for rec in tr if rec.get("ev") == "iter"]
    boot = [rec["secs"] for rec in tr if rec.get("name") == "net.bootstrap"]
    ledger = [rec["ledger"] for rec in tr if rec.get("name") == "net.ledger"]
    launches = [rec["counts"] for rec in tr if rec.get("name") == "kernel.launches"]
    sent = {}
    for rec in tr:
        if rec.get("ev") == "counter" and rec.get("name") == "net.bytes":
            sent[rec["purpose"]] = sent.get(rec["purpose"], 0) + int(rec["value"])
    peak = _logged(g.log_text(r), "Peak device memory ")
    return dict(ms_a_tree=round(float(np.median(iters)), 3) if iters else None,
                trees=len(iters), bootstrap_s=boot[0] if boot else None,
                allgathers=sum(1 for rec in tr if rec.get("name") == "net.allgather"),
                ledger=ledger[0] if ledger else None, bytes_sent=sent,
                launches=launches[0] if launches else None,
                peak_device_mib=round(float(peak[0].split()[0]) * 1024, 1) if peak else None)


def _card_mib_sampler(stop, out):
    """The card's used MiB (nvidia-smi) every 0.5 s until ``stop``; the
    largest reading goes into ``out["card_mib"]``."""
    while not stop.is_set():
        try:
            smi = subprocess.run(["nvidia-smi", "--query-gpu=memory.used",
                                  "--format=csv,noheader,nounits"], capture_output=True,
                                 text=True, timeout=10)
            out["card_mib"] = max(out.get("card_mib", 0), int(smi.stdout.split()[0]))
        except (OSError, ValueError, IndexError, subprocess.SubprocessError):
            pass
        stop.wait(0.5)


def phase_distributed(ds, dev):
    """"higgs-10.5M-distributed": training over several processes on the
    one card (parallel/distributed.py, collect.py, net.py; the host
    learners over NetComm, their B8 / B9 in each rank process).  The main
    cell's first DIST_ROWS rows as CSV files (the label first), a
    contiguous half a rank (feature mode: every row on both); two `python
    -m lightgbm_tpu_torch train` processes a run, bootstrapped from a
    machine list on 127.0.0.1, the main cell's parameters, DIST_ITERS
    iterations, network_timeout DIST_CALM_TIMEOUT (the drills:
    DIST_TIMEOUT), each traced.  Modes: data
    (checkpointed every iteration), feature, voting at top_k 14 (2k >= F),
    quantized data: data and feature first, then the rest beside the
    drills and this process's references.  Checks, each a
    failure when it
    does not hold: feature's model text == the serial mask grower's on the
    same CSV in this process; voting's == data's; data's and quantized's
    == the same mode over LocalComm rank threads in this process on the
    ranks' saved bins (is_save_binary_file), rank by rank, and each rank's
    ledger == its thread's; rank 1 SIGKILLed mid-run (LIGHTGBM_TPU_FAULT=
    die:K at the middle of iteration 2's collectives) makes rank 0 exit 75
    within 2 x DIST_TIMEOUT + 10 s, and the rerun resumes to data's model
    text; a wedged rank 1 (a delay fault past the budget at its
    DIST_WEDGE_AT-th collective) makes rank 0 exit 74; `report merge` of
    data's two traces: one timeline whose run_ids agree.  Prints ms a tree of each mode (the ranks' iter records),
    bytes by purpose, allgathers and their wait share, bootstrap s, each
    rank's peak device MiB and the card's (nvidia-smi), the ranks' launches
    (which count in the kernels line).  Returns the paths' counts."""
    import threading

    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.obs import report
    from lightgbm_tpu_torch.parallel.comm import LocalGroup, rank_thread

    work = os.path.join(HERE, "build", "chip_dist")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    X = np.asarray(ds.data[:DIST_ROWS])
    y = np.asarray(ds.construct(TRAIN_PARAMS).metadata.label[:DIST_ROWS])
    half = DIST_ROWS // 2
    files = {}
    for name, mode, _ in DIST_MODES:  # a file set a run: each rank may save its bins
        if mode == "feature":
            path = os.path.join(work, f"{name}.all.csv")
            np.savetxt(path, np.column_stack([y, X]), delimiter=",", fmt="%.9g")
            files[name] = [path, path]
            continue
        files[name] = []
        for r in range(2):
            path = os.path.join(work, f"{name}.shard{r}.csv")
            np.savetxt(path, np.column_stack([y[r * half:(r + 1) * half],
                                              X[r * half:(r + 1) * half]]),
                       delimiter=",", fmt="%.9g")
            files[name].append(path)
    for tag in ("kill", "wedge"):
        files[tag] = [shutil.copy(p, p.replace("data.", f"{tag}.")) for p in files["data"]]
    res, counts, groups = {"rows": DIST_ROWS, "iterations": DIST_ITERS}, [], []
    stop = threading.Event()
    sampler = threading.Thread(target=_card_mib_sampler, args=(stop, res), daemon=True)
    sampler.start()
    kw_of = {name: dict(kw, tree_learner=mode) for name, mode, kw in DIST_MODES}
    ck = os.path.join(work, "ck_data")
    on = dict(device=dev.type)
    calm = dict(on, timeout=DIST_CALM_TIMEOUT)
    need = (lambda k: (k,)) if dev.type == "cuda" else (lambda k: ())  # a CPU rehearsal
    saves = ("is_save_binary_file=true",)
    try:
        # wave 1: data (checkpointed) and feature
        t0 = time.perf_counter()
        runs = {"data": _Ranks(work, "data", files["data"], kw_of["data"],
                               saves + (f"checkpoint_dir={ck}", "checkpoint_freq=1"), **calm),
                "feature": _Ranks(work, "feature", files["feature"], kw_of["feature"], **calm)}
        groups += runs.values()
        _wait_ranks(list(runs.values()))
        wave1 = time.perf_counter() - t0
        for name in runs:
            _require_ok(runs[name], kw_of[name]["tree_learner"], dev.type)
        barriers, total = _collective_calls(runs["data"].trace(1))
        assert len(barriers) == DIST_ITERS, f"checkpoint barriers {barriers}"
        die_at = (barriers[0] + barriers[1]) // 2
        # wave 2: voting and quantized; rank 1 of a data run killed mid-run,
        # then that run resumed; a data run whose rank 1 stalls a
        # collective past the budget; this process's references
        t0 = time.perf_counter()
        stall_ms = int((2 * DIST_TIMEOUT + 6) * 1000)
        wedge = _Ranks(work, "wedge", files["wedge"], kw_of["data"], rank0_ends=True,
                       env={1: {"LIGHTGBM_TPU_FAULT": f"delay:{stall_ms}:after:{DIST_WEDGE_AT}",
                                "LIGHTGBM_TPU_FAULT_RANK": "1"}}, **on)
        groups.append(wedge)
        runs["voting"] = _Ranks(work, "voting", files["voting"], kw_of["voting"], **calm)
        runs["quantized"] = _Ranks(work, "quantized", files["quantized"], kw_of["quantized"],
                                   saves, **calm)
        ck_kill = os.path.join(work, "ck_kill")
        kill = _Ranks(work, "kill", files["kill"], kw_of["data"],
                      (f"checkpoint_dir={ck_kill}", "checkpoint_freq=1"),
                      env={1: {"LIGHTGBM_TPU_FAULT": f"die:{die_at}",
                               "LIGHTGBM_TPU_FAULT_RANK": "1"}}, **on)
        groups += [runs["voting"], runs["quantized"], kill]
        _wait_ranks([kill])
        kill_log = kill.log_text(0)
        # the drill's times from the ranks' traces (one clock): rank 1's last
        # record before its death, rank 0's peer-failure event and its last
        # record before its exit (a killed process's exit itself lags: the
        # card's context is torn down first)
        dead = kill.trace(1)[-1]["ts"]
        tr0 = kill.trace(0)
        found = [r["ts"] for r in tr0 if r.get("name") == "net.peer_failure"]
        res["kill"] = dict(die_at_collective=die_at, collectives_a_run=total, rcs=kill.rcs(),
                           detected_after_death_s=round(found[0] - dead, 3) if found else None,
                           rank0_exit_after_death_s=round(tr0[-1]["ts"] - dead, 3),
                           bound_s=2 * DIST_TIMEOUT + 10)
        log(f"higgs-10.5M-distributed kill: {json.dumps(res['kill'])}")
        assert kill.rcs() == [75, -9], f"kill drill exits {kill.rcs()}: {kill_log[-3000:]}"
        assert res["kill"]["detected_after_death_s"] is not None, kill_log[-3000:]
        assert res["kill"]["rank0_exit_after_death_s"] <= 2 * DIST_TIMEOUT + 10
        assert "ranks [1]" in kill_log, kill_log[-3000:]
        # the rerun resumes, beside the rest of the wave
        resume = _Ranks(work, "resume", files["kill"], kw_of["data"],
                        (f"checkpoint_dir={ck_kill}", "checkpoint_freq=1"), **on)
        groups.append(resume)
        # this process's references beside them: the serial mask grower
        # on feature's CSV, and data / quantized over LocalComm rank threads
        # on the ranks' saved bins, on the card
        os.environ["LIGHTGBM_TPU_PGROW"] = "0"
        try:
            def serial():
                return lgt.train(dict(TRAIN_PARAMS), lgt.Dataset(files["feature"][0]),
                                 DIST_ITERS, device=dev).model_to_string()

            serial_text, c = driven("higgs-10.5M-distributed serial", serial,
                                    need("hist_segment"))
            counts.append(c)
        finally:
            os.environ.pop("LIGHTGBM_TPU_PGROW", None)
        threads = {}
        for name in ("data", "quantized"):
            params = dict(TRAIN_PARAMS, num_machines=2, pre_partition=True,
                          network_timeout=DIST_CALM_TIMEOUT, **kw_of[name])
            hk = "hist_segment_q" if name == "quantized" else "hist_segment"

            def group_run(params=params, name=name):
                group, out, errs = LocalGroup(2), [None, None], []

                def work_rank(r, comm):
                    try:
                        with rank_thread(comm):
                            b = lgt.train(dict(params), lgt.Dataset(files[name][r] + ".bin"),
                                          DIST_ITERS, device=dev)
                            out[r] = (b.model_to_string(), dict(comm.ledger))
                    except BaseException as e:  # noqa: BLE001 - raised below
                        errs.append(e)
                        group.barrier.abort()

                ts = [threading.Thread(target=work_rank, args=(r, c), daemon=True)
                      for r, c in enumerate(group.comms())]
                for t in ts:
                    t.start()
                for t in ts:
                    t.join(300)
                if errs:
                    raise errs[0]
                return out

            threads[name], c = driven(f"higgs-10.5M-distributed {name} rank threads",
                                      group_run, need(hk))
            counts.append(c)
        _wait_ranks([runs["voting"], runs["quantized"], wedge, resume])
        wave2 = time.perf_counter() - t0
        for name in ("voting", "quantized"):
            _require_ok(runs[name], kw_of[name]["tree_learner"], dev.type)
        # rank 1 stalls at its DIST_WEDGE_AT-th collective: from the end of
        # the one before (its span's record)
        spans1 = [r["ts"] for r in wedge.trace(1)
                  if r.get("ev") == "span" and r.get("name") == "net.allgather"]
        stalled = spans1[DIST_WEDGE_AT - 2]
        gave_up = [r["ts"] for r in wedge.trace(0) if r.get("name") == "net.timeout"]
        res["wedge"] = dict(rcs=wedge.rcs(), stall_ms=stall_ms, at_collective=DIST_WEDGE_AT,
                            rank0_timeout_after_stall_s=round(gave_up[0] - stalled, 3)
                            if gave_up else None)
        log(f"higgs-10.5M-distributed wedge: {json.dumps(res['wedge'])}")
        assert wedge.rcs()[0] == 74, f"wedge drill: {wedge.log_text(0)[-3000:]}"
        assert "Collective/bootstrap timeout" in wedge.log_text(0)
        _require_ok(resume, "data", dev.type)
        resumed = _logged(resume.log_text(0), "Resuming training from checkpoint at iteration ")
        res["resume"] = dict(from_iteration=int(resumed[0]) if resumed else None,
                             equals_uninterrupted=resume.model(0) == runs["data"].model(0))
        log(f"higgs-10.5M-distributed resume: {json.dumps(res['resume'])}")
        assert res["resume"]["from_iteration"] == 1, resume.log_text(0)[-3000:]
        assert res["resume"]["equals_uninterrupted"], "the resumed model differs"
        res["waves_s"] = [round(w, 3) for w in (wave1, wave2)]
    finally:
        stop.set()
        for g in groups:
            g.kill()
    sampler.join(15)
    # the checks
    res["checks"] = dict(
        feature_equals_serial=runs["feature"].model(0) == serial_text,
        voting_equals_data=runs["voting"].model(0) == runs["data"].model(0),
        ranks_agree=all(g.model(0) == g.model(1) for g in runs.values()),
        **{f"{name}_equals_rank_threads": all(
            threads[name][r][0] == runs[name].model(r) for r in range(2))
           for name in threads})
    for name, g in runs.items():
        nums = [_rank_numbers(g, r) for r in range(2)]
        res[name] = dict(ms_a_tree=[n["ms_a_tree"] for n in nums],
                         trees=[n["trees"] for n in nums],
                         bootstrap_s=[n["bootstrap_s"] for n in nums],
                         allgathers=[n["allgathers"] for n in nums],
                         ledger=nums[0]["ledger"], bytes_sent=nums[0]["bytes_sent"],
                         peak_device_mib=[n["peak_device_mib"] for n in nums],
                         hist_launches=[n["launches"]["hist_segment"] for n in nums],
                         hist_q_launches=[n["launches"]["hist_segment_q"] for n in nums])
        if name in threads:
            res["checks"][f"{name}_ledgers_equal_rank_threads"] = all(
                threads[name][r][1] == nums[r]["ledger"] for r in range(2))
        for n in nums:
            counts.append(n["launches"])
        log(f"higgs-10.5M-distributed {name}: {json.dumps(res[name])}")
    resumed_launches = [_rank_numbers(resume, r)["launches"] for r in range(2)]
    counts += resumed_launches  # the resumed run's processes launched too
    res["resume"]["hist_launches"] = [c["hist_segment"] for c in resumed_launches]
    paths = [os.path.join(work, f"data.rank{r}.jsonl") for r in range(2)]
    merged = report.merge_summary(report.load_rank_traces(paths))
    res["merge"] = dict(run_id=merged["run_id"], ranks=merged["ranks"],
                        aligned_iterations=merged["aligned_iterations"],
                        wait_share=[round(p["barrier_wait_s"] / p["wall_s"], 4)
                                    if p["wall_s"] else None
                                    for p in merged["per_rank"].values()],
                        straggler=merged.get("straggler"))
    log(report.render_merge(merged).rstrip())
    log("higgs-10.5M-distributed: " + json.dumps(res))
    assert all(res["checks"].values()), res["checks"]
    assert merged["run_id"] and merged["ranks"] == [0, 1], res["merge"]
    assert merged["aligned_iterations"] == DIST_ITERS, res["merge"]
    for name in runs:
        key = "hist_q_launches" if name == "quantized" else "hist_launches"
        assert dev.type != "cuda" or all(n > 0 for n in res[name][key]), (
            f"{name}: B8 / B9 not launched in a rank")
    return counts, res


ELASTIC_ROWS = 20_000  # the global rows of every elastic path (the -distributed cut)
ELASTIC_TREES = 6  # cut from 10, for time
# the rebalance drill's trees: three before the move, one after; held to
# the reference's first four
ELASTIC_REBALANCE_TREES = 4
ELASTIC_REBALANCE_MEMBERS = 3  # the controller's median is then a fast member's
# the member worker at the main cell's width: integer-valued features of
# 63 values (every contiguous slice sees them all, so each member's bin
# mappers are the same), max_bin 63, 255 leaves
ELASTIC_WIDTH = {"MEMBER_ROWS": str(ELASTIC_ROWS), "MEMBER_FEATURES": "28",
                 "MEMBER_MAX_BIN": "63", "MEMBER_LEAVES": "255",
                 "MEMBER_TREES": str(ELASTIC_TREES)}
ELASTIC_TIMEOUT = "5"  # the members' network_timeout, s: a kill is seen within ~2x it
ELASTIC_OOC_ITERS = 3
ELASTIC_OOC_CHUNK = 4096  # 10,000 rows a rank: 3 chunks a pass (2 of 4,096, one of 1,808)
ELASTIC_SPOT = ("nproc=3", "script=preempt@3;spawn@6", "trees=6", f"rows={ELASTIC_ROWS}",
                "features=28", "max_bin=63", "leaves=255")


class _Fleet:
    """One elastic fleet of member workers (python -m lightgbm_tpu_torch.
    factory.member_worker) in its own fleet directory under ``work``:
    ``nproc`` launch-time members and ``joiners`` mid-run arrivals, each
    logging to member.<key>.log; a member's ``env`` overrides the common
    ones (ELASTIC_WIDTH, the timeout)."""

    def __init__(self, work, tag, nproc, per=None, joiners=0, extra=None, device="cuda"):
        self.dir = os.path.join(work, tag)
        shutil.rmtree(self.dir, ignore_errors=True)
        os.makedirs(self.dir)
        self.tag, self.out = tag, os.path.join(self.dir, "out")
        self.procs, self.started = {}, {}
        keys = list(range(nproc)) + ["join"] * joiners
        for i, key in enumerate(keys):
            e = {k: v for k, v in os.environ.items()
                 if not k.startswith(("LIGHTGBM_TPU_", "MEMBER_"))}
            e.update(ELASTIC_WIDTH, PYTHONPATH=HERE, OMP_NUM_THREADS="1",
                     MEMBER_NPROC=str(nproc), LIGHTGBM_TPU_NET_TIMEOUT=ELASTIC_TIMEOUT)
            if device == "cpu":  # a rehearsal on the CPU
                e["MEMBER_DEVICE"] = "cpu"
            e.update(extra or {})
            name = str(key) if key != "join" else f"join{i - nproc}"
            e.update((per or {}).get(key if key != "join" else name, {}))
            with open(os.path.join(self.dir, f"member.{name}.log"), "w") as f:
                self.started[name] = time.time()
                self.procs[name] = subprocess.Popen(
                    [sys.executable, "-m", "lightgbm_tpu_torch.factory.member_worker", str(key),
                     self.dir, self.out], cwd=HERE, env=e, stdout=f, stderr=subprocess.STDOUT)

    def done(self):
        return all(p.poll() is not None for p in self.procs.values())

    def kill(self):
        for p in self.procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()

    def rcs(self):
        return {k: p.returncode for k, p in self.procs.items()}

    def log_text(self, key):
        with open(os.path.join(self.dir, f"member.{key}.log")) as f:
            return f.read()

    def ids(self, suffix):
        return sorted(int(f.split(".m")[1].split(".")[0]) for f in os.listdir(self.dir)
                      if f.startswith("out.m") and f.endswith(suffix))

    def meta(self, mid):
        with open(f"{self.out}.m{mid}.json") as f:
            return json.load(f)

    def model(self, mid):
        with open(f"{self.out}.m{mid}.txt") as f:
            return f.read()

    def dump(self):
        return "\n".join(f"--- {k} rc={p.returncode} ---\n{self.log_text(k)[-2500:]}"
                         for k, p in self.procs.items())


def _wait_all(groups, timeout=400):
    """Wait until every fleet's and rank group's processes have exited."""
    t = time.perf_counter()
    while not all(g.done() if isinstance(g, _Fleet) else g.poll() for g in groups):
        if time.perf_counter() - t > timeout:
            for g in groups:
                g.kill()
            raise RuntimeError(f"processes still running after {timeout} s: "
                               f"{[g.tag for g in groups]}")
        time.sleep(0.05)


def _member_numbers(fleet, mid, key):
    """A finished member's numbers: ms a tree (median iteration), the
    resize pauses, bytes by purpose, B8 / B9 launches, the seconds from its
    spawn to its first iteration's end."""
    m = fleet.meta(mid)
    its = m.get("iter_s") or []
    return dict(member=mid, ms_a_tree=round(1e3 * float(np.median(its)), 3) if its else None,
                trees=m.get("trees"), resize_pause_s=m.get("resize_pauses"),
                final_members=m.get("final_members"), final_counts=m.get("final_counts"),
                bytes=m.get("ledger"), hist_segment_q=m.get("launches", {}).get("hist_segment_q"),
                hist_segment=m.get("launches", {}).get("hist_segment"), device=m.get("device"),
                start_to_first_iter_s=(round(m["first_iter_at"] - fleet.started[key], 3)
                                       if m.get("first_iter_at") else None))


def _tree_blocks(text):
    """A model text's tree blocks, each from its ``Tree=`` line on."""
    return ["Tree=" + b.split("\n\n")[0] for b in text.split("Tree=")[1:]]


def _count_line_diff(a, b):
    """The lines of two model texts that differ, by key (``leaf_count``,
    ...); None when the line counts differ."""
    la, lb = a.splitlines(), b.splitlines()
    if len(la) != len(lb):
        return None
    keys = {}
    for x, z in zip(la, lb):
        if x != z:
            k = x.split("=")[0]
            keys[k] = keys.get(k, 0) + 1
    return keys


def _ooc_rank_numbers(g, r):
    """A streaming rank's numbers: ms a tree, streamed GB/s (its ooc.bytes
    over its iterations' wall), B9 launches, spawn to first iteration."""
    tr = g.trace(r)
    iters = [rec for rec in tr if rec.get("ev") == "iter"]
    streamed = sum(rec["value"] for rec in tr if rec.get("ev") == "counter"
                   and rec.get("name") == "ooc.bytes")
    wall = sum(rec["wall_s"] for rec in iters)
    launches = [rec["counts"] for rec in tr if rec.get("name") == "kernel.launches"]
    return dict(ms_a_tree=round(1e3 * float(np.median([rec["wall_s"] for rec in iters])), 3)
                if iters else None,
                streamed_gb_s=round(streamed / wall / 1e9, 4) if wall else None,
                streamed_bytes=int(streamed),
                launches=launches[0] if launches else {},
                start_to_first_iter_s=round(iters[0]["ts"] - g.started, 3) if iters else None)


def phase_elastic(ds, dev):
    """"higgs-10.5M-elastic": elastic and rank-sharded training over
    several processes on the one card (parallel/membership.py, shardplan.py,
    boosting/oocdist.py, factory/spot.py), B8 / B9 in every member and rank
    process.  Wave 1, three fleets at once (member worker, ELASTIC_WIDTH,
    quantized binary, ELASTIC_TREES trees): the static reference (one
    member, all ELASTIC_ROWS global rows); the churn run (members 0-2 and a
    joiner; member 1 SIGTERMs itself at iteration 2, member 2 is SIGKILLed
    at iteration 4, member 0 paced 0.4 s an iteration); the coordinator
    drill (members 0-2, member 0 SIGKILLed at iteration 3).  Wave 2: the
    rebalance drill (ELASTIC_REBALANCE_MEMBERS members with
    MEMBER_REBALANCE=1, member 0 slowed by
    a collective delay fault sized from the reference's ms a tree,
    ELASTIC_REBALANCE_TREES trees); rank-sharded out of core (the main
    cell's first ELASTIC_ROWS rows and parameters, quantized, `python -m
    lightgbm_tpu_torch train` ranks on binary caches of one binning,
    ooc_chunk_rows ELASTIC_OOC_CHUNK: two ranks for ELASTIC_OOC_ITERS
    iterations, two checkpointing for one fewer, then three resuming that
    checkpoint; in this process the same rows over LocalComm rank threads
    in memory, streamed in one process and on the resident mask grower);
    `factory spot` (ELASTIC_SPOT) through the CLI.  Checks: exits 0 / 0 /
    -SIGKILL / 0 and the leaver writes no model, the joiner's id >= 3, each
    finisher's model text byte-identical to the reference's, final counts
    summing to ELASTIC_ROWS, the survivor's ELASTIC_TREES epochs_seen; the
    drill's survivors [1, 2] with the reference's bytes; a rebalance.plan
    event, rows moved off member 0, trees equal to the reference's first
    ones; the ranks' model == the rank threads' and == the 3-rank resume,
    and the one-process and resident models equal it but for their
    quantized leaf counts; the spot run's cost and zero lost iterations.
    Prints each member's ms a tree, resize pauses, bytes by purpose,
    launches and start to first iteration, rows moved, each rank's
    streamed GB/s and stall share (report merge), the card's used MiB."""
    import threading

    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.obs import report
    from lightgbm_tpu_torch.parallel.comm import LocalGroup, rank_thread

    work = os.path.join(HERE, "build", "chip_elastic")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    res, counts, groups = {"rows": ELASTIC_ROWS, "trees": ELASTIC_TREES}, [], []
    stop = threading.Event()
    sampler = threading.Thread(target=_card_mib_sampler, args=(stop, res), daemon=True)
    sampler.start()
    need = (lambda k: (k,)) if dev.type == "cuda" else (lambda k: ())  # a CPU rehearsal
    try:
        # ---- wave 1: the reference, the churn run, the coordinator drill
        t0 = time.perf_counter()
        ref = _Fleet(work, "reference", 1, device=dev.type)
        churn = _Fleet(work, "churn", 3, joiners=1, device=dev.type,
                       per={0: {"MEMBER_ITER_SLEEP": "0.4"}, 1: {"MEMBER_SIGTERM_ITER": "2"},
                            2: {"MEMBER_KILL_ITER": "4"}})
        coord = _Fleet(work, "coordinator", 3, device=dev.type,
                       per={0: {"MEMBER_KILL_ITER": "3"}})
        groups += [ref, churn, coord]
        _wait_all([ref, churn, coord])
        res["wave1_s"] = round(time.perf_counter() - t0, 3)
        assert ref.rcs() == {"0": 0}, ref.dump()
        ref_text = ref.model(0)
        ref_num = _member_numbers(ref, 0, "0")
        res["reference"] = ref_num
        log(f"higgs-10.5M-elastic reference: {json.dumps(ref_num)}")
        # churn: exits 0 / 0 / -SIGKILL / 0, the leaver writes no model
        rcs = churn.rcs()
        joiner = max(churn.ids(".json"))
        res["churn"] = dict(rcs=rcs, joiner_id=joiner, leaver=churn.meta(1),
                            members=[_member_numbers(churn, m, str(m) if m < 3 else "join0")
                                     for m in (0, joiner)])
        log(f"higgs-10.5M-elastic churn: {json.dumps(res['churn'])}")
        assert rcs == {"0": 0, "1": 0, "2": -signal.SIGKILL, "join0": 0}, churn.dump()
        assert not os.path.exists(churn.out + ".m1.txt") and joiner >= 3, churn.dump()
        for m in (0, joiner):
            meta = churn.meta(m)
            assert churn.model(m) == ref_text, f"churn member {m}: not the reference's bytes"
            assert sum(meta["final_counts"]) == int(ELASTIC_WIDTH["MEMBER_ROWS"])
            assert meta["trees"] == ELASTIC_TREES
            assert joiner in meta["final_members"] and not {1, 2} & set(meta["final_members"])
        assert len(churn.meta(0)["epochs_seen"]) == ELASTIC_TREES  # no lost iteration
        # the coordinator drill
        rcs = coord.rcs()
        res["coordinator"] = dict(rcs=rcs, members=[_member_numbers(coord, m, str(m))
                                                    for m in (1, 2)])
        log(f"higgs-10.5M-elastic coordinator: {json.dumps(res['coordinator'])}")
        assert rcs == {"0": -signal.SIGKILL, "1": 0, "2": 0}, coord.dump()
        for m in (1, 2):
            assert coord.meta(m)["final_members"] == [1, 2], coord.dump()
            assert coord.model(m) == ref_text, f"coordinator drill member {m}: other bytes"
        for f, mids in ((ref, (0,)), (churn, (0, joiner)), (coord, (1, 2))):
            counts += [f.meta(m)["launches"] for m in mids]

        # ---- wave 2: rebalance, rank-sharded out of core, factory spot
        t0 = time.perf_counter()
        # member 0's delay is 1.5 times the reference's host work a
        # collective: the controller's threshold (1.5x the median, a fast
        # member's compute) then holds while a fast member's tree, beside
        # the wave's other processes, takes up to three reference trees
        # (with two members the median is their mean, and member 0's
        # compute must pass three times its peer's)
        colls = 3 * (int(ELASTIC_WIDTH["MEMBER_LEAVES"]) - 1) + 4  # a tree's collectives
        delay_ms = max(2, int(round(1.5 * ref_num["ms_a_tree"] / colls)))
        reb = _Fleet(work, "rebalance", ELASTIC_REBALANCE_MEMBERS, device=dev.type,
                     extra={"MEMBER_REBALANCE": "1",
                            "MEMBER_TREES": str(ELASTIC_REBALANCE_TREES)},
                     per={0: {"LIGHTGBM_TPU_FAULT": f"delay:{delay_ms}:after:5",
                              "LIGHTGBM_TPU_FAULT_RANK": "0",
                              "LIGHTGBM_TPU_TRACE": os.path.join(work, "rebalance.m0.jsonl")},
                          **{m: {"LIGHTGBM_TPU_TRACE": os.path.join(work, f"rebalance.m{m}.jsonl")}
                             for m in range(1, ELASTIC_REBALANCE_MEMBERS)}})
        groups.append(reb)
        spot_dir = os.path.join(work, "spot")
        spot_env = {k: v for k, v in os.environ.items()
                    if not k.startswith(("LIGHTGBM_TPU_", "MEMBER_"))}
        spot_env.update(PYTHONPATH=HERE, OMP_NUM_THREADS="1",
                        LIGHTGBM_TPU_NET_TIMEOUT=ELASTIC_TIMEOUT)
        spot_args = [sys.executable, "-m", "lightgbm_tpu_torch", "factory", "spot",
                     f"fleet={spot_dir}", *ELASTIC_SPOT]
        if dev.type == "cpu":
            spot_args.append("device=cpu")
        spot_log = os.path.join(work, "spot.log")
        with open(spot_log, "w") as f:
            spot = subprocess.Popen(spot_args, cwd=HERE, env=spot_env, stdout=f,
                                    stderr=subprocess.STDOUT)
        # the out-of-core rows: the main cell's first ELASTIC_ROWS, binned
        # once; the ranks' shards are binary caches of that binning
        X = np.asarray(ds.data[:ELASTIC_ROWS])
        y = np.asarray(ds.construct(TRAIN_PARAMS).metadata.label[:ELASTIC_ROWS])
        full = lgt.Dataset(X, label=y, params=dict(TRAIN_PARAMS))
        full.construct(TRAIN_PARAMS)
        caches = {}
        for world in (2, 3):
            caches[world] = []
            for r in range(world):
                lo, hi = r * ELASTIC_ROWS // world, (r + 1) * ELASTIC_ROWS // world
                path = os.path.join(work, f"ooc.w{world}.s{r}.bin")
                lgt.Dataset(X[lo:hi], label=y[lo:hi], reference=full).save_binary(path)
                caches[world].append(path)
        okw = dict(tree_learner="data", out_of_core="true", quantized_training="true",
                   ooc_chunk_rows=ELASTIC_OOC_CHUNK)
        ck = os.path.join(work, "ck_ooc")
        on = dict(device=dev.type, timeout=DIST_CALM_TIMEOUT)
        ooc = _Ranks(work, "ooc", caches[2], okw, iters=ELASTIC_OOC_ITERS, **on)
        ooc_ck = _Ranks(work, "ooc_ck", caches[2], okw, (f"checkpoint_dir={ck}",
                                                         "checkpoint_freq=1"),
                        iters=ELASTIC_OOC_ITERS - 1, **on)
        groups += [ooc, ooc_ck]
        _wait_all([ooc_ck])
        assert ooc_ck.rcs() == [0, 0], ooc_ck.log_text(0)[-3000:]
        resume = _Ranks(work, "ooc_resume", caches[3], okw, (f"checkpoint_dir={ck}",
                                                             "checkpoint_resume=force"),
                        nranks=3, iters=ELASTIC_OOC_ITERS, **on)
        groups.append(resume)
        # this process's references, beside the ranks
        params = dict(TRAIN_PARAMS, num_machines=2, pre_partition=True,
                      network_timeout=DIST_CALM_TIMEOUT, tree_learner="data",
                      quantized_training=True, out_of_core="false")

        def threads_run():
            group, out, errs = LocalGroup(2), [None, None], []

            def work_rank(r, comm):
                try:
                    with rank_thread(comm):
                        out[r] = lgt.train(dict(params), lgt.Dataset(caches[2][r]),
                                           ELASTIC_OOC_ITERS, device=dev).model_to_string()
                except BaseException as e:  # noqa: BLE001 - raised below
                    errs.append(e)
                    group.barrier.abort()

            ts = [threading.Thread(target=work_rank, args=(r, c), daemon=True)
                  for r, c in enumerate(group.comms())]
            for t in ts:
                t.start()
            for t in ts:
                t.join(300)
            if errs:
                raise errs[0]
            return out

        thread_texts, c = driven("higgs-10.5M-elastic ooc rank threads", threads_run,
                                 need("hist_segment_q"))
        counts.append(c)
        one_params = dict(TRAIN_PARAMS, tree_learner="data", quantized_training=True,
                          out_of_core="true", ooc_chunk_rows=ELASTIC_OOC_CHUNK)
        one_text, c = driven("higgs-10.5M-elastic ooc one process", lambda: lgt.train(
            dict(one_params), full, ELASTIC_OOC_ITERS, device=dev).model_to_string(),
            need("hist_segment_q"))
        counts.append(c)
        os.environ["LIGHTGBM_TPU_PGROW"] = "0"
        try:
            resident_text, c = driven("higgs-10.5M-elastic resident mask grower", lambda: lgt.train(
                dict(TRAIN_PARAMS, quantized_training=True), full, ELASTIC_OOC_ITERS,
                device=dev).model_to_string(), need("hist_segment_q"))
            counts.append(c)
        finally:
            os.environ.pop("LIGHTGBM_TPU_PGROW", None)
        _wait_all([reb, ooc, resume])
        spot_rc = spot.wait(timeout=400)
        res["wave2_s"] = round(time.perf_counter() - t0, 3)
    finally:
        stop.set()
        for g in groups:
            g.kill()
        if "spot" in locals() and spot.poll() is None:
            spot.kill()
    sampler.join(15)

    # ---- rebalance
    reb_ids = range(ELASTIC_REBALANCE_MEMBERS)
    assert reb.rcs() == {str(m): 0 for m in reb_ids}, reb.dump()
    moved, plans = 0.0, []
    for rec in report.load_trace(os.path.join(work, "rebalance.m0.jsonl"), warn=False):
        if rec.get("name") == "rebalance.move_rows":
            moved += rec["value"]
        elif rec.get("name") == "rebalance.plan":
            plans.append(dict(iter=rec["iter"], before=rec["before"], after=rec["after"]))
    reb_blocks = _tree_blocks(reb.model(0))
    res["rebalance"] = dict(delay_ms=delay_ms, plans=plans, rows_moved=int(moved),
                            members=[_member_numbers(reb, m, str(m)) for m in reb_ids],
                            trees_equal_reference=reb_blocks == _tree_blocks(ref_text)[
                                :ELASTIC_REBALANCE_TREES],
                            ranks_agree=all(reb.model(m) == reb.model(0) for m in reb_ids))
    log(f"higgs-10.5M-elastic rebalance: {json.dumps(res['rebalance'])}")
    assert plans and plans[-1]["after"][0] < plans[0]["before"][0], reb.dump()
    assert res["rebalance"]["trees_equal_reference"] and res["rebalance"]["ranks_agree"]
    for m in reb_ids:
        counts.append(reb.meta(m)["launches"])

    # ---- rank-sharded out of core
    for g, n in ((ooc, 2), (resume, 3)):
        assert g.rcs() == [0] * n, g.log_text(0)[-3000:]
        for r in range(n):
            text = g.log_text(r)
            assert f"Distributed runtime up: rank {r} of {n}" in text, f"{g.tag} rank {r}"
            assert f"Using distributed out-of-core data-parallel learner over {n} processes on " \
                   f"{dev.type}" in text, f"{g.tag} rank {r}: not the rank-sharded stream"
    resumed = _logged(resume.log_text(0), "Resuming training from checkpoint at iteration ")
    ooc_text = ooc.model(0)
    merged = report.merge_summary(report.load_rank_traces(
        [os.path.join(work, f"ooc.rank{r}.jsonl") for r in range(2)]))
    nums = [_ooc_rank_numbers(ooc, r) for r in range(2)]
    res["ooc"] = dict(
        ranks=[dict(n, stall_share=merged["per_rank"][r].get("ooc_stall_share"),
                    hist_segment_q=n["launches"].get("hist_segment_q"))
               for r, n in enumerate(nums)],
        chunks_a_pass=[_logged(ooc.log_text(r), "Distributed out-of-core training: ")[0]
                       for r in range(2)],
        checks=dict(ranks_agree=all(ooc.model(r) == ooc_text for r in range(2)),
                    equals_rank_threads=thread_texts == [ooc_text, ooc_text],
                    resumed_at_3_equals=all(resume.model(r) == ooc_text for r in range(3)),
                    resumed_from=int(resumed[0]) if resumed else None),
        one_process_differs_in=_count_line_diff(one_text, ooc_text),
        resident_differs_in=_count_line_diff(resident_text, ooc_text))
    log(f"higgs-10.5M-elastic ooc: {json.dumps(res['ooc'])}")
    chk = res["ooc"]["checks"]
    assert chk["ranks_agree"] and chk["equals_rank_threads"], res["ooc"]
    assert chk["resumed_at_3_equals"] and chk["resumed_from"] == ELASTIC_OOC_ITERS - 1
    for diff in (res["ooc"]["one_process_differs_in"], res["ooc"]["resident_differs_in"]):
        # the same trees: only the quantized leaf counts, which the serial
        # grower derives from the hessians, differ from the exact counts
        assert diff is not None and set(diff) <= {"leaf_count", "internal_count"}, diff
    for g, n in ((ooc, 2), (ooc_ck, 2), (resume, 3)):
        for r in range(n):
            c = _ooc_rank_numbers(g, r)["launches"]
            assert dev.type != "cuda" or c.get("hist_segment_q", 0) > 0, f"{g.tag} rank {r}"
            counts.append(dict({k: 0 for k in KERNEL_NAMES}, **c))

    # ---- factory spot
    with open(spot_log) as f:
        spot_out = f.read()
    lines = spot_out.splitlines()
    first = max(i for i, ln in enumerate(lines) if ln == "{")
    summary = json.loads("\n".join(lines[first:]))
    spot_metas = summary.get("metas", {})
    res["spot"] = dict(rc=spot_rc, cost=summary.get("cost"),
                       zero_lost_iterations=summary.get("zero_lost_iterations"),
                       wall_s=summary.get("wall_s"), exits=summary.get("exits"),
                       baseline="not run on the card (tests/test_torch_spot.py prices one)",
                       members={k: dict(ms_a_tree=round(1e3 * float(np.median(m["iter_s"])), 3)
                                        if m.get("iter_s") else None,
                                        resize_pause_s=m.get("resize_pauses"),
                                        start_to_first_iter_s=round(
                                            m["first_iter_at"] - summary["started"][
                                                k if k in summary["started"] else "join1"], 3)
                                        if m.get("first_iter_at") else None)
                                for k, m in spot_metas.items() if "trees" in m})
    log(f"higgs-10.5M-elastic spot: {json.dumps(res['spot'])}")
    assert spot_rc == 0 and res["spot"]["cost"] is not None, spot_out[-4000:]
    assert res["spot"]["zero_lost_iterations"], spot_out[-4000:]
    for m in spot_metas.values():
        if "launches" in m:
            counts.append(m["launches"])
    res["launches"] = {k: sum(c.get(k, 0) for c in counts)
                       for k in ("hist_segment", "hist_segment_q")}
    log("higgs-10.5M-elastic: " + json.dumps(res))
    if dev.type == "cuda":
        for c in counts:
            assert c.get("hist_segment_q", 0) > 0, "B9 not launched in a process of the path"
    return counts, res


def phase_strategies(higgs, dev):
    """The tree strategies at full width on the higgs-10.5M cell's binned
    data and parameters, STRAT_ITERS iterations each on the mask grower:
    "higgs-10.5M-linear" (linear_tree) and "higgs-10.5M-monotone" (the 6
    features of largest |corr(x, y)| constrained by its sign).  Returns
    the launch counts of both paths and their numbers."""
    import torch

    import lightgbm_tpu_torch as lgt

    ds, Xv, yv = higgs
    X, y = ds.data, ds.get_label()
    counts, res = [], {}

    def peak_reset():
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()

    def peak():
        return torch.cuda.max_memory_allocated() / 2**30 if dev.type == "cuda" else float("nan")

    # 1. linear trees, one update at a time, the fit timed by CUDA events
    def linear():
        peak_reset()
        b = lgt.Booster(LINEAR_PARAMS, ds, device=dev)
        fit = b.boosting._fit_linear_tree
        fit_ms = []

        def timed_fit(*args):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            fit(*args)
            e1.record()
            e1.synchronize()
            fit_ms.append(e0.elapsed_time(e1))

        b.boosting._fit_linear_tree = timed_fit
        for _ in range(STRAT_ITERS - 1):
            b.update()
        _, nsync = count_syncs(b.update)
        sync(dev)
        return b, fit_ms, nsync

    (b, fit_ms, nsync), c = driven("higgs-10.5M-linear", linear, ("hist_segment",))
    counts.append(c)
    assert b.boosting.ptrainer is None
    its = b.boosting.iter_seconds
    s_iter = float(np.median(its[1:]))
    trees = [t for t in b.boosting.models if t.is_linear]  # no boost-from-average tree
    assert len(trees) == STRAT_ITERS
    n_lin = sum(int(t.leaf_is_linear[:t.num_leaves].sum()) for t in trees)
    n_leaves = sum(t.num_leaves for t in trees)
    a = auc(yv, b.predict(Xv))
    log(f"higgs-10.5M-linear: {STRAT_ITERS} iterations on the mask grower, s/iter {s_iter:.4f} "
        f"(median after the first; first {its[0]:.3f} s); the fit {np.median(fit_ms):.1f} ms a "
        f"tree (CUDA events, median; each {[round(m, 1) for m in fit_ms]}); {n_lin} of "
        f"{n_leaves} leaves linear ({100 * n_lin / n_leaves:.1f} %); held-out AUC {a:.6f}; "
        f"the last iteration made {nsync} host syncs; peak device memory {peak():.2f} GiB; "
        f"hist_segment launches {c['hist_segment']}")
    assert 0.6 < a <= 1.0, "higgs-10.5M-linear's held-out AUC out of range"
    res["linear"] = dict(s_iter=s_iter, fit_ms=float(np.median(fit_ms)), linear_share=n_lin /
                         n_leaves, auc=a, syncs=nsync, peak_gib=peak())
    del b
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # 2. monotone constraints on the 6 features users know the direction of
    mono = monotone_directions(X, y, 6)

    def monotone():
        peak_reset()
        t = time.perf_counter()
        bst = lgt.train(dict(TRAIN_PARAMS, monotone_constraints=mono), ds, STRAT_ITERS,
                        device=dev)
        sync(dev)
        return bst, time.perf_counter() - t

    (b, wall), c = driven("higgs-10.5M-monotone", monotone, ("hist_segment",))
    counts.append(c)
    assert b.boosting.ptrainer is None
    its = b.boosting.iter_seconds
    s_iter = float(np.median(its[1:]))
    a = auc(yv, b.predict(Xv))
    # the sweep: 200 held-out rows x 32 values of each constrained feature
    base, grid_n, worst = Xv[:200], 32, {}
    for j in (j for j, s in enumerate(mono) if s):
        grid = np.quantile(Xv[:, j], np.linspace(0.0, 1.0, grid_n))
        Z = np.repeat(base[None], grid_n, axis=0)
        Z[:, :, j] = grid[:, None]
        p = b.predict(Z.reshape(-1, Z.shape[2]), raw_score=True).reshape(grid_n, len(base))
        worst[j] = float((np.diff(p, axis=0) * mono[j]).min())
    log(f"higgs-10.5M-monotone: features {[j for j, s in enumerate(mono) if s]} constrained by "
        f"{[s for s in mono if s]}; {STRAT_ITERS} iterations in {wall:.2f} s, s/iter "
        f"{s_iter:.4f} (median after the first; first {its[0]:.3f} s); held-out AUC {a:.6f}; "
        f"the sweep's worst signed step by feature {worst} (tol -1e-6); peak device memory "
        f"{peak():.2f} GiB; hist_segment launches {c['hist_segment']}")
    assert 0.6 < a <= 1.0, "higgs-10.5M-monotone's held-out AUC out of range"
    assert min(worst.values()) >= -1e-6, "a constrained feature's sweep moves the wrong way"
    res["monotone"] = dict(s_iter=s_iter, auc=a, worst_step=min(worst.values()),
                           peak_gib=peak())
    del b
    return counts, res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=10_500_000)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--small-rows", type=int, default=30_000)
    ap.add_argument("--small-iters", type=int, default=2)
    ap.add_argument("--repeat-iters", type=int, default=3)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    card = smi.stdout.strip()
    if smi.returncode != 0 or not card:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    log(card.splitlines()[0])  # the card's name and power limit, as nvidia-smi gives them
    sys.path.insert(0, HERE)
    from lightgbm_tpu_torch.ops import _build, pkernels as pk

    t0 = time.perf_counter()
    _build.lib()
    log(f"build: {time.perf_counter() - t0:.1f} s ({_build.library_path()})")

    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.config import Config

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    Xc, yc = make_covertype_shaped()
    nc = COV_TRAIN_ROWS
    cov = lgt.Dataset(Xc[:nc], label=yc[:nc])
    cov.construct(COV_PARAMS).ensure_bundles(Config.from_params(COV_PARAMS))
    log(f"covertype data: {len(yc)}x54, {nc} train rows binned and bundled in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    kern = phase_kernels(args.rows, dev)
    kern.update(phase_kernels_multi(cov.construct(COV_PARAMS), dev))
    phase_update_edges(dev)
    b1_kinds, b10_kinds = phase_kernels_objectives(args.rows, dev)
    kern.update(phase_kernels_mask(args.rows, dev))
    from lightgbm_tpu_torch.boosting.ooc import resolve_chunk_rows

    ooc_chunk = resolve_chunk_rows(Config.from_params(TRAIN_PARAMS), 28, 1)
    for name, v in phase_kernels_carry(args.rows, ooc_chunk, dev).items():
        kern[name].update(v)
        kern[name]["max_abs_err"] = max(kern[name]["max_abs_err"], v["carry_max_abs_err"])
    phase_feature_tiles(min(args.rows, 1_000_000), dev)
    log(f"kernels checked in {time.perf_counter() - t0:.1f} s")
    pool, cpu = start_small_cpu(args.small_rows)
    try:
        return run_phases(args, dev, pool, cpu, kern, b1_kinds, b10_kinds, Xc, yc, cov)
    finally:
        pool.shutdown(wait=True, cancel_futures=True)


def run_phases(args, dev, pool, cpu, kern, b1_kinds, b10_kinds, Xc, yc, cov):
    """main()'s phases from the small ones on, with the CPU-half workers'
    ``pool`` (the small checks' futures in ``cpu``); prints the kernels
    line and the result line."""
    import torch

    # the two large data sets are made and binned on the host while the
    # small phases run (after the kernel timings, which they would disturb)
    prep = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    higgs_data = prep.submit(prep_higgs, args.rows)
    mslr_data = prep.submit(prep_mslr)
    prep.shutdown(wait=False)
    nc = COV_TRAIN_ROWS
    t0 = time.perf_counter()
    threads, switch = torch.get_num_threads(), sys.getswitchinterval()
    torch.set_num_threads(min(threads, SMALL_MAIN_THREADS))
    # the small phases release the GIL at every small torch op; beside the
    # data thread's Python each would wait up to a switch interval to get
    # it back, so the interval is short while both run
    sys.setswitchinterval(SMALL_SWITCH_S)
    small = phase_small(args.small_rows, args.small_iters, dev)
    multi = phase_small_multi(Xc, yc, COV_SMALL_ROWS, COV_SMALL_ITERS, dev)
    phase_small_sampled(args.small_rows, dev, cpu)
    phase_small_mask(small[2], Xc, yc, dev, cpu)
    phase_small_objectives(small[2], dev, cpu)
    phase_small_rank(dev, cpu)
    t1 = time.perf_counter()
    small_api_counts = phase_small_api(small, multi, dev)
    log(f"small API paths in {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    small_strat_counts, linear_text = phase_small_strategies(small, dev)
    serve_texts = dict(linear=linear_text, k7=multi["cuda"].model_to_string())
    log(f"small tree strategies in {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    small_ckpt_counts = phase_small_ckpt(small[2], Xc, yc, dev)
    del small, multi
    log(f"small checkpoint resumes in {time.perf_counter() - t1:.1f} s")
    torch.set_num_threads(threads)
    sys.setswitchinterval(switch)
    log(f"small end to end in {time.perf_counter() - t0:.1f} s (this process on "
        f"{SMALL_MAIN_THREADS} torch threads, {threads} after; the data thread "
        f"{'done' if higgs_data.done() and mslr_data.done() else 'still running'})")
    t0 = time.perf_counter()
    # phase_parallel's CPU half runs in the workers beside the fused cells,
    # whose times are the card's (CUDA events), not beside its own card
    # half, whose host-driven ranks it would slow
    par_cpu = start_parallel_cpu(pool, higgs_data.result()[0][0])
    counts, full, higgs = phase_full(higgs_data, args.iters, dev, args.repeat_iters)
    del higgs_data
    log(f"higgs-10.5M in {time.perf_counter() - t0:.1f} s")
    kern["split_stream"].update(phase_split_tail(full["tail_rows"], dev))
    t0 = time.perf_counter()
    sampled_counts, _ = phase_sampled(*higgs, dev, full["iter_seconds"])
    log(f"higgs-10.5M-bagging and higgs-10.5M-goss in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    obj_counts, _ = phase_full_objectives(*higgs, dev)
    log(f"higgs-10.5M regression cells in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    q_counts, quant = phase_quantized(*higgs, dev, full["auc"])
    log(f"higgs-10.5M-quantized in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    ooc_counts, _ = phase_ooc(higgs[0], dev)
    log(f"higgs-10.5M-ooc in {time.perf_counter() - t0:.1f} s")
    main_text = full.pop("main_text")
    t0 = time.perf_counter()
    api_counts, _ = phase_api(higgs, main_text, dev)
    log(f"higgs-10.5M API paths in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    cli_counts, _ = phase_cli(higgs, main_text, args.iters, dev)
    log(f"higgs-10.5M-cli in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_serve(higgs, main_text, serve_texts, Xc[nc:][:50_000], dev)
    log(f"higgs-10.5M-serve in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_fleet(higgs, main_text, dev)
    log(f"higgs-10.5M-fleet in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    par_counts, _ = phase_parallel(higgs[0], dev, par_cpu)
    log(f"higgs-10.5M-parallel in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    fac_counts, _ = phase_factory(dev)
    log(f"higgs-10.5M-factory in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    dist_counts, _ = phase_distributed(higgs[0], dev)
    log(f"higgs-10.5M-distributed in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    elastic_counts, _ = phase_elastic(higgs[0], dev)
    log(f"higgs-10.5M-elastic in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    strat_counts, _ = phase_strategies(higgs, dev)
    del higgs
    log(f"higgs-10.5M-linear and higgs-10.5M-monotone in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    cov_counts, cov_full = phase_covertype(cov, Xc[nc:], yc[nc:], COV_ITERS, dev)
    log(f"covertype-581k in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    goss_counts, cov_goss = phase_covertype_goss(cov, Xc[nc:], yc[nc:], dev)
    log(f"covertype-581k-goss in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    rank_counts, _ = phase_rank(mslr_data, dev)
    del mslr_data
    log(f"mslr-web10k-shaped in {time.perf_counter() - t0:.1f} s")
    # B8 and B9 at their cells' mean selected rows per launch, and each
    # cell's device time an iteration in them (its profile window)
    t0 = time.perf_counter()
    sel8 = goss_counts["hist_segment_rows"] // goss_counts["hist_segment"]
    sel9 = q_counts["hist_segment_q_rows"] // q_counts["hist_segment_q"]
    log(f"mean selected rows per launch: hist_segment {sel8} on covertype-581k-goss, "
        f"hist_segment_q {sel9} on higgs-10.5M-quantized")
    paths = phase_mask_paths(cov.construct(COV_PARAMS), args.rows, dev, sel8, sel9)
    for name, prof, kind in (("hist_segment", cov_goss["profile"], "float"),
                             ("hist_segment_q", quant["profile"], "quantized")):
        wide_err = kern[name]["max_abs_err"]
        kern[name].update(paths[name])
        kern[name]["max_abs_err"] = max(wide_err, paths[name]["max_abs_err"])
        if prof:
            kern[name].update(device_window(prof[kind]))
    log(f"mask-grower kernels at their paths' shapes in {time.perf_counter() - t0:.1f} s")
    # B1 and B2: the same from the higgs-10.5M and covertype-581k windows
    for name, prof in (("update_and_root_hist", full["profile"]),
                       ("update_multi_and_hists", cov_full["profile"])):
        if prof:
            kern[name].update(device_window(prof[name]))

    # B1 and B10 by objective kind: each kind's error and times
    for name, kinds in (("update_and_root_hist", b1_kinds), ("update_channels", b10_kinds)):
        kern[name]["kinds"] = kinds
        kern[name]["max_abs_err"] = max([kern[name]["max_abs_err"]]
                                        + [v["max_abs_err"] for v in kinds.values()])

    entries = []
    for name in KERNEL_NAMES:
        k = kern[name]
        launches = sum(c[name] for c in [counts, q_counts, goss_counts, rank_counts, cli_counts]
                       + cov_counts + sampled_counts + obj_counts + small_api_counts + ooc_counts
                       + api_counts + small_strat_counts + strat_counts + small_ckpt_counts
                       + par_counts + fac_counts + dist_counts + elastic_counts)
        assert launches > 0, f"{name} was launched on no path"
        entries.append(dict(name=name, route="cuda", source=SOURCES[name],
                            replaces=REPLACES[name], launches=launches,
                            max_abs_err=k["max_abs_err"], ms=k["ms"], plain_ms=k["plain_ms"],
                            bound_ms=k["bound_ms"], bound_by=k["bound_by"],
                            library_ms=k["library_ms"],
                            **{x: v for x, v in k.items()
                               if x.startswith(("single", "tail", "library_single", "wide",
                                                "path", "device", "sel_mul", "ova", "empty",
                                                "kinds", "carry"))}))
    log(json.dumps({"kernels": entries}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except Exception:
        traceback.print_exc()
        rc = 1
    sys.exit(rc)
