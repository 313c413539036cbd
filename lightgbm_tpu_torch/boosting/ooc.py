"""Out-of-core tree growth: the bin matrix streams, the vectors stay —
PyTorch counterpart of lightgbm_tpu/boosting/ooc.py.

The mask grower (ops/grow.py) keeps the whole bin matrix on the card as
packed words.  Out of core, every per-row vector (scores, grad, hess,
select, ``leaf_id``) stays on the card, so the objective, GOSS, bagging
and the score updates run as in memory, and the (N, F) matrix, the only
O(N·F) tensor, streams through the prefetch ring (data/prefetch.py) in
row chunks: peak device residency is ``depth`` chunk buffers and one
packed chunk, not the dataset.

Per tree the grower's best-first loop runs unchanged (``grow_tree`` with
``stream=``): one streamed pass builds the root histogram, then each
split makes one pass that partitions the chunk's ``leaf_id`` slice and
folds both children into B8/B9's carries (data/chunksource.py
``ChunkFolder``).  The smaller child keeps its direct histogram and the
larger is parent minus smaller, as in memory.

Bit identity: the carries are float64 (int32) and rounded once after a
pass, so the streamed histograms are the resident ones for any chunk
grid, and so is the model text (tests/test_torch_ooc.py holds it for
float, quantized, GOSS and linear runs, and through a kill and resume).
The plan still rounds ``chunk_rows`` up to ``ROW_BLOCK``, as the JAX
package must for its float32 block adds, so that the schedule's
fingerprint (a checkpoint's ``ooc_schedule``) is the JAX package's.

Routing (``resolve_out_of_core``): ``out_of_core`` true / false forces,
``auto`` streams only when the packed bins exceed the device budget
(``LIGHTGBM_TPU_DEVICE_BUDGET`` bytes, else the card's total memory);
``LIGHTGBM_TPU_OOC`` overrides the config per run.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch

from ..data.chunksource import ChunkFolder, ChunkPlan, ChunkStream, PrefetchStats, make_chunk_source
from ..obs import tracer
from ..ops.grow import GrowResult, grow_tree
from ..ops.histogram import ROW_BLOCK
from ..utils.log import Log

# auto chunk sizing aims each chunk at ~64 MiB of bins: big enough to
# amortize a pass's launches, small enough that the ring is noise next to
# the card's memory
_AUTO_CHUNK_BYTES = 64 << 20


def _device_budget_bytes(device=None) -> Optional[int]:
    """The device-memory budget ``auto`` compares the packed bins against:
    LIGHTGBM_TPU_DEVICE_BUDGET (bytes) when set, else the card's total
    memory (``torch.cuda.mem_get_info``), else None (``auto`` stays off,
    as on the CPU)."""
    env = os.environ.get("LIGHTGBM_TPU_DEVICE_BUDGET", "").strip()
    if env:
        try:
            return int(env)
        except ValueError:
            Log.warning("LIGHTGBM_TPU_DEVICE_BUDGET=%r is not an integer byte count; ignoring",
                        env)
    if device is not None and torch.device(device).type == "cuda":
        return int(torch.cuda.mem_get_info(torch.device(device))[1])
    return None


def resolve_chunk_rows(config, num_features: int, itemsize: int) -> int:
    """The streaming chunk height: ``ooc_chunk_rows`` when set, else ~64
    MiB of rows — always rounded up to a ``ROW_BLOCK`` multiple (a 1-row
    request is one block), as the JAX package rounds it."""
    rows = int(getattr(config, "ooc_chunk_rows", 0) or 0)
    if rows <= 0:
        row_bytes = max(num_features * itemsize, 1)
        rows = max(_AUTO_CHUNK_BYTES // row_bytes, 1)
    return -(-rows // ROW_BLOCK) * ROW_BLOCK


def resolve_out_of_core(config, train_set, device=None) -> Tuple[bool, int, str]:
    """Routing decision: ``(enabled, chunk_rows, reason)``.

    ``out_of_core`` = true/false forces; "auto" turns streaming on only
    when the packed bins exceed the device budget of ``device``.  The
    LIGHTGBM_TPU_OOC environment variable overrides the config knob."""
    mode = os.environ.get("LIGHTGBM_TPU_OOC", "").strip().lower()
    if not mode:
        mode = str(getattr(config, "out_of_core", "auto")).strip().lower()
    if mode in ("false", "0", "off", "no"):
        return False, 0, "out_of_core=false"
    if mode not in ("true", "1", "on", "yes", "auto"):
        Log.fatal("Unknown out_of_core mode %r (expected true/false/auto)", mode)
    binned = train_set.binned
    packed = int(train_set.num_data) * int(train_set.num_features) * int(binned.dtype.itemsize)
    if mode == "auto":
        budget = _device_budget_bytes(device)
        if budget is None:
            return False, 0, "auto: no device budget known"
        if packed <= budget:
            return False, 0, f"auto: packed bins {packed} B fit the {budget} B device budget"
        reason = f"auto: packed bins {packed} B exceed the {budget} B device budget"
    else:
        reason = "out_of_core=true (forced)"
    chunk_rows = resolve_chunk_rows(config, train_set.num_features, binned.dtype.itemsize)
    return True, chunk_rows, reason


class OocTrainer:
    """The mask grower's learner with the matrix streamed: ``grow()``
    takes what ``ops/grow.py grow_tree`` takes but the words, which come
    from this trainer's chunk source."""

    def __init__(self, train_set, config, grow_params, chunk_rows: int, device="cpu"):
        self.params = grow_params
        self.num_rows = int(train_set.num_data)
        self.num_features = int(train_set.num_features)
        self.plan = ChunkPlan(self.num_rows, chunk_rows)
        self.stats = PrefetchStats()
        self.depth = max(int(getattr(config, "ooc_prefetch_depth", 2) or 2), 1)
        self.source = make_chunk_source(train_set)
        self.chunks = ChunkStream(self.source, self.plan, self.depth, self.stats, device)
        self.folder = ChunkFolder(self.chunks, self.num_features, grow_params.num_bins,
                                  grow_params.bits)
        self._trees_grown = 0
        tracer.event("ooc.plan", rows=self.num_rows, features=self.num_features,
                     chunk_rows=self.plan.chunk_rows, chunks=self.plan.num_chunks,
                     depth=self.depth, source=self.source.describe())
        Log.info("Out-of-core training: %d rows in %d chunks of %d (%s, prefetch depth %d)",
                 self.num_rows, self.plan.num_chunks, self.plan.chunk_rows,
                 self.source.describe(), self.depth)

    def schedule_fingerprint(self) -> str:
        """Chunk-schedule identity for checkpoints."""
        return self.plan.fingerprint()

    def grow(self, grad, hess, select, feature_mask, meta, hyper, qscale=None,
             searches: dict = None) -> GrowResult:
        """Grow one leaf-wise tree, streaming the matrix once a pass."""
        stats0 = dict(self.stats.as_dict())
        with tracer.span("ooc.grow", tree=self._trees_grown, chunks=self.plan.num_chunks):
            gr = grow_tree(None, grad, hess, select, feature_mask, meta, hyper, self.params,
                           qscale=qscale, searches=searches, stream=self.folder)
        self._trees_grown += 1
        self._emit_stream_obs(stats0)
        return gr

    def add_tree_scores(self, score_k, arrays, lut=None):
        """``score_k`` += the stacked trees' outputs, streamed over the chunk
        grid (rollback's score pass when the matrix is not resident)."""
        return self.folder.streamed_scores(score_k, arrays, lut)

    def _emit_stream_obs(self, before: dict, **attrs) -> None:
        """A tree's stream records (the JAX package's names); ``attrs``
        (a rank-sharded stream's ``rank``) go on each, so `report merge`
        keys its per-rank stall share on them."""
        if not tracer.enabled:
            return
        now = self.stats.as_dict()
        tracer.counter("ooc.chunks", now["chunks"] - before["chunks"], **attrs)
        tracer.counter("ooc.bytes", now["bytes"] - before["bytes"], **attrs)
        tracer.gauge("ooc.fetch_ms", (now["fetch_s"] - before["fetch_s"]) * 1e3, **attrs)
        tracer.gauge("ooc.stall_ms", (now["stall_s"] - before["stall_s"]) * 1e3, **attrs)
        tracer.gauge("ooc.overlap_pct", now["overlap_pct"], **attrs)
