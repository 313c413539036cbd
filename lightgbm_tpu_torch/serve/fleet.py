"""Zero-downtime hot swap — the ``SwappablePredictor`` of
lightgbm_tpu/serve/fleet.py, ported to PyTorch.

One replica holds one slot.  The microbatchers' predict function samples
the slot's ``(version, PackedPredictor)`` once per device batch, so every
batch, and so every request, is answered by exactly one model version
even while a swap lands.

A captured CUDA graph bakes in the addresses of the buffers it reads, so
the port swaps in two ways:

- **same shape class** (a retrain with the same ``num_trees`` /
  ``num_leaves``, padded by ``serve/compilecache.tree_shape_bucket`` to
  the same arrays, the same walk steps and the same objective): the new
  arrays go to the card beside the live ones while traffic flows; then, at
  a batch boundary under the slot's lock, the new batches wait, the
  running ones finish, the arrays are copied into the live predictor's
  buffers and the version flips.  No capture, no new predictor;
- **another shape class**: a new predictor is built and warmed (its
  captures on its own stream, in ``thread_local`` mode, while the old one
  keeps serving), the pointer flips at a microbatch boundary, and the
  swap waits for the old version's in-flight batches to drain.

``FleetProxy``, ``spawn_replicas``, ``python -m lightgbm_tpu_torch fleet``
and the circuit breaker wait for the port's fleet (queue A item 8b).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Tuple

import numpy as np

from ..obs.metrics import LATENCY_BUCKETS, registry as metrics_registry
from ..obs.trace import total_compiles, tracer
from ..utils.log import Log
from .artifact import PackedPredictor, PredictorArtifact

_M_SWAPS = metrics_registry.counter(
    "lightgbm_tpu_serve_model_swaps_total",
    "completed hot swaps to a new model version")
_M_SWAP_SECONDS = metrics_registry.histogram(
    "lightgbm_tpu_serve_swap_seconds",
    "hot-swap latency: artifact load + warmup to traffic on the new model",
    buckets=LATENCY_BUCKETS)
_M_SWAP_COMPILES = metrics_registry.counter(
    "lightgbm_tpu_serve_swap_compiles_total",
    "CUDA graph captures attributable to hot swaps (0 for same-shape retrains)")


class SwappablePredictor:
    """Version-stamped predictor slot with zero-downtime swap.

    ``predict`` returns ``(outputs, version)``: the MicroBatcher calls it
    once per device batch, so the version is sampled exactly once per
    batch — the concurrent-swap attribution contract."""

    def __init__(self, predictor: PackedPredictor, version: int = 1):
        self._lock = threading.Lock()
        self._drain_cv = threading.Condition(self._lock)
        self._current: Tuple[int, PackedPredictor] = (int(version), predictor)
        self._inflight: Dict[int, int] = {}
        self._swapping = False  # an in-place swap holds new batches back
        self._swaps = 0
        self.last_swap: Dict = {}
        metrics_registry.gauge(
            "lightgbm_tpu_serve_model_version",
            "model version currently receiving traffic",
            fn=lambda: float(self.version))
        metrics_registry.gauge(
            "lightgbm_tpu_serve_draining_model_versions",
            "old model versions still finishing in-flight batches",
            fn=lambda: float(self.draining_versions))

    # -- introspection -------------------------------------------------
    @property
    def version(self) -> int:
        return self._current[0]

    @property
    def predictor(self) -> PackedPredictor:
        return self._current[1]

    @property
    def artifact(self) -> PredictorArtifact:
        return self._current[1].artifact

    @property
    def num_features(self) -> int:
        return self._current[1].num_features

    @property
    def swaps(self) -> int:
        return self._swaps

    @property
    def draining_versions(self) -> int:
        with self._lock:
            cur = self._current[0]
            return sum(1 for v, n in self._inflight.items() if v != cur and n > 0)

    # -- serving path --------------------------------------------------
    def predict(self, batch: np.ndarray, raw_score: bool = False):
        """(outputs, version) — the whole batch runs on ONE model."""
        with self._drain_cv:
            while self._swapping:
                self._drain_cv.wait()
            ver, pred = self._current
            self._inflight[ver] = self._inflight.get(ver, 0) + 1
        try:
            out = pred.predict(batch, raw_score=raw_score)
        finally:
            with self._drain_cv:
                self._inflight[ver] -= 1
                if self._inflight[ver] <= 0:
                    self._inflight.pop(ver, None)
                    self._drain_cv.notify_all()
        return out, ver

    def warmup(self, max_rows: int) -> Dict:
        return self._current[1].warmup(max_rows)

    # -- swap ----------------------------------------------------------
    def swap_to(self, artifact: PredictorArtifact, version: int,
                warmup_max_rows: int = 4096, do_warmup: bool = True,
                drain_timeout_s: float = 30.0) -> Dict:
        """Zero-downtime swap to ``artifact`` as ``version``: in place for
        a model of the live one's shape class, else a new predictor warmed
        beside the old one.  Returns the swap's stats, with the captures
        it cost (0 for a same-shape retrain) under ``new_compiles``."""
        t0 = time.perf_counter()
        c0 = total_compiles()
        live = self.predictor
        new_pred = PackedPredictor(artifact, device=live.device)
        in_place = live.can_adopt(new_pred)
        if in_place:
            old_ver, drained = self._swap_in_place(live, new_pred, version,
                                                   drain_timeout_s)
        else:
            if do_warmup:
                new_pred.warmup(warmup_max_rows)
            with self._lock:
                old_ver = self._current[0]
                self._current = (int(version), new_pred)
                self._swaps += 1
        swap_s = time.perf_counter() - t0
        new_compiles = total_compiles() - c0
        if not in_place:
            drained = self._wait_version_drained(old_ver, drain_timeout_s)
        stats = {
            "from_version": int(old_ver),
            "to_version": int(version),
            "swap_ms": round(1e3 * swap_s, 3),
            "new_compiles": int(new_compiles),
            "in_place": bool(in_place),
            "old_drained": bool(drained),
        }
        self.last_swap = stats
        _M_SWAPS.inc()
        _M_SWAP_SECONDS.observe(swap_s)
        if new_compiles > 0:
            _M_SWAP_COMPILES.inc(new_compiles)
        tracer.event("serve.swap", **stats)
        Log.info("serve: hot-swapped model v%d -> v%d in %.1f ms (%s, %d new captures, "
                 "old %s)", old_ver, version, stats["swap_ms"],
                 "in place" if in_place else "new predictor", new_compiles,
                 "drained" if drained else "DRAIN TIMED OUT")
        return stats

    def _swap_in_place(self, live: PackedPredictor, new_pred: PackedPredictor,
                       version: int, timeout_s: float) -> Tuple[int, bool]:
        """Hold new batches back, let the running ones finish, copy the
        new arrays into the live buffers and flip the version; all under
        the slot's lock, so a batch sees the old model or the new one,
        never a mix.  Returns the old version and False when the running
        batches outlived ``timeout_s`` (the copy still waits for them:
        the buffers are shared)."""
        deadline = time.monotonic() + float(timeout_s)
        with self._drain_cv:
            self._swapping = True
            try:
                old_ver = self._current[0]
                while self._inflight.get(old_ver, 0) > 0:
                    self._drain_cv.wait(0.1)
                drained = time.monotonic() <= deadline
                live.adopt(new_pred)
                self._current = (int(version), live)
                self._swaps += 1
            finally:
                self._swapping = False
                self._drain_cv.notify_all()
        return old_ver, drained

    def _wait_version_drained(self, version: int, timeout_s: float) -> bool:
        deadline = time.monotonic() + float(timeout_s)
        with self._drain_cv:
            while self._inflight.get(version, 0) > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._drain_cv.wait(min(remaining, 0.1))
        return True
