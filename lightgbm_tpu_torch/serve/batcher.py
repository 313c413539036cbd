"""Microbatching request engine — PyTorch-port copy of
lightgbm_tpu/serve/batcher.py.

Throughput on the card comes from batch size: a single-row batch pays the
same graph replay and host round trip as a 1024-row one.  The
batcher makes concurrent single/small requests share that cost: callers
block in ``submit()`` while a background thread coalesces queued
requests into one device batch, bounded by ``max_batch_size`` rows and
``max_delay_ms`` of added latency for the request at the head of the
queue.

Overload policy is shed-not-queue: the pending-row budget is a hard
bound, and a ``submit()`` that would exceed it raises
``ServerOverloaded`` immediately instead of stretching everyone's
latency (the caller sees a 503 and can retry against another replica).
Requests whose caller deadline expires while still queued are dropped
before they waste device time.

Metrics (queue depth, batch occupancy, shed/timeout counts, latency
quantiles) are kept in-process for ``stats()``, mirrored to the obs
tracer when tracing is enabled, and — always — observed into the
Prometheus registry (obs/metrics.py) that ``GET /metrics`` scrapes:
request/row/batch/shed/deadline counters, batch-size and latency
histograms, and the queue-depth gauge.  Registry updates are plain
locked float adds, negligible next to a graph replay.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from ..obs import metrics, tracer
from ..utils.log import Log

# shared across batcher instances (a server runs two — converted and
# raw-score — and Prometheus wants the aggregate; per-batcher detail
# stays on /stats)
_M_REQUESTS = metrics.registry.counter(
    "lightgbm_tpu_serve_requests_total", "predict requests submitted")
_M_ROWS = metrics.registry.counter(
    "lightgbm_tpu_serve_rows_total", "predict rows submitted")
_M_BATCHES = metrics.registry.counter(
    "lightgbm_tpu_serve_batches_total", "device batches executed")
_M_SHED = metrics.registry.counter(
    "lightgbm_tpu_serve_shed_total",
    "requests shed by the queue-full overload policy (HTTP 503)")
_M_TIMEOUTS = metrics.registry.counter(
    "lightgbm_tpu_serve_deadline_expired_total",
    "requests dropped because their deadline expired while queued (504)")
_M_ERRORS = metrics.registry.counter(
    "lightgbm_tpu_serve_errors_total", "device batches that raised")
_M_QUEUE = metrics.registry.gauge(
    "lightgbm_tpu_serve_queue_rows", "rows currently queued")
_M_BATCH_ROWS = metrics.registry.histogram(
    "lightgbm_tpu_serve_batch_rows", "rows per executed device batch",
    buckets=metrics.BATCH_BUCKETS)
_M_LATENCY = metrics.registry.histogram(
    "lightgbm_tpu_serve_latency_seconds",
    "request latency, enqueue to completed batch",
    buckets=metrics.LATENCY_BUCKETS)


class ServerOverloaded(RuntimeError):
    """The pending-row queue is full; the request was shed."""


class RequestTimeout(RuntimeError):
    """The request's deadline expired before a batch picked it up."""


class _Request:
    __slots__ = ("rows", "deadline", "done", "result", "error", "info",
                 "t_enqueue")

    def __init__(self, rows: np.ndarray, deadline: float):
        self.rows = rows
        self.deadline = deadline
        self.done = threading.Event()
        self.result: Optional[np.ndarray] = None
        self.error: Optional[BaseException] = None
        self.info = None  # batch-level metadata (e.g. model version)
        self.t_enqueue = time.perf_counter()


def _quantile(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1, int(q * len(sorted_vals)))
    return sorted_vals[i]


class MicroBatcher:
    """Coalesce concurrent ``submit(rows)`` calls into bounded batches.

    ``predict_fn(batch) -> per-row outputs`` must return an array whose
    leading axis is the batch row axis ((N,) or (N, K)) — exactly the
    ``PackedPredictor.predict`` contract.  It may instead return
    ``(outputs, info)``: the extra ``info`` (a hot-swap predictor's
    model version) is attached to every request of that batch and
    surfaced through ``submit_ex`` — because it is sampled once per
    BATCH, every request is attributable to exactly one model version
    even across a swap boundary.
    """

    def __init__(
        self,
        predict_fn: Callable[[np.ndarray], np.ndarray],
        max_batch_size: int = 1024,
        max_delay_ms: float = 5.0,
        max_queue_rows: int = 8192,
        request_timeout_ms: float = 2000.0,
        latency_window: int = 2048,
    ):
        self.predict_fn = predict_fn
        self.max_batch_size = int(max_batch_size)
        self.max_delay_ms = float(max_delay_ms)
        self.max_queue_rows = int(max_queue_rows)
        self.request_timeout_ms = float(request_timeout_ms)

        self._queue: collections.deque = collections.deque()
        self._queued_rows = 0
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._closed = False
        self._draining = False
        self._executing_rows = 0  # rows inside the running predict_fn
        self._counts = {"requests": 0, "rows": 0, "batches": 0,
                        "shed": 0, "timeouts": 0, "errors": 0}
        self._occupancy: collections.deque = collections.deque(maxlen=256)
        self._latency_s: collections.deque = collections.deque(maxlen=latency_window)
        self._thread = threading.Thread(
            target=self._loop, name="lightgbm-tpu-torch-batcher", daemon=True
        )
        self._thread.start()

    # -- client side ---------------------------------------------------
    def submit(self, rows: np.ndarray, timeout_ms: Optional[float] = None) -> np.ndarray:
        """Block until the batch containing ``rows`` completes; returns
        the per-row outputs for exactly these rows.  Raises
        ``ServerOverloaded`` (queue full), ``RequestTimeout`` (deadline
        expired before execution), or the predict error."""
        return self._submit(rows, timeout_ms).result

    def submit_ex(self, rows: np.ndarray,
                  timeout_ms: Optional[float] = None):
        """Like ``submit`` but returns ``(outputs, info)`` where
        ``info`` is whatever the predict_fn returned alongside the
        outputs for this request's batch (None for plain predict_fns or
        empty requests)."""
        req = self._submit(rows, timeout_ms)
        return req.result, req.info

    def _submit(self, rows: np.ndarray,
                timeout_ms: Optional[float]) -> _Request:
        rows = np.asarray(rows, np.float64)
        if rows.ndim == 1:
            rows = rows.reshape(1, -1)
        tmo = self.request_timeout_ms if timeout_ms is None else float(timeout_ms)
        if tmo <= 0:
            # deadline propagation (docs/ROBUSTNESS.md): a request whose
            # X-Deadline-Ms budget is already spent fails fast — no
            # queue slot, no device work
            with self._lock:
                self._counts["timeouts"] += 1
            _M_TIMEOUTS.inc()
            tracer.counter("serve_request_timeout")
            raise RequestTimeout("deadline exhausted on arrival")
        req = _Request(rows, deadline=time.monotonic() + tmo / 1e3)
        if rows.shape[0] == 0:
            req.result = np.empty((0,))
            return req
        with self._lock:
            if self._closed:
                raise RuntimeError("batcher is closed")
            if self._draining:
                # drain admits nothing new: queued work finishes, the
                # caller sheds to another replica/model (HTTP 503)
                self._counts["shed"] += 1
                _M_SHED.inc()
                tracer.counter("serve_shed")
                raise ServerOverloaded("batcher is draining")
            if self._queued_rows + rows.shape[0] > self.max_queue_rows:
                self._counts["shed"] += 1
                _M_SHED.inc()
                tracer.counter("serve_shed")
                raise ServerOverloaded(
                    f"queue holds {self._queued_rows} rows; "
                    f"+{rows.shape[0]} exceeds max_queue_rows="
                    f"{self.max_queue_rows}"
                )
            self._counts["requests"] += 1
            self._counts["rows"] += rows.shape[0]
            _M_REQUESTS.inc()
            _M_ROWS.inc(rows.shape[0])
            self._queue.append(req)
            self._queued_rows += rows.shape[0]
            _M_QUEUE.set(self._queued_rows)
            self._wake.notify()
        # wait past the deadline by a grace period: an in-flight batch
        # holding this request may still complete it
        req.done.wait(tmo / 1e3 + 60.0)
        if req.error is not None:
            raise req.error
        if req.result is None:
            raise RequestTimeout("request was never executed")
        lat = time.perf_counter() - req.t_enqueue
        self._latency_s.append(lat)
        _M_LATENCY.observe(lat)
        return req

    # -- batch loop ----------------------------------------------------
    def _take_batch(self) -> List[_Request]:
        """Pop up to max_batch_size rows' worth of requests, waiting at
        most max_delay_ms after the first arrival; expired requests are
        failed here rather than executed."""
        with self._lock:
            while not self._queue and not self._closed:
                self._wake.wait(0.1)
            if self._closed and not self._queue:
                return []
            batch_deadline = time.monotonic() + self.max_delay_ms / 1e3
            taken: List[_Request] = []
            rows = 0
            while True:
                while self._queue:
                    req = self._queue[0]
                    if time.monotonic() > req.deadline:
                        self._queue.popleft()
                        self._queued_rows -= req.rows.shape[0]
                        self._counts["timeouts"] += 1
                        _M_TIMEOUTS.inc()
                        tracer.counter("serve_request_timeout")
                        req.error = RequestTimeout(
                            "deadline expired while queued")
                        req.done.set()
                        continue
                    if rows and rows + req.rows.shape[0] > self.max_batch_size:
                        return taken
                    self._queue.popleft()
                    self._queued_rows -= req.rows.shape[0]
                    taken.append(req)
                    rows += req.rows.shape[0]
                    if rows >= self.max_batch_size:
                        return taken
                remaining = batch_deadline - time.monotonic()
                if remaining <= 0 or self._closed:
                    return taken
                self._wake.wait(remaining)

    def _loop(self) -> None:
        while True:
            taken = self._take_batch()
            if not taken:
                if self._closed:
                    return
                continue
            batch = (taken[0].rows if len(taken) == 1
                     else np.concatenate([r.rows for r in taken], axis=0))
            self._occupancy.append(batch.shape[0])
            with self._lock:
                self._executing_rows = batch.shape[0]
            _M_QUEUE.set(self._queued_rows)
            _M_BATCH_ROWS.observe(batch.shape[0])
            tracer.gauge("serve_queue_depth", float(self._queued_rows))
            tracer.gauge("serve_batch_rows", float(batch.shape[0]))
            try:
                with tracer.span("serve_batch", rows=batch.shape[0],
                                 requests=len(taken)):
                    out = self.predict_fn(batch)
                self._counts["batches"] += 1
                _M_BATCHES.inc()
            except BaseException as e:  # predict failure fans out to callers
                self._counts["errors"] += 1
                _M_ERRORS.inc()
                for req in taken:
                    req.error = e
                    req.done.set()
                with self._lock:
                    self._executing_rows = 0
                    self._wake.notify_all()
                continue
            # a predict_fn may return (outputs, info): the info —
            # sampled once per batch — stamps every request with the
            # single model version that produced its rows
            info = None
            if isinstance(out, tuple):
                out, info = out
            start = 0
            for req in taken:
                n = req.rows.shape[0]
                req.result = np.asarray(out[start:start + n])
                req.info = info
                start += n
                req.done.set()
            with self._lock:
                self._executing_rows = 0
                self._wake.notify_all()

    # -- ops surface ---------------------------------------------------
    def stats(self) -> Dict:
        with self._lock:
            counts = dict(self._counts)
            depth = self._queued_rows
            executing = self._executing_rows
            draining = self._draining
        lat = sorted(self._latency_s)
        occ = list(self._occupancy)
        return {
            **counts,
            "queue_rows": depth,
            "inflight_rows": depth + executing,
            "draining": draining,
            "batch_occupancy_mean": round(float(np.mean(occ)), 2) if occ else 0.0,
            "latency_p50_ms": round(1e3 * _quantile(lat, 0.50), 3),
            "latency_p99_ms": round(1e3 * _quantile(lat, 0.99), 3),
        }

    def drain(self, timeout_s: float = 10.0) -> bool:
        """In-process drain (hot-swap uses this mid-life, not only at
        exit): stop admitting new submits (they shed with
        ``ServerOverloaded``), let everything queued and executing
        finish, then settle the accounting — ``inflight_rows`` and
        ``draining`` both read a stable ZERO after a completed drain.
        Returns True when nothing was left in flight at the deadline."""
        deadline = time.monotonic() + float(timeout_s)
        with self._lock:
            self._draining = True
            self._wake.notify_all()
            while self._queued_rows > 0 or self._executing_rows > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._wake.wait(min(remaining, 0.1))
            drained = self._queued_rows == 0 and self._executing_rows == 0
            # a COMPLETED drain settles to zero: not draining anymore,
            # nothing in flight (the gauges-readable steady state)
            if drained:
                self._draining = False
        if not drained:
            Log.warning("batcher drain timed out with %d queued + %d "
                        "executing rows", self._queued_rows,
                        self._executing_rows)
        return drained

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._wake.notify_all()
        self._thread.join(timeout=5.0)
