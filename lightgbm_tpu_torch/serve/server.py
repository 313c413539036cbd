"""Stdlib-HTTP JSONL predict server — ``python -m lightgbm_tpu_torch
serve``; PyTorch counterpart of lightgbm_tpu/serve/server.py, with the same
endpoints, keys and defaults, plus ``device`` (the card unless it says
``cpu``).

Endpoints:
  POST /predict      body: one JSON row per line — either ``[f0, f1, ...]``
                     or ``{"features": [...]}``.  Response: one JSON
                     prediction per line, same order (a float, or a list
                     for multiclass), with the serving model version in
                     the ``X-Model-Version`` header (``?model_version=1``
                     additionally stamps every line as
                     ``{"prediction": ..., "model_version": N}`` — each
                     request is answered by exactly ONE version even
                     across a hot swap).  ``?raw_score=1`` skips the
                     objective's output conversion.
  POST /models       registry mode only: the body is a packed ``.npz``
                     artifact; it is validated, published into the model
                     registry as the next version, activated, and
                     hot-swapped into this replica without dropping a
                     request (serve/fleet.py).
  GET  /models       registry mode only: the registry listing plus the
                     version this replica is currently serving.
  GET  /healthz      liveness only: ``{"status": "ok"}`` whenever the
                     process answers.
  GET  /readyz       readiness: 200 once the artifact is loaded AND the
                     bucket-ladder warmup completed; 503 while warming
                     and again while draining — the signal a load
                     balancer keys traffic on.
  GET  /stats        serving metrics: batcher counters + latency
                     quantiles, bucket-cache compile accounting, queue
                     depth, readiness/drain state, registry staleness,
                     uptime.
  POST /fault        chaos drills (serve/faults.py): (re)arm serving
                     fault injection at runtime — ``{"spec":
                     "hang:1"}`` — an empty spec clears it; GET /fault
                     reports the armed spec + per-kind injection counts.
                     ``LIGHTGBM_TPU_SERVE_FAULT`` arms the same grammar
                     at startup.
  GET  /metrics      the same signals in Prometheus text format
                     (obs/metrics.py): request/shed/deadline counters,
                     batch-size + latency histograms, queue depth,
                     ready/draining/inflight state, CUDA graph capture
                     accounting.  Rendering reads host counters only —
                     a scrape never touches the card.

Shutdown: SIGTERM starts a graceful drain — ``/readyz`` flips to 503,
new ``/predict`` requests get 503, in-flight microbatches finish
(bounded by ``drain_timeout_ms``), then the server exits 0.

Each HTTP request becomes one ``MicroBatcher.submit`` call, so
concurrent requests coalesce into shared device batches; an overloaded
queue answers 503 and an expired request deadline 504 (shed-not-queue,
see batcher.py).  A client (or proxy) ``X-Deadline-Ms`` header bounds
the request end to end: a spent budget 504s before any device work and
a live one caps the batcher queue wait at
``min(request_timeout_ms, remaining budget)``.

Startup: ``model=`` accepts either a packed ``.npz`` artifact
(serve/artifact.py) or a reference-format model text file, which is
packed on the fly.  Unless ``warmup=0``, the bucket ladder is
captured (one CUDA graph per bucket, serve/compilecache.py) before the
socket starts accepting, so the first real request never pays a capture.
A failed capture or launch is an error, never a quiet eager or CPU path.

Registry mode (``registry=dir``): the replica serves the registry's
active version and polls ``watch_token()`` every ``registry_poll_ms``;
when a publisher (another process, or ``POST /models`` on any replica
sharing the directory) activates a new version, the replica hot-swaps
to it at a microbatch boundary with zero dropped requests — and, for a
same-shape retrain, zero new captures: the new arrays are copied into
the live predictor's buffers (serve/fleet.py).  An empty registry is
seeded from ``model=`` when given.  Named routes each capture their own
bucket ladder (the JAX package's same-shape routes share compiled
programs; a graph here reads its own predictor's buffers).
"""

from __future__ import annotations

import json
import signal
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

import numpy as np
import torch

from ..obs.metrics import registry as metrics_registry
from ..obs.trace import compile_counts, graph_captures, tracer
from ..utils.log import LightGBMError, Log
from . import faults
from .artifact import PackedPredictor, PredictorArtifact
from .batcher import MicroBatcher, RequestTimeout, ServerOverloaded
from .fleet import SwappablePredictor
from .registry import ModelRegistry

DEFAULTS = {
    "port": 9090,
    "max_batch_size": 1024,
    "max_delay_ms": 2.0,
    "max_queue_rows": 8192,
    "request_timeout_ms": 2000,
    "warmup": 1,
    "warmup_max_rows": 4096,
    "shard": 0,
    "drain_timeout_ms": 10000,
    "registry_poll_ms": 500.0,
    "pin_version": 0,
    "route_budget_mb": 0.0,
}

# per-version serving attribution (docs/FACTORY.md): one labeled child
# per model version currently loaded — the canary verdict's scrape
# surface.  Families are pruned back to the live version after every
# completed swap, so label cardinality stays bounded by the versions
# this replica is actually serving.
_M_VER_REQS = metrics_registry.labeled_counter(
    "lightgbm_tpu_serve_version_requests_total",
    "predict requests answered, split by serving model version")
_M_VER_ERRS = metrics_registry.labeled_counter(
    "lightgbm_tpu_serve_version_errors_total",
    "failed predict requests (500/503/504), split by model version")
_M_VER_LATENCY = metrics_registry.labeled_histogram(
    "lightgbm_tpu_serve_version_latency_seconds",
    "predict request latency, split by serving model version")

# per-route attribution (multi-model serving): one labeled child per
# route currently admitted ("default" is the unnamed /predict route).
# Families are pruned to the live route set on every route sync, so
# cardinality stays bounded by what this replica actually serves.
_M_ROUTE_REQS = metrics_registry.labeled_counter(
    "lightgbm_tpu_serve_route_requests_total",
    "predict requests answered, split by model route", label="model_route")
_M_ROUTE_ERRS = metrics_registry.labeled_counter(
    "lightgbm_tpu_serve_route_errors_total",
    "failed predict requests (500/503/504), split by model route",
    label="model_route")
_M_ROUTE_LATENCY = metrics_registry.labeled_histogram(
    "lightgbm_tpu_serve_route_latency_seconds",
    "predict request latency, split by model route", label="model_route")
_M_ADMISSION_REFUSED = metrics_registry.counter(
    "lightgbm_tpu_serve_admission_refused_total",
    "route admissions refused by the device-bytes budget")
_M_DEADLINE_REJECTED = metrics_registry.counter(
    "lightgbm_tpu_serve_deadline_rejected_total",
    "predicts 504ed because the X-Deadline-Ms budget was already spent")
_M_FAULTS_INJECTED = metrics_registry.counter(
    "lightgbm_tpu_serve_fault_injected_total",
    "requests wounded by LIGHTGBM_TPU_SERVE_FAULT / POST /fault")

_DEFAULT_ROUTE = "default"


def load_artifact(model_path: str) -> PredictorArtifact:
    """Load a packed ``.npz`` artifact, or pack a model text file."""
    if model_path.endswith(".npz"):
        return PredictorArtifact.load(model_path)
    from ..basic import Booster

    # packing only parses the text: no device is needed
    return PredictorArtifact.from_booster(Booster(model_file=model_path, device="cpu"))


def make_predictor(artifact: PredictorArtifact, shard: bool = False,
                   device=None) -> PackedPredictor:
    """The artifact's predictor on ``device`` (the card unless ``cpu``);
    ``shard`` with one visible card shards nothing, with more it raises
    (serve/compilecache.py)."""
    return PackedPredictor(artifact, device=device, shard=shard)


def load_predictor(model_path: str, shard: bool = False, device=None) -> PackedPredictor:
    return make_predictor(load_artifact(model_path), shard=shard, device=device)


def _parse_rows(body: bytes) -> np.ndarray:
    rows: List[List[float]] = []
    width = None
    for ln, line in enumerate(body.decode("utf-8").splitlines()):
        line = line.strip()
        if not line:
            continue
        row = json.loads(line)
        if isinstance(row, dict):
            row = row.get("features")
        if not isinstance(row, list):
            raise ValueError(f"line {ln + 1}: expected a JSON array of features")
        if width is None:
            width = len(row)
        elif len(row) != width:
            raise ValueError(
                f"line {ln + 1}: ragged request ({len(row)} features, "
                f"expected {width})"
            )
        rows.append([float(v) for v in row])
    if not rows:
        raise ValueError("empty request body")
    return np.asarray(rows, np.float64)


class _RouteSlot:
    """One admitted named route: its hot-swap slot + its own batcher
    pair.  Its predictor captures its own bucket ladder (a graph reads
    its own predictor's buffers), counted in the captures like any
    other."""

    __slots__ = ("route", "swapper", "batcher", "raw_batcher")

    def __init__(self, route: str, swapper, batcher_opts: Dict):
        self.route = route
        self.swapper = swapper
        self.batcher = MicroBatcher(
            lambda batch: swapper.predict(batch), **batcher_opts)
        self.raw_batcher = MicroBatcher(
            lambda batch: swapper.predict(batch, raw_score=True),
            **batcher_opts)

    def close(self) -> None:
        self.batcher.close()
        self.raw_batcher.close()


class PredictServer(ThreadingHTTPServer):
    """HTTP server owning the predictor + batcher; ``daemon_threads`` so
    in-flight handler threads never block shutdown."""

    daemon_threads = True

    def __init__(self, addr, predictor,
                 batcher_opts: Optional[Dict] = None,
                 registry: Optional[ModelRegistry] = None,
                 registry_poll_ms: float = 500.0,
                 warmup_max_rows: int = 4096, do_warmup: bool = True,
                 pin_version: Optional[int] = None,
                 route_budget_bytes: int = 0,
                 predictor_factory=None):
        self.predictor = predictor
        # pinned replicas (canary) serve exactly one version: no
        # watcher, and maybe_swap is a no-op even on POST /models
        self.pin_version = int(pin_version) if pin_version else None
        opts = dict(batcher_opts or {})
        self._batcher_opts = opts
        self.batcher = MicroBatcher(
            lambda batch: predictor.predict(batch),
            **opts,
        )
        self.raw_batcher = MicroBatcher(
            lambda batch: predictor.predict(batch, raw_score=True),
            **opts,
        )
        # multi-model: named routes from the registry's route table,
        # each a _RouteSlot admitted against the device-bytes budget
        # (0 = unlimited); refused routes answer 503 with the reason
        self.routes: Dict[str, _RouteSlot] = {}
        self.route_budget_bytes = max(0, int(route_budget_bytes))
        self.admission_refused: Dict[str, str] = {}
        self._route_lock = threading.Lock()
        self._predictor_factory = predictor_factory or PackedPredictor
        self.registry = registry
        self.registry_poll_ms = float(registry_poll_ms)
        self._warmup_max_rows = int(warmup_max_rows)
        self._do_warmup = bool(do_warmup)
        self._swap_lock = threading.Lock()
        self._watch_stop = threading.Event()
        self._watch_thread: Optional[threading.Thread] = None
        self.t_start = time.time()
        # readiness/drain state (docs/ROBUSTNESS.md): ready flips on
        # once the artifact is loaded and warmup completed; draining
        # flips /readyz and /predict to 503 while in-flight batches run;
        # drained marks a COMPLETED drain (draining settles back to
        # False so the state gauges read a stable zero — the satellite-2
        # accounting contract)
        self.ready = False
        self.draining = False
        self.drained = False
        self._inflight = 0
        self._inflight_cv = threading.Condition()
        # scrape-time state gauges: evaluated inside /metrics rendering,
        # zero cost between scrapes (fn re-registration means the latest
        # server instance in a process owns the gauge)
        metrics_registry.gauge(
            "lightgbm_tpu_serve_ready",
            "1 once the artifact is loaded and warmup completed",
            fn=lambda: 1.0 if self.ready else 0.0)
        metrics_registry.gauge(
            "lightgbm_tpu_serve_draining",
            "1 while a SIGTERM graceful drain is in progress",
            fn=lambda: 1.0 if self.draining else 0.0)
        metrics_registry.gauge(
            "lightgbm_tpu_serve_inflight_requests",
            "HTTP predict requests currently being handled",
            fn=lambda: float(self._inflight))
        metrics_registry.gauge(
            "lightgbm_tpu_serve_uptime_seconds",
            "seconds since this server process started serving",
            fn=lambda: time.time() - self.t_start)
        # registry-staleness degradation (docs/ROBUSTNESS.md): a replica
        # whose swaps keep failing serves last-good FOREVER — correct,
        # but it must be visible, and the factory refuses to promote
        # against it (factory/supervisor.py _fleet_fresh)
        self._registry_stale_lock = threading.Lock()
        self._registry_stale_since: Optional[float] = None
        self._registry_failures = 0
        if registry is not None:
            # scrape-time registry views: a manifest read is host-side
            # file I/O only (never the card), cheap enough per scrape
            metrics_registry.gauge(
                "lightgbm_tpu_registry_models",
                "artifact versions published in the model registry",
                fn=lambda: float(len(registry.read_manifest()["entries"])))
            metrics_registry.gauge(
                "lightgbm_tpu_registry_active_version",
                "version the registry manifest currently activates",
                fn=lambda: float(registry.active_version() or 0))
            metrics_registry.gauge(
                "lightgbm_tpu_serve_registry_stale_seconds",
                "seconds since registry swaps started failing on this "
                "replica (0 = fresh)",
                fn=lambda: self.registry_stale_seconds())
        super().__init__(addr, _Handler)

    # -- registry staleness --------------------------------------------
    def registry_stale_seconds(self) -> float:
        with self._registry_stale_lock:
            if self._registry_stale_since is None:
                return 0.0
            return max(0.0, time.monotonic() - self._registry_stale_since)

    def _registry_sync_failed(self, err: Exception) -> None:
        with self._registry_stale_lock:
            self._registry_failures += 1
            n = self._registry_failures
            if self._registry_stale_since is None:
                self._registry_stale_since = time.monotonic()
        tracer.event("serve.registry_stale", consecutive_failures=n,
                     error=f"{type(err).__name__}: {err}")

    def _registry_sync_ok(self) -> None:
        with self._registry_stale_lock:
            was_stale = self._registry_stale_since is not None
            self._registry_stale_since = None
            self._registry_failures = 0
        if was_stale:
            Log.info("serve: registry sync recovered (fresh again)")

    # -- registry / hot swap -------------------------------------------
    def maybe_swap(self) -> Optional[Dict]:
        """Hot-swap to the registry's active version if it differs from
        the one serving.  Serialized so the watcher thread and a POST
        /models handler cannot double-load; returns the swap stats, or
        None when already current (or not in registry mode)."""
        if self.registry is None or self.pin_version is not None:
            return None
        with self._swap_lock:
            target = self.registry.active_version()
            if target is None or target == self.predictor.version:
                return None
            artifact = self.registry.load(target)
            stats = self.predictor.swap_to(
                artifact, target, warmup_max_rows=self._warmup_max_rows,
                do_warmup=self._do_warmup)
            # swap_to returned => the old version finished draining; its
            # labeled children would otherwise accumulate forever
            for fam in (_M_VER_REQS, _M_VER_ERRS, _M_VER_LATENCY):
                fam.prune({str(target)})
            return stats

    # -- multi-model routes --------------------------------------------
    def device_bytes_used(self) -> int:
        """Device-resident tree bytes across the default predictor and
        every admitted route — the admission accounting base."""
        used = int(getattr(self.predictor, "predictor",
                           self.predictor).device_bytes)
        for slot in self.routes.values():
            used += int(slot.swapper.predictor.device_bytes)
        return used

    def sync_routes(self) -> Optional[Dict]:
        """Reconcile the served route slots against the registry's route
        table: admit new routes (against the device-bytes budget),
        independently hot-swap routes whose version moved, tear down
        removed routes (and prune their metric children).  Returns a
        summary dict, or None when not in registry mode."""
        if self.registry is None or self.pin_version is not None:
            return None
        with self._route_lock:
            want = self.registry.routes()
            for name in list(self.routes):
                if name not in want:
                    slot = self.routes.pop(name)
                    slot.close()
                    self.admission_refused.pop(name, None)
                    tracer.event("serve.route_removed", route=name)
            for name, version in sorted(want.items()):
                slot = self.routes.get(name)
                try:
                    if slot is not None:
                        if slot.swapper.version != version:
                            artifact = self.registry.load(version)
                            slot.swapper.swap_to(
                                artifact, version,
                                warmup_max_rows=self._warmup_max_rows,
                                do_warmup=self._do_warmup)
                        continue
                    artifact = self.registry.load(version)
                    need = artifact.device_bytes_estimate()
                    used = self.device_bytes_used()
                    budget = self.route_budget_bytes
                    if budget and used + need > budget:
                        reason = (
                            f"route {name!r} (v{version}) needs {need} "
                            f"device bytes but {used} of the {budget}-byte "
                            f"budget are in use — remove a route or raise "
                            f"route_budget_mb")
                        if self.admission_refused.get(name) != reason:
                            Log.warning("serve: ADMISSION REFUSED: %s",
                                        reason)
                            _M_ADMISSION_REFUSED.inc()
                            tracer.event("serve.route_refused", route=name,
                                         version=int(version),
                                         need_bytes=int(need),
                                         used_bytes=int(used),
                                         budget_bytes=int(budget))
                        self.admission_refused[name] = reason
                        continue
                    swapper = SwappablePredictor(
                        self._predictor_factory(artifact), version=version)
                    if self._do_warmup:
                        swapper.warmup(self._warmup_max_rows)
                    self.routes[name] = _RouteSlot(name, swapper,
                                                   self._batcher_opts)
                    self.admission_refused.pop(name, None)
                    tracer.event("serve.route_added", route=name,
                                 version=int(version),
                                 device_bytes=int(
                                     swapper.predictor.device_bytes))
                except LightGBMError as e:
                    # a torn publish/corrupt artifact on ONE route must
                    # not take down the others — skip and retry on the
                    # next registry change
                    Log.warning("serve: route %r sync failed: %s", name, e)
            live = set(self.routes) | {_DEFAULT_ROUTE}
            for fam in (_M_ROUTE_REQS, _M_ROUTE_ERRS, _M_ROUTE_LATENCY):
                fam.prune(live)
            return {"routes": {n: s.swapper.version
                               for n, s in self.routes.items()},
                    "refused": dict(self.admission_refused)}

    def start_registry_watcher(self) -> None:
        """Poll the registry's change token and swap on activation —
        inotify-free, so it works on any shared filesystem."""
        if (self.registry is None or self.pin_version is not None
                or self._watch_thread is not None):
            return
        poll_s = max(self.registry_poll_ms, 1.0) / 1e3

        def _loop():
            token = self.registry.watch_token()
            while not self._watch_stop.wait(poll_s):
                t = self.registry.watch_token()
                if t == token:
                    continue
                token = t
                failed = None
                try:
                    self.maybe_swap()
                except Exception as e:
                    # a torn publish or corrupt artifact must not kill
                    # the serving loop — keep the current model and retry
                    # on the next token change
                    failed = e
                    Log.warning("serve: registry swap failed (still on "
                                "v%s): %s", getattr(self.predictor,
                                                    "version", "?"), e)
                try:
                    self.sync_routes()
                except Exception as e:
                    failed = e
                    Log.warning("serve: route sync failed: %s", e)
                if failed is None:
                    self._registry_sync_ok()
                else:
                    self._registry_sync_failed(failed)

        self._watch_thread = threading.Thread(
            target=_loop, name="ltpu-registry-watch", daemon=True)
        self._watch_thread.start()

    # -- in-flight request accounting ----------------------------------
    def track_begin(self) -> None:
        with self._inflight_cv:
            self._inflight += 1

    def track_end(self) -> None:
        with self._inflight_cv:
            self._inflight -= 1
            if self._inflight <= 0:
                self._inflight_cv.notify_all()

    def drain(self, timeout_s: float = 10.0) -> bool:
        """Graceful shutdown: stop admitting work (``/readyz`` and
        ``/predict`` answer 503), wait for in-flight HTTP requests AND
        the batchers' queued/executing rows to finish (bounded by
        ``timeout_s``), then stop the accept loop and close the
        batchers.  Returns True when the drain completed with nothing in
        flight — in which case ``draining`` settles back to False (and
        ``drained`` latches True), so the inflight/draining gauges read
        a stable zero instead of being stuck at 1 forever."""
        self.draining = True
        deadline = time.monotonic() + float(timeout_s)
        with self._inflight_cv:
            while self._inflight > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._inflight_cv.wait(min(remaining, 0.1))
            drained = self._inflight == 0
        # settle the batchers too: every queued AND executing row must
        # reach zero before the drain counts as complete
        batchers = [self.batcher, self.raw_batcher]
        for slot in list(self.routes.values()):
            batchers += [slot.batcher, slot.raw_batcher]
        for b in batchers:
            remaining = max(0.0, deadline - time.monotonic())
            drained = b.drain(remaining) and drained
        if not drained:
            Log.warning("serve: drain timed out with %d request(s) in "
                        "flight", self._inflight)
        self.shutdown()
        if drained:
            self.draining = False
        self.drained = True
        return drained

    def version_stats(self) -> Dict[str, Dict]:
        """Per-version serving attribution — the JSON parity view of the
        labeled ``/metrics`` families (same counters, same histogram).
        This is what the factory's canary observer polls for its SLO
        verdict."""
        out: Dict[str, Dict] = {}
        lat = _M_VER_LATENCY.children()
        errs = _M_VER_ERRS.children()
        for v, c in _M_VER_REQS.children().items():
            h = lat.get(v)
            out[v] = {
                "requests": int(c.value()),
                "errors": int(errs[v].value()) if v in errs else 0,
                "latency_p50_ms":
                    round(h.quantile(0.5) * 1e3, 3) if h else 0.0,
                "latency_p99_ms":
                    round(h.quantile(0.99) * 1e3, 3) if h else 0.0,
            }
        for v, c in errs.items():
            if v not in out:
                out[v] = {"requests": 0, "errors": int(c.value()),
                          "latency_p50_ms": 0.0, "latency_p99_ms": 0.0}
        return out

    def route_stats(self) -> Dict[str, Dict]:
        """Per-route serving attribution — the JSON parity view of the
        ``model_route``-labeled ``/metrics`` families (same counters,
        same histogram), pinned by tests/test_fleet.py."""
        out: Dict[str, Dict] = {}
        lat = _M_ROUTE_LATENCY.children()
        errs = _M_ROUTE_ERRS.children()
        for r, c in _M_ROUTE_REQS.children().items():
            h = lat.get(r)
            out[r] = {
                "requests": int(c.value()),
                "errors": int(errs[r].value()) if r in errs else 0,
                "latency_p50_ms":
                    round(h.quantile(0.5) * 1e3, 3) if h else 0.0,
                "latency_p99_ms":
                    round(h.quantile(0.99) * 1e3, 3) if h else 0.0,
            }
        for r, c in errs.items():
            if r not in out:
                out[r] = {"requests": 0, "errors": int(c.value()),
                          "latency_p50_ms": 0.0, "latency_p99_ms": 0.0}
        return out

    def stats(self) -> Dict:
        captures = compile_counts()
        out = {
            "uptime_s": round(time.time() - self.t_start, 1),
            "ready": self.ready,
            "draining": self.draining,
            "drained": self.drained,
            "inflight": self._inflight,
            "num_features": self.predictor.num_features,
            "num_class": self.predictor.artifact.num_class,
            "model_version": getattr(self.predictor, "version", None),
            "pin_version": self.pin_version,
            "per_version": self.version_stats(),
            "batcher": self.batcher.stats(),
            "raw_batcher": self.raw_batcher.stats(),
            # the port's compiles are CUDA graph captures: all of them, and
            # each serving walk's
            "compiles": {
                "graph_captures": graph_captures(),
                "predict_compiles": captures.get("graph_capture.serve.predict_raw", 0),
                "qpredict_compiles": captures.get("graph_capture.serve.qpredict", 0),
                "linear_compiles": captures.get("graph_capture.serve.predict_linear", 0),
            },
            "device": str(self.predictor.predictor.device),
            # the card's peak allocation in this process (0 on the CPU)
            "device_peak_bytes": (torch.cuda.max_memory_allocated(
                self.predictor.predictor.device)
                if self.predictor.predictor.device.type == "cuda" else 0),
        }
        if self.routes or self.admission_refused or self.route_budget_bytes:
            with self._route_lock:
                out["routes"] = {
                    name: {
                        "version": slot.swapper.version,
                        "quantized": bool(getattr(
                            slot.swapper.predictor, "quantized", False)),
                        "device_bytes": getattr(
                            slot.swapper.predictor, "device_bytes", 0),
                        "swaps": slot.swapper.swaps,
                        "batcher": slot.batcher.stats(),
                    }
                    for name, slot in self.routes.items()
                }
            out["per_route"] = self.route_stats()
            out["admission"] = {
                "budget_bytes": self.route_budget_bytes,
                "used_bytes": self.device_bytes_used(),
                "refused": dict(self.admission_refused),
            }
        if isinstance(self.predictor, SwappablePredictor):
            out["swap"] = {
                "swaps": self.predictor.swaps,
                "draining_versions": self.predictor.draining_versions,
                "last": self.predictor.last_swap,
            }
        if self.registry is not None:
            with self._registry_stale_lock:
                failures = self._registry_failures
            out["registry"] = {
                "dir": self.registry.dir,
                "active_version": self.registry.active_version(),
                "models": len(self.registry.read_manifest()["entries"]),
                "stale_seconds": round(self.registry_stale_seconds(), 3),
                "consecutive_failures": failures,
            }
        fault = faults.counters()
        if fault["spec"]:
            out["fault"] = fault
        return out

    def shutdown(self):
        self._watch_stop.set()
        super().shutdown()
        self.batcher.close()
        self.raw_batcher.close()
        for slot in list(self.routes.values()):
            slot.close()


class _Handler(BaseHTTPRequestHandler):
    server_version = "lightgbm-tpu-torch-serve/1"
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # route access logs to our logger
        Log.debug("serve: " + fmt, *args)

    def _reply(self, code: int, payload: bytes,
               ctype: str = "application/json",
               extra_headers: Optional[List] = None) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        for k, v in extra_headers or []:
            self.send_header(k, str(v))
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    def _reply_json(self, code: int, obj) -> None:
        self._reply(code, (json.dumps(obj) + "\n").encode())

    def do_GET(self):
        if self.path == "/healthz":
            self._reply_json(200, {"status": "ok"})
        elif self.path == "/readyz":
            if self.server.drained:
                self._reply_json(503, {"status": "stopped"})
            elif self.server.draining:
                self._reply_json(503, {"status": "draining"})
            elif not self.server.ready:
                self._reply_json(503, {"status": "warming"})
            else:
                self._reply_json(200, {"status": "ready"})
        elif self.path == "/stats":
            self._reply_json(200, self.server.stats())
        elif self.path == "/models":
            if self.server.registry is None:
                self._reply_json(404, {"error": "no model registry "
                                                "(start with registry=dir)"})
            else:
                self._reply_json(200, {
                    "models": self.server.registry.list_models(),
                    "active_version": self.server.registry.active_version(),
                    "serving_version": getattr(self.server.predictor,
                                               "version", None),
                    "routes": self.server.registry.routes(),
                })
        elif self.path == "/routes":
            self._do_routes_get()
        elif self.path == "/fault":
            self._reply_json(200, faults.counters())
        elif self.path == "/metrics":
            # Prometheus text format; render() reads host counters only,
            # so a scrape storm cannot capture or serialize device work
            self._reply(200, metrics_registry.render().encode(),
                        ctype="text/plain; version=0.0.4; charset=utf-8")
        else:
            self._reply_json(404, {"error": f"unknown path {self.path}"})

    def do_POST(self):
        path, _, query = self.path.partition("?")
        if path == "/models":
            self._do_publish()
            return
        if path == "/routes":
            self._do_routes_post()
            return
        if path == "/fault":
            self._do_fault()
            return
        route = None
        if path.startswith("/predict/"):
            route = path[len("/predict/"):]
        elif path != "/predict":
            self._reply_json(404, {"error": f"unknown path {path}"})
            return
        if self.server.draining or self.server.drained:
            # shed-not-queue during drain: the LB already saw /readyz
            # flip; anything still arriving is told to go elsewhere
            self._reply_json(503, {"error": "server is draining"})
            return
        # serving fault injection (serve/faults.py): wound the request
        # BEFORE inflight tracking so a hung drill never wedges a drain;
        # admin endpoints above stay exempt so a chaos test can always
        # clear the fault it armed
        act = faults.action()
        if act is not None:
            _M_FAULTS_INJECTED.inc()
            tracer.event("serve.fault", kind=act[0])
            if act[0] == "hang":
                # the canonical gray failure: the connection stays open,
                # /readyz stays 200, no response ever comes (bounded
                # only so the daemon thread eventually dies in tests)
                time.sleep(3600.0)
                return
            if act[0] == "error":
                length = int(self.headers.get("Content-Length") or 0)
                if length:
                    self.rfile.read(length)  # keep the connection parseable
                self._count_error(route)
                self._reply_json(500, {"error": "injected serve fault"})
                return
            if act[0] == "delay":
                time.sleep(act[1] / 1e3)
        self.server.track_begin()
        try:
            self._do_predict(query, route=route)
        finally:
            self.server.track_end()

    def _do_fault(self) -> None:
        """POST /fault {"spec": "hang:1,..."} — (re)arm serving fault
        injection at runtime; an empty spec clears it.  The chaos
        harness measures a healthy baseline on a fleet, then wounds the
        very same replicas through this endpoint."""
        try:
            length = int(self.headers.get("Content-Length") or 0)
            body = json.loads(self.rfile.read(length) or b"{}")
            spec = str(body.get("spec") or "")
        except (ValueError, json.JSONDecodeError) as e:
            self._reply_json(400, {"error": f"bad request body: {e}"})
            return
        try:
            armed = faults.set_spec(spec)
        except ValueError as e:
            self._reply_json(400, {"error": str(e)})
            return
        self._reply_json(200, {"spec": armed})

    def _do_routes_get(self) -> None:
        """GET /routes: the live route table (what THIS replica serves)
        plus the admission ledger — budget, usage, and refusals."""
        with self.server._route_lock:
            table = {name: {"version": slot.swapper.version,
                            "quantized": bool(getattr(
                                slot.swapper.predictor, "quantized", False)),
                            "device_bytes": getattr(
                                slot.swapper.predictor, "device_bytes", 0)}
                     for name, slot in self.server.routes.items()}
        self._reply_json(200, {
            "routes": table,
            "registry_routes": (self.server.registry.routes()
                                if self.server.registry is not None else {}),
            "admission": {
                "budget_bytes": self.server.route_budget_bytes,
                "used_bytes": self.server.device_bytes_used(),
                "refused": dict(self.server.admission_refused),
            },
        })

    def _do_routes_post(self) -> None:
        """POST /routes admin endpoint (registry mode only).

        ``{"route": name, "version": v}`` binds the route to a published
        version; ``{"route": name, "remove": true}`` unbinds it.  Either
        way the local reconciler runs synchronously so the reply reflects
        this replica's actual serving state (other replicas converge via
        their registry watcher).
        """
        if self.server.registry is None:
            self._reply_json(404, {"error": "no model registry "
                                            "(start with registry=dir)"})
            return
        try:
            length = int(self.headers.get("Content-Length") or 0)
            body = json.loads(self.rfile.read(length) or b"{}")
            route = str(body["route"])
        except (ValueError, KeyError, json.JSONDecodeError) as e:
            self._reply_json(400, {"error": f"bad request body: {e}"})
            return
        try:
            if body.get("remove"):
                removed = self.server.registry.remove_route(route)
                if not removed:
                    self._reply_json(404,
                                     {"error": f"unknown route {route!r}"})
                    return
            else:
                self.server.registry.set_route(route, int(body["version"]))
        except (LightGBMError, TimeoutError, KeyError, ValueError) as e:
            self._reply_json(400, {"error": str(e)})
            return
        sync = None
        try:
            sync = self.server.sync_routes()
        except Exception as e:
            Log.warning("serve: route sync after POST /routes failed: %s", e)
        self._reply_json(200, {
            "route": route,
            "registry_routes": self.server.registry.routes(),
            "sync": sync,
        })

    def _do_publish(self) -> None:
        """POST /models: validate + publish the uploaded artifact bytes,
        then hot-swap this replica to it (other replicas polling the
        shared registry follow within their poll interval)."""
        if self.server.registry is None:
            self._reply_json(404, {"error": "no model registry "
                                            "(start with registry=dir)"})
            return
        length = int(self.headers.get("Content-Length") or 0)
        blob = self.rfile.read(length) if length else b""
        if not blob:
            self._reply_json(400, {"error": "empty artifact upload"})
            return
        try:
            version = self.server.registry.publish_bytes(blob)
        except (LightGBMError, TimeoutError) as e:
            self._reply_json(400, {"error": str(e)})
            return
        swap = None
        try:
            swap = self.server.maybe_swap()
        except Exception as e:
            Log.warning("serve: swap to freshly published v%d failed: %s",
                        version, e)
        self._reply_json(200, {
            "version": version,
            "active_version": self.server.registry.active_version(),
            "serving_version": getattr(self.server.predictor, "version",
                                       None),
            "swap": swap,
        })

    def _count_error(self, route: Optional[str] = None) -> None:
        # a failed request never reached a batch, so it is attributed
        # to the version currently serving
        _M_VER_ERRS.labels(
            getattr(self.server.predictor, "version", 0)).inc()
        _M_ROUTE_ERRS.labels(route if route is not None else
                             _DEFAULT_ROUTE).inc()

    def _do_predict(self, query: str, route: Optional[str] = None) -> None:
        # deadline propagation: the proxy forwards the SHRUNKEN client
        # budget in X-Deadline-Ms; a spent budget 504s before any row
        # parsing or device work, and a live one bounds the batcher wait
        t_arrive = time.monotonic()
        budget_ms: Optional[float] = None
        raw_budget = self.headers.get("X-Deadline-Ms")
        if raw_budget:
            try:
                budget_ms = float(raw_budget)
            except ValueError:
                budget_ms = None
        if budget_ms is not None and budget_ms <= 0:
            _M_DEADLINE_REJECTED.inc()
            self._count_error(route)
            self._reply_json(504, {"error": "deadline exhausted before "
                                            "any device work"})
            return
        raw_score = "raw_score=1" in query
        stamp_version = "model_version=1" in query
        if route is None:
            batcher_pair = (self.server.batcher, self.server.raw_batcher)
        else:
            with self.server._route_lock:
                slot = self.server.routes.get(route)
                refused = self.server.admission_refused.get(route)
            if slot is None:
                if refused is not None:
                    # admitted-by-name but not by budget: loud, actionable
                    self._reply_json(503, {"error": f"route {route!r} "
                                           f"refused admission: {refused}"})
                else:
                    self._reply_json(404,
                                     {"error": f"unknown route {route!r}"})
                return
            batcher_pair = (slot.batcher, slot.raw_batcher)
        batcher = batcher_pair[1] if raw_score else batcher_pair[0]
        route_label = route if route is not None else _DEFAULT_ROUTE
        try:
            length = int(self.headers.get("Content-Length") or 0)
            rows = _parse_rows(self.rfile.read(length))
        except (ValueError, json.JSONDecodeError) as e:
            self._reply_json(400, {"error": str(e)})
            return
        t0 = time.monotonic()
        timeout_ms: Optional[float] = None
        if budget_ms is not None:
            remaining = budget_ms - (time.monotonic() - t_arrive) * 1e3
            # the batcher queue wait takes min(local timeout, remaining
            # budget); an already-spent budget fast-fails inside _submit
            timeout_ms = min(float(batcher.request_timeout_ms), remaining)
        try:
            preds, version = batcher.submit_ex(rows, timeout_ms=timeout_ms)
        except ServerOverloaded as e:
            self._count_error(route)
            self._reply_json(503, {"error": str(e)})
            return
        except RequestTimeout as e:
            self._count_error(route)
            self._reply_json(504, {"error": str(e)})
            return
        except Exception as e:
            Log.warning("serve: predict failed: %s", e)
            self._count_error(route)
            self._reply_json(500, {"error": f"{type(e).__name__}: {e}"})
            return
        # attribute the request to the ONE version that answered it —
        # the same version the X-Model-Version header carries — and to
        # the route the caller addressed ("default" for bare /predict)
        _M_VER_REQS.labels(version).inc()
        _M_VER_LATENCY.labels(version).observe(time.monotonic() - t0)
        _M_ROUTE_REQS.labels(route_label).inc()
        _M_ROUTE_LATENCY.labels(route_label).observe(time.monotonic() - t0)

        def _plain(p):
            return p.tolist() if isinstance(p, np.ndarray) else float(p)

        if stamp_version:
            lines = [json.dumps({"prediction": _plain(p),
                                 "model_version": version})
                     for p in preds]
        else:
            lines = [json.dumps(_plain(p)) for p in preds]
        headers = ([("X-Model-Version", int(version))]
                   if version is not None else [])
        if route is not None:
            headers.append(("X-Model-Route", route))
        self._reply(200, ("\n".join(lines) + "\n").encode(),
                    ctype="application/jsonl", extra_headers=headers)


def make_server(model_path: Optional[str] = None, host: str = "127.0.0.1",
                port: int = 0, warmup_max_rows: int = 4096,
                shard: bool = False, do_warmup: bool = True,
                registry_dir: Optional[str] = None,
                registry_poll_ms: float = 500.0,
                pin_version: Optional[int] = None,
                route_budget_mb: float = 0.0, device=None,
                **batcher_opts) -> PredictServer:
    """Build (and optionally warm) a ready-to-run server; ``port=0``
    binds an ephemeral port (tests).  With ``registry_dir`` the server
    serves the registry's active version and hot-swaps on activation;
    an empty registry is seeded from ``model_path``.  ``pin_version``
    (registry mode) serves exactly that published version and never
    swaps — the factory's canary replica.  ``device``: the card (None)
    or ``"cpu"``."""
    registry = ModelRegistry(registry_dir) if registry_dir else None
    version = 1
    if registry is not None:
        if pin_version:
            # canary replica: serve exactly this version, ignore
            # activations — promotion/rollback happens around us
            version = int(pin_version)
            artifact = registry.load(version)
        else:
            if registry.active_version() is None:
                if not model_path:
                    Log.fatal("serve: registry %s is empty and no model= "
                              "was given to seed it", registry_dir)
                # lock-guarded: N replicas racing to seed the same shared
                # registry publish exactly one v1
                registry.seed(load_artifact(model_path))
            version, artifact = registry.load_active()
        predictor = make_predictor(artifact, shard=shard, device=device)
    else:
        if not model_path:
            Log.fatal("serve: need model=path.npz|model.txt (or "
                      "registry=dir)")
        predictor = load_predictor(model_path, shard=shard, device=device)
    swapper = SwappablePredictor(predictor, version=version)
    server = PredictServer((host, port), swapper, batcher_opts,
                           registry=registry,
                           registry_poll_ms=registry_poll_ms,
                           warmup_max_rows=warmup_max_rows,
                           do_warmup=do_warmup,
                           pin_version=pin_version,
                           route_budget_bytes=int(route_budget_mb * (1 << 20)),
                           predictor_factory=lambda art: make_predictor(
                               art, shard=shard, device=device))
    if do_warmup:
        stats = swapper.warmup(warmup_max_rows)
        Log.info("serve: warmup captured %d CUDA graphs over buckets %s in %.2fs",
                 stats["compiles"], stats["buckets"], stats["secs"])
    server.sync_routes()  # admit named routes before advertising ready
    server.ready = True  # artifact loaded + warmup complete -> /readyz 200
    if registry is not None:
        server.start_registry_watcher()
    return server


def main(argv: List[str]) -> int:
    """``python -m lightgbm_tpu_torch serve model=... [key=value ...]``;
    ``device=cpu`` serves on the CPU, anything else names the card."""
    from ..cli import device_of, parse_argv

    tracer.refresh_from_env()
    faults.refresh_from_env()  # LIGHTGBM_TPU_SERVE_FAULT chaos drills
    params = parse_argv(argv)
    device = device_of(params)
    model_path = params.get("model") or params.get("input_model")
    registry_dir = params.get("registry")
    if not model_path and not registry_dir:
        Log.warning("serve: no model file (model=path.npz or model=model.txt"
                    ", or registry=dir)")
        return 1
    opts = dict(DEFAULTS)
    for k in list(opts):
        if k in params:
            opts[k] = type(opts[k])(float(params[k]))
    server = make_server(
        model_path,
        host=str(params.get("host", "127.0.0.1")),
        port=int(opts["port"]),
        warmup_max_rows=int(opts["warmup_max_rows"]),
        shard=bool(opts["shard"]),
        do_warmup=bool(opts["warmup"]),
        registry_dir=registry_dir,
        registry_poll_ms=float(opts["registry_poll_ms"]),
        pin_version=int(opts["pin_version"]) or None,
        route_budget_mb=float(opts["route_budget_mb"]),
        max_batch_size=int(opts["max_batch_size"]),
        max_delay_ms=float(opts["max_delay_ms"]),
        max_queue_rows=int(opts["max_queue_rows"]),
        request_timeout_ms=float(opts["request_timeout_ms"]),
        device=device,
    )
    host, port = server.server_address[:2]
    Log.info("serve: listening on http://%s:%d (POST /predict, GET "
             "/healthz /readyz /stats)", host, port)

    drain_timeout_s = float(opts["drain_timeout_ms"]) / 1e3

    drainers = []

    def _on_sigterm(signum, frame):
        # graceful drain off the signal context: flip /readyz, let
        # in-flight microbatches finish, then stop serve_forever
        Log.warning("serve: SIGTERM — draining (timeout %.1fs)",
                    drain_timeout_s)
        drainer = threading.Thread(target=server.drain, args=(drain_timeout_s,),
                                   name="ltpu-serve-drain", daemon=True)
        drainers.append(drainer)
        drainer.start()

    try:
        signal.signal(signal.SIGTERM, _on_sigterm)
    except ValueError:  # pragma: no cover - non-main thread (embedding)
        pass

    try:
        server.serve_forever()
    except KeyboardInterrupt:
        Log.info("serve: shutting down")
        server.shutdown()
    finally:
        server.server_close()
    # the drain closes the batchers after serve_forever returns: exiting
    # before it ends aborted the process now and then (SIGABRT at exit)
    for drainer in drainers:
        drainer.join()
    Log.info("serve: drained and stopped")
    return 0
