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

``FleetProxy`` (the JAX package's, host-only) is a stdlib-HTTP
load-balancing front end over N replica processes: round-robin or
least-loaded choice, ejection of a backend that refuses connections (the
request retries elsewhere: predict is idempotent, so a SIGKILLed replica
costs a retry, never a dropped answer) and a ``/readyz`` prober that
restores it.  Against gray failures it forwards the client's
``X-Deadline-Ms`` budget shrunk at each hop, hedges a slow predict at a
second backend (first answer wins, within a budget), opens a
latency-outlier circuit breaker (serve/breaker.py) on a replica that is
alive but wedged, and sheds excess load with 503 + ``Retry-After``.
``spawn_replicas`` starts ``python -m lightgbm_tpu_torch serve``
processes (``device=`` passed through), ``main`` is ``python -m
lightgbm_tpu_torch fleet``.
"""

from __future__ import annotations

import http.client
import json
import os
import queue
import signal
import subprocess
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..obs.metrics import LATENCY_BUCKETS, RollingQuantile, registry as metrics_registry
from ..obs.trace import total_compiles, tracer
from ..utils.log import Log
from . import breaker as breaker_mod
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
_M_PROXY_REQS = metrics_registry.counter(
    "lightgbm_tpu_proxy_requests_total", "requests handled by the proxy")
_M_PROXY_RETRIES = metrics_registry.counter(
    "lightgbm_tpu_proxy_retries_total",
    "request attempts re-routed to another backend")
_M_PROXY_EJECTIONS = metrics_registry.counter(
    "lightgbm_tpu_proxy_ejections_total",
    "backends ejected after a connection failure")
_M_PROXY_LATENCY = metrics_registry.histogram(
    "lightgbm_tpu_proxy_latency_seconds",
    "proxy request latency including retries", buckets=LATENCY_BUCKETS)
_M_PROXY_CANARY = metrics_registry.counter(
    "lightgbm_tpu_proxy_canary_requests_total",
    "predict requests answered by the canary backend")
_M_PROXY_HEDGES = metrics_registry.counter(
    "lightgbm_tpu_proxy_hedges_total",
    "hedge attempts launched for slow predicts")
_M_PROXY_HEDGE_WINS = metrics_registry.counter(
    "lightgbm_tpu_proxy_hedge_wins_total",
    "predicts where the hedge attempt answered first")
_M_PROXY_BREAKER_OPENS = metrics_registry.counter(
    "lightgbm_tpu_proxy_breaker_opens_total",
    "circuit-breaker CLOSED/HALF_OPEN -> OPEN transitions")
_M_PROXY_BREAKER_CLOSES = metrics_registry.counter(
    "lightgbm_tpu_proxy_breaker_closes_total",
    "circuit-breaker HALF_OPEN -> CLOSED restorations")
_M_PROXY_SHED = metrics_registry.counter(
    "lightgbm_tpu_proxy_shed_total",
    "requests shed by proxy overload control (503 + Retry-After)")
_M_PROXY_DEADLINE = metrics_registry.counter(
    "lightgbm_tpu_proxy_deadline_rejected_total",
    "requests 504ed at the proxy because the X-Deadline-Ms budget ran out")


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


# ----------------------------------------------------------------------
# load-balancing proxy
# ----------------------------------------------------------------------
class _Backend:
    __slots__ = ("host", "port", "healthy", "inflight", "requests",
                 "failures", "ejections")

    def __init__(self, addr: str):
        host, _, port = addr.rpartition(":")
        self.host = host or "127.0.0.1"
        self.port = int(port)
        self.healthy = True
        self.inflight = 0
        self.requests = 0
        self.failures = 0
        self.ejections = 0

    @property
    def addr(self) -> str:
        return f"{self.host}:{self.port}"

    def as_dict(self) -> Dict:
        return {"addr": self.addr, "healthy": self.healthy,
                "inflight": self.inflight, "requests": self.requests,
                "failures": self.failures, "ejections": self.ejections}


class FleetProxy(ThreadingHTTPServer):
    """Round-robin / least-loaded HTTP proxy with health ejection.

    Local endpoints: ``/healthz`` (proxy liveness), ``/fleet/stats``
    (per-backend health + counters), ``/metrics`` (Prometheus).
    Everything else is forwarded to a healthy backend; connection
    failures eject the backend and the request retries elsewhere until
    ``retry_deadline_s`` — a response is dropped only when NO backend
    answers for that long."""

    daemon_threads = True

    def __init__(self, addr, backends: List[str], policy: str = "least_loaded",
                 backend_timeout_s: float = 30.0, health_poll_s: float = 0.5,
                 retry_deadline_s: float = 10.0,
                 hedge_delay_ms: float = 0.0, hedge_budget_pct: float = 10.0,
                 breaker_k: float = 3.0, breaker_m: int = 5,
                 breaker_open_ms: float = 2000.0,
                 max_concurrent: int = 128, max_queue: int = 256):
        if not backends:
            Log.fatal("fleet proxy needs at least one backend")
        if policy not in ("least_loaded", "rr"):
            Log.fatal("unknown proxy policy %r (least_loaded or rr)", policy)
        self.backends = [_Backend(b) for b in backends]
        self.policy = policy
        self.backend_timeout_s = float(backend_timeout_s)
        self.health_poll_s = float(health_poll_s)
        self.retry_deadline_s = float(retry_deadline_s)
        # gray-failure hardening (docs/ROBUSTNESS.md serving table):
        # hedge_delay_ms: fixed hedge trigger; 0 = adaptive (p95 of the
        # recent attempt-latency window); <0 disables hedging entirely
        self.hedge_delay_ms = float(hedge_delay_ms)
        self.hedge_budget_pct = float(hedge_budget_pct)
        self.breaker = breaker_mod.LatencyBreaker(
            k=float(breaker_k), m=int(breaker_m),
            open_s=float(breaker_open_ms) / 1e3)
        self.max_concurrent = int(max_concurrent)
        self.max_queue = int(max_queue)
        self._lat_window = RollingQuantile(window=512)
        self._fwd_requests = 0
        self._hedges = 0
        self._hedge_wins = 0
        self._shed = 0
        self._deadline_rejected = 0
        self._ocv = threading.Condition(threading.Lock())
        self._active = 0
        self._waiting = 0
        self._block = threading.Lock()
        self._rr = 0
        self._stop = threading.Event()
        self.t_start = time.time()
        # canary slice (docs/FACTORY.md): an out-of-rotation backend
        # pinned to the candidate version; a deterministic fraction of
        # /predict traffic is diverted to it, and a canary failure falls
        # back into the main pool so the client never pays for it
        self.canary: Optional[_Backend] = None
        self.canary_fraction = 0.0
        self._canary_tick = 0
        metrics_registry.gauge(
            "lightgbm_tpu_proxy_healthy_backends",
            "backends currently accepting traffic",
            fn=lambda: float(sum(1 for b in self.backends if b.healthy)))
        metrics_registry.gauge(
            "lightgbm_tpu_proxy_open_breakers",
            "backends whose circuit breaker is OPEN or HALF_OPEN",
            fn=lambda: float(self.breaker.open_count()))
        metrics_registry.gauge(
            "lightgbm_tpu_proxy_inflight_requests",
            "forwarded requests currently admitted by overload control",
            fn=lambda: float(self._active))
        self._health_thread = threading.Thread(
            target=self._health_loop, name="ltpu-fleet-health", daemon=True)
        super().__init__(addr, _ProxyHandler)
        self._health_thread.start()

    # -- backend choice ------------------------------------------------
    def pick(self, exclude: Optional[set] = None) -> Optional[_Backend]:
        exclude = exclude or set()
        with self._block:
            candidates = [b for b in self.backends
                          if b.healthy and b.addr not in exclude]
            if not candidates:
                # all excluded this attempt round: fall back to any
                # healthy backend (it may have recovered)
                candidates = [b for b in self.backends if b.healthy]
            if not candidates:
                return None
            # circuit breakers (serve/breaker.py): a due half-open probe
            # takes priority — that single request is what restores a
            # recovered backend; otherwise route among CLOSED backends,
            # and when every breaker is open fall back to all healthy
            # (breakers advise, they never zero out availability)
            trials = [b for b in candidates
                      if self.breaker.trial_eligible(b.addr)]
            if trials:
                candidates = trials
            else:
                closed = [b for b in candidates
                          if self.breaker.state(b.addr) == breaker_mod.CLOSED]
                if closed:
                    candidates = closed
            self._rr += 1
            if self.policy == "rr":
                chosen = candidates[self._rr % len(candidates)]
            else:
                # least-loaded, with a rotating tie-break so idle fleets
                # still spread sequential traffic instead of hammering
                # the first backend
                lo = min(b.inflight for b in candidates)
                tied = [b for b in candidates if b.inflight == lo]
                chosen = tied[self._rr % len(tied)]
            self.breaker.begin_attempt(chosen.addr)
            chosen.inflight += 1
            chosen.requests += 1
            return chosen

    def has_untried(self, tried: set) -> bool:
        """A healthy backend outside ``tried`` exists — the 503 re-route
        bound (counting against the live backend-list length shifts as
        backends eject/restore mid-request; the tried set does not)."""
        with self._block:
            return any(b.healthy and b.addr not in tried
                       for b in self.backends)

    def note_result(self, backend: _Backend, elapsed_s: float,
                    ok: bool) -> None:
        """Feed one attempt's outcome to the breaker + hedge-delay
        window and mirror breaker transitions to metrics/trace."""
        transition = self.breaker.observe(backend.addr, elapsed_s, ok)
        if ok:
            self._lat_window.observe(elapsed_s)
        if transition in ("open", "reopen"):
            _M_PROXY_BREAKER_OPENS.inc()
            Log.warning("fleet: breaker OPEN on %s (%s)", backend.addr,
                        "probe failed" if transition == "reopen"
                        else "latency/error outlier")
        elif transition == "close":
            _M_PROXY_BREAKER_CLOSES.inc()
            Log.info("fleet: breaker CLOSED on %s (probe succeeded)",
                     backend.addr)
        if transition:
            tracer.event("fleet.breaker", addr=backend.addr,
                         transition=transition)

    # -- hedging -------------------------------------------------------
    def hedge_delay_s(self) -> Optional[float]:
        """Current hedge trigger in seconds, or None when hedging is
        off (negative knob or a single-backend fleet)."""
        if self.hedge_delay_ms < 0 or len(self.backends) < 2:
            return None
        if self.hedge_delay_ms > 0:
            return self.hedge_delay_ms / 1e3
        # adaptive: p95 of the recent attempt-latency window, floored so
        # a microsecond-fast fleet does not hedge-storm, with a cold
        # fallback until the window has signal
        if self._lat_window.count() < 20:
            return 0.05
        return max(0.025, self._lat_window.quantile(0.95))

    def take_hedge_token(self) -> bool:
        """Hedge budget: hedges may not exceed ``hedge_budget_pct`` % of
        forwarded requests (with a small floor so early traffic can
        still hedge before the denominator grows)."""
        if self.hedge_budget_pct <= 0:
            return False
        with self._block:
            allowed = max(5.0,
                          self.hedge_budget_pct / 100.0 * self._fwd_requests)
            if self._hedges + 1 > allowed:
                return False
            self._hedges += 1
            return True

    # -- overload control ----------------------------------------------
    def admit(self, deadline: float) -> bool:
        """Bounded concurrency + bounded wait queue: a forwarded request
        either gets a concurrency slot (possibly after queueing until
        ``deadline``) or is shed — the proxy never grows an unbounded
        thread pile behind a slow fleet."""
        if self.max_concurrent <= 0:
            return True
        with self._ocv:
            if self._active < self.max_concurrent:
                self._active += 1
                return True
            if self._waiting >= self.max_queue:
                return False
            self._waiting += 1
            try:
                while self._active >= self.max_concurrent:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return False
                    self._ocv.wait(min(remaining, 0.05))
                self._active += 1
                return True
            finally:
                self._waiting -= 1

    def unadmit(self) -> None:
        if self.max_concurrent <= 0:
            return
        with self._ocv:
            self._active = max(0, self._active - 1)
            self._ocv.notify()

    # -- canary slice --------------------------------------------------
    def set_canary(self, addr: Optional[str],
                   fraction: float = 0.0) -> None:
        """Install (or clear with ``addr=None``/``fraction<=0``) the
        canary backend receiving ``fraction`` of /predict traffic."""
        with self._block:
            if addr and fraction > 0:
                self.canary = _Backend(addr)
                self.canary_fraction = min(1.0, float(fraction))
                self._canary_tick = 0
            else:
                self.canary = None
                self.canary_fraction = 0.0
        tracer.event("fleet.canary",
                     addr=str(addr) if addr and fraction > 0 else None,
                     fraction=float(self.canary_fraction))

    def pick_canary(self) -> Optional[_Backend]:
        """Deterministic fraction routing: predict request t diverts to
        the canary exactly when ``floor(t*f)`` advances — fraction f of
        traffic with no RNG and no burst (every 1/f-th request)."""
        with self._block:
            c = self.canary
            if c is None or not c.healthy:
                return None
            self._canary_tick += 1
            t, f = self._canary_tick, self.canary_fraction
            if int(t * f) <= int((t - 1) * f):
                return None
            c.inflight += 1
            c.requests += 1
            return c

    def release(self, backend: _Backend) -> None:
        with self._block:
            backend.inflight = max(0, backend.inflight - 1)

    def eject(self, backend: _Backend) -> None:
        with self._block:
            backend.failures += 1
            if backend.healthy:
                backend.healthy = False
                backend.ejections += 1
                _M_PROXY_EJECTIONS.inc()
                Log.warning("fleet: ejected backend %s after a "
                            "connection failure", backend.addr)

    # -- health probing ------------------------------------------------
    def _probe(self, backend: _Backend) -> bool:
        try:
            conn = http.client.HTTPConnection(backend.host, backend.port,
                                              timeout=2.0)
            try:
                conn.request("GET", "/readyz")
                return conn.getresponse().status == 200
            finally:
                conn.close()
        except OSError:
            return False
        except http.client.HTTPException:
            return False

    def _health_loop(self) -> None:
        while not self._stop.wait(self.health_poll_s):
            with self._block:
                c = self.canary
            probed = list(self.backends) + ([c] if c is not None else [])
            for b in probed:
                ok = self._probe(b)
                with self._block:
                    if ok and not b.healthy:
                        Log.info("fleet: backend %s recovered", b.addr)
                    b.healthy = ok

    # -- ops surface ---------------------------------------------------
    def stats(self) -> Dict:
        breakers = self.breaker.snapshot()
        with self._block:
            backends = [dict(b.as_dict(), breaker=breakers.get(b.addr))
                        for b in self.backends]
            canary = (dict(self.canary.as_dict(),
                           fraction=self.canary_fraction)
                      if self.canary is not None else None)
            hedges = {"launched": self._hedges, "wins": self._hedge_wins,
                      "budget_pct": self.hedge_budget_pct,
                      "delay_ms": self.hedge_delay_ms}
            deadline_rejected = self._deadline_rejected
            shed = self._shed
        with self._ocv:
            overload = {"active": self._active, "waiting": self._waiting,
                        "shed": shed,
                        "max_concurrent": self.max_concurrent,
                        "max_queue": self.max_queue}
        return {
            "uptime_s": round(time.time() - self.t_start, 1),
            "policy": self.policy,
            "healthy": sum(1 for b in backends if b["healthy"]),
            "backends": backends,
            "canary": canary,
            "hedges": hedges,
            "overload": overload,
            "open_breakers": sum(1 for s in breakers.values()
                                 if s["state"] != breaker_mod.CLOSED),
            "deadline_rejected": deadline_rejected,
        }

    def shutdown(self):
        self._stop.set()
        super().shutdown()


class _ProxyHandler(BaseHTTPRequestHandler):
    server_version = "lightgbm-tpu-fleet/1"
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):
        Log.debug("fleet: " + fmt, *args)

    def _reply(self, code: int, payload: bytes,
               headers: Optional[List[Tuple[str, str]]] = None) -> None:
        self.send_response(code)
        sent = set()
        for k, v in headers or []:
            if k.lower() in ("content-type", "x-model-version",
                             "x-model-route", "retry-after"):
                self.send_header(k, v)
                sent.add(k.lower())
        if "content-type" not in sent:
            self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    def _reply_json(self, code: int, obj) -> None:
        self._reply(code, (json.dumps(obj) + "\n").encode())

    def do_GET(self):
        if self.path == "/healthz":
            self._reply_json(200, {"status": "ok", "role": "proxy"})
        elif self.path == "/fleet/stats":
            self._reply_json(200, self.server.stats())
        elif self.path == "/metrics":
            self._reply(200, metrics_registry.render().encode(),
                        headers=[("Content-Type",
                                  "text/plain; version=0.0.4; charset=utf-8")])
        else:
            self._forward("GET", body=None)

    def do_POST(self):
        length = int(self.headers.get("Content-Length") or 0)
        body = self.rfile.read(length) if length else b""
        if self.path == "/fleet/canary":
            self._do_canary(body)
            return
        self._forward("POST", body=body)

    def _do_canary(self, body: bytes) -> None:
        """POST /fleet/canary {"addr": "host:port", "fraction": 0.2} —
        install a canary slice; null addr or fraction<=0 clears it."""
        try:
            req = json.loads(body.decode("utf-8") or "{}")
            addr = req.get("addr")
            fraction = float(req.get("fraction") or 0.0)
        except (ValueError, AttributeError) as e:
            self._reply_json(400, {"error": f"bad canary request: {e}"})
            return
        self.server.set_canary(addr, fraction)
        with self.server._block:
            c = self.server.canary
            self._reply_json(200, {
                "canary": c.addr if c is not None else None,
                "fraction": self.server.canary_fraction,
            })

    def _deadline_budget_ms(self) -> Optional[float]:
        """Client ``X-Deadline-Ms`` budget, or None (absent/bad)."""
        raw = self.headers.get("X-Deadline-Ms")
        if not raw:
            return None
        try:
            v = float(raw)
        except ValueError:
            return None
        return v if v > 0 else 0.0

    def _forward(self, method: str, body: Optional[bytes]) -> None:
        """Relay to a healthy backend under the gray-failure contract:

        - ``X-Deadline-Ms`` budget bounds the WHOLE relay (attempts,
          queueing, retries); each backend attempt gets the shrunken
          remainder forwarded and a socket timeout no larger than it,
          so a hung replica costs a bounded timeout, never 30 s.
        - Connection failures eject-and-retry; 503s re-route until the
          set of backends *tried this round* is exhausted.
        - Idempotent predicts that outlive the hedge delay fire ONE
          hedge at a different backend; first response wins.
        - Admission control sheds with 503 + ``Retry-After`` instead of
          queueing unboundedly."""
        srv: FleetProxy = self.server
        t0 = time.perf_counter()
        tm0 = time.monotonic()
        _M_PROXY_REQS.inc()
        with srv._block:
            srv._fwd_requests += 1
        budget_ms = self._deadline_budget_ms()
        budget_deadline = (tm0 + budget_ms / 1e3
                           if budget_ms is not None else None)
        deadline = tm0 + srv.retry_deadline_s
        if budget_deadline is not None:
            deadline = min(deadline, budget_deadline)
        is_predict = (method == "POST"
                      and self.path.partition("?")[0].startswith("/predict"))
        if not srv.admit(deadline):
            with srv._block:
                srv._shed += 1
            _M_PROXY_SHED.inc()
            self._reply(503, (json.dumps(
                {"error": "proxy overloaded, retry later"}) + "\n").encode(),
                headers=[("Retry-After", "1")])
            return
        try:
            if budget_deadline is not None \
                    and time.monotonic() >= budget_deadline:
                self._reply_deadline_exceeded(srv, 0)
                return
            if is_predict and self.path.partition("?")[0] == "/predict":
                canary = srv.pick_canary()
                if canary is not None:
                    status = None
                    try:
                        status, headers, payload = self._try_backend(
                            srv, canary, method, body,
                            timeout_s=self._attempt_timeout(srv, deadline),
                            deadline_ms=self._remaining_ms(budget_deadline))
                    except (OSError, http.client.HTTPException):
                        # a canary that stops answering must not be
                        # re-picked and re-timed-out on every request
                        # until the prober notices: eject it like a
                        # main-pool backend
                        srv.eject(canary)
                    finally:
                        srv.release(canary)
                    if status is not None and status < 500 and status != 503:
                        _M_PROXY_CANARY.inc()
                        _M_PROXY_LATENCY.observe(time.perf_counter() - t0)
                        self._reply(status, payload, headers=headers)
                        return
                    # a failing canary never costs the client a
                    # response: fall back into the main pool.  The
                    # canary replica's own per-version error metrics
                    # carry the verdict evidence — the proxy only
                    # limits the blast radius.
                    _M_PROXY_RETRIES.inc()
            self._forward_pool(srv, method, body, t0, deadline,
                               budget_deadline, hedge_ok=is_predict)
        finally:
            srv.unadmit()

    @staticmethod
    def _attempt_timeout(srv: FleetProxy, deadline: float) -> float:
        return min(srv.backend_timeout_s,
                   max(deadline - time.monotonic(), 0.05))

    @staticmethod
    def _remaining_ms(budget_deadline: Optional[float]) -> Optional[float]:
        if budget_deadline is None:
            return None
        return max(0.0, (budget_deadline - time.monotonic()) * 1e3)

    def _reply_deadline_exceeded(self, srv: FleetProxy,
                                 attempts: int) -> None:
        with srv._block:
            srv._deadline_rejected += 1
        _M_PROXY_DEADLINE.inc()
        self._reply_json(504, {"error": "deadline exhausted",
                               "attempts": attempts})

    def _forward_pool(self, srv: FleetProxy, method: str,
                      body: Optional[bytes], t0: float, deadline: float,
                      budget_deadline: Optional[float],
                      hedge_ok: bool) -> None:
        """The attempt loop: worker threads race into a result queue so
        the handler can arm a hedge while the first attempt is still in
        flight.  At most one hedge per request; every launched attempt
        feeds the breaker when it eventually resolves."""
        resultq: "queue.Queue" = queue.Queue()
        tried: set = set()
        busy: set = set()  # addrs with an attempt currently in flight
        inflight = 0
        attempt = 0
        hedge_used = False
        last_503 = None

        def launch(backend: _Backend, is_hedge: bool) -> None:
            nonlocal inflight, attempt
            attempt += 1
            inflight += 1
            busy.add(backend.addr)
            timeout_s = self._attempt_timeout(srv, deadline)
            deadline_ms = self._remaining_ms(budget_deadline)
            t_launch = time.monotonic()

            def run():
                # breaker feeding + ejection live HERE, in the attempt
                # thread: a hung attempt whose handler already answered
                # via hedge still lands its timeout on the breaker —
                # that orphaned observation is exactly the gray-failure
                # evidence the breaker exists to accumulate
                try:
                    out = self._try_backend(srv, backend, method, body,
                                            timeout_s=timeout_s,
                                            deadline_ms=deadline_ms)
                    srv.note_result(backend,
                                    time.monotonic() - t_launch,
                                    ok=out[0] < 500)
                    resultq.put((backend, is_hedge, t_launch, None, out))
                except (OSError, http.client.HTTPException) as e:
                    srv.note_result(backend,
                                    time.monotonic() - t_launch, ok=False)
                    srv.eject(backend)
                    resultq.put((backend, is_hedge, t_launch, e, None))
                finally:
                    srv.release(backend)

            threading.Thread(target=run, daemon=True,
                             name="ltpu-fleet-attempt").start()

        def give_up(now: float) -> None:
            # the client's budget is spent (attempts may still be in
            # flight) — answer now, bounded: the best 503 we saw, a 504
            # for an exhausted client deadline, a 502 otherwise
            if last_503 is not None:
                status, headers, payload = last_503
                self._reply(status, payload, headers=headers)
            elif budget_deadline is not None and now >= budget_deadline:
                self._reply_deadline_exceeded(srv, attempt)
            else:
                self._reply_json(502, {
                    "error": "no backend answered before the retry "
                             "deadline", "attempts": attempt})

        while True:
            if inflight == 0:
                if time.monotonic() > deadline:
                    give_up(time.monotonic())
                    return
                backend = srv.pick(exclude=tried)
                if backend is None:
                    time.sleep(0.05)
                    tried.clear()  # health loop may restore one
                    continue
                launch(backend, is_hedge=False)
            # wait for a result; while the FIRST attempt is alone in
            # flight an un-hedged predict wakes early at the hedge delay
            wait_s = max(deadline - time.monotonic(), 0.001)
            hd = srv.hedge_delay_s() if (hedge_ok and not hedge_used
                                         and inflight == 1) else None
            if hd is not None:
                wait_s = min(wait_s, hd)
            try:
                backend, is_hedge, t_launch, err, out = resultq.get(
                    timeout=wait_s)
            except queue.Empty:
                now = time.monotonic()
                if now > deadline:
                    give_up(now)
                    return
                if hd is not None and not hedge_used:
                    hedge_used = True  # one hedge per request, ever
                    if srv.take_hedge_token():
                        # a hedge at the backend the stuck attempt is
                        # already on is no hedge at all: exclude busy
                        # addrs, and skip entirely if pick's all-healthy
                        # fallback re-includes one (hung single-survivor
                        # fleets just wait out the first attempt)
                        hb = srv.pick(exclude=tried | busy)
                        if hb is not None and hb.addr in busy:
                            srv.release(hb)
                        elif hb is not None:
                            _M_PROXY_HEDGES.inc()
                            launch(hb, is_hedge=True)
                continue
            inflight -= 1
            busy.discard(backend.addr)
            if err is not None:
                tried.add(backend.addr)
                _M_PROXY_RETRIES.inc()
                continue
            status, headers, payload = out
            if status == 503:
                tried.add(backend.addr)
                last_503 = (status, headers, payload)
                if srv.has_untried(tried) and time.monotonic() <= deadline:
                    # draining/overloaded replica: give the others a
                    # shot, but relay the 503 once every backend
                    # actually tried this round said it
                    _M_PROXY_RETRIES.inc()
                    continue
                if inflight > 0:
                    continue  # a raced attempt may still answer
            elif is_hedge:
                with srv._block:
                    srv._hedge_wins += 1
                _M_PROXY_HEDGE_WINS.inc()
            _M_PROXY_LATENCY.observe(time.perf_counter() - t0)
            self._reply(status, payload, headers=headers)
            return

    def _try_backend(self, srv: FleetProxy, backend: _Backend,
                     method: str, body: Optional[bytes],
                     timeout_s: Optional[float] = None,
                     deadline_ms: Optional[float] = None):
        conn = http.client.HTTPConnection(
            backend.host, backend.port,
            timeout=timeout_s if timeout_s else srv.backend_timeout_s)
        headers = {"Content-Type": "application/json"}
        if deadline_ms is not None:
            # each hop forwards the SHRUNKEN remainder: the replica sees
            # how much of the client's budget is actually left
            headers["X-Deadline-Ms"] = str(int(deadline_ms))
        try:
            conn.request(method, self.path, body=body, headers=headers)
            resp = conn.getresponse()
            payload = resp.read()
            return resp.status, resp.getheaders(), payload
        finally:
            conn.close()


# ----------------------------------------------------------------------
# fleet launcher — N serve subprocesses + the proxy
# ----------------------------------------------------------------------
FLEET_DEFAULTS = {
    "replicas": 2,
    "port": 9095,
    "base_port": 0,
    "health_poll_ms": 500,
    "retry_deadline_ms": 10000,
    "ready_timeout_ms": 120000,
    "backend_timeout_ms": 30000,
    "hedge_delay_ms": 0.0,       # 0 = adaptive p95; <0 disables hedging
    "hedge_budget_pct": 10.0,
    "breaker_k": 3.0,
    "breaker_m": 5,
    "breaker_open_ms": 2000,
    "max_concurrent": 128,
    "max_queue": 256,
}


def _free_ports(n: int, host: str = "127.0.0.1") -> List[int]:
    import socket

    socks, ports = [], []
    try:
        for _ in range(n):
            s = socket.socket()
            s.bind((host, 0))
            socks.append(s)
            ports.append(s.getsockname()[1])
    finally:
        for s in socks:
            s.close()
    return ports


def _wait_ready(host: str, port: int, timeout_s: float) -> bool:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        try:
            conn = http.client.HTTPConnection(host, port, timeout=2.0)
            try:
                conn.request("GET", "/readyz")
                if conn.getresponse().status == 200:
                    return True
            finally:
                conn.close()
        except (OSError, http.client.HTTPException):
            pass
        time.sleep(0.1)
    return False


def _package_root() -> str:
    """The directory that holds the ``lightgbm_tpu_torch`` package, so a
    replica imports the same code from any working directory."""
    return os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def spawn_replicas(n: int, serve_params: Dict[str, str],
                   ports: Optional[List[int]] = None,
                   host: str = "127.0.0.1",
                   envs: Optional[List[Optional[Dict[str, str]]]] = None,
                   device: Optional[str] = None,
                   ) -> List[Tuple[subprocess.Popen, int]]:
    """Launch ``n`` ``python -m lightgbm_tpu_torch serve`` subprocesses.

    ``device`` (or a ``device`` key of ``serve_params``) goes to each
    replica: the card unless it says ``cpu``.  ``envs[i]`` overlays extra
    environment onto replica ``i`` — how a chaos drill arms per-replica
    fault injection (``LIGHTGBM_TPU_SERVE_FAULT``) without touching the
    shared argv."""
    ports = ports or _free_ports(n, host)
    params = dict(serve_params)
    if device is not None:
        params["device"] = str(device)
    procs = []
    for i, port in enumerate(ports[:n]):
        argv = [sys.executable, "-m", "lightgbm_tpu_torch", "serve",
                f"host={host}", f"port={port}"]
        argv += [f"{k}={v}" for k, v in params.items()]
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [_package_root()] + [x for x in env.get("PYTHONPATH", "").split(os.pathsep) if x])
        if envs and i < len(envs) and envs[i]:
            env.update(envs[i])
        procs.append((subprocess.Popen(argv, env=env), port))
    return procs


def main(argv: List[str]) -> int:
    """``python -m lightgbm_tpu_torch fleet model=...|registry=...
    replicas=N port=... [backends=h:p,h:p] [policy=least_loaded|rr]
    [device=cpu] [serve knobs]``.

    With ``backends=`` the proxy fronts already-running replicas;
    otherwise it spawns ``replicas`` serve subprocesses (sharing
    ``registry=`` when given, so one publish hot-swaps the whole fleet)
    and supervises them.  SIGTERM drains: replicas get SIGTERM (their
    own graceful drain), then the proxy stops."""
    from ..cli import parse_argv

    tracer.refresh_from_env()
    params = parse_argv(argv)
    opts = dict(FLEET_DEFAULTS)
    for k in list(opts):
        if k in params:
            opts[k] = type(opts[k])(float(params[k]))
    host = str(params.get("host", "127.0.0.1"))
    policy = str(params.get("policy", "least_loaded"))

    procs: List[Tuple[subprocess.Popen, int]] = []
    if params.get("backends"):
        backends = [b.strip() for b in params["backends"].split(",")
                    if b.strip()]
    else:
        if not (params.get("model") or params.get("registry")):
            Log.warning("fleet: need model=..., registry=..., or "
                        "backends=host:port,...")
            return 1
        passthrough = {
            k: v for k, v in params.items()
            if k not in ("host", "port", "replicas", "base_port", "policy",
                         "backends", "health_poll_ms", "retry_deadline_ms",
                         "ready_timeout_ms", "backend_timeout_ms",
                         "hedge_delay_ms", "hedge_budget_pct", "breaker_k",
                         "breaker_m", "breaker_open_ms", "max_concurrent",
                         "max_queue")
        }
        n = int(opts["replicas"])
        ports = (list(range(int(opts["base_port"]),
                            int(opts["base_port"]) + n))
                 if int(opts["base_port"]) else None)
        procs = spawn_replicas(n, passthrough, ports=ports, host=host)
        backends = [f"{host}:{port}" for _, port in procs]
        for _, port in procs:
            if not _wait_ready(host, port,
                               float(opts["ready_timeout_ms"]) / 1e3):
                Log.warning("fleet: replica on port %d never became ready",
                            port)
                for p, _ in procs:
                    p.terminate()
                return 1
        Log.info("fleet: %d replica(s) ready on %s", n, backends)

    proxy = FleetProxy(
        (host, int(opts["port"])), backends, policy=policy,
        backend_timeout_s=float(opts["backend_timeout_ms"]) / 1e3,
        health_poll_s=float(opts["health_poll_ms"]) / 1e3,
        retry_deadline_s=float(opts["retry_deadline_ms"]) / 1e3,
        hedge_delay_ms=float(opts["hedge_delay_ms"]),
        hedge_budget_pct=float(opts["hedge_budget_pct"]),
        breaker_k=float(opts["breaker_k"]),
        breaker_m=int(opts["breaker_m"]),
        breaker_open_ms=float(opts["breaker_open_ms"]),
        max_concurrent=int(opts["max_concurrent"]),
        max_queue=int(opts["max_queue"]),
    )
    bound = proxy.server_address[1]
    Log.info("fleet: proxy listening on http://%s:%d over %d backend(s)",
             host, bound, len(backends))

    def _on_sigterm(signum, frame):
        Log.warning("fleet: SIGTERM — draining replicas and stopping proxy")
        for p, _ in procs:
            try:
                p.send_signal(signal.SIGTERM)
            except OSError:
                pass
        threading.Thread(target=proxy.shutdown, daemon=True).start()

    try:
        signal.signal(signal.SIGTERM, _on_sigterm)
    except ValueError:  # pragma: no cover - embedded in a non-main thread
        pass

    try:
        proxy.serve_forever()
    except KeyboardInterrupt:
        _on_sigterm(signal.SIGINT, None)
        proxy.shutdown()
    finally:
        proxy.server_close()
        for p, _ in procs:
            try:
                p.wait(timeout=15)
            except subprocess.TimeoutExpired:
                p.kill()
    Log.info("fleet: stopped")
    return 0
