"""Structured run tracer — PyTorch-port copy of lightgbm_tpu/obs/trace.py.

Nested host-side spans, counters and gauges written as one JSON record a
line (JSONL), so a run that dies still leaves every record flushed before
its death, plus per-iteration records that ``python -m lightgbm_tpu_torch
report`` (and the JAX package's ``report``) aggregate.  The record names,
the schema and the environment variables are the JAX package's.

Enable with ``LIGHTGBM_TPU_TRACE=/path/to/trace.jsonl`` (re-read at every
``engine.train`` and ``GBDT.init``) or ``tracer.configure(path)``.  With
tracing off ``span()`` returns a shared no-op context manager, every other
entry point is one attribute check, no record is built and no flight ring
exists.

Record schema (every record carries ``ev`` and ``ts`` = time.time()):

  {"ev":"meta", "version":1, "pid":..., "argv":[...]}
  {"ev":"span", "name":..., "dur_s":..., "depth":..., "parent":..., ...attrs}
  {"ev":"counter"|"gauge", "name":..., "value":..., ...attrs}
  {"ev":"event", "name":..., ...attrs}
  {"ev":"iter", "iter":i, "wall_s":..., "phases":{name: secs},
   "compiles":n, "host_rss_mb":..., "dev_mb":..., ...fields}

Spans opened while an iteration record is open also add into that
iteration's ``phases``.  The port has no XLA compiles: an iteration's
``compiles`` counts its analogue, the CUDA graph captures (``TreeGraphs``
and the mask grower's split searches) and the lazy builds of the kernel
library and the native parser (``note_compile``).  The fused chunk emits
its ``iter`` records after its one read of the card (``emit_iter``), from
the CUDA-event times that read already carries, so tracing adds no host
sync inside a chunk.
"""

from __future__ import annotations

import atexit
import contextlib
import json
import os
import sys
import threading
import time
from typing import Any, Dict, Optional

# the port's analogue of XLA compiles, by kind: "build", "graph_capture"
# (training graphs) and "graph_capture.<walk>" (a serving walk's bucket,
# e.g. "graph_capture.serve.qpredict"); the server captures from its
# warmup, swap and request threads at once
_COMPILES: Dict[str, int] = {}
_COMPILES_LOCK = threading.Lock()


def note_compile(kind: str) -> None:
    """Count one CUDA graph capture or one lazy build (always on: one
    locked dict update, on paths that cost milliseconds or more)."""
    with _COMPILES_LOCK:
        _COMPILES[kind] = _COMPILES.get(kind, 0) + 1


def total_compiles() -> int:
    with _COMPILES_LOCK:
        return sum(_COMPILES.values())


def compile_counts() -> Dict[str, int]:
    with _COMPILES_LOCK:
        return dict(_COMPILES)


def graph_captures() -> int:
    """CUDA graph captures of every kind, training and serving."""
    with _COMPILES_LOCK:
        return sum(v for k, v in _COMPILES.items() if k.startswith("graph_capture"))


class _NullSpan:
    """Shared no-op context manager returned when tracing is disabled."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


def _max_bytes_from_env() -> int:
    """LIGHTGBM_TPU_TRACE_MAX_MB as a byte cap (0, unset or garbage: no
    rotation)."""
    raw = os.environ.get("LIGHTGBM_TPU_TRACE_MAX_MB", "").strip()
    if not raw:
        return 0
    try:
        mb = float(raw)
    except ValueError:
        return 0
    return int(mb * 1024 * 1024) if mb > 0 else 0


def _flight_recorder():
    """The crash flight recorder (obs/flight.py), imported at the first
    enabled-mode emit."""
    global _FLIGHT
    if _FLIGHT is None:
        from . import flight

        _FLIGHT = flight.recorder
    return _FLIGHT


_FLIGHT = None


class _Span:
    __slots__ = ("_tr", "name", "attrs", "_t0")

    def __init__(self, tr: "Tracer", name: str, attrs: Dict[str, Any]):
        self._tr = tr
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        self._tr._stack.append(self.name)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter() - self._t0
        tr = self._tr
        stack = tr._stack
        if stack and stack[-1] is self.name:
            stack.pop()
        rec = {
            "ev": "span",
            "name": self.name,
            "dur_s": round(dur, 9),
            "depth": len(stack),
            "parent": stack[-1] if stack else None,
        }
        if self.attrs:
            rec.update(self.attrs)
        tr._emit(rec)
        if tr._iter_phases is not None:
            tr._iter_phases[self.name] = tr._iter_phases.get(self.name, 0.0) + dur
        return False


class Tracer:
    """Process-global structured tracer with a JSONL sink."""

    def __init__(self):
        self.enabled = False
        self.path: Optional[str] = None
        self._f = None
        # rotation: bytes written to the current file and the
        # LIGHTGBM_TPU_TRACE_MAX_MB cap (0 = unbounded); at the cap the
        # sink moves to <path>.1 and report reads the pair in order
        self._bytes = 0
        self._max_bytes = 0
        self._lock = threading.Lock()
        # each thread's open spans: a span's parent is its own thread's
        # (the heartbeat thread's spans run inside the main thread's)
        self._local = threading.local()
        self._iter_phases: Optional[Dict[str, float]] = None
        self._atexit_registered = False
        # rank, world and run_id stamped onto every record of a run over
        # several processes, so ``report merge`` can correlate the ranks'
        # files (empty in one process: records keep their schema)
        self._ident: Dict[str, Any] = {}
        # records processed (emitted and mirrored): stays 0 with tracing
        # off, which the tests pin
        self.work_ops = 0

    # -- lifecycle -----------------------------------------------------
    def refresh_from_env(self) -> None:
        """(Re-)read LIGHTGBM_TPU_TRACE; called at the training entry
        points so tests and the CLI toggle tracing by the environment."""
        self._ident_from_env()
        self._max_bytes = _max_bytes_from_env()
        path = os.environ.get("LIGHTGBM_TPU_TRACE", "")
        if path and path != self.path:
            self.configure(path)

    def _ident_from_env(self) -> None:
        """The identity the launcher's env gives before the bootstrap
        (parallel/distributed.py refines it with ``set_identity``)."""
        rank = os.environ.get("LIGHTGBM_TPU_PROCESS_ID", "").strip()
        world = os.environ.get("LIGHTGBM_TPU_NUM_PROCESSES", "").strip()
        if rank and world:
            self.set_identity(rank=int(rank), world_size=int(world))

    def set_identity(self, rank: Optional[int] = None, world_size: Optional[int] = None,
                     run_id: Optional[str] = None) -> None:
        """Stamp rank, world and run_id onto every later record.
        ``run_id`` defaults to LIGHTGBM_TPU_RUN_ID, else the coordinator's
        address: the same on every rank of one run, which ``report merge``
        checks before it correlates the files."""
        if rank is not None:
            self._ident["rank"] = int(rank)
        if world_size is not None:
            self._ident["world"] = int(world_size)
        if run_id is None:
            run_id = (os.environ.get("LIGHTGBM_TPU_RUN_ID", "").strip()
                      or os.environ.get("LIGHTGBM_TPU_COORDINATOR", "").strip())
        if run_id:
            self._ident["run_id"] = str(run_id)

    def configure(self, path: str) -> None:
        """Open (truncate) the JSONL sink at ``path`` and enable tracing."""
        self.close()
        self.path = path
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._f = open(path, "w", buffering=1)  # line buffered
        self._bytes = 0
        self._max_bytes = _max_bytes_from_env()
        self.enabled = True
        from . import flight

        # the flight ring exists only while tracing is on
        flight.recorder.activate(path)
        self._emit({"ev": "meta", "version": 1, "pid": os.getpid(), "argv": sys.argv})
        if not self._atexit_registered:
            atexit.register(self.close)
            self._atexit_registered = True

    def close(self) -> None:
        if self._f is not None:
            try:
                self._f.flush()
                self._f.close()
            except Exception:  # interpreter teardown
                pass
            try:
                from . import flight

                flight.recorder.deactivate()
            except Exception:  # interpreter teardown
                pass
        self._f = None
        self.path = None
        self.enabled = False

    # -- emission ------------------------------------------------------
    def _emit(self, rec: Dict[str, Any]) -> None:
        for k, v in self._ident.items():
            rec.setdefault(k, v)
        rec.setdefault("ts", round(time.time(), 6))
        line = json.dumps(rec, default=str)
        self.work_ops += 1
        _flight_recorder().record(rec)
        with self._lock:
            if self._f is not None:
                self._f.write(line + "\n")
                self._bytes += len(line) + 1
                if self._max_bytes and self._bytes >= self._max_bytes:
                    self._rotate_locked()

    def _rotate_locked(self) -> None:
        """The current file becomes ``<path>.1`` and a fresh sink opens at
        ``path`` with a meta record of its own (caller holds the lock)."""
        try:
            self._f.flush()
            self._f.close()
            os.replace(self.path, self.path + ".1")
        except OSError:
            pass
        self._f = open(self.path, "w", buffering=1)
        self._bytes = 0
        meta = {"ev": "meta", "version": 1, "pid": os.getpid(), "rotated": True,
                "ts": round(time.time(), 6)}
        meta.update(self._ident)
        line = json.dumps(meta)
        self._f.write(line + "\n")
        self._bytes += len(line) + 1

    @property
    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def span(self, name: str, **attrs):
        """Timed nested span (the no-op singleton when disabled)."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, attrs)

    def counter(self, name: str, value: float = 1.0, **attrs) -> None:
        if not self.enabled:
            return
        rec = {"ev": "counter", "name": name, "value": value}
        rec.update(attrs)
        self._emit(rec)
        from . import metrics

        metrics.registry.trace_counter(name, value)

    def gauge(self, name: str, value: float, **attrs) -> None:
        if not self.enabled:
            return
        rec = {"ev": "gauge", "name": name, "value": value}
        rec.update(attrs)
        self._emit(rec)
        from . import metrics

        metrics.registry.trace_gauge(name, value)

    def event(self, name: str, **attrs) -> None:
        if not self.enabled:
            return
        rec = {"ev": "event", "name": name}
        rec.update(attrs)
        self._emit(rec)

    # -- per-iteration records -----------------------------------------
    @contextlib.contextmanager
    def iteration(self, it: int, **fields):
        """Open an iteration record; spans entered inside add into its
        ``phases``.  Yields a dict the caller may add fields to (None when
        disabled).  On close the record gains its wall time, the compiles
        it saw and the memory gauges."""
        if not self.enabled:
            yield None
            return
        from . import memory

        prev_phases = self._iter_phases
        self._iter_phases = {}
        c0 = total_compiles()
        t0 = time.perf_counter()
        rec: Dict[str, Any] = dict(fields)
        try:
            yield rec
        finally:
            wall = time.perf_counter() - t0
            out = {
                "ev": "iter",
                "iter": int(it),
                "wall_s": round(wall, 6),
                "phases": {k: round(v, 6) for k, v in self._iter_phases.items()},
                "compiles": total_compiles() - c0,
            }
            out.update(memory.memory_gauges())
            out.update(rec)
            self._emit(out)
            self._iter_phases = prev_phases

    def emit_iter(self, it: int, wall_s: float, phases: Dict[str, float], **fields) -> None:
        """Write an iteration record directly (the fused chunk's, after
        its one read of the card)."""
        if not self.enabled:
            return
        from . import memory

        rec = {
            "ev": "iter",
            "iter": int(it),
            "wall_s": round(wall_s, 6),
            "phases": {k: round(v, 6) for k, v in phases.items()},
        }
        rec.update(memory.memory_gauges())
        rec.update(fields)
        self._emit(rec)

tracer = Tracer()


def fence(x):
    """Wait for the card at a phase boundary, so a span times the work in
    it: a no-op unless tracing is on and ``x`` (a tensor, or a tuple or
    list of them) lies on a CUDA device.  The fused chunk never calls it.
    Returns ``x``."""
    if tracer.enabled and x is not None:
        for t in (x if isinstance(x, (tuple, list)) else (x,)):
            dev = getattr(t, "device", None)
            if dev is not None and dev.type == "cuda":
                import torch

                torch.cuda.synchronize(dev)
                break
    return x
