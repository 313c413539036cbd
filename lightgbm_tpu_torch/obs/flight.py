"""Crash flight recorder — PyTorch-port copy of lightgbm_tpu/obs/flight.py:
the last N trace records, flushed on death.

The JSONL trace is line-buffered, so completed records survive a crash,
but the operator still has to find the end of the right file.  The
recorder keeps a bounded in-memory ring of the most recent records the
tracer emitted and writes the whole ring, after a meta record naming the
reason, to ``<trace>.crash.jsonl`` beside the trace: on the CLI's fatal
path and on ``SIGUSR1`` (ask a running training process what it is doing
without stopping it).

The ring is allocated only when the tracer is configured
(``tracer.configure`` calls :meth:`FlightRecorder.activate`); with tracing
off no ring exists and no record is copied.  Knobs, as in the JAX package:

  LIGHTGBM_TPU_FLIGHT_RING=n   ring capacity in records (default 512; 0 off)
  LIGHTGBM_TPU_FLIGHT=path     the dump path (default: from the trace path)

``dump()`` never raises and writes through its own file handle with an
fsync, because its caller is usually about to exit.
"""

from __future__ import annotations

import collections
import json
import os
import signal
import threading
import time
from typing import Any, Dict, Optional

DEFAULT_RING = 512


def _crash_path_for(trace_path: str) -> str:
    """<dir>/run.jsonl -> <dir>/run.crash.jsonl (a non-.jsonl trace
    path just gains the suffix)."""
    if trace_path.endswith(".jsonl"):
        return trace_path[: -len(".jsonl")] + ".crash.jsonl"
    return trace_path + ".crash.jsonl"


class FlightRecorder:
    """Bounded ring of recent trace records + the crash dump writer."""

    def __init__(self):
        self.ring: Optional[collections.deque] = None
        self.path: Optional[str] = None
        self._lock = threading.Lock()
        self.dumps = 0  # how many crash dumps this process wrote

    # -- lifecycle -----------------------------------------------------
    def activate(self, trace_path: str) -> None:
        override = os.environ.get("LIGHTGBM_TPU_FLIGHT", "").strip()
        cap_raw = os.environ.get("LIGHTGBM_TPU_FLIGHT_RING", "").strip()
        try:
            cap = int(cap_raw) if cap_raw else DEFAULT_RING
        except ValueError:
            cap = DEFAULT_RING
        with self._lock:
            self.path = override or _crash_path_for(trace_path)
            if cap <= 0:  # explicit opt-out
                self.ring = None
            else:
                self.ring = collections.deque(maxlen=cap)

    def deactivate(self) -> None:
        with self._lock:
            self.ring = None
            self.path = None

    # -- hot path (called by Tracer._emit on every enabled record) -----
    def record(self, rec: Dict[str, Any]) -> None:
        ring = self.ring
        if ring is not None:
            ring.append(rec)  # deque.append is atomic under the GIL

    # -- the crash dump ------------------------------------------------
    def dump(self, reason: str, error: Optional[BaseException] = None,
             **attrs) -> Optional[str]:
        """Flush the ring to the crash file.  Returns the path written,
        or None when the recorder is inactive.  Never raises: this runs
        on paths that are already dying."""
        with self._lock:
            ring = self.ring
            path = self.path
            if ring is None or path is None:
                return None
            records = list(ring)
        meta: Dict[str, Any] = {
            "ev": "meta", "kind": "flight", "reason": reason,
            "pid": os.getpid(), "ts": round(time.time(), 6),
            "ring_len": len(records),
        }
        if error is not None:
            meta["error"] = f"{type(error).__name__}: {error}"
        meta.update(attrs)
        try:
            with open(path, "w") as f:
                f.write(json.dumps(meta, default=str) + "\n")
                for rec in records:
                    f.write(json.dumps(rec, default=str) + "\n")
                f.flush()
                os.fsync(f.fileno())
        except Exception:  # disk full on a dying host
            return None
        self.dumps += 1
        return path


recorder = FlightRecorder()


def dump(reason: str, error: Optional[BaseException] = None,
         **attrs) -> Optional[str]:
    """Module-level convenience used by the CLI."""
    return recorder.dump(reason, error=error, **attrs)


def install_signal_handler(signum: int = signal.SIGUSR1) -> bool:
    """SIGUSR1 -> flush the ring.  Main thread only; returns False when
    the handler cannot be installed."""

    def _on_signal(_signum, _frame):
        p = dump("sigusr1")
        if p:
            from ..utils.log import Log

            Log.warning("flight recorder dumped to %s (SIGUSR1)", p)

    try:
        signal.signal(signum, _on_signal)
        return True
    except (ValueError, OSError):  # non-main thread / unsupported
        return False
