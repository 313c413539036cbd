"""Latency-outlier circuit breakers for the serving fleet — the
``LatencyBreaker`` of lightgbm_tpu/serve/breaker.py, kept here as the
port's own copy (it is host-only: addresses, clocks and counts).

The proxy's health prober only sees *crash* failures: a hung replica
still answers ``/readyz`` so it keeps getting picked and holds every
routed request for the full backend socket timeout.  Each backend
carries a latency EWMA; an observation is **hot** when it failed outright
or when the backend's EWMA exceeds ``k``× the fleet-median EWMA, and
``m`` consecutive hot observations trip the breaker

    CLOSED ──m hot──▶ OPEN ──open_s cooldown──▶ HALF_OPEN ──trial ok──▶ CLOSED
                        ▲                            │trial bad
                        └────────────────────────────┘

HALF_OPEN admits exactly one in-flight trial request (claimed under the
proxy's pick lock via :meth:`begin_attempt`); a good trial closes the
breaker, a bad one re-opens it for another cooldown.  The breaker only
*advises* the proxy's pick — when every backend is open the proxy falls
back to any healthy backend, so breakers can never zero out availability.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


class _Entry:
    __slots__ = ("ewma", "hot", "state", "opened_at", "trial_inflight",
                 "opens", "observations")

    def __init__(self):
        self.ewma = 0.0
        self.hot = 0
        self.state = CLOSED
        self.opened_at = 0.0
        self.trial_inflight = False
        self.opens = 0
        self.observations = 0


class LatencyBreaker:
    """Per-backend CLOSED→OPEN→HALF_OPEN breaker keyed by address."""

    def __init__(self, k: float = 3.0, m: int = 5, open_s: float = 2.0,
                 alpha: float = 0.3):
        self.k = float(k)
        self.m = max(1, int(m))
        self.open_s = float(open_s)
        self.alpha = float(alpha)
        self._lock = threading.Lock()
        self._entries: Dict[str, _Entry] = {}

    def _entry(self, addr: str) -> _Entry:
        e = self._entries.get(addr)
        if e is None:
            e = self._entries[addr] = _Entry()
        return e

    def _median_ewma(self) -> float:
        vals = sorted(e.ewma for e in self._entries.values()
                      if e.observations > 0)
        if not vals:
            return 0.0
        mid = len(vals) // 2
        if len(vals) % 2:
            return vals[mid]
        return 0.5 * (vals[mid - 1] + vals[mid])

    # -- pick-side ------------------------------------------------------
    def state(self, addr: str) -> str:
        with self._lock:
            e = self._entries.get(addr)
            return e.state if e is not None else CLOSED

    def trial_eligible(self, addr: str) -> bool:
        """True when ``addr`` is due its single half-open probe: OPEN
        past the cooldown, or HALF_OPEN with no trial in flight."""
        with self._lock:
            e = self._entries.get(addr)
            if e is None:
                return False
            if e.state == OPEN:
                return (time.monotonic() - e.opened_at) >= self.open_s
            if e.state == HALF_OPEN:
                return not e.trial_inflight
            return False

    def begin_attempt(self, addr: str) -> None:
        """Called under the proxy's pick for the chosen backend: claims
        the half-open trial slot so concurrent picks can't double-probe."""
        with self._lock:
            e = self._entries.get(addr)
            if e is None:
                return
            if e.state == OPEN and \
                    (time.monotonic() - e.opened_at) >= self.open_s:
                e.state = HALF_OPEN
                e.trial_inflight = True
            elif e.state == HALF_OPEN and not e.trial_inflight:
                e.trial_inflight = True

    # -- observe-side ---------------------------------------------------
    def observe(self, addr: str, elapsed_s: float,
                ok: bool) -> Optional[str]:
        """Record one attempt's outcome.  Returns the transition it
        caused (``"open"``/``"close"``/``"reopen"``) or None."""
        now = time.monotonic()
        with self._lock:
            e = self._entry(addr)
            e.observations += 1
            e.ewma = (self.alpha * float(elapsed_s)
                      + (1.0 - self.alpha) * e.ewma) \
                if e.observations > 1 else float(elapsed_s)
            med = self._median_ewma()
            outlier = (not ok) or (med > 0.0 and e.ewma > self.k * med)
            if e.state == HALF_OPEN:
                # the trial verdict (a late pre-open result lands here
                # too — acceptable: it is still fresh evidence).  Judged
                # on the PROBE's own outcome, not the EWMA: the EWMA is
                # still poisoned by the open-causing latencies and would
                # take ~1/alpha probes to decay below k×median
                e.trial_inflight = False
                if (not ok) or (med > 0.0
                                and float(elapsed_s) > self.k * med):
                    e.state = OPEN
                    e.opened_at = now
                    e.opens += 1
                    e.hot = self.m
                    return "reopen"
                e.state = CLOSED
                e.hot = 0
                e.ewma = float(elapsed_s)  # re-enter with fresh stats
                return "close"
            if outlier:
                e.hot += 1
            else:
                e.hot = 0
            if e.state == CLOSED and e.hot >= self.m:
                e.state = OPEN
                e.opened_at = now
                e.opens += 1
                e.trial_inflight = False
                return "open"
        return None

    # -- ops surface ----------------------------------------------------
    def open_count(self) -> int:
        with self._lock:
            return sum(1 for e in self._entries.values()
                       if e.state != CLOSED)

    def snapshot(self) -> Dict[str, Dict]:
        with self._lock:
            return {
                addr: {
                    "state": e.state,
                    "ewma_ms": round(1e3 * e.ewma, 3),
                    "hot": int(e.hot),
                    "opens": int(e.opens),
                    "observations": int(e.observations),
                }
                for addr, e in self._entries.items()
            }
