"""Serving-plane fault injection (gray-failure drills) — PyTorch-port copy
of lightgbm_tpu/serve/faults.py.

The JAX package's ``parallel/net.py`` ``fault_point`` grammar for the
serving request path: ``LIGHTGBM_TPU_SERVE_FAULT`` arms a spec at replica start,
and ``POST /fault {"spec": ...}`` re-arms (or clears) it at runtime so a
chaos test can measure a healthy baseline on the very fleet it is about
to wound.  The replica's request handler calls :func:`action` once per
predict request and applies whatever fires:

    hang:N        every predict from request N on (1-based) never
                  answers — the canonical gray failure: the socket
                  accepts, ``/readyz`` stays 200, ``/predict`` wedges
    delay:ms      every predict stalls ``ms`` milliseconds before work
    delay:ms:frac deterministic fraction ``frac`` of predicts stall
                  (canary-tick arithmetic — no RNG, no bursts)
    error:N       every predict from request N on returns HTTP 500
    flap:s        alternate ``s`` seconds hanging / ``s`` seconds
                  healthy on the wall clock (hang phase first)

Specs are comma-separable; the first clause that fires wins.  With
nothing armed :func:`action` is a single attribute read — the off path
adds no measurable per-request overhead and responses are byte-identical
to a build without this module.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional, Tuple

from ..utils.log import Log

ENV_VAR = "LIGHTGBM_TPU_SERVE_FAULT"

_lock = threading.Lock()
_armed = False          # fast-path flag: False ⇒ action() returns None
_loaded = False         # env consulted at least once
_spec_str = ""
_spec: List[Tuple] = []
_requests = 0           # predicts seen while a spec was armed
_t_armed = 0.0          # monotonic arm time (flap phase origin)
_injected: Dict[str, int] = {}


def parse_serve_fault_spec(spec: str) -> List[Tuple]:
    """Parse ``hang:N|delay:ms[:frac]|error:N|flap:s`` (comma-separable)
    into clause tuples.  Raises ``ValueError`` on bad grammar — the env
    path warns-and-ignores, the ``/fault`` endpoint relays a 400."""
    out: List[Tuple] = []
    for part in str(spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        fields = part.split(":")
        kind = fields[0]
        try:
            if kind == "hang" and len(fields) == 2:
                out.append(("hang", int(fields[1])))
            elif kind == "error" and len(fields) == 2:
                out.append(("error", int(fields[1])))
            elif kind == "delay" and len(fields) in (2, 3):
                ms = float(fields[1])
                frac = float(fields[2]) if len(fields) == 3 else 1.0
                if ms < 0 or not (0.0 < frac <= 1.0):
                    raise ValueError(part)
                out.append(("delay", ms, frac))
            elif kind == "flap" and len(fields) == 2:
                s = float(fields[1])
                if s <= 0:
                    raise ValueError(part)
                out.append(("flap", s))
            else:
                raise ValueError(part)
        except ValueError:
            raise ValueError(
                f"bad serve fault clause {part!r} (want hang:N | "
                f"delay:ms[:frac] | error:N | flap:s)") from None
    return out


def set_spec(spec: Optional[str]) -> str:
    """Arm ``spec`` (empty/None clears).  Resets the per-spec request
    counter and flap clock.  Raises ``ValueError`` on bad grammar."""
    global _armed, _loaded, _spec_str, _spec, _requests, _t_armed
    clauses = parse_serve_fault_spec(spec or "")
    with _lock:
        _loaded = True
        _spec = clauses
        _spec_str = str(spec or "") if clauses else ""
        _requests = 0
        _injected.clear()
        _t_armed = time.monotonic()
        _armed = bool(clauses)
        if clauses:
            Log.warning("serve: FAULT INJECTION armed: %s", _spec_str)
    return _spec_str


def refresh_from_env() -> None:
    """Load ``LIGHTGBM_TPU_SERVE_FAULT`` (bad specs warn and stay off,
    like net.fault_point)."""
    global _loaded
    raw = os.environ.get(ENV_VAR, "")
    try:
        set_spec(raw)
    except ValueError as e:
        Log.warning("serve: ignoring bad %s: %s", ENV_VAR, e)
        with _lock:
            _loaded = True


def _ensure_loaded() -> None:
    if not _loaded:
        refresh_from_env()


def action() -> Optional[Tuple]:
    """The per-request hook: returns the firing clause — ``("hang",)``,
    ``("delay", ms)``, ``("error",)`` — or None.  First clause wins."""
    global _requests
    if _loaded and not _armed:
        return None
    _ensure_loaded()
    if not _armed:
        return None
    with _lock:
        _requests += 1
        n = _requests
        elapsed = time.monotonic() - _t_armed
        for clause in _spec:
            kind = clause[0]
            if kind == "hang" and n >= clause[1]:
                _injected["hang"] = _injected.get("hang", 0) + 1
                return ("hang",)
            if kind == "error" and n >= clause[1]:
                _injected["error"] = _injected.get("error", 0) + 1
                return ("error",)
            if kind == "delay":
                ms, frac = clause[1], clause[2]
                # canary-tick arithmetic: fires on exactly the requests
                # where floor(n*frac) advances — fraction frac, no RNG
                if int(n * frac) > int((n - 1) * frac):
                    _injected["delay"] = _injected.get("delay", 0) + 1
                    return ("delay", ms)
            if kind == "flap":
                if int(elapsed / clause[1]) % 2 == 0:
                    _injected["hang"] = _injected.get("hang", 0) + 1
                    return ("hang",)
    return None


def counters() -> Dict:
    """``/stats``/``GET /fault`` surface: the armed spec + what fired."""
    _ensure_loaded()
    with _lock:
        return {
            "spec": _spec_str,
            "requests_seen": int(_requests),
            "injected": dict(_injected),
        }
