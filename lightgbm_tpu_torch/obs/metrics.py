"""Prometheus text-format metrics registry — PyTorch-port copy of the
training half of lightgbm_tpu/obs/metrics.py.

- :class:`MetricsRegistry` holds **counters** (monotone) and **gauges**
  (sampled), thread-safe; a metric may be **fn-backed**, its value read
  at render time from a callback that reads plain host state.
- ``render()`` writes the Prometheus exposition text format (``# HELP`` /
  ``# TYPE`` lines), dumped at the end of a CLI training run to
  ``LIGHTGBM_TPU_METRICS=path``.
- The run tracer (obs/trace.py) mirrors every enabled-mode
  ``tracer.counter`` / ``tracer.gauge`` here under the JAX package's
  mapping ``name.with.dots`` -> ``lightgbm_tpu_name_with_dots[_total]``,
  so a run's checkpoint counters land in the same dump.  With tracing
  off the mirror is never called.

The serving metrics (histograms, labeled families, rolling quantiles)
wait for the port's serving.  The JAX package's XLA compile counters have
no torch form; the port registers its analogue instead:
``lightgbm_tpu_cuda_graph_captures_total`` and
``lightgbm_tpu_lazy_builds_total`` (obs/trace.py ``note_compile``).
"""

from __future__ import annotations

import re
import threading
from typing import Callable, Dict, List, Optional

PREFIX = "lightgbm_tpu_"

_NAME_OK = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_SANITIZE = re.compile(r"[^a-zA-Z0-9_:]")


def sanitize(name: str) -> str:
    """Tracer-name -> Prometheus-name fragment (dots become underscores,
    anything else illegal collapses to '_')."""
    return _SANITIZE.sub("_", name)


def _fmt(v: float) -> str:
    """Prometheus sample value: integers render without the trailing
    '.0' (counters are usually whole), floats via repr (full
    round-trip precision)."""
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


class Counter:
    """Monotone counter.  ``fn``-backed counters read their value at
    render time (the underlying source must itself be monotone)."""

    kind = "counter"

    def __init__(self, name: str, help: str = "",
                 fn: Optional[Callable[[], float]] = None):
        self.name = name
        self.help = help
        self.fn = fn
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, value: float = 1.0) -> None:
        if value < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        with self._lock:
            self._value += value

    def value(self) -> float:
        if self.fn is not None:
            try:
                return float(self.fn())
            except Exception:
                return 0.0
        return self._value

    def samples(self) -> List[str]:
        return [f"{self.name} {_fmt(self.value())}"]


class Gauge:
    """Sampled value; ``fn``-backed gauges evaluate at render time."""

    kind = "gauge"

    def __init__(self, name: str, help: str = "",
                 fn: Optional[Callable[[], float]] = None):
        self.name = name
        self.help = help
        self.fn = fn
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, value: float = 1.0) -> None:
        with self._lock:
            self._value += value

    def value(self) -> float:
        if self.fn is not None:
            try:
                return float(self.fn())
            except Exception:
                return 0.0
        return self._value

    def samples(self) -> List[str]:
        return [f"{self.name} {_fmt(self.value())}"]


class MetricsRegistry:
    """Process-global named-metric store.  ``counter``/``gauge`` are
    get-or-create (idempotent by name); re-registering an fn-backed
    metric replaces the callback (latest wins)."""

    def __init__(self):
        self._metrics: Dict[str, object] = {}
        self._lock = threading.Lock()

    def _get_or_create(self, cls, name: str, help: str, **kw):
        if not _NAME_OK.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help, **kw)
                self._metrics[name] = m
                return m
            if not isinstance(m, cls):
                raise TypeError(
                    f"metric {name} already registered as {m.kind}"
                )
            if kw.get("fn") is not None:
                m.fn = kw["fn"]
            if help and not m.help:
                m.help = help
            return m

    def counter(self, name: str, help: str = "",
                fn: Optional[Callable[[], float]] = None) -> Counter:
        return self._get_or_create(Counter, name, help, fn=fn)

    def gauge(self, name: str, help: str = "",
              fn: Optional[Callable[[], float]] = None) -> Gauge:
        return self._get_or_create(Gauge, name, help, fn=fn)

    # -- tracer mirror -------------------------------------------------
    def _mirror_target(self, n: str):
        """The mirror metric ``n``, unless that name is instrumented
        directly at its source (mirroring would count it twice).
        Mirror-created metrics are tagged so repeat mirrors keep flowing
        to them."""
        with self._lock:
            m = self._metrics.get(n)
        if m is not None and not getattr(m, "mirrored", False):
            return None
        return m

    def trace_counter(self, name: str, value: float) -> None:
        """Mirror of an enabled-mode ``tracer.counter``: dotted trace
        names land as ``lightgbm_tpu_<sanitized>_total``."""
        n = PREFIX + sanitize(name)
        if not n.endswith("_total"):
            n += "_total"
        m = self._mirror_target(n)
        if m is None:
            with self._lock:
                if n in self._metrics:
                    return
            m = self.counter(n, help=f"mirror of trace counter {name}")
            m.mirrored = True
        m.inc(value)

    def trace_gauge(self, name: str, value: float) -> None:
        n = PREFIX + sanitize(name)
        m = self._mirror_target(n)
        if m is None:
            with self._lock:
                if n in self._metrics:
                    return
            m = self.gauge(n, help=f"mirror of trace gauge {name}")
            m.mirrored = True
        m.set(value)

    # -- output --------------------------------------------------------
    def render(self) -> str:
        """Prometheus exposition text format (content type
        ``text/plain; version=0.0.4``); fn-backed metrics read plain host
        state only."""
        lines: List[str] = []
        with self._lock:
            metrics = list(self._metrics.values())
        for m in sorted(metrics, key=lambda m: m.name):
            if m.help:
                lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            lines.extend(m.samples())
        return "\n".join(lines) + ("\n" if lines else "")

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.render())


registry = MetricsRegistry()


def _compile_stat(kind: str) -> Callable[[], float]:
    def read() -> float:
        from .trace import compile_counts

        return float(compile_counts().get(kind, 0))

    return read


def _install_default_collectors(reg: MetricsRegistry) -> None:
    """The port's compile analogue, read at render time."""
    reg.counter("lightgbm_tpu_cuda_graph_captures_total",
                "CUDA graph captures (fused trees, mask-grower split searches)",
                fn=_compile_stat("graph_capture"))
    reg.counter("lightgbm_tpu_lazy_builds_total",
                "lazy builds of the CUDA kernel library and the native parser",
                fn=_compile_stat("build"))


_install_default_collectors(registry)


def parse_text_format(text: str) -> Dict[str, Dict]:
    """Minimal exposition-format parser (tests read a dump with it):
    returns {metric_family: {"type": ..., "samples": {sample_key: value}}}
    where sample_key includes any label suffix (e.g. 'name_bucket{le="1"}').
    Raises ValueError on malformed lines."""
    out: Dict[str, Dict] = {}
    current: Optional[str] = None
    for ln, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("# HELP "):
            continue
        if line.startswith("# TYPE "):
            parts = line.split(None, 3)
            if len(parts) != 4 or parts[3] not in ("counter", "gauge",
                                                   "histogram", "summary",
                                                   "untyped"):
                raise ValueError(f"line {ln}: malformed TYPE line {line!r}")
            current = parts[2]
            out[current] = {"type": parts[3], "samples": {}}
            continue
        if line.startswith("#"):
            raise ValueError(f"line {ln}: unknown comment {line!r}")
        try:
            key, val = line.rsplit(None, 1)
            fval = float(val)
        except ValueError:
            raise ValueError(f"line {ln}: malformed sample {line!r}")
        base = key.split("{")[0]
        fam = None
        for suffix in ("_bucket", "_sum", "_count", ""):
            cand = base[: len(base) - len(suffix)] if suffix else base
            if suffix and not base.endswith(suffix):
                continue
            if cand in out:
                fam = cand
                break
        if fam is None:
            raise ValueError(f"line {ln}: sample {key!r} precedes its TYPE line")
        if not _NAME_OK.match(base):
            raise ValueError(f"line {ln}: invalid sample name {base!r}")
        out[fam]["samples"][key] = fval
    return out
