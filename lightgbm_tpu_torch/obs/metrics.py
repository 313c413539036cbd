"""Prometheus text-format metrics registry — PyTorch-port copy of
lightgbm_tpu/obs/metrics.py.

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

The serving layer (serve/) adds **fixed-bucket histograms** (cumulative
``le`` buckets, ``_sum``/``_count``), **labeled families** (one child per
model version or route, pruned after every swap) and
:class:`RollingQuantile` (a window's exact quantiles, a control input,
not a metric); for the same observations their text is the JAX
registry's line for line.  The JAX package's XLA compile counters have
no torch form; the port registers its analogue instead:
``lightgbm_tpu_cuda_graph_captures_total`` and
``lightgbm_tpu_lazy_builds_total`` (obs/trace.py ``note_compile``).
"""

from __future__ import annotations

import re
import threading
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence

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


# default latency ladder (seconds): sub-ms serving hits through
# multi-second stragglers
LATENCY_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                   0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)
# power-of-two row ladder matching the serving bucket ladder
BATCH_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0,
                 512.0, 1024.0, 2048.0, 4096.0)


class Histogram:
    """Fixed-bucket histogram: per-bucket counts are kept exclusive and
    rendered cumulative with a final ``le="+Inf"`` bucket, plus
    ``_sum`` and ``_count`` series (the Prometheus contract
    ``bucket[+Inf] == count``)."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Sequence[float] = LATENCY_BUCKETS):
        self.name = name
        self.help = help
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise ValueError(f"histogram {name} needs at least one bucket")
        self._counts = [0] * (len(self.buckets) + 1)  # last = overflow
        self._sum = 0.0
        self._count = 0
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        v = float(value)
        i = len(self.buckets)
        for j, b in enumerate(self.buckets):
            if v <= b:
                i = j
                break
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    def value(self) -> float:  # symmetry with counter/gauge (snapshot())
        return float(self._count)

    def quantile(self, q: float) -> float:
        """Smallest bucket upper bound covering fraction ``q`` of the
        observations (0.0 when empty).  Bucket-resolution only — what
        an SLO verdict needs, not a billing meter."""
        with self._lock:
            counts = list(self._counts)
            total = self._count
        if total <= 0:
            return 0.0
        target = float(q) * total
        acc = 0
        for b, c in zip(self.buckets, counts):
            acc += c
            if acc >= target:
                return float(b)
        return float(self.buckets[-1])

    def samples(self) -> List[str]:
        with self._lock:
            counts = list(self._counts)
            total = self._count
            s = self._sum
        out = []
        acc = 0
        for b, c in zip(self.buckets, counts):
            acc += c
            out.append(f'{self.name}_bucket{{le="{b:g}"}} {acc}')
        out.append(f'{self.name}_bucket{{le="+Inf"}} {total}')
        out.append(f"{self.name}_sum {_fmt(s)}")
        out.append(f"{self.name}_count {total}")
        return out


class RollingQuantile:
    """Exact quantiles over a sliding window of the last ``window``
    observations.  Unlike :class:`Histogram` (cumulative, bucket
    resolution) this *adapts*: the fleet proxy derives its hedge delay
    from the p95 of recent attempt latencies, so the trigger tracks the
    fleet's current speed instead of its lifetime average.  Not a
    Prometheus metric — a control-loop input."""

    def __init__(self, window: int = 512):
        self._window = max(1, int(window))
        self._buf: deque = deque(maxlen=self._window)
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        with self._lock:
            self._buf.append(float(value))

    def count(self) -> int:
        with self._lock:
            return len(self._buf)

    def quantile(self, q: float) -> float:
        """Exact order statistic over the window (0.0 when empty)."""
        with self._lock:
            vals = sorted(self._buf)
        if not vals:
            return 0.0
        i = min(len(vals) - 1, max(0, int(float(q) * len(vals))))
        return vals[i]


class LabeledFamily:
    """One metric family split by a single label — per-model-version
    serving metrics (``requests{model_version="3"}``) without an
    unbounded cardinality risk: children are created per label value and
    ``prune()``'d back to the versions actually loaded after every swap.
    Child samples are re-emitted with the label pair injected, merging
    with any labels the child already carries (histogram ``le``)."""

    def __init__(self, name: str, help: str = "", child_cls=Counter,
                 label: str = "model_version", **kw):
        self.name = name
        self.help = help
        self.cls = child_cls
        self.kind = child_cls.kind
        self.label = label
        self._kw = kw
        self._children: Dict[str, object] = {}
        self._lock = threading.Lock()

    def labels(self, value) -> object:
        key = str(value)
        with self._lock:
            c = self._children.get(key)
            if c is None:
                c = self.cls(self.name, self.help, **self._kw)
                self._children[key] = c
            return c

    def children(self) -> Dict[str, object]:
        with self._lock:
            return dict(self._children)

    def prune(self, keep) -> None:
        """Drop children whose label value is not in ``keep`` — bounds
        scrape cardinality to the versions currently loaded."""
        keep = {str(k) for k in keep}
        with self._lock:
            for k in list(self._children):
                if k not in keep:
                    del self._children[k]

    def value(self) -> float:
        return sum(c.value() for c in self.children().values())

    def samples(self) -> List[str]:
        out: List[str] = []
        for key, c in sorted(self.children().items()):
            pair = f'{self.label}="{key}"'
            for s in c.samples():
                metric, val = s.rsplit(None, 1)
                if "{" in metric:
                    head, rest = metric.split("{", 1)
                    out.append(f"{head}{{{pair},{rest} {val}")
                else:
                    out.append(f"{metric}{{{pair}}} {val}")
        return out


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

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = LATENCY_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help, buckets=buckets)

    def labeled_counter(self, name: str, help: str = "",
                        label: str = "model_version") -> LabeledFamily:
        return self._get_or_create(LabeledFamily, name, help,
                                   child_cls=Counter, label=label)

    def labeled_histogram(self, name: str, help: str = "",
                          label: str = "model_version",
                          buckets: Sequence[float] = LATENCY_BUCKETS,
                          ) -> LabeledFamily:
        return self._get_or_create(LabeledFamily, name, help,
                                   child_cls=Histogram, label=label,
                                   buckets=buckets)

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

    def snapshot(self) -> Dict[str, float]:
        """{name: scalar value} view (histograms report their count)."""
        with self._lock:
            metrics = list(self._metrics.values())
        return {m.name: m.value() for m in metrics}

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.render())


registry = MetricsRegistry()


def _graph_captures() -> float:
    from .trace import graph_captures

    return float(graph_captures())


def _lazy_builds() -> float:
    from .trace import compile_counts

    return float(compile_counts().get("build", 0))


def _install_default_collectors(reg: MetricsRegistry) -> None:
    """The port's compile analogue, read at render time."""
    reg.counter("lightgbm_tpu_cuda_graph_captures_total",
                "CUDA graph captures (fused trees, mask-grower split searches, "
                "serving buckets)",
                fn=_graph_captures)
    reg.counter("lightgbm_tpu_lazy_builds_total",
                "lazy builds of the CUDA kernel library and the native parser",
                fn=_lazy_builds)


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
