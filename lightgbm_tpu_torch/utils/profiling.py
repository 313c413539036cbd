"""Phase timers and the bounded profiler capture — PyTorch-port copy of
lightgbm_tpu/utils/profiling.py (the reference's TIMETAG phase timers,
serial_tree_learner.cpp:10-37, gbdt.cpp:22-63).

``PhaseTimers`` (``timetag``) times named phases: the TIMETAG totals
dumped at exit (``LIGHTGBM_TPU_TIMETAG=1`` or ``timetag.enable()``) and,
with ``LIGHTGBM_TPU_TRACE`` set, a tracer span each (the iteration
records' ``phases``).  While a profiler capture runs, each phase is also
a ``torch.profiler.record_function`` range, so the capture carries the
same names; otherwise a phase with both sinks off costs one check.

``XprofCapture`` keeps the JAX package's ``LIGHTGBM_TPU_XPROF=<dir>``
knobs: it skips ``LIGHTGBM_TPU_XPROF_SKIP`` iterations (default 1), then
records ``torch.profiler`` activity (host, and the card's kernels on
CUDA) over the next ``LIGHTGBM_TPU_XPROF_ITERS`` (default 4) and writes a
Chrome trace (``trace_<pid>.json``) to the directory.  The JAX package's
``jax.named_scope`` ranges have no cost when nothing records; the port's
``record_function`` does, hence the gate.
"""

from __future__ import annotations

import atexit
import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator

from ..obs.trace import tracer
from .log import Log

_CAPTURING = [False]  # a profiler capture is recording


class PhaseTimers:
    """Accumulating named phase timers (the TIMETAG duration maps),
    bridged onto the structured tracer."""

    def __init__(self):
        self.enabled = bool(int(os.environ.get("LIGHTGBM_TPU_TIMETAG", "0") or 0))
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self._dump_registered = False
        if self.enabled:
            self.enable()

    def enable(self) -> None:
        self.enabled = True
        if not self._dump_registered:
            atexit.register(self.dump)
            self._dump_registered = True

    @contextlib.contextmanager
    def phase(self, name: str, **attrs) -> Iterator[None]:
        """Time a phase: a tracer span when tracing is on, the TIMETAG
        totals when enabled, a profiler range while a capture records."""
        if not (self.enabled or tracer.enabled or _CAPTURING[0]):
            yield
            return
        start = time.perf_counter()
        with tracer.span(name, **attrs), _profiler_range(name):
            yield
        if self.enabled:
            self.totals[name] += time.perf_counter() - start
            self.counts[name] += 1

    def dump(self) -> None:
        """TIMETAG destructor-style dump (serial_tree_learner.cpp:12-24)."""
        for name in sorted(self.totals):
            Log.info("%s costs: %f (n=%d)", name, self.totals[name], self.counts[name])


def _profiler_range(name: str):
    if not _CAPTURING[0]:
        return contextlib.nullcontext()
    import torch

    return torch.profiler.record_function(name)


timetag = PhaseTimers()


class XprofCapture:
    """A ``torch.profiler`` capture over a few steady iterations.  Drive
    ``on_iter_start()`` before and ``on_iter_end(n)`` after each step of
    ``n`` iterations, and ``close()`` on the way out (it stops a capture
    the run left in its window)."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self.skip = int(os.environ.get("LIGHTGBM_TPU_XPROF_SKIP", "1"))
        self.iters = max(1, int(os.environ.get("LIGHTGBM_TPU_XPROF_ITERS", "4")))
        self.path = None
        self._seen = 0
        self._prof = None
        self._done = False
        self._t0 = 0.0

    def boundaries(self):
        """The iteration counts where the window opens and closes: a
        chunked training loop ends its chunks there."""
        return (self.skip, self.skip + self.iters)

    def on_iter_start(self) -> None:
        if self._done or self._prof is not None or self._seen < self.skip:
            return
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.start()
        _CAPTURING[0] = True
        self._t0 = time.perf_counter()
        Log.info("xprof capture started -> %s (iters %d..%d)", self.log_dir, self._seen,
                 self._seen + self.iters - 1)

    def on_iter_end(self, n: int = 1) -> None:
        self._seen += n
        if self._prof is not None and self._seen >= self.skip + self.iters:
            self._stop()

    def close(self) -> None:
        if self._prof is not None:
            self._stop()

    def _stop(self) -> None:
        wall = time.perf_counter() - self._t0
        prof, self._prof = self._prof, None
        _CAPTURING[0] = False
        self._done = True
        prof.stop()
        os.makedirs(self.log_dir, exist_ok=True)
        self.path = os.path.join(self.log_dir, f"trace_{os.getpid()}.json")
        prof.export_chrome_trace(self.path)
        tracer.event("xprof.capture", dir=self.log_dir, iters=self.iters, skip=self.skip,
                     wall_s=round(wall, 6))
        Log.info("xprof capture done: %d iteration(s) in %.3f s -> %s", self.iters, wall,
                 self.path)


def maybe_xprof_capture() -> "XprofCapture | None":
    """``LIGHTGBM_TPU_XPROF=<dir>`` arms a capture; unset returns None."""
    log_dir = os.environ.get("LIGHTGBM_TPU_XPROF", "").strip()
    return XprofCapture(log_dir) if log_dir else None
