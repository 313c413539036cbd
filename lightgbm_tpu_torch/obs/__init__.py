"""Observability — PyTorch-port copy of lightgbm_tpu/obs/: structured run
tracing, memory gauges, the Prometheus dump, the split audit trail, the
crash flight recorder and trace reports.

  from lightgbm_tpu_torch.obs import tracer, fence
  tracer.refresh_from_env()           # LIGHTGBM_TPU_TRACE=trace.jsonl
  with tracer.span("tree"): ...
  with tracer.iteration(i) as rec: rec["leaves"] = 31

Submodules: ``trace`` (spans, counters, gauges, iteration records, the
JSONL sink with LIGHTGBM_TPU_TRACE_MAX_MB rotation, the compile
analogue), ``memory`` (host and device gauges), ``metrics`` (Prometheus
text format, ``LIGHTGBM_TPU_METRICS``), ``audit`` (LIGHTGBM_TPU_AUDIT
split-decision trail), ``flight`` (crash flight recorder,
``<trace>.crash.jsonl``) and ``report`` (``python -m lightgbm_tpu_torch
report``).  The JAX package's ``compilewatch`` (XLA compile and retrace
accounting) and ``costmodel`` (HLO cost inventory) have no torch form
yet.
"""

from .trace import Tracer, fence, tracer  # noqa: F401

__all__ = ["Tracer", "tracer", "fence"]
