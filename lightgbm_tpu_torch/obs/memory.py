"""Host and device memory gauges — PyTorch-port copy of
lightgbm_tpu/obs/memory.py.

Host RSS comes from /proc/self/status (Linux) with a
resource.getrusage fallback; device memory from PyTorch's caching
allocator (``torch.cuda.memory_allocated`` / ``max_memory_allocated``,
which read the allocator's counters and never wait for the card) where
the JAX package reads ``Device.memory_stats()``.  Only queried once torch
has initialized CUDA in this process, so a gauge never starts a CUDA
context.  Peak watermarks are kept process-wide, so a trace's last
iteration record carries the high-water mark.
"""

from __future__ import annotations

import sys
from typing import Any, Dict

_peaks = {"host_rss_mb": 0.0, "dev_mb": 0.0}


def host_rss_mb() -> float:
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return float(line.split()[1]) / 1024.0
    except OSError:
        pass
    try:  # non-Linux fallback
        import resource

        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0
    except Exception:
        return 0.0


def device_memory_mb() -> Dict[str, float]:
    """{'dev_mb': allocated, 'dev_peak_mb': the allocator's peak} of the
    current card, or {} when CUDA is not initialized in this process."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_initialized():
        return {}
    try:
        return {"dev_mb": round(torch.cuda.memory_allocated() / 1e6, 1),
                "dev_peak_mb": round(torch.cuda.max_memory_allocated() / 1e6, 1)}
    except Exception:
        return {}


def memory_gauges() -> Dict[str, Any]:
    """Host and device snapshot carried by every iteration record."""
    out: Dict[str, Any] = {"host_rss_mb": round(host_rss_mb(), 1)}
    out.update(device_memory_mb())
    for k in ("host_rss_mb", "dev_mb"):
        if k in out and out[k] > _peaks[k]:
            _peaks[k] = out[k]
    return out


def peaks() -> Dict[str, float]:
    return dict(_peaks)
