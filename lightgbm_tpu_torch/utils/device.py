"""Device selection for the port's entry points, and the card's context
and stream as the kernel wrappers read them."""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card.  A CUDA device with no card present
    raises: an entry point never continues quietly on the CPU.  The CPU
    runs only when asked for by name (the plain PyTorch versions of the
    kernels)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "lightgbm_tpu_torch: no CUDA device is available; pass device='cpu' "
            "to run the plain PyTorch versions of the kernels")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def device_of(t: torch.Tensor):
    """``torch.cuda.device(t.device)``, or nothing when ``t`` already lies
    on the current device (the usual case; the context costs host time on
    every call)."""
    if t.device.index is None or t.device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(t.device)


def raw_stream(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s card as a raw handle, read
    without building a ``torch.cuda.Stream`` object (host time on every
    launch).  ``torch._C._cuda_getCurrentRawStream`` is private: checked
    against torch 2.11 (CUDA 12.8); ``torch.cuda.current_stream(d).cuda_stream``
    is the public equivalent."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)
