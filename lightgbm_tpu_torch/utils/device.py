"""Device selection for the port's entry points."""

from __future__ import annotations

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
