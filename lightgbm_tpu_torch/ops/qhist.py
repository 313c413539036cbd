"""Quantized-gradient training on one device — PyTorch counterpart of
lightgbm_tpu/ops/qhist.py:67-184 (``quantized_training=true``, the
``use_quantized_grad`` of LightGBM >= 4.0).

Once per iteration and class, each row's (grad, hess) is rounded
stochastically to a few signed integer levels under one global scale
per channel, and everything from there to the split scan is exact
integer arithmetic:

- scales ``s = max|x| / QMAX`` over the selected rows, in host float32
  (``scales_from_max``), an all-zero channel taking scale 1.0;
- ``q = clip(floor(x / s + u), -QMAX, QMAX)`` as int16, where ``u`` is a
  hash of the value's own float32 bits and an iteration key, so equal
  values round alike wherever their rows sit;
- int32 histograms (ops/histogram.py) and int sums, dequantized once at
  split-scan time (``dequantize_hist``, ``dequantize_sums``).

The hash is uint32 arithmetic; torch's uint32 lacks most operators, so
it runs on int64 tensors masked to 32 bits after every step, the
multiplications split into 16-bit halves so no product leaves int64.
That gives the JAX package's levels bit for bit, on the CPU and on the
card.  ``x / s + u`` stays a true division followed by an add (both
IEEE-rounded in PyTorch on either device), then ``floor``.

The wire of the host-driven parallel learners (parallel/hostlearner.py,
JAX qhist.py:186-284) is numpy on the host: ``pack_hist_q`` ships the
(F, B, 2) integer (g, h) planes as little-endian int16 (int32 when a sum
leaves int16's range), with the exact count plane as a third plane only
from a rank whose hessian mass for the node quantized to zero;
``unpack_hist_q`` tells the four formats apart by length;
``assemble_hist`` dequantizes the merged planes and derives the count
plane from the hessian plane and the node's count (``derive_count_plane``,
the reference's cnt_factor).
"""

from __future__ import annotations

import numpy as np
import torch

# Default width: QMAX = 2**(bits-1) - 1 = 15 levels a side.
QUANT_BITS = 5
MASK = 0xFFFFFFFF
_SALT_G, _SALT_H = 0x9E3779B9, 0x85EBCA6B


def qmax_for(bits: int) -> int:
    """Largest quantized magnitude at a signed bit width."""
    return (1 << (bits - 1)) - 1


def max_rows_for(bits: int = QUANT_BITS) -> int:
    """Largest row count the int32 accumulators hold: a node (or one bin)
    sums up to ``n * QMAX``, so training declines quantized mode above
    ``(2**31 - 1) // QMAX`` rows."""
    return (2 ** 31 - 1) // qmax_for(bits)


def local_absmax(grad: torch.Tensor, hess: torch.Tensor, select: torch.Tensor) -> torch.Tensor:
    """(2,) float32 ``(max|g|, max|h|)`` over the selected rows."""
    return torch.stack([torch.max(torch.abs(grad) * select),
                        torch.max(torch.abs(hess) * select)])


def scales_from_max(gmax: float, hmax: float, bits: int = QUANT_BITS) -> np.ndarray:
    """(2,) np.float32 scales from the abs-maxima, in host float32 so
    every caller derives the identical scale; a zero channel gets 1.0."""
    q = np.float32(qmax_for(bits))
    g, h = np.float32(gmax), np.float32(hmax)
    sg = g / q if g > 0 else np.float32(1.0)
    sh = h / q if h > 0 else np.float32(1.0)
    return np.asarray([sg, sh], np.float32)


def _mul32(u: torch.Tensor, c: int) -> torch.Tensor:
    """(u * c) mod 2**32 for uint32 values u (int64 tensor) and a uint32
    constant c, without leaving int64: c is taken in two 16-bit halves."""
    lo, hi = c & 0xFFFF, c >> 16
    return (u * lo + (((u * hi) & 0xFFFF) << 16)) & MASK


def _hash_uniform(x: torch.Tensor, key: int) -> torch.Tensor:
    """[0, 1) float32 uniform keyed by the float32 bits of ``x`` and
    ``key`` (a murmur3-style finalizer); the top 24 hash bits, so the
    result is exact in float32 and strictly below 1."""
    u = (x.to(torch.float32).view(torch.int32).to(torch.int64) & MASK) ^ (int(key) & MASK)
    u = _mul32(u ^ (u >> 16), 0x7FEB352D)
    u = _mul32(u ^ (u >> 15), 0x846CA68B)
    u = u ^ (u >> 16)
    return (u >> 8).to(torch.float32) * (2.0 ** -24)


def _scales_on(scales, device) -> torch.Tensor:
    """The (2,) scales as a float32 tensor on ``device`` (no upload when
    they already lie there)."""
    if isinstance(scales, torch.Tensor):
        return scales.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(scales, np.float32), device=device)


def quantize_rows(grad: torch.Tensor, hess: torch.Tensor, scales, seed: int,
                  bits: int = QUANT_BITS):
    """Stochastically round (grad, hess) to int16 levels in [-QMAX, QMAX]
    under the (2,) ``scales``: ``floor(x / s + u)``, unbiased over u."""
    q = float(qmax_for(bits))
    s = _scales_on(scales, grad.device)

    def one(x, sc, salt):
        u = _hash_uniform(x, (int(seed) & MASK) ^ salt)
        return torch.clamp(torch.floor(x / sc + u), -q, q).to(torch.int16)

    return one(grad, s[0], _SALT_G), one(hess, s[1], _SALT_H)


def dequantize_hist(hist_q: torch.Tensor, scales) -> torch.Tensor:
    """(..., 3) int32 histogram -> (..., 3) float32 (g, h, count)."""
    s = _scales_on(scales, hist_q.device)
    return torch.stack([hist_q[..., 0].to(torch.float32) * s[0],
                        hist_q[..., 1].to(torch.float32) * s[1],
                        hist_q[..., 2].to(torch.float32)], dim=-1)


def dequantize_sums(sums_q, scales) -> np.ndarray:
    """(3,) integer node totals -> (3,) np.float32 (g, h, count)."""
    sq = np.asarray(sums_q, np.int64).astype(np.int32).astype(np.float32)
    s = np.asarray(scales, np.float32)
    return np.asarray([sq[0] * s[0], sq[1] * s[1], sq[2]], np.float32)


def derive_count_plane(hist2: np.ndarray, node_cnt: float, exact: np.ndarray = None) -> np.ndarray:
    """The count plane of a merged 2-plane quantized histogram:
    ``rint(sum_qh * cnt_factor)`` with ``cnt_factor = node_cnt /
    node_sum_qh``, the node's quantized hessian total being feature 0's
    bins (every row lands in one bin of it).  ``exact`` is the summed (F,
    B) count plane of the ranks that shipped three planes (their hessian
    mass was zero, so derivation cannot see their rows): those rows are
    counted exactly and the rest derived."""
    hist2 = np.asarray(hist2)
    qh_tot = int(hist2[0, :, 1].sum())
    if exact is not None:
        exact = np.asarray(exact, np.float32)
        rest = max(float(node_cnt) - float(exact[0, :].sum()), 0.0)
        cf = np.float32(rest) / np.float32(max(qh_tot, 1))
        return exact + np.rint(hist2[..., 1].astype(np.float32) * cf).astype(np.float32)
    if qh_tot == 0 and float(node_cnt) > 0:
        # no sender shipped counts yet the node holds rows: every bin
        # derives to zero and min_data_in_leaf prunes the node's splits
        from ..utils.log import Log

        Log.warning("quantized histogram node with %d rows has zero hessian mass and no "
                    "exact count plane; its splits will be pruned", int(node_cnt))
    cf = np.float32(node_cnt) / np.float32(max(qh_tot, 1))
    return np.rint(hist2[..., 1].astype(np.float32) * cf).astype(np.float32)


def assemble_hist(hist2: np.ndarray, scales, node_cnt: float,
                  counts: np.ndarray = None) -> np.ndarray:
    """Merged (F, B, 2) integer planes -> the (F, B, 3) float32 histogram
    of the split scan; ``counts`` is the merged exact count plane of any
    3-plane payloads (``derive_count_plane``)."""
    hist2 = np.asarray(hist2)
    s = np.asarray(scales, np.float32)
    out = np.empty(hist2.shape[:2] + (3,), np.float32)
    out[..., 0] = hist2[..., 0].astype(np.float32) * s[0]
    out[..., 1] = hist2[..., 1].astype(np.float32) * s[1]
    out[..., 2] = derive_count_plane(hist2, node_cnt, exact=counts)
    return out


def pack_hist_q(hist2, counts=None) -> bytes:
    """The ``hist_q`` wire of the (F, B, 2) integer (sum_qg, sum_qh)
    planes: little-endian int16, F*B*4 bytes (the float32 wire's third),
    or int32 (F*B*8) when a sum leaves int16's range; ``counts``, an exact
    (F, B) count plane, adds a third plane (F*B*6 / F*B*12 bytes)."""
    arr = np.ascontiguousarray(np.asarray(hist2, np.int32))
    if counts is not None:
        arr = np.ascontiguousarray(np.concatenate(
            [arr, np.asarray(counts, np.int32)[..., None]], axis=-1))
    if abs(int(arr.min(initial=0))) <= 32767 and int(arr.max(initial=0)) <= 32767:
        return arr.astype("<i2").tobytes()
    return arr.astype("<i4").tobytes()


def unpack_hist_q(blob: bytes, num_features: int, num_bins: int) -> np.ndarray:
    """Inverse of ``pack_hist_q``: (F, B, 2) or (F, B, 3) int32, the
    format told by the blob's length (the four lengths differ)."""
    m = num_features * num_bins
    by_len = {m * 4: ("<i2", 2), m * 8: ("<i4", 2), m * 6: ("<i2", 3), m * 12: ("<i4", 3)}
    fmt = by_len.get(len(blob))
    if fmt is None:
        raise ValueError(
            f"hist_q payload of {len(blob)} B matches neither the int16 ({m * 4}/{m * 6} B) "
            f"nor the int32 ({m * 8}/{m * 12} B) 2/3-plane formats for F={num_features}, "
            f"B={num_bins}")
    arr = np.frombuffer(blob, fmt[0]).astype(np.int32)
    return arr.reshape(num_features, num_bins, fmt[1])

