"""The bits of ``jax.random``'s default generator, in torch.

The JAX package's fused trainer draws its bagging mask, its
feature_fraction sample and GOSS's rest sample from threefry keys
(lightgbm_tpu/boosting/ptrainer.py:179-181, :349-361, :389-391), and
the mask-grower GOSS chains ``jax.random.split`` of one key
(lightgbm_tpu/boosting/goss.py:43-65).  The port reproduces those bits
exactly, so a sampled run grows the same trees as the JAX package's.
This module copies what those draws call: ``PRNGKey``, ``fold_in``,
``split``, ``uniform`` and ``bernoulli`` of jax 0.9.0's threefry2x32
with ``jax_threefry_partitionable=True`` and 32-bit integers
(``jax_enable_x64`` off):

- a key is two uint32 words; ``PRNGKey(seed)`` is ``(0, seed)``;
- ``fold_in(key, d)`` hashes the count pair ``(0, d)`` under ``key``;
- ``split(key)`` is the two keys hashed from the count pairs ``(0, 0)``
  and ``(0, 1)`` (the partitionable "fold-like" split);
- the (n,) random bits are ``y0 ^ y1`` of the hash of ``(0, i)`` for
  each index i (the partitionable counter layout);
- ``uniform`` puts the top 23 bits in the mantissa of a float32 in
  [1, 2) and subtracts 1; ``bernoulli`` is ``uniform < float32(p)``.

Keys are tiny host values (Python ints).  The per-row hash runs as torch
integer ops on the requested device: uint32 arithmetic carried in int64
tensors and masked to 32 bits after every add and shift, which behaves
the same on the CPU and on CUDA.  It is plain tensor code, as in the JAX
package, where XLA computes it outside any Pallas kernel.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

Key = Tuple[int, int]


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(key: Key, x0, x1):
    """Threefry-2x32 (20 rounds) of the count pair (x0, x1) under
    ``key``; x0 and x1 are Python ints or int64 tensors holding uint32
    values.  Returns the hashed pair, of the same kind."""
    ks = (key[0] & MASK, key[1] & MASK, (key[0] ^ key[1] ^ _PARITY) & MASK)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def PRNGKey(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)`` for an int32 seed: the words (0, seed)."""
    seed = int(seed)
    if not -(1 << 31) <= seed < (1 << 31):
        raise OverflowError(f"seed {seed} does not fit the 32-bit integers of the JAX default")
    return (0, seed & MASK)


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in(key, data)``."""
    return threefry2x32(key, 0, int(data) & MASK)


def split(key: Key) -> Tuple[Key, Key]:
    """``jax.random.split(key)``: the two new keys, in order."""
    return threefry2x32(key, 0, 0), threefry2x32(key, 0, 1)


def random_bits(key: Key, n: int, device="cpu") -> torch.Tensor:
    """(n,) int64 tensor of the 32-bit words ``jax.random.bits(key, (n,))``."""
    if n >= 1 << 32:
        raise ValueError("more than 2**32 draws")
    idx = torch.arange(int(n), dtype=torch.int64, device=device)
    y0, y1 = threefry2x32(key, torch.zeros_like(idx), idx)
    return y0 ^ y1


def uniform(key: Key, n: int, device="cpu") -> torch.Tensor:
    """(n,) float32 ``jax.random.uniform(key, (n,))`` in [0, 1)."""
    bits = (random_bits(key, n, device) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


def bernoulli(key: Key, p: float, n: int, device="cpu") -> torch.Tensor:
    """(n,) bool ``jax.random.bernoulli(key, p, (n,))``: uniform < p, with p
    rounded to float32 as JAX rounds a Python float."""
    # a fill, not an upload: no wait for the device
    return uniform(key, n, device) < torch.full((), float(np.float32(p)), dtype=torch.float32,
                                                device=device)
