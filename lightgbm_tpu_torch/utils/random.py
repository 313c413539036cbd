"""Deterministic light-weight PRNG matching the reference's ``Random``
(include/LightGBM/utils/random.h): an LCG with NextShort/NextInt/NextFloat
and the same three-branch ``Sample`` (full / selection / step sampling).
Host-side sampling (bin-construction row sampling, feature_fraction,
bagging) uses this so seeded runs are reproducible and structurally
comparable with the reference.

Device-side randomness (DART drops inside jit, Pallas PRNG) uses
``jax.random`` instead — cross-implementation bit-parity of sampled indices
is not required there, only determinism under a fixed seed.
"""

from __future__ import annotations

import numpy as np


class Random:
    def __init__(self, seed: int = 123456789):
        self.x = int(seed) & 0xFFFFFFFF

    # -- checkpoint support --------------------------------------------
    # The whole generator is the 32-bit LCG word, so state export is one
    # int; model text cannot carry it, which is exactly why checkpoint
    # resume needs it (ckpt/state.py).
    def get_state(self) -> int:
        return int(self.x)

    def set_state(self, state: int) -> "Random":
        self.x = int(state) & 0xFFFFFFFF
        return self

    def next_short(self, lower_bound: int, upper_bound: int) -> int:
        """Random int in [lower_bound, upper_bound), 15-bit source."""
        return self._rand_int16() % (upper_bound - lower_bound) + lower_bound

    def next_int(self, lower_bound: int, upper_bound: int) -> int:
        """Random int in [lower_bound, upper_bound), 31-bit source."""
        return self._rand_int31() % (upper_bound - lower_bound) + lower_bound

    def next_float(self) -> float:
        """Random float in [0, 1)."""
        return self._rand_int16() / 32768.0

    def _rand_int16(self) -> int:
        self.x = (214013 * self.x + 2531011) & 0xFFFFFFFF
        return (self.x >> 16) & 0x7FFF

    def _rand_int31(self) -> int:
        self.x = (214013 * self.x + 2531011) & 0xFFFFFFFF
        return self.x & 0x7FFFFFFF

    def sample(self, n: int, k: int) -> np.ndarray:
        """Sample ``k`` ordered values from range(n) (random.h Sample)."""
        ret: list[int] = []
        if k > n or k < 0:
            pass
        elif k == n:
            ret = list(range(n))
        elif k > n // 2:
            # selection sampling
            for i in range(n):
                prob = (k - len(ret)) / (n - i)
                if self.next_float() < prob:
                    ret.append(i)
        else:
            # step sampling: cheap for sparse picks
            min_step = 1
            avg_step = n // k
            max_step = 2 * avg_step - min_step
            start = -1
            for _ in range(k):
                start += self.next_short(min_step, max_step + 1)
                if start >= n:
                    break
                ret.append(start)
        return np.asarray(ret, dtype=np.int64)
