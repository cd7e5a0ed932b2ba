"""The Gating Dropout consensus bit of a step, as the model defines it:

  bit(seed, step) = uniform(fold_in(PRNGKey(seed ^ 0x6A7ED0), step)) < rate

with JAX's threefry-2x32 ``PRNGKey``/``fold_in`` and a partitionable
scalar ``uniform`` (the 32 random bits are the XOR of the two output words
of threefry on the counter (0, 0); the top 23 bits make a float in [1, 2),
minus 1). Written here in numpy uint32 arithmetic."""
from __future__ import annotations

import numpy as np

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry(k0, k1, x0, x1):
    k0, k1 = np.uint32(k0), np.uint32(k1)
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    with np.errstate(over="ignore"):
        x0 = np.uint32(x0) + ks[0]
        x1 = np.uint32(x1) + ks[1]
        for i in range(5):
            for r in _ROT[i % 2]:
                x0 = x0 + x1
                x1 = ((x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def dropped(seed: int, step: int, rate: float) -> bool:
    """Whether step ``step`` of a run seeded ``seed`` takes the dropped
    branch."""
    if rate <= 0:
        return False
    key = (0, (seed ^ 0x6A7ED0) & 0xFFFFFFFF)
    k0, k1 = _threefry(key[0], key[1], 0, step & 0xFFFFFFFF)
    y0, y1 = _threefry(k0, k1, 0, 0)
    bits = (y0 ^ y1) >> np.uint32(9) | np.uint32(0x3F800000)
    u = np.array([bits], np.uint32).view(np.float32)[0] - np.float32(1.0)
    return bool(u < np.float32(rate))
