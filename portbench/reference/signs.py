"""The rotation's +-1 signs, worked out from the index seed alone.

A frozen copy of the stream the configuration names: the sign vector is
``jax.random.rademacher`` under JAX's partitionable threefry2x32 stream,
keyed by ``fold_in(key(seed_lo), seed_hi)``.  Plain numpy; nothing of the
program is imported.
"""

from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key, x0: np.ndarray, x1: np.ndarray):
    """Threefry-2x32, 20 rounds, on uint32 counter pairs."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x = [np.asarray(x0, np.uint32) + ks[0], np.asarray(x1, np.uint32) + ks[1]]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def signs(seed: int, d_pad: int) -> np.ndarray:
    """[d'] f32 of +-1: +1 where the element's 32 random bits have a 0 top bit."""
    lo, hi = seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF
    b0, b1 = threefry2x32((0, lo), np.zeros(1, np.uint32), np.full(1, hi, np.uint32))
    key = (int(b0[0]), int(b1[0]))
    w0, w1 = threefry2x32(key, np.zeros(d_pad, np.uint32), np.arange(d_pad, dtype=np.uint32))
    bits = w0 ^ w1
    return np.where(bits >> np.uint32(31), -1.0, 1.0).astype(np.float32)
