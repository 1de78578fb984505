"""Randomized Hadamard Transform (RHDH): the paper's data-oblivious rotation.

R = (1/sqrt(d')) H D with D = diag(±1 signs) and H the Walsh-Hadamard matrix,
d' = next power of two >= d.  The signs come from the 64-bit seed stored in
the .mvec header, through the same threefry2x32 stream ``repro.core.rhdh``
draws from ``jax.random``, re-implemented here in numpy so that the port
opens and writes the reference's files without JAX.

JAX has two threefry streams, picked by its ``jax_threefry_partitionable``
flag; ``THREEFRY_PARTITIONABLE`` mirrors it (True, jax 0.9.0's default).
Code that must agree with a running JAX sets it to that flag's value.

``fwht`` is the plain version of the transform: the reference's Kronecker
split H_{ab} = H_a (x) H_b as two small dense products.  On a CUDA tensor
``rhdh_apply`` runs the butterfly kernel in ``repro_torch.kernels.hadamard``
instead, with the zero-pad and the sign multiply fused into its load.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

#: Which of JAX's threefry streams the sign vector is drawn from.
THREEFRY_PARTITIONABLE = True

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def next_pow2(d: int) -> int:
    p = 1
    while p < d:
        p <<= 1
    return p


@functools.lru_cache(maxsize=None)
def hadamard_matrix(n: int) -> np.ndarray:
    """Sylvester Walsh-Hadamard matrix H_n (entries ±1), n a power of two."""
    if n <= 0 or n & (n - 1):
        raise ValueError(f"n={n} must be a power of two")
    h = np.array([[1.0]], dtype=np.float32)
    while h.shape[0] < n:
        h = np.block([[h, h], [h, -h]])
    h = h.astype(np.float32)
    h.flags.writeable = False   # shared by every caller of the cache
    return h


@functools.lru_cache(maxsize=64)
def _hadamard_tensor(n: int, device: torch.device) -> torch.Tensor:
    return torch.tensor(hadamard_matrix(n), device=device)


def _split_pow2(dp: int) -> Tuple[int, int]:
    """Split d' = a*b with a, b powers of two, a <= b, both near sqrt(d')."""
    lg = dp.bit_length() - 1
    a = 1 << (lg // 2)
    return a, dp // a


# ---------------------------------------------------------------------------
# threefry2x32 in numpy (bit-exact with jax.random's threefry PRNG).
# ---------------------------------------------------------------------------

def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key: Tuple[int, int], x0: np.ndarray,
                 x1: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 block cipher (20 rounds) on uint32 counter pairs."""
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


def _seed_key(seed: int) -> Tuple[int, int]:
    """``fold_in(key(seed_lo), seed_hi)`` as a raw threefry key pair."""
    lo, hi = seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF
    b0, b1 = threefry2x32((0, lo), np.zeros(1, np.uint32),
                          np.full(1, hi, np.uint32))
    return int(b0[0]), int(b1[0])


def _random_bits32(key: Tuple[int, int], size: int,
                   partitionable: bool) -> np.ndarray:
    if partitionable:
        # Counter (0, i) per element; the two output words are XORed.
        b0, b1 = threefry2x32(key, np.zeros(size, np.uint32),
                              np.arange(size, dtype=np.uint32))
        return b0 ^ b1
    # Legacy stream: the counter iota is split in halves (zero-padded to
    # even length) and the two output words are concatenated.
    half = (size + 1) // 2
    iota = np.zeros(2 * half, np.uint32)
    iota[:size] = np.arange(size, dtype=np.uint32)
    b0, b1 = threefry2x32(key, iota[:half], iota[half:])
    return np.concatenate([b0, b1])[:size]


def rademacher_signs_np(seed: int, d_pad: int, partitionable: bool) -> np.ndarray:
    """The ±1 sign vector of ``repro.core.rhdh.rademacher_signs``.

    ``jax.random.rademacher`` is ``uniform < 0.5``: +1 exactly where the top
    bit of the element's 32 random bits is 0.
    """
    bits = _random_bits32(_seed_key(int(seed)), d_pad, partitionable)
    return np.where(bits >> np.uint32(31), -1.0, 1.0).astype(np.float32)


@functools.lru_cache(maxsize=256)
def _signs_tensor(seed: int, d_pad: int, partitionable: bool,
                  device: torch.device) -> torch.Tensor:
    return torch.from_numpy(rademacher_signs_np(seed, d_pad, partitionable)).to(device)


def rademacher_signs(seed: int, d_pad: int,
                     device: torch.device | str = "cpu") -> torch.Tensor:
    """Signs as an f32 tensor on ``device``: drawn once on the host per
    (seed, d', stream), then kept on the device.  Callers must not write
    into the returned tensor."""
    return _signs_tensor(int(seed), int(d_pad), bool(THREEFRY_PARTITIONABLE),
                         torch.device(device))


# ---------------------------------------------------------------------------
# The transform.
# ---------------------------------------------------------------------------

def fwht(x: torch.Tensor) -> torch.Tensor:
    """Walsh-Hadamard transform of the last axis (length a power of 2).

    Plain version, as the reference computes it: reshape (..., a, b), apply
    H_a on axis -2 and H_b on axis -1.  Unnormalized.
    """
    d = x.shape[-1]
    a, b = _split_pow2(d)
    ha, hb = _hadamard_tensor(a, x.device), _hadamard_tensor(b, x.device)
    xr = x.reshape(x.shape[:-1] + (a, b))
    y = torch.einsum("ij,...jk->...ik", ha, xr)
    y = torch.einsum("...ik,kl->...il", y, hb)
    return y.reshape(x.shape)


def pad_to_pow2(x: torch.Tensor, d_pad: int) -> torch.Tensor:
    d = x.shape[-1]
    if d == d_pad:
        return x
    return torch.nn.functional.pad(x, (0, d_pad - d))


def rhdh_apply(x: torch.Tensor, seed: int, *, normalized: bool = True) -> torch.Tensor:
    """Seeded Hadamard rotation of the last axis of [n, d]; output has d' dims.

    normalized=False is the quantizer-space transform Z = H D x (unit input
    -> ~N(0,1) coordinates); normalized=True adds the 1/sqrt(d') factor.
    """
    # Imported here: the kernel module's plain version is this module's fwht.
    from ..kernels import hadamard

    d_pad = next_pow2(x.shape[-1])
    y = hadamard.signed_fwht(x, rademacher_signs(seed, d_pad, x.device), d_pad)
    if normalized:
        y = y * np.float32(1.0 / np.sqrt(d_pad))
    return y


def rhdh_inverse(y: torch.Tensor, seed: int, d_orig: int) -> torch.Tensor:
    """Inverse rotation: x = D H y / sqrt(d') truncated to the original dim."""
    d_pad = y.shape[-1]
    signs = rademacher_signs(seed, d_pad, y.device)
    x = fwht(y) * np.float32(1.0 / np.sqrt(d_pad)) * signs
    return x[..., :d_orig]
