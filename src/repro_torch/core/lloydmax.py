"""Lloyd-Max optimal scalar quantizer for N(0,1): the frozen tables
(counterpart of ``repro/core/lloydmax.py``).

The same constants as the reference's (the paper's §3.1.3 tables, compiled
in as data), generated offline by ``generate_tables`` (20k iteration cap,
tol 1e-13); ``expected_distortion`` is their closed-form MSE on N(0,1);
``uniform_centroids`` / ``uniform_boundaries`` are the uniform quantizer
over the same range (the ablation of Table 7).  Codes are integers, so
quantizing the same f32 values gives the same codes on every device.
"""

from __future__ import annotations

import functools
import math
from statistics import NormalDist

import numpy as np
import torch

CENTROIDS_4BIT = np.array(
    [
        -2.7325895709929284, -2.0690172265288570, -1.6180463860193035,
        -1.2562311973447498, -0.9423404564848586, -0.6567591185308426,
        -0.3880482994892674, -0.1283950298507978,  0.1283950298507979,
         0.3880482994892679,  0.6567591185308430,  0.9423404564848593,
         1.2562311973447489,  1.6180463860192993,  2.0690172265288647,
         2.7325895709929156,
    ],
    dtype=np.float32,
)

BOUNDARIES_4BIT = np.array(
    [
        -2.4008033987608925, -1.8435318062740804, -1.4371387916820266,
        -1.0992858269148043, -0.7995497875078506, -0.5224037090100551,
        -0.2582216646700326,  0.0000000000000000,  0.2582216646700329,
         0.5224037090100555,  0.7995497875078512,  1.0992858269148040,
         1.4371387916820240,  1.8435318062740820,  2.4008033987608899,
    ],
    dtype=np.float32,
)

CENTROIDS_2BIT = np.array(
    [-1.5104176084989853, -0.4527800346364387, 0.4527800346364388, 1.5104176084989855],
    dtype=np.float32,
)

BOUNDARIES_2BIT = np.array(
    [-0.9815988215677121, 0.0, 0.9815988215677122],
    dtype=np.float32,
)

_TABLES = {
    4: (CENTROIDS_4BIT, BOUNDARIES_4BIT),
    2: (CENTROIDS_2BIT, BOUNDARIES_2BIT),
}


def centroids(bits: int) -> np.ndarray:
    """Frozen Lloyd-Max centroid table for ``bits`` in {2, 4}."""
    return _TABLES[bits][0]


def boundaries(bits: int) -> np.ndarray:
    """Frozen Lloyd-Max decision boundaries for ``bits`` in {2, 4}."""
    return _TABLES[bits][1]


def uniform_centroids(bits: int, lo: float = -2.7326, hi: float = 2.7326) -> np.ndarray:
    """Uniform quantizer over the same dynamic range (ablation baseline, Table 7)."""
    levels = 1 << bits
    return np.linspace(lo, hi, levels, dtype=np.float32)


def uniform_boundaries(bits: int, lo: float = -2.7326, hi: float = 2.7326) -> np.ndarray:
    c = uniform_centroids(bits, lo, hi)
    return ((c[:-1] + c[1:]) / 2).astype(np.float32)


def _tables(bits: int, table: str):
    """(centroids, boundaries) of the Lloyd-Max or the uniform quantizer."""
    if table == "lloydmax":
        return _TABLES[bits]
    if table == "uniform":
        return uniform_centroids(bits), uniform_boundaries(bits)
    raise ValueError(f"unknown table {table!r}")


@functools.lru_cache(maxsize=8)
def _boundaries_on(bits: int, table: str, device: torch.device) -> torch.Tensor:
    # Cached: a fresh host-to-device copy per query would wait for the stream.
    return torch.as_tensor(_tables(bits, table)[1], device=device)


def quantize(x: torch.Tensor, bits: int = 4, *, table: str = "lloydmax") -> torch.Tensor:
    """Map values to codes in [0, 2^bits): the count of boundaries <= x.

    ``searchsorted(..., right=True)`` is the reference's
    ``jnp.searchsorted(side='right')``: the nearest-centroid rule for
    boundaries at centroid midpoints.  Integer output, no float reduction.
    ``table="uniform"`` quantizes against the uniform ablation's boundaries.
    """
    return torch.searchsorted(_boundaries_on(bits, table, x.device), x.contiguous(),
                              right=True).to(torch.uint8)


@functools.lru_cache(maxsize=8)
def _centroids_on(bits: int, table: str, device: torch.device) -> torch.Tensor:
    # Cached, as the boundaries: a decode step dequantizes its KV cache on the
    # card, and a fresh host-to-device copy there would wait for the stream.
    return torch.as_tensor(_tables(bits, table)[0], device=device)


def dequantize(codes: torch.Tensor, bits: int = 4, *, table: str = "lloydmax") -> torch.Tensor:
    """Codes -> centroid values (f32), a table gather."""
    return _centroids_on(bits, table, codes.device)[codes.long()]


# ---------------------------------------------------------------------------
# Offline generator: re-derives the frozen constants (and tables for other
# bit widths).
# ---------------------------------------------------------------------------

def _phi(x: float) -> float:
    return math.exp(-x * x / 2) / math.sqrt(2 * math.pi)


def _Phi(x: float) -> float:
    return 0.5 * (1 + math.erf(x / math.sqrt(2)))


def generate_tables(bits: int, iters: int = 20000, tol: float = 1e-13):
    """Lloyd-Max fixed point for N(0,1): alternate centroid/boundary updates.

    Centroid update is the conditional mean of the Gaussian over each decision
    cell, available in closed form via the hazard-function identity
    E[X | a<X<b] = (phi(a) - phi(b)) / (Phi(b) - Phi(a)).
    Returns (centroids, boundaries), f64.
    """
    levels = 1 << bits
    nd = NormalDist()
    c = np.array([nd.inv_cdf((i + 0.5) / levels) for i in range(levels)])   # N(0,1) quantiles
    for _ in range(iters):
        b = (c[:-1] + c[1:]) / 2
        edges = np.concatenate([[-np.inf], b, [np.inf]])
        new_c = np.empty_like(c)
        for i in range(levels):
            a_, b_ = edges[i], edges[i + 1]
            pa = _phi(a_) if np.isfinite(a_) else 0.0
            pb = _phi(b_) if np.isfinite(b_) else 0.0
            Pa = _Phi(a_) if np.isfinite(a_) else 0.0
            Pb = _Phi(b_) if np.isfinite(b_) else 1.0
            new_c[i] = (pa - pb) / (Pb - Pa)
        delta = float(np.max(np.abs(new_c - c)))
        c = new_c
        if delta < tol:
            break
    b = (c[:-1] + c[1:]) / 2
    return c.astype(np.float64), b.astype(np.float64)


def expected_distortion(bits: int) -> float:
    """Closed-form MSE of the frozen quantizer on N(0,1) (no Monte Carlo)."""
    c, b = centroids(bits).astype(np.float64), boundaries(bits).astype(np.float64)
    edges = np.concatenate([[-np.inf], b, [np.inf]])

    def phi(x):
        return np.exp(-x * x / 2) / np.sqrt(2 * np.pi) if np.isfinite(x) else 0.0

    def Phi(x):
        return _Phi(x) if np.isfinite(x) else (0.0 if x < 0 else 1.0)

    mse = 0.0
    for i in range(len(c)):
        a_, b_ = edges[i], edges[i + 1]
        Pa, Pb = Phi(a_), Phi(b_)
        pa, pb = phi(a_), phi(b_)
        m0 = Pb - Pa                       # integral of p
        m1 = pa - pb                       # integral of x p
        a_t = a_ * pa if np.isfinite(a_) else 0.0
        b_t = b_ * pb if np.isfinite(b_) else 0.0
        m2 = m0 + a_t - b_t                # integral of x^2 p
        mse += m2 - 2 * c[i] * m1 + c[i] ** 2 * m0
    return float(mse)
