"""Lloyd-Max optimal scalar quantizer for N(0,1): the frozen tables.

The same constants as ``repro.core.lloydmax`` (the paper's §3.1.3 tables,
compiled in as data).  Codes are integers, so quantizing the same f32 values
gives the same codes on every device.
"""

from __future__ import annotations

import functools

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


@functools.lru_cache(maxsize=8)
def _boundaries_on(bits: int, device: torch.device) -> torch.Tensor:
    # Cached: a fresh host-to-device copy per query would wait for the stream.
    return torch.as_tensor(boundaries(bits), device=device)


def quantize(x: torch.Tensor, bits: int = 4) -> torch.Tensor:
    """Map values to codes in [0, 2^bits): the count of boundaries <= x.

    ``searchsorted(..., right=True)`` is the reference's
    ``jnp.searchsorted(side='right')``: the nearest-centroid rule for
    boundaries at centroid midpoints.  Integer output, no float reduction.
    """
    return torch.searchsorted(_boundaries_on(bits, x.device), x.contiguous(),
                              right=True).to(torch.uint8)


@functools.lru_cache(maxsize=8)
def _centroids_on(bits: int, device: torch.device) -> torch.Tensor:
    # Cached, as the boundaries: a decode step dequantizes its KV cache on the
    # card, and a fresh host-to-device copy there would wait for the stream.
    return torch.as_tensor(centroids(bits), device=device)


def dequantize(codes: torch.Tensor, bits: int = 4) -> torch.Tensor:
    """Codes -> centroid values (f32), a table gather."""
    return _centroids_on(bits, codes.device)[codes.long()]
