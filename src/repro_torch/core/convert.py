"""Build the port's ``Encoded`` and a segmented ``MonaVec`` from plain arrays.

The fields of an encoded corpus (packed codes, norms, seed, shape
metadata and, for a mixed corpus, its 4/2 split and permutation) are the
"weights" of this system, and a mutated index adds per-segment ids,
tombstones and the next segment ordinal.  Taking them as numpy arrays lets
one index, for example the reference's mutated ``MonaVec``, feed both
packages without going through a file.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from . import quantize as qz
from .rhdh import next_pow2
from .standardize import METRICS, GlobalStd


def encoded_from_arrays(
    packed: np.ndarray,
    qnorms: np.ndarray,
    *,
    seed: int,
    metric: str,
    bits: int,
    dim: int,
    dim_pad: int,
    n4_dims: int = 0,
    perm: Optional[np.ndarray] = None,
    std_mean: Optional[float] = None,
    std_inv_std: Optional[float] = None,
    device: torch.device | str = "cuda",
) -> qz.Encoded:
    """An Encoded on ``device``; ``bits`` 2, 3 (mixed, with ``n4_dims``
    4-bit dims and optionally the variance permutation ``perm``) or 4."""
    width = qz.bytes_per_vector(dim_pad, bits, n4_dims)   # validates bits
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r}; expected one of {METRICS}")
    if dim_pad != next_pow2(dim):
        raise ValueError(f"dim_pad={dim_pad} is not next_pow2(dim={dim})")
    if bits == 3:
        if not 0 <= n4_dims <= dim_pad or n4_dims % 4:
            raise ValueError(f"n4_dims={n4_dims} must be a multiple of 4 in [0, {dim_pad}]")
    elif n4_dims or perm is not None:
        raise ValueError(f"n4_dims and perm belong to mixed (bits=3) corpora, got bits={bits}")
    if perm is not None:
        perm = np.asarray(perm, dtype=np.int32)
        if perm.shape != (dim_pad,) or not np.array_equal(np.sort(perm), np.arange(dim_pad)):
            raise ValueError(f"perm must be a permutation of range({dim_pad})")
    packed = np.asarray(packed, dtype=np.uint8)
    qnorms = np.asarray(qnorms, dtype=np.float32)
    if packed.ndim != 2 or packed.shape[1] != width:
        raise ValueError(f"packed must be [n, {width}], got {packed.shape}")
    if qnorms.shape != (packed.shape[0],):
        raise ValueError(f"qnorms must be [{packed.shape[0]}], got {qnorms.shape}")
    if (std_mean is None) != (std_inv_std is None):
        raise ValueError("pass both std_mean and std_inv_std, or neither")
    std = None if std_mean is None else GlobalStd(float(std_mean), float(std_inv_std))
    dev = resolve_device(device)
    return qz.Encoded(
        packed=torch.tensor(packed, device=dev),
        qnorms=torch.tensor(qnorms, device=dev),
        seed=int(seed), metric=metric, bits=bits, dim=int(dim), dim_pad=int(dim_pad),
        n4_dims=int(n4_dims), std=std, perm=perm,
    )


def segmented_from_arrays(
    segments: Sequence[dict],
    *,
    next_ordinal: int,
    metric: str,
    bits: int,
    dim: int,
    dim_pad: int,
    n4_dims: int = 0,
    perm: Optional[np.ndarray] = None,
    std_mean: Optional[float] = None,
    std_inv_std: Optional[float] = None,
    coarse: Optional[str] = None,
    device: torch.device | str = "cuda",
):
    """A ``MonaVec`` over segments given base first, each a dict of
    ``packed``, ``qnorms``, ``seed``, ``ids`` and ``tombs`` ([n] bool); with
    ``coarse`` every segment derives its coarse code from its codes."""
    from . import binary
    from . import segments as seg
    from .api import MonaVec
    from .bruteforce import BruteForceIndex

    if not segments:
        raise ValueError("segments must hold at least the base segment")
    if next_ordinal < len(segments):
        raise ValueError(f"next_ordinal={next_ordinal} is below the {len(segments)} "
                         f"segments given")
    parts = []
    for s in segments:
        enc = encoded_from_arrays(s["packed"], s["qnorms"], seed=s["seed"], metric=metric,
                                  bits=bits, dim=dim, dim_pad=dim_pad, n4_dims=n4_dims,
                                  perm=perm, std_mean=std_mean, std_inv_std=std_inv_std,
                                  device=device)
        if coarse is not None:
            enc = binary.attach_coarse(enc, coarse)
        ids = np.asarray(s["ids"], dtype=np.uint64)
        tombs = np.asarray(s["tombs"], dtype=bool).copy()
        if ids.shape != (enc.n,) or tombs.shape != (enc.n,):
            raise ValueError(f"ids and tombs must be [{enc.n}], got {ids.shape} and "
                             f"{tombs.shape}")
        parts.append((enc, ids, tombs))
    (enc0, ids0, tombs0), extras = parts[0], parts[1:]
    state = seg.SegmentedState(
        base_tombs=tombs0, next_ordinal=int(next_ordinal),
        extras=[seg.Segment(enc=e, ids=i, tombs=t) for e, i, t in extras])
    return MonaVec(BruteForceIndex(enc=enc0, ids=ids0), mut=state)
