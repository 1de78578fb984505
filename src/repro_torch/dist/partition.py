"""Deterministic corpus partitioning over the mesh's data axis (counterpart
of ``repro/dist/partition.py``).

A corpus of n rows is split into contiguous equal-size shards in row order
(shard s owns global rows [s * ceil(n/S), (s+1) * ceil(n/S))) after padding
n up to a multiple of the shard count.  Contiguity is what makes the
cross-shard merge tie-consistent with the single-device scan: global ids
increase with (shard, local row), so a stable per-shard top-k followed by a
stable merge top-k reproduces the lower-index-wins order exactly.

Padding rows never enter a top-k: the scan masks every global id >= n to
-inf before the local top-k (a score sentinel, not a data sentinel: padded
codes decode to the lowest centroid, a valid score).  ``qnorms`` are padded
with 1.0 all the same, so cosine's divide stays finite before the mask.

Each shard is a buffer of its own on its device, as ``jax.device_put`` of
the padded array gives, never a row view into one tensor: a view offset by
``lo * bytes_per_row`` need not meet the 16-byte alignment the kernels may
assume at small d'.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..launch.mesh import axes_entry, data_axes


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def data_axis_size(mesh) -> int:
    """Number of corpus shards: the product of the data axes' sizes."""
    n = 1
    for a in data_axes(mesh):
        n *= mesh.shape[a]
    return n


def shard_sizes(n: int, n_shards: int) -> Tuple[int, int]:
    """(rows per shard, padded total) for an n-row corpus on n_shards."""
    per = round_up(n, n_shards) // n_shards
    return per, per * n_shards


def partition_bounds(n: int, n_shards: int, shard: int) -> Tuple[int, int]:
    """[lo, hi) of global rows owned by ``shard`` (hi clamped to n)."""
    per, _ = shard_sizes(n, n_shards)
    return shard * per, min((shard + 1) * per, n)


def pad_rows(x: torch.Tensor, n_pad: int, fill=0) -> torch.Tensor:
    """``x`` padded on axis 0 to n_pad rows of ``fill`` (``x`` itself when it
    has n_pad rows)."""
    n = int(x.shape[0])
    if n == n_pad:
        return x
    tail = torch.full((n_pad - n,) + tuple(x.shape[1:]), fill, dtype=x.dtype, device=x.device)
    return torch.cat([x, tail])


def shard_rows(devices, x: torch.Tensor, fill=0) -> Tuple[torch.Tensor, ...]:
    """``x``'s rows padded to the grid of one shard per entry of ``devices``,
    one new buffer per shard on its device, in shard order."""
    n = int(x.shape[0])
    n_shards = len(devices)
    per, _ = shard_sizes(n, n_shards)
    out = []
    for s, dev in enumerate(devices):
        lo, hi = partition_bounds(n, n_shards, s)
        buf = torch.full((per,) + tuple(x.shape[1:]), fill, dtype=x.dtype, device=dev)
        if hi > lo:
            buf[:hi - lo].copy_(x[lo:hi])
        out.append(buf)
    return tuple(out)


def corpus_sharding(mesh, ndim: int = 2) -> tuple:
    """The spec that splits corpus rows over the data axes, the rest
    replicated (a ``dist.sharding`` spec)."""
    return (axes_entry(data_axes(mesh)),) + (None,) * (ndim - 1)


def place_sharded(mesh, packed: torch.Tensor, qnorms: torch.Tensor):
    """Pad a (packed, qnorms) corpus to the shard grid and place each shard
    on its device: (packed shards, qnorms shards, n)."""
    devices = mesh.devices
    return shard_rows(devices, packed), shard_rows(devices, qnorms, 1.0), int(packed.shape[0])
