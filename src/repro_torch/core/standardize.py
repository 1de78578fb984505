"""Metric-aware input preparation (paper §3.1.1).

- Cosine: unit-normalize.
- L2: optional global scalar standardization (x - mu) / sigma, a uniform
  scaling that preserves Euclidean ordering.
- Dot: raw passthrough.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

COSINE = "cosine"
DOT = "dot"
L2 = "l2"
METRICS = (COSINE, DOT, L2)


@dataclasses.dataclass(frozen=True)
class GlobalStd:
    """Scalar (mu, 1/sigma) computed by fit(); persisted in the .mvec STD block."""

    mean: float
    inv_std: float

    @staticmethod
    def fit(sample, eps: float = 1e-12) -> "GlobalStd":
        """Single pass in float64 on the host: summary statistics only."""
        if isinstance(sample, torch.Tensor):
            sample = sample.detach().cpu().numpy()
        x = np.asarray(sample, dtype=np.float64)
        return GlobalStd(mean=float(x.mean()), inv_std=1.0 / max(float(x.std()), eps))

    def transform(self, x: torch.Tensor) -> torch.Tensor:
        mean, inv = _scalars(self.mean, self.inv_std, x.device)
        return (x - mean) * inv

    def inverse(self, x: torch.Tensor) -> torch.Tensor:
        """Undo ``transform``: x / (1/sigma) + mu, in f32."""
        mean, inv = _scalars(self.mean, self.inv_std, x.device)
        return x / inv + mean


@dataclasses.dataclass(frozen=True)
class PerDimWhiten:
    """Ablation baseline only (Mahalanobis: breaks L2 ordering, paper §3.1.1)."""

    mean: np.ndarray       # [d] f32
    inv_std: np.ndarray    # [d] f32

    @staticmethod
    def fit(sample, eps: float = 1e-6) -> "PerDimWhiten":
        """Per-dim statistics in float64 on the host, kept as f32."""
        if isinstance(sample, torch.Tensor):
            sample = sample.detach().cpu().numpy()
        x = np.asarray(sample, dtype=np.float64)
        sigma = np.maximum(x.std(axis=0), eps)
        return PerDimWhiten(mean=x.mean(axis=0).astype(np.float32),
                            inv_std=(1.0 / sigma).astype(np.float32))

    def transform(self, x: torch.Tensor) -> torch.Tensor:
        mean = torch.from_numpy(self.mean).to(x.device)
        inv = torch.from_numpy(self.inv_std).to(x.device)
        return (x - mean) * inv


@functools.lru_cache(maxsize=64)
def _scalars(mean: float, inv_std: float, device: torch.device):
    # The f32 scalars as 0-d tensors, copied to the device once: a fresh
    # host-to-device copy each query would wait for the stream, and could
    # not be recorded into a CUDA graph.
    return (torch.tensor(np.float32(mean), device=device),
            torch.tensor(np.float32(inv_std), device=device))


#: Rows one row-norm reduction runs on.  A reduction splits a row, and so
#: orders its sum, by the shape of the whole call (on the card, PyTorch gives
#: each row a wider block below 16 rows, and splits a long row across blocks
#: by the row count).  Every norm therefore runs on blocks of exactly this
#: many rows, the last one zero-padded, as ``kernels.ref._chunked_dot`` fixes
#: the scan's chunk: a row's norm depends on the row alone, never on how many
#: rows came with it, so a query's bytes do not depend on its batch.
_NORM_ROWS = 64


def row_norms(x: torch.Tensor) -> torch.Tensor:
    """[..., d] -> [..., 1] L2 norms, each a function of its own row only."""
    d = x.shape[-1]
    flat = x.reshape(-1, d)
    rows = flat.shape[0]
    if rows == 0:
        return torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    pad = (-rows) % _NORM_ROWS
    if pad:
        flat = torch.cat([flat, flat.new_zeros((pad, d))])
    norms = torch.cat([torch.linalg.vector_norm(flat[i:i + _NORM_ROWS], dim=-1, keepdim=True)
                       for i in range(0, flat.shape[0], _NORM_ROWS)])
    return norms[:rows].reshape(*x.shape[:-1], 1)


def unit_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.clamp(row_norms(x), min=eps)


def prepare(x: torch.Tensor, metric: str, std: Optional[GlobalStd] = None) -> torch.Tensor:
    """Metric-aware input preparation stage (Figure 1 of the paper)."""
    if metric == COSINE:
        return unit_normalize(x)
    if metric == L2:
        return std.transform(x) if std is not None else x
    if metric == DOT:
        return x
    raise ValueError(f"unknown metric {metric!r}; expected one of {METRICS}")
