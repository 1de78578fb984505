"""Metric-aware input preparation (paper §3.1.1).

- Cosine: unit-normalize.
- L2: optional global scalar standardization (x - mu) / sigma, a uniform
  scaling that preserves Euclidean ordering.
- Dot: raw passthrough.
"""

from __future__ import annotations

import dataclasses
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
        mean = torch.tensor(np.float32(self.mean), device=x.device)
        inv = torch.tensor(np.float32(self.inv_std), device=x.device)
        return (x - mean) * inv


def unit_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    n = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x / torch.clamp(n, min=eps)


def prepare(x: torch.Tensor, metric: str, std: Optional[GlobalStd] = None) -> torch.Tensor:
    """Metric-aware input preparation stage (Figure 1 of the paper)."""
    if metric == COSINE:
        return unit_normalize(x)
    if metric == L2:
        return std.transform(x) if std is not None else x
    if metric == DOT:
        return x
    raise ValueError(f"unknown metric {metric!r}; expected one of {METRICS}")
