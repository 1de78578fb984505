"""Pre-filter allowlist (paper §3.5).

Applied BEFORE top-k, never after, so a selective allowlist still returns
min(k, |allowlist|) real results.  The mask over row positions is built on
the host from external ids and copied to a device once, at its first use
there: a fresh host-to-device copy on every search would wait for the stream.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

# Mask value for disallowed rows: large-negative instead of -inf so that
# score arithmetic never produces NaNs.
NEG = np.float32(-3.0e38)


@dataclasses.dataclass
class Allowlist:
    """Pre-filter over external ids."""

    mask: np.ndarray  # [n] bool over row positions
    n_allowed: int
    _on_device: dict = dataclasses.field(default_factory=dict, repr=False, compare=False)

    @staticmethod
    def from_ids(
        allowed_ids: Sequence[int],
        index_ids: np.ndarray,
        *,
        dense_threshold: float = 0.01,
    ) -> "Allowlist":
        """Dense selections go through a bounded-universe bitmap, sparse ones
        through a sorted membership test (the paper's bitvec/HashSet split)."""
        allowed = np.asarray(list(allowed_ids), dtype=np.int64)
        n = len(index_ids)
        if len(allowed) >= dense_threshold * n:
            lo, hi = index_ids.min(), index_ids.max()
            bitmap = np.zeros(int(hi - lo + 1), dtype=bool)
            in_range = (allowed >= lo) & (allowed <= hi)
            bitmap[(allowed[in_range] - lo).astype(np.int64)] = True
            mask = bitmap[(index_ids - lo).astype(np.int64)]
        else:
            mask = np.isin(index_ids, allowed)
        return Allowlist(mask=mask, n_allowed=int(mask.sum()))

    def mask_on(self, device: torch.device) -> torch.Tensor:
        """The mask as a bool tensor on ``device``, copied there once."""
        if device not in self._on_device:
            self._on_device[device] = torch.as_tensor(self.mask, dtype=torch.bool).to(device)
        return self._on_device[device]

    def apply(self, scores: torch.Tensor) -> torch.Tensor:
        """Mask scores of disallowed rows to NEG (pre-top-k)."""
        return torch.where(self.mask_on(scores.device), scores, float(NEG))
