"""Scoring entry points over the kernels (counterpart of ``repro/kernels/ops.py``).

Dispatch is by the tensor's device, with no switch and no fallback: a CUDA
tensor goes through the CUDA kernel, a CPU tensor through the kernel's plain
version in ``kernels.ref``.
"""

from __future__ import annotations

import torch

from ..core import quantize as qz
from ..core.scoring import adjust_scores
from . import ref
from .nibble_dot import nibble_dot_cuda


def nibble_score_raw(packed: torch.Tensor, q_rot: torch.Tensor) -> torch.Tensor:
    """Raw 4-bit scores [b, n] of rotated queries against packed codes."""
    if packed.is_cuda:
        return nibble_dot_cuda(packed, q_rot.contiguous())
    if packed.device.type != "cpu":
        raise ValueError(f"no scan path for device {packed.device}")
    return ref.nibble_dot_ref(packed, q_rot)


def score_raw(packed: torch.Tensor, q_rot: torch.Tensor, *, bits: int) -> torch.Tensor:
    """Raw (un-adjusted) scores [b, n]: the one bit-mode dispatch point."""
    if bits == 4:
        return nibble_score_raw(packed, q_rot)
    raise NotImplementedError(
        f"bits={bits} scans are not ported yet (ROADMAP A3, kernel B3)")


def score_packed(q_rot: torch.Tensor, enc: qz.Encoded) -> torch.Tensor:
    """Metric-adjusted scores [b, n] for an Encoded corpus."""
    raw = score_raw(enc.packed, q_rot, bits=enc.bits)
    return adjust_scores(raw, enc.qnorms, enc.metric)
