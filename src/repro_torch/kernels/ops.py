"""Scoring entry points over the kernels (counterpart of ``repro/kernels/ops.py``).

Dispatch is by the tensor's device, with no switch and no fallback: a CUDA
tensor goes through the CUDA kernel, a CPU tensor through the kernel's plain
version in ``kernels.ref``.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core import quantize as qz
from ..core.allowlist import NEG
from ..core.scoring import adjust_scores
from . import ref
from .binary_dot import crumb_affinity_cuda, sign_hamming_cuda
from .gather_dot import gather_nibble_dot_cuda
from .nibble_dot import nibble_dot_cuda


def _on_card(t: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; any other device raises."""
    if t.is_cuda:
        return True
    if t.device.type != "cpu":
        raise ValueError(f"no kernel path for device {t.device}")
    return False


def nibble_score_raw(packed: torch.Tensor, q_rot: torch.Tensor) -> torch.Tensor:
    """Raw 4-bit scores [b, n] of rotated queries against packed codes."""
    if _on_card(packed):
        return nibble_dot_cuda(packed, q_rot.contiguous())
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


# ---------------------------------------------------------------------------
# Binarized coarse-scan proxies (the cascade's first stage).
# ---------------------------------------------------------------------------

def sign_coarse_raw(cbits: torch.Tensor, qbits: torch.Tensor) -> torch.Tensor:
    """Hamming distances [b, n] (int32) of packed query against corpus sign bits."""
    if _on_card(cbits):
        return sign_hamming_cuda(cbits, qbits.contiguous())
    return ref.sign_hamming_ref(cbits, qbits)


def crumb_coarse_raw(ccodes: torch.Tensor, qplanes: torch.Tensor) -> torch.Tensor:
    """Crumb affinities [b, n] (int32) from plane-packed codes: both carry the
    hi bit plane then the lo bit plane, d'/8 bytes each."""
    if _on_card(ccodes):
        return crumb_affinity_cuda(ccodes, qplanes.contiguous())
    return ref.crumb_affinity_ref(ccodes, qplanes)


# ---------------------------------------------------------------------------
# Gathered candidate-set scoring (the cascade's rescore; later IVF and HNSW).
# ---------------------------------------------------------------------------

def score_gathered_raw(packed: torch.Tensor, q_rot: torch.Tensor, cand: torch.Tensor, *,
                       bits: int) -> torch.Tensor:
    """Raw scores [b, m] of row ``cand[q, i]`` against query ``q``; the
    kernel reads the rows itself (no gathered copy)."""
    if bits != 4:
        raise NotImplementedError(
            f"bits={bits} gathered scans are not ported yet (ROADMAP A3, kernel B5)")
    if _on_card(packed):
        return gather_nibble_dot_cuda(packed, q_rot.contiguous(),
                                      cand.to(torch.int32).contiguous())
    return ref.gather_nibble_dot_ref(packed, q_rot, cand)


def score_gathered(packed: torch.Tensor, q_rot: torch.Tensor, cand: torch.Tensor, *,
                   bits: int, qnorms: Optional[torch.Tensor] = None,
                   metric: Optional[str] = None) -> torch.Tensor:
    """Scores [b, m] for per-query candidate sets, -1 candidates masked to NEG.

    The scan skips candidates of -1 (their rows are never read) and they come
    back NEG.  With ``qnorms`` and ``metric`` the scores are metric-adjusted
    by the same ``adjust_scores`` as the full scan, so a candidate's score
    equals its full-scan score wherever the raw scores are equal.
    """
    valid = cand >= 0
    scores = score_gathered_raw(packed, q_rot, cand, bits=bits)
    if qnorms is not None:
        if metric is None:
            raise ValueError("metric is required to adjust scores")
        scores = adjust_scores(scores, qnorms[cand.clamp(min=0).long()], metric)
    return torch.where(valid, scores, float(NEG))
