"""Scoring entry points over the kernels (counterpart of ``repro/kernels/ops.py``).

Dispatch is by the tensor's device, with no switch and no fallback: a CUDA
tensor goes through the CUDA kernel, a CPU tensor through the kernel's plain
version in ``kernels.ref``, and a meta tensor through the plain version too,
which there gives shapes and dtypes only.  A mixed (bits=3) corpus is scored block by
block: the 4-bit scan of its first ``n4_dims / 2`` bytes against the first
``n4_dims`` query dims plus the 2-bit scan of the rest, both on column views
of the codes and queries (the kernels take a row stride), with one f32 add
of the two blocks' scores; an empty block is not launched.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core import quantize as qz
from ..core.allowlist import NEG
from ..core.scoring import adjust_scores
from . import ref
from .binary_dot import crumb_affinity_cuda, sign_hamming_cuda
from .gather_dot import gather_crumb_dot_cuda, gather_nibble_dot_cuda
from .nibble_dot import crumb_dot_cuda, nibble_dot_cuda


def _on_card(t: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU or a meta one; any other device
    raises.  On meta the plain version is a shape-only route: it computes
    nothing and gives the outputs' shapes and dtypes (the dry-run's cells)."""
    if t.is_cuda:
        return True
    if t.device.type not in ("cpu", "meta"):
        raise ValueError(f"no kernel path for device {t.device}")
    return False


def _unit_stride(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself where its rows are contiguous (any row stride), else a copy."""
    return t if t.shape[-1] <= 1 or t.stride(-1) == 1 else t.contiguous()


def _by_block(score, packed: torch.Tensor, q_rot: torch.Tensor, bits: int, n4_dims: int,
              *args) -> torch.Tensor:
    """The one bit-mode dispatch: ``score(bits, packed, q_rot, *args)`` per block."""
    if bits in (2, 4):
        return score(bits, packed, q_rot, *args)
    if bits != 3:
        raise ValueError(f"unsupported bits={bits}: expected one of {qz.BIT_WIDTHS}")
    b4, d_pad = n4_dims // 2, q_rot.shape[-1]
    if n4_dims == 0:
        return score(2, packed, q_rot, *args)
    if n4_dims == d_pad:
        return score(4, packed, q_rot, *args)
    return (score(4, packed[:, :b4], q_rot[:, :n4_dims], *args)
            + score(2, packed[:, b4:], q_rot[:, n4_dims:], *args))


def nibble_score_raw(packed: torch.Tensor, q_rot: torch.Tensor) -> torch.Tensor:
    """Raw 4-bit scores [b, n] of rotated queries against packed codes."""
    if _on_card(packed):
        return nibble_dot_cuda(packed, _unit_stride(q_rot))
    return ref.nibble_dot_ref(packed, q_rot)


def crumb_score_raw(packed: torch.Tensor, q_rot: torch.Tensor) -> torch.Tensor:
    """Raw 2-bit scores [b, n] of rotated queries against packed codes."""
    if _on_card(packed):
        return crumb_dot_cuda(packed, _unit_stride(q_rot))
    return ref.crumb_dot_ref(packed, q_rot)


def _scan(bits: int, packed: torch.Tensor, q_rot: torch.Tensor) -> torch.Tensor:
    return (nibble_score_raw if bits == 4 else crumb_score_raw)(packed, q_rot)


def score_raw(packed: torch.Tensor, q_rot: torch.Tensor, *, bits: int,
              n4_dims: int = 0) -> torch.Tensor:
    """Raw (un-adjusted) scores [b, n] for bits 4, 2 or 3 (mixed [4-bit |
    2-bit] rows with ``n4_dims`` 4-bit dims)."""
    return _by_block(_scan, packed, q_rot, bits, n4_dims)


def score_packed(q_rot: torch.Tensor, enc: qz.Encoded) -> torch.Tensor:
    """Metric-adjusted scores [b, n] for an Encoded corpus."""
    raw = score_raw(enc.packed, q_rot, bits=enc.bits, n4_dims=enc.n4_dims)
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
# Gathered candidate-set scoring (the cascade's rescore and IVF's probe scan).
# ---------------------------------------------------------------------------

def _gathered(bits: int, packed: torch.Tensor, q_rot: torch.Tensor,
              cand: torch.Tensor) -> torch.Tensor:
    if _on_card(packed):
        kernel = gather_nibble_dot_cuda if bits == 4 else gather_crumb_dot_cuda
        return kernel(packed, _unit_stride(q_rot), cand)
    plain = ref.gather_nibble_dot_ref if bits == 4 else ref.gather_crumb_dot_ref
    return plain(packed, q_rot, cand)


def score_gathered_raw(packed: torch.Tensor, q_rot: torch.Tensor, cand: torch.Tensor, *,
                       bits: int, n4_dims: int = 0) -> torch.Tensor:
    """Raw scores [b, m] of row ``cand[q, i]`` against query ``q``, for the
    same bit modes as ``score_raw``; the kernels read the rows themselves
    (no gathered copy)."""
    if _on_card(packed):
        cand = cand.to(torch.int32).contiguous()
    return _by_block(_gathered, packed, q_rot, bits, n4_dims, cand)


def score_gathered(packed: torch.Tensor, q_rot: torch.Tensor, cand: torch.Tensor, *,
                   bits: int, n4_dims: int = 0, qnorms: Optional[torch.Tensor] = None,
                   metric: Optional[str] = None,
                   allow_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Scores [b, m] for per-query candidate sets, masked to NEG before any
    top-k: -1 candidates and, with ``allow_mask`` ([n] bool), disallowed rows.

    The scan skips candidates of -1 (their rows are never read); a
    disallowed row is scored and then masked.  With ``qnorms`` and
    ``metric`` the scores are metric-adjusted by the same ``adjust_scores``
    as the full scan, so a candidate's score equals its full-scan score
    wherever the raw scores are equal.
    """
    valid = cand >= 0
    rows = cand.clamp(min=0).long()
    scores = score_gathered_raw(packed, q_rot, cand, bits=bits, n4_dims=n4_dims)
    if qnorms is not None:
        if metric is None:
            raise ValueError("metric is required to adjust scores")
        scores = adjust_scores(scores, qnorms[rows], metric)
    if allow_mask is not None:
        valid = valid & allow_mask[rows]
    return torch.where(valid, scores, float(NEG))
