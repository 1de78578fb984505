"""Plain PyTorch versions of the port's kernels (counterpart of
``repro/kernels/ref.py``).

The simplest correct implementation of each kernel's function: the CPU path
runs them, the tests hold them against the reference, and ``chip_smoke.py``
holds every CUDA kernel against them on the card.

The full-corpus dot runs in fixed 8-query chunks, as the reference's does: a
plain ``[b, d] @ [d, n]`` may pick another reduction strategy per shape, so
the same query row could score differently at different batch sizes.  With
the chunk shape fixed, each row's score depends only on (row, corpus).
"""

from __future__ import annotations

import torch

from ..core import lloydmax
from ..core.quantize import unpack_4bit
from ..core.rhdh import hadamard_matrix

_ROW_CHUNK = 8


def _chunked_dot(q_rot: torch.Tensor, deq_t: torch.Tensor) -> torch.Tensor:
    """[b, d] @ [d, n] in fixed [8, d] query chunks (batch-size-stable)."""
    b, d = q_rot.shape
    pad = (-b) % _ROW_CHUNK
    if pad:
        q_rot = torch.cat([q_rot, q_rot.new_zeros((pad, d))])
    out = torch.cat([q_rot[i:i + _ROW_CHUNK] @ deq_t
                     for i in range(0, q_rot.shape[0], _ROW_CHUNK)])
    return out[:b]


def nibble_dot_ref(packed: torch.Tensor, q_rot: torch.Tensor) -> torch.Tensor:
    """[n, d/2] packed uint8, [b, d] rotated f32 queries -> [b, n] raw scores."""
    deq = lloydmax.dequantize(unpack_4bit(packed), 4)      # [n, d] f32
    return _chunked_dot(q_rot, deq.T)


def hadamard_ref(x: torch.Tensor) -> torch.Tensor:
    """Direct H @ x on the last axis (unnormalized), the O(d^2) oracle."""
    h = torch.tensor(hadamard_matrix(x.shape[-1]), device=x.device)
    return x @ h.T
