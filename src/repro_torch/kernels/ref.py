"""Plain PyTorch versions of the port's kernels (counterpart of
``repro/kernels/ref.py``).

The simplest correct implementation of each kernel's function: the CPU path
runs them, the tests hold them against the reference, and ``chip_smoke.py``
holds every CUDA kernel against them on the card.

The full-corpus dot runs in fixed 8-query chunks, as the reference's does: a
plain ``[b, d] @ [d, n]`` may pick another reduction strategy per shape, so
the same query row could score differently at different batch sizes.  With
the chunk shape fixed, each row's score depends only on (row, corpus).  The
gathered rescore's batched product is chunked the same way.
"""

from __future__ import annotations

import torch

from ..core import lloydmax
from ..core.quantize import unpack_2bit, unpack_4bit
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


def crumb_dot_ref(packed: torch.Tensor, q_rot: torch.Tensor) -> torch.Tensor:
    """[n, d/4] packed uint8 (2-bit codes), [b, d] rotated f32 queries -> [b, n]."""
    deq = lloydmax.dequantize(unpack_2bit(packed), 2)
    return _chunked_dot(q_rot, deq.T)


def mixed_dot_ref(packed: torch.Tensor, q_rot: torch.Tensor, n4_dims: int) -> torch.Tensor:
    """Mixed [4-bit block | 2-bit block] rows: the sum of the two blocks' scores."""
    b4 = n4_dims // 2
    return (nibble_dot_ref(packed[:, :b4], q_rot[:, :n4_dims])
            + crumb_dot_ref(packed[:, b4:], q_rot[:, n4_dims:]))


def hadamard_ref(x: torch.Tensor) -> torch.Tensor:
    """Direct H @ x on the last axis (unnormalized), the O(d^2) oracle."""
    h = torch.tensor(hadamard_matrix(x.shape[-1]), device=x.device)
    return x @ h.T


# ---------------------------------------------------------------------------
# Binarized coarse proxies and the gathered rescore.
# ---------------------------------------------------------------------------

#: Set bits of every byte value.
_POPCOUNT8 = torch.tensor([bin(v).count("1") for v in range(256)], dtype=torch.uint8)

#: Elements of the [b, rows, bytes] intermediate per chunk of corpus rows.
_CHUNK_ELEMENTS = 1 << 24


def _popcount_rows(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each row of a uint8 tensor, summed over the last axis (int32)."""
    return _POPCOUNT8.to(x.device)[x.long()].sum(dim=-1, dtype=torch.int32)


def _pairwise_popcounts(qcodes: torch.Tensor, codes: torch.Tensor, op) -> torch.Tensor:
    """[b, n] int32: popcount(op(qcodes[q], codes[r])) summed over bytes, in
    chunks of corpus rows so the [b, chunk, bytes] intermediate stays bounded."""
    b, nbytes = qcodes.shape
    chunk = max(1, _CHUNK_ELEMENTS // max(1, b * nbytes))
    return torch.cat([_popcount_rows(op(qcodes[:, None, :], codes[None, lo:lo + chunk, :]))
                      for lo in range(0, codes.shape[0], chunk)], dim=1)


def sign_hamming_ref(cbits: torch.Tensor, qbits: torch.Tensor) -> torch.Tensor:
    """[n, d'/8] uint8, [b, d'/8] uint8 packed sign bits -> [b, n] int32 Hamming distances."""
    return _pairwise_popcounts(qbits, cbits, torch.bitwise_xor)


def crumb_affinity_ref(ccodes: torch.Tensor, qplanes: torch.Tensor) -> torch.Tensor:
    """[n, d'/4] uint8, [b, d'/4] uint8 crumb planes (hi || lo) -> [b, n] int32
    affinities: the four weighted AND+popcount terms plus the rank-1 terms
    ``9 d' - 12 pc(qhi) - 6 pc(qlo) - 12 pc(chi) - 6 pc(clo)``."""
    dkp = ccodes.shape[1] // 2
    chi, clo = ccodes[:, :dkp], ccodes[:, dkp:]
    qhi, qlo = qplanes[:, :dkp], qplanes[:, dkp:]
    cross = (16 * _pairwise_popcounts(qhi, chi, torch.bitwise_and)
             + 8 * _pairwise_popcounts(qhi, clo, torch.bitwise_and)
             + 8 * _pairwise_popcounts(qlo, chi, torch.bitwise_and)
             + 4 * _pairwise_popcounts(qlo, clo, torch.bitwise_and))
    row = 12 * _popcount_rows(chi) + 6 * _popcount_rows(clo)          # [n]
    qc = 12 * _popcount_rows(qhi) + 6 * _popcount_rows(qlo)           # [b]
    return cross + (9 * 8 * dkp - qc)[:, None] - row[None, :]


def _gather_dot(packed: torch.Tensor, q_rot: torch.Tensor, cand: torch.Tensor,
                bits: int) -> torch.Tensor:
    n = packed.shape[0]
    valid = (cand >= 0) & (cand < n)
    rows = packed[cand.long().clamp(0, n - 1)]                       # [b, m, bytes]
    codes = unpack_4bit(rows) if bits == 4 else unpack_2bit(rows)
    deq = lloydmax.dequantize(codes, bits)                           # [b, m, d']
    scores = _chunked_bmm(deq, q_rot)
    return torch.where(valid, scores, torch.zeros((), device=scores.device))


def _chunked_bmm(deq: torch.Tensor, q_rot: torch.Tensor) -> torch.Tensor:
    """[b, m, d] x [b, d] -> [b, m] in fixed 8-query batches: a plain
    ``bmm`` over all b may split a query's dot another way at another b
    (on the CPU, one query's product runs across threads), so the batch
    shape is fixed as ``_chunked_dot`` fixes the full scan's."""
    b = deq.shape[0]
    pad = (-b) % _ROW_CHUNK
    if pad:
        deq = torch.cat([deq, deq.new_zeros((pad,) + tuple(deq.shape[1:]))])
        q_rot = torch.cat([q_rot, q_rot.new_zeros((pad, q_rot.shape[1]))])
    out = torch.cat([torch.bmm(deq[i:i + _ROW_CHUNK], q_rot[i:i + _ROW_CHUNK, :, None])[..., 0]
                     for i in range(0, deq.shape[0], _ROW_CHUNK)])
    return out[:b]


def gather_nibble_dot_ref(packed: torch.Tensor, q_rot: torch.Tensor,
                          cand: torch.Tensor) -> torch.Tensor:
    """[n, d'/2] uint8, [b, d'] f32, [b, m] int rows -> [b, m] raw scores of
    each query against its candidate rows; a row outside [0, n) scores 0."""
    return _gather_dot(packed, q_rot, cand, 4)


def gather_crumb_dot_ref(packed: torch.Tensor, q_rot: torch.Tensor,
                         cand: torch.Tensor) -> torch.Tensor:
    """The 2-bit version of ``gather_nibble_dot_ref``: [n, d'/4] uint8 rows."""
    return _gather_dot(packed, q_rot, cand, 2)


def gather_mixed_dot_ref(packed: torch.Tensor, q_rot: torch.Tensor, cand: torch.Tensor,
                         n4_dims: int) -> torch.Tensor:
    """Mixed rows: the sum of the two blocks' gathered scores."""
    b4 = n4_dims // 2
    return (gather_nibble_dot_ref(packed[:, :b4], q_rot[:, :n4_dims], cand)
            + gather_crumb_dot_ref(packed[:, b4:], q_rot[:, n4_dims:], cand))
