"""The plain search: exact scores over the 4-bit codes, the top-k, and the
sign cascade's survivors.

Scores are worked out in f64 (the program's are f32): the rotated query
dotted with each row's dequantized codes, over the row's dequantized norm
(cosine).  The full scan's top-k is the k best of every row; the cascade's
survivors are the m rows of least Hamming distance between the query's sign
bits (rotated value >= 0) and the row's (code >= 8), ties to the lower row,
and its answer is the k best of those.

``precision="tf32"`` is the control: the scores as an f32 product whose
inputs are rounded to TF32, the precision below the configuration's f32.
"""

from __future__ import annotations

import contextlib
from typing import Tuple

import torch

from . import encode as enc

#: Corpus rows dequantized at a time.
CORPUS_BLOCK = 1 << 16
#: Query rows per survivor selection (bounds the [rows, n] proxies).
QUERY_BLOCK = 128


@contextlib.contextmanager
def exact_matmul():
    """f32 products in full f32 (no TF32) for the duration."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def _block_scores(q_rot: torch.Tensor, packed: torch.Tensor, precision: str) -> torch.Tensor:
    """[b, rows] cosine scores of rotated queries against a block of codes."""
    deq = enc.dequantize64(packed)
    qn = torch.linalg.vector_norm(deq, dim=-1).clamp(min=1e-12)
    if precision == "f64":
        return (q_rot.double() @ deq.T) / qn
    if precision == "tf32":
        raw = enc.to_tf32(q_rot.float()) @ enc.to_tf32(deq.float()).T
        return raw.double() / qn
    raise ValueError(f"unknown precision {precision!r}")


def topk_full(q_rot: torch.Tensor, packed: torch.Tensor, k: int, precision: str = "f64"
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scores [b, k] f64 descending, rows [b, k] int64) over every row;
    equal scores go to the lower row."""
    with exact_matmul():
        best_v = best_i = None
        for lo in range(0, packed.shape[0], CORPUS_BLOCK):
            s = _block_scores(q_rot, packed[lo:lo + CORPUS_BLOCK], precision)
            rows = torch.arange(lo, lo + s.shape[1], device=s.device).expand_as(s)
            if best_v is not None:
                s, rows = torch.cat([best_v, s], 1), torch.cat([best_i, rows], 1)
            v, j = torch.sort(s, dim=1, descending=True, stable=True)
            best_v, best_i = v[:, :k], torch.gather(rows, 1, j[:, :k])
    return best_v, best_i


def scores_at(q_rot: torch.Tensor, packed: torch.Tensor, rows: torch.Tensor
              ) -> torch.Tensor:
    """[b, k] f64 scores of query i against rows[i, :] (each in [0, n))."""
    with exact_matmul():
        deq = enc.dequantize64(packed[rows.reshape(-1)]).reshape(rows.shape + (-1,))
        qn = torch.linalg.vector_norm(deq, dim=-1).clamp(min=1e-12)
        return torch.einsum("bd,bkd->bk", q_rot.double(), deq) / qn


def survivors(q_rot: torch.Tensor, signs: torch.Tensor, m: int) -> torch.Tensor:
    """[b, m] int64 rows of least Hamming distance to each query's sign bits,
    ties to the lower row.  ``signs`` are the rows' sign bits as +-1 f32
    [n, d'] computed block by block by the caller's ``sign_planes``."""
    d_pad = q_rot.shape[1]
    qs = torch.where(q_rot >= 0, 1.0, -1.0).float()
    out = []
    with exact_matmul():
        for lo in range(0, qs.shape[0], QUERY_BLOCK):
            agree = torch.cat([qs[lo:lo + QUERY_BLOCK] @ blk.T for blk in signs], dim=1)
            hamming = ((d_pad - agree) / 2).round().to(torch.int32)
            order = torch.sort(hamming, dim=1, stable=True).indices
            out.append(order[:, :min(m, hamming.shape[1])])
    return torch.cat(out)


def sign_planes(packed: torch.Tensor) -> list:
    """The rows' sign bits (code >= 8) as +-1 f32 blocks of CORPUS_BLOCK rows."""
    return [torch.where(enc.unpack(packed[lo:lo + CORPUS_BLOCK]) >= 8, 1.0, -1.0).float()
            for lo in range(0, packed.shape[0], CORPUS_BLOCK)]


def topk_among(q_rot: torch.Tensor, packed: torch.Tensor, cand: torch.Tensor, k: int,
               precision: str = "f64") -> Tuple[torch.Tensor, torch.Tensor]:
    """(scores [b, k] f64 descending, rows [b, k]) of the best k of each
    query's candidate rows ``cand`` [b, m]; equal scores go to the lower row."""
    with exact_matmul():
        if precision == "f64":
            s = scores_at(q_rot, packed, cand)
        else:
            deq = enc.dequantize64(packed[cand.reshape(-1)]).reshape(cand.shape + (-1,))
            qn = torch.linalg.vector_norm(deq, dim=-1).clamp(min=1e-12)
            raw = torch.einsum("bd,bkd->bk", enc.to_tf32(q_rot.float()),
                               enc.to_tf32(deq.float()))
            s = raw.double() / qn
        order = torch.argsort(cand, dim=1)
        s, cand = torch.gather(s, 1, order), torch.gather(cand, 1, order)
        v, j = torch.sort(s, dim=1, descending=True, stable=True)
    return v[:, :k], torch.gather(cand, 1, j[:, :k])
