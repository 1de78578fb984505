"""Asymmetric scoring (paper §3.3): metric adjustment, exact f32 ground
truth, and the stable top-k.

Metric adjustments (q_norm = ||dequantized rotated vector||):
    cosine: s / q_norm
    dot:    s
    l2:     s - q_norm^2 / 2   (HIGHER = closer)
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..kernels import topk_select
from .allowlist import NEG
from .standardize import COSINE, DOT, L2


def adjust_scores(raw: torch.Tensor, qnorms: torch.Tensor, metric: str) -> torch.Tensor:
    """Apply the per-metric score correction.  raw: [..., n]; qnorms: [n]."""
    if metric == COSINE:
        return raw / torch.clamp(qnorms, min=1e-12)
    if metric == DOT:
        return raw
    if metric == L2:
        return raw - 0.5 * qnorms * qnorms
    raise ValueError(f"unknown metric {metric!r}")


def score_packed_ref(q_rot: torch.Tensor, enc) -> torch.Tensor:
    """Reference scoring: [b, d'] rotated f32 queries against an ``Encoded``
    corpus -> adjusted [b, n].  Decodes the whole corpus, then one product:
    the plain oracle for small corpora (an O(n d') f32 intermediate)."""
    from . import quantize as qz

    raw = q_rot @ qz.decode(enc).T
    return adjust_scores(raw, enc.qnorms, enc.metric)


def score_f32(q: torch.Tensor, corpus: torch.Tensor, metric: str) -> torch.Tensor:
    """Exact f32 scores, higher is better (the ground truth for recall)."""
    if metric == COSINE:
        qn = q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True), min=1e-12)
        cn = corpus / torch.clamp(torch.linalg.vector_norm(corpus, dim=-1, keepdim=True),
                                  min=1e-12)
        return qn @ cn.T
    if metric == DOT:
        return q @ corpus.T
    if metric == L2:
        q2 = torch.sum(q * q, dim=-1, keepdim=True)
        v2 = torch.sum(corpus * corpus, dim=-1)
        return 2.0 * (q @ corpus.T) - q2 - v2[None, :]
    raise ValueError(f"unknown metric {metric!r}")


def topk(scores: torch.Tensor, k: int,
         live: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k of the last axis with the reference's tie rule: among equal
    scores the lower index wins, as with ``jax.lax.top_k``.  With ``live``
    ([n] bool) a dead column scores NEG.

    Rows that ``kernels.topk_select.fits`` (2-D f32, k <= ``K_MAX``, no
    gradient wanted; for k > 32 wider than 4,096) go to the top-k select
    kernel (its plain version off the card); any other keeps a stable
    descending sort cut to k (``torch.topk`` gives no such order).  Both
    give the same bytes."""
    if topk_select.fits(scores, k):
        return topk_select.select(scores, k, live)
    if live is not None:
        scores = scores.masked_fill(~live, float(NEG))
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]
