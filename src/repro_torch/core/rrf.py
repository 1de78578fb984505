"""Reciprocal Rank Fusion (counterpart of ``repro/core/rrf.py``; paper
§3.6): RRF(d) = sum_i 1 / (k + rank_i(d))."""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np


def rrf_fuse(rankings: Sequence[np.ndarray], *, k: int = 60, top_k: int = 10
             ) -> Tuple[np.ndarray, np.ndarray]:
    """Fuse ranked id lists (best first) into (fused scores f32, ids int64);
    ties are broken by the smaller id."""
    scores: Dict[int, float] = {}
    for ranking in rankings:
        for rank, doc in enumerate(np.asarray(ranking).tolist()):
            scores[int(doc)] = scores.get(int(doc), 0.0) + 1.0 / (k + rank + 1)
    items = sorted(scores.items(), key=lambda kv: (-kv[1], kv[0]))[:top_k]
    if not items:
        return np.zeros(0, np.float32), np.zeros(0, np.int64)
    ids = np.array([i for i, _ in items], dtype=np.int64)
    vals = np.array([v for _, v in items], dtype=np.float32)
    return vals, ids
