"""Deterministic synthetic embedding corpora (copy of the MonaVec part of
``repro/data/synthetic.py``).

Every array is a pure function of its seed: counter-based Philox streams,
so both packages draw the same corpus and the same queries.
"""

from __future__ import annotations

import numpy as np


def _rng(seed: int, step: int, stream: int = 0) -> np.random.Generator:
    return np.random.Generator(np.random.Philox(key=seed, counter=[step, stream, 0, 0]))


def embedding_corpus(seed: int, n: int, dim: int, *, n_clusters: int = 64,
                     noise: float = 0.25) -> np.ndarray:
    """Clustered vectors with semantic-embedding-like geometry (the AG News
    surrogate: clusters are topics).  Per-document noise scales are drawn from
    U(0.3, 1.5)x, so within-cluster similarities are graded."""
    g = _rng(seed, 0, 2)
    centers = g.standard_normal((n_clusters, dim)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    assign = g.integers(0, n_clusters, size=n)
    scale = (noise * (0.3 + 1.2 * g.random(n))).astype(np.float32)
    x = centers[assign] + scale[:, None] * g.standard_normal((n, dim)).astype(np.float32)
    return x.astype(np.float32)


def pixel_corpus(seed: int, n: int, dim: int) -> np.ndarray:
    """Raw-magnitude, non-Gaussian data (the fashion-mnist surrogate): sparse
    positive "pixels" with block structure, the setting where fit() matters."""
    g = _rng(seed, 0, 3)
    base = g.random((n, dim)).astype(np.float32) * 255.0
    mask = g.random((n, dim)) < 0.55                  # many near-zero pixels
    out = np.where(mask, 0.0, base)
    prototypes = g.random((10, dim)).astype(np.float32) * 128.0
    out += prototypes[g.integers(0, 10, size=n)]
    return out.astype(np.float32)


def queries_from_corpus(corpus: np.ndarray, seed: int, n_q: int,
                        noise: float = 0.15) -> np.ndarray:
    """Noisy copies of seeded corpus rows."""
    g = _rng(seed, 1, 4)
    idx = g.integers(0, len(corpus), size=n_q)
    q = corpus[idx] + noise * g.standard_normal((n_q, corpus.shape[1])).astype(np.float32)
    return q.astype(np.float32)
