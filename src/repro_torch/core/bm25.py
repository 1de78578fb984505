"""BM25 sparse index (counterpart of ``repro/core/bm25.py``; paper §3.6):
term-based, zero-training, offline.

A host inverted index with numpy postings (float32 term frequencies), the
reference's tokenizer (``[^\\W_]+`` over lowercased Unicode text: runs of
letters and digits, split at ``_``) and its scoring, accumulated term by
term in doc order, so the same docs and query give the same bytes.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

_TOKEN_RE = re.compile(r"[^\W_]+", re.UNICODE)


def tokenize(text: str) -> List[str]:
    return _TOKEN_RE.findall(text.lower())


@dataclasses.dataclass
class Bm25Index:
    postings: Dict[str, Tuple[np.ndarray, np.ndarray]]  # term -> (doc rows, tf)
    doc_len: np.ndarray
    avg_len: float
    n_docs: int
    k1: float = 1.2
    b: float = 0.75

    @staticmethod
    def build(docs: Sequence[str], *, k1: float = 1.2, b: float = 0.75) -> "Bm25Index":
        tf_maps: List[Dict[str, int]] = []
        for doc in docs:
            tf: Dict[str, int] = {}
            for tok in tokenize(doc):
                tf[tok] = tf.get(tok, 0) + 1
            tf_maps.append(tf)
        doc_len = np.array([sum(m.values()) for m in tf_maps], dtype=np.float32)
        inv: Dict[str, List[Tuple[int, int]]] = {}
        for row, tf in enumerate(tf_maps):
            for term, c in tf.items():
                inv.setdefault(term, []).append((row, c))
        postings = {
            t: (np.array([r for r, _ in ps], dtype=np.int64),
                np.array([c for _, c in ps], dtype=np.float32))
            for t, ps in inv.items()
        }
        return Bm25Index(postings=postings, doc_len=doc_len,
                         avg_len=float(doc_len.mean()) if len(doc_len) else 0.0,
                         n_docs=len(docs), k1=k1, b=b)

    def idf(self, term: str) -> float:
        df = len(self.postings.get(term, ((), ()))[0])
        return math.log((self.n_docs - df + 0.5) / (df + 0.5) + 1.0)

    def score(self, query: str) -> np.ndarray:
        """Dense score vector over all docs (accumulated in doc order)."""
        scores = np.zeros(self.n_docs, dtype=np.float32)
        for term in tokenize(query):
            if term not in self.postings:
                continue
            rows, tf = self.postings[term]
            denom = tf + self.k1 * (1 - self.b + self.b * self.doc_len[rows]
                                    / max(self.avg_len, 1e-9))
            scores[rows] += self.idf(term) * tf * (self.k1 + 1) / denom
        return scores

    def search(self, query: str, k: int, *, allow_mask: Optional[np.ndarray] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k rows by BM25 score, sorted by (-score, row).  ``allow_mask``
        is the §3.5 pre-filter: disallowed rows are excluded before the
        top-k, so a selective filter still yields min(k, n_allowed) rows."""
        scores = self.score(query)
        rows = np.arange(self.n_docs) if allow_mask is None else np.nonzero(allow_mask)[0]
        k = min(k, len(rows))
        sub = scores[rows]
        order = np.lexsort((rows, -sub))[:k]
        return sub[order], rows[order]
