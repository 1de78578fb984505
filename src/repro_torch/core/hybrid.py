"""Hybrid dense + sparse retrieval (counterpart of ``repro/core/hybrid.py``;
paper §3.6): MonaVec dense + BM25, fused by RRF.

A facade over ``engine.fusion``: the dense channel is one bucketed
BruteForce plan (on the card, a replay of its captured graph), BM25 stays on
the host under the same combined allowlist and predicate pre-filter, and the
RRF merge is the deterministic host stage.  ``[b, d]`` vectors with ``b``
texts return ``[b, k]`` results, each row its single-query run's.

    hy = HybridIndex.build(vectors, docs, meta={"lang": langs})   # on the card
    scores, ids = hy.search(query_vec, "query text", k=10)        # 1-D
    scores, ids = hy.search(query_vecs, texts, k=10, where=Eq("lang", "en"))
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device
from .allowlist import Allowlist
from .bm25 import Bm25Index
from .bruteforce import BruteForceIndex
from .metadata import MetaStore
from .predicate import Predicate


@dataclasses.dataclass
class HybridIndex:
    dense: BruteForceIndex
    sparse: Bm25Index
    meta: Optional[MetaStore] = None

    @staticmethod
    def build(vectors, docs: Sequence[str], *, metric: str = "cosine",
              seed: int = 0x6D6F6E61, std=None, meta: Optional[dict] = None,
              device: torch.device | str = "cuda") -> "HybridIndex":
        """A 4-bit BruteForce index of ``vectors`` on ``device`` and a BM25
        index of ``docs`` (one per row) on the host; ``meta`` names per-row
        columns that ``where=`` filters both channels by."""
        x = torch.as_tensor(vectors, dtype=torch.float32).to(resolve_device(device))
        if x.shape[0] != len(docs):
            raise ValueError(f"{x.shape[0]} vectors but {len(docs)} docs")
        store = MetaStore.build(meta, int(x.shape[0])) if meta else None
        return HybridIndex(dense=BruteForceIndex.build(x, metric=metric, seed=seed, std=std),
                           sparse=Bm25Index.build(docs), meta=store)

    def search(self, query_vec, query_text: Union[str, Sequence[str]], k: int = 10, *,
               fetch_k: Optional[int] = None, rrf_k: int = 60,
               allow: Optional[Allowlist] = None, where: Optional[Predicate] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Hybrid top-k through the engine (``engine.fusion``).

        Single query (1-D vec + str): 1-D ``(scores, ids)``, possibly
        shorter than ``k`` when the fused candidate pool is small.  Batch
        ([b, d] vec + b texts): ``[b, k]`` arrays, rows padded with id -1 /
        score 0.0.  ``where=`` filters both channels through the index's
        metadata columns (§3.5 pre-filter semantics).
        """
        from ..engine import fusion
        return fusion.search_hybrid(self, query_vec, query_text, k, fetch_k=fetch_k,
                                    rrf_k=rrf_k, allow=allow, where=where)
