"""Hybrid dense + sparse retrieval as an engine path (counterpart of
``repro/engine/fusion.py``; DESIGN.md §8, paper §3.6).

  1. dense channel: one bucketed ``search_backend`` call over the whole
     query batch, with ``allow`` and ``where`` in the plan's live-mask
     stage (on the card, a replay of the plan's captured graph);
  2. sparse channel: per-row BM25 top-``fetch_k`` on the host with the same
     combined allowlist and predicate row mask applied before the top-k,
     so a selective filter still surfaces ``fetch_k`` candidates a channel;
  3. RRF merge: ``rrf_fuse`` per row, ties by the smaller id.

A single query (1-D ``query_vec``, ``str`` text) returns 1-D ``(scores,
ids)``, possibly shorter than ``k`` when the candidate pool is small.  A
batch returns ``[b, k]`` arrays, rows independently equal to their
single-query results, padded with id -1 / score 0.0.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import obs
from ..core import predicate as pred
from ..core.allowlist import Allowlist
from ..core.rrf import rrf_fuse
from ..core.segments import SENTINEL_ID
from .plan import search_backend


#: The stage factories the determinism audit must witness (analysis/grid.py).
PLAN_STAGES = ("search_hybrid",)


def _sparse_mask(index, allow: Optional[Allowlist],
                 where: Optional[pred.Predicate]) -> Optional[np.ndarray]:
    """The combined allowlist and predicate row mask for the BM25 channel,
    evaluated on the host against the column values (the oracle the dense
    channel's mask stage equals), so both channels filter alike."""
    mask = None if allow is None else np.asarray(allow.mask, dtype=bool)
    if where is not None:
        if index.meta is None or not index.meta:
            raise ValueError("where= requires a hybrid index built with metadata columns")
        pred.validate(where, index.meta)
        pm = pred.evaluate(where, index.meta)
        mask = pm if mask is None else mask & pm
    return mask


def search_hybrid(index, query_vec, query_text: Union[str, Sequence[str]], k: int = 10, *,
                  fetch_k: Optional[int] = None, rrf_k: int = 60,
                  allow: Optional[Allowlist] = None,
                  where: Optional[pred.Predicate] = None) -> Tuple[np.ndarray, np.ndarray]:
    """Filtered hybrid search of a ``HybridIndex`` (module docstring):
    ``query_vec`` is [d] with a ``str`` text, or [b, d] with ``b`` texts."""
    fetch_k = fetch_k or max(2 * k, 20)
    qv = query_vec if isinstance(query_vec, torch.Tensor) else np.asarray(query_vec,
                                                                          dtype=np.float32)
    single = qv.ndim == 1
    texts = [query_text] if isinstance(query_text, str) else list(query_text)
    b = 1 if single else int(qv.shape[0])
    if len(texts) != b:
        raise ValueError(f"hybrid search: {b} query rows but {len(texts)} query texts")
    for t in texts:
        if not isinstance(t, str):
            raise TypeError(f"query text must be a string, got {t!r}")

    obs.inc("engine.hybrid_searches")
    # Dense channel: one bucketed plan run for the whole batch, the
    # predicate in the plan's mask stage.
    _, dense_ids = search_backend(index.dense, None, qv, fetch_k, allow=allow, where=where,
                                  meta=index.meta)
    with obs.timed_span("hybrid.sparse_fuse", histogram="engine.stage_us",
                        labels={"backend": "HybridIndex", "stage": "sparse_fuse"},
                        attrs={"rows": b}):
        return _fuse_rows(index, texts, dense_ids, allow, where, fetch_k, rrf_k, k, b,
                          single)


def _fuse_rows(index, texts, dense_ids, allow, where, fetch_k, rrf_k, k, b, single):
    mask = _sparse_mask(index, allow, where)
    corpus_ids = np.asarray(index.dense.ids)
    out_vals = np.zeros((b, k), dtype=np.float32)
    out_ids = np.full((b, k), -1, dtype=np.int64)
    for i in range(b):
        # A selective filter can return fewer than fetch_k real rows:
        # SENTINEL_ID slots must not enter the fusion as if they were docs.
        drow = dense_ids[i]
        drow = drow[drow != SENTINEL_ID]
        _, sparse_rows = index.sparse.search(texts[i], fetch_k, allow_mask=mask)
        vals, ids = rrf_fuse([drow, corpus_ids[sparse_rows]], k=rrf_k, top_k=k)
        if single:
            return vals, ids
        out_vals[i, :ids.shape[0]] = vals
        out_ids[i, :ids.shape[0]] = ids
    return out_vals, out_ids
