"""Exact predicate-selectivity counts (counterpart of
``repro/tune/selectivity.py``; DESIGN.md §12).

Filtered IVF recall collapses at low selectivity because candidate lists are
cut BEFORE the predicate mask; the boost curve (``tune.autotune``) fixes it
and needs, per search, how selective the predicate is.  "Estimate" here is
an EXACT count: the mask of ``predicate.build_stage_fn`` (the lowering the
engine puts into its plans) ANDed with the live mask on the index's device,
summed in int64 and read back with one ``.item()``.  Exactness keeps the
boost decision deterministic: cache keys and plan keys never hang on a
sampling RNG.

The count is a host sync, so the engine takes it while it resolves a
search, before the plan is keyed and outside any CUDA graph capture (a
capture may hold no device-to-host read).  Two caches keep it off the
repeated path:

  * one stage function per predicate STRUCTURE (constants are operands, so
    ``Eq("a", 1)`` and ``Eq("a", 2)`` share it);
  * an LRU of 256 counts keyed by (structure, encoded constants, the used
    columns' version tokens, row count, live-mask digest).  A column's
    ``version`` is minted when it is built and every mutation builds new
    ``Column`` objects, so a new token is a sound staleness signal without
    hashing the values.
"""

from __future__ import annotations

import collections
from typing import Callable, Dict, Optional

import numpy as np
import torch

from .. import obs
from ..core import predicate as pred_mod
from ..core.metadata import MetaStore, encode_constant
from ..device import resolve_device

#: The stage factory the determinism audit must witness (analysis/grid.py).
PLAN_STAGES = ("make_popcount_fn",)
#: The stage name the count reports under to the engine's stage observer.
_STAGE_NAME = "selectivity_popcount"

#: structure -> stage function ``fn(live, *args) -> [] int64 count``
_FN_CACHE: Dict[tuple, Callable] = {}

#: LRU of exact counts; bounded so a long-lived server cannot grow it.
_COUNT_CACHE: "collections.OrderedDict[tuple, int]" = collections.OrderedDict()
_COUNT_CACHE_MAX = 256


def make_popcount_fn(p: "pred_mod.Predicate") -> Callable[..., torch.Tensor]:
    """``fn(live, *args) -> int64 count of live & mask`` (a 0-d tensor),
    with ``predicate.build_stage_fn``'s arguments: per leaf, the column's
    key plane and the constant's key.  The sum is integer, so the count is
    exact on any device."""
    mask_fn = pred_mod.build_stage_fn(p)

    def popcount(live: torch.Tensor, *args: torch.Tensor) -> torch.Tensor:
        return torch.sum(mask_fn(live, *args), dtype=torch.int64)

    return popcount


def _constants_key(p: "pred_mod.Predicate", store: MetaStore) -> tuple:
    """Encoded constants per leaf, preorder: hashable and exact."""
    out = []
    for leaf in pred_mod._leaves(p):
        col = store[leaf.col]
        vocab = col.vocab_map()
        values = leaf.values if isinstance(leaf, pred_mod.In) else (leaf.value,)
        out.append(tuple(encode_constant(col.kind, v, vocab) for v in values))
    return tuple(out)


def _live_key(live: Optional[np.ndarray]) -> Optional[tuple]:
    if live is None:
        return None
    arr = np.asarray(live, dtype=bool)
    return (int(arr.shape[0]), hash(arr.tobytes()))


def estimate_matches(p: "pred_mod.Predicate", store: MetaStore,
                     live: Optional[np.ndarray] = None, *,
                     device: torch.device | str = "cuda") -> int:
    """Exact count of the rows passing ``p`` (of the ``live`` rows if given,
    an [n_rows] bool mask), counted on ``device`` on a cache miss."""
    dev = resolve_device(device)
    structure = pred_mod.structure(p, store)
    used = dict.fromkeys(pred_mod.leaf_columns(p))
    key = (structure, _constants_key(p, store), tuple(store[c].version for c in used),
           store.n_rows, _live_key(live))
    hit = _COUNT_CACHE.get(key)
    if hit is not None:
        _COUNT_CACHE.move_to_end(key)
        obs.inc("tune.selectivity_cache.hits")
        return hit
    obs.inc("tune.selectivity_cache.misses")

    fn = _FN_CACHE.get(structure)
    if fn is None:
        fn = _FN_CACHE[structure] = make_popcount_fn(p)
    if live is None:
        live_t = torch.ones(store.n_rows, dtype=torch.bool, device=dev)
    else:
        live_t = torch.from_numpy(np.array(live, dtype=bool)).to(dev)
    args = []
    for col, const in zip(pred_mod.leaf_columns(p), pred_mod.constant_keys(p, store)):
        args += [store[col].on(dev), torch.from_numpy(np.array(const)).to(dev)]
    from ..engine import plan as plan_mod
    plan_mod.observe("SelectivityEstimator", _STAGE_NAME, fn, (live_t, *args))
    count = int(fn(live_t, *args).item())
    _COUNT_CACHE[key] = count
    while len(_COUNT_CACHE) > _COUNT_CACHE_MAX:
        _COUNT_CACHE.popitem(last=False)
    return count


def clear_caches() -> None:
    """Drop both caches (tests; never needed for correctness)."""
    _FN_CACHE.clear()
    _COUNT_CACHE.clear()


__all__ = ["PLAN_STAGES", "clear_caches", "estimate_matches", "make_popcount_fn"]
