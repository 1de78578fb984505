# Query-execution engine (DESIGN.md §7): search plans replayed as CUDA graphs
# on the card, the shape-bucketed plan cache, the bound Searcher handle, the
# micro-batched multi-tenant serving queue and the hybrid dense + BM25 path.

from ..obs import DeltaStats

from .batcher import BatcherStats, MicroBatcher, Ticket
from .fusion import search_hybrid
from .plan import (PlanCache, PlanKey, PlanStats, SearchPlan, Searcher, plan_cache,
                   plan_key_digest, resolve_knobs, search_backend, search_eager,
                   search_sharded, set_stage_observer, shape_bucket)

__all__ = [
    "BatcherStats", "DeltaStats", "MicroBatcher", "Ticket",
    "PlanCache", "PlanKey", "PlanStats", "SearchPlan", "Searcher",
    "plan_cache", "plan_key_digest", "resolve_knobs", "search_backend", "search_eager",
    "search_hybrid", "search_sharded", "set_stage_observer", "shape_bucket",
]
