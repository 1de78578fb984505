"""Search plans and the shape-bucketed plan cache (counterpart of
``repro/engine/plan.py``; DESIGN.md §7).

Every search of a BruteForce index, static or mutated, runs through a
``SearchPlan``: the whole query path (rotate the query under each segment's
seed -> per-segment scan, or coarse proxy / survivor top-m / gathered
rescore -> metric adjustment -> live mask -> stable top-k -> -1 marking),
cached under

    (fingerprint incl. one signature per segment, shape bucket, k, device,
     normalized knobs)

so repeated traffic finds its plan with one dict lookup.  A batch of b
queries is zero-padded up to its power-of-two bucket (``shape_bucket``,
floored at 8); pad rows come out NEG / -1 (their top-k masked by ``q_valid``
after the per-row selection, one [bucket, k] pass instead of one over every
score) and are sliced off, so a bucketed run returns the same bytes as the
rows of a full-bucket run and as the plan's stages run eagerly on the raw b
queries: every score depends only on its (query, row).

On the CPU a plan runs its stages eagerly.  On the card it runs as ONE
captured CUDA graph: the first search of a plan over an index warms the
stages up eagerly on a side stream (which builds the kernels, sets their
attributes and fills the per-device caches of signs, lookup tables and
scalars), discards that result, then captures the stages into a
``torch.cuda.CUDAGraph`` with its own memory pool.  That search and every
later one of the same key copy the queries, the valid-row mask and the
[n_total] live mask into the graph's static inputs and replay it; the
host copy of the result and ``rows_to_ids`` stay outside.  A graph reads
the index's tensors at fixed addresses, so it belongs to the index, not to
the shared plan: the backend's ``graphs`` holds one graph per plan key, over
the tensors of the index's current segments, and holds those tensors.
Dropping the index frees its graphs; ``MonaVec.add`` drops them, and
``compact`` and ``enable_coarse`` replace the backend that holds them.  A
capture over another segment set first frees every graph of the old one, so
an index never keeps graphs it can no longer replay.  A capture that fails
raises: nothing falls back to eager execution.

The live mask (tombstones and allowlist) is an input of the plan, never part
of its key, so ``delete()`` mints no plan and no graph.  ``where=``
predicates are ROADMAP A6, tuned knobs A11, sharded search A12 and the stage
observer A15.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import logging
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import obs
from ..core import binary as bin_mod
from ..core import bruteforce as bf_mod
from ..core import segments as seg
from ..core.allowlist import NEG, Allowlist
from ..core.rhdh import rhdh_apply
from ..core.scoring import adjust_scores, topk
from ..core.standardize import prepare
from ..kernels import cuda_build

_LOG = logging.getLogger("repro_torch.engine.plan")
_NEG = float(NEG)


def _unported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP {item})")


def set_stage_observer(observer):
    raise _unported("the stage observer", "A15")


def shape_bucket(b: int) -> int:
    """Power-of-two batch bucket, floored at 8: the plan cache's shape key."""
    p = 8
    while p < max(b, 1):
        p <<= 1
    return p


# ---------------------------------------------------------------------------
# Cache and keys.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PlanKey:
    fingerprint: tuple            # backend and segment signatures
    bucket: int                   # padded batch size
    k: int
    device: str                   # the index's device: dispatch is by device
    knobs: tuple                  # normalized backend knobs, sorted items


@dataclasses.dataclass
class PlanStats(obs.DeltaStats):
    """Plan-cache counters for a serving window: hits, misses, CUDA graph
    captures (0 on the CPU) and evictions; the same counts go to the
    metrics registry as ``plan_cache.{hits,misses,captures,evictions}``."""

    hits: int = 0
    misses: int = 0
    captures: int = 0
    evictions: int = 0


class _Graph:
    """One captured CUDA graph of a plan over one set of bound tensors: its
    static inputs and outputs, the bound tensors it holds, and the kernel
    launches one replay runs."""

    def __init__(self, fn: Callable, arrays: tuple, bucket: int, dim: int, n_total: int,
                 stats: PlanStats) -> None:
        dev = arrays[0].device
        self.arrays = arrays      # held: no address the graph reads is reused under it
        self.q = torch.zeros((bucket, dim), dtype=torch.float32, device=dev)
        self.q_valid = torch.zeros(bucket, dtype=torch.bool, device=dev)
        self.live = torch.ones(n_total, dtype=torch.bool, device=dev)
        self.b = 0                # rows q_valid marks
        self.live_host: Optional[np.ndarray] = None    # None: every row live
        # Pinned host buffers: the queries go in and the top-k comes out by
        # asynchronous copies, with one wait for the stream per search.
        self.q_host = torch.empty((bucket, dim), dtype=torch.float32, pin_memory=True)
        with torch.cuda.device(dev):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):      # warm-up; its result is discarded
                fn(self.q, self.q_valid, self.live, arrays)
            torch.cuda.current_stream().wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with cuda_build.capture_tally() as tally, torch.cuda.graph(self.graph):
                self.vals, self.pos = fn(self.q, self.q_valid, self.live, arrays)
        self.tally = dict(tally)
        self.vals_host = torch.empty(self.vals.shape, dtype=self.vals.dtype, pin_memory=True)
        self.pos_host = torch.empty(self.pos.shape, dtype=self.pos.dtype, pin_memory=True)
        stats.captures += 1
        obs.inc("plan_cache.captures")

    def reads(self, arrays: tuple) -> bool:
        """Whether this graph was captured over exactly these tensors."""
        return len(arrays) == len(self.arrays) and all(
            a is b for a, b in zip(arrays, self.arrays))

    def replay(self, q: torch.Tensor, b: int, live: Optional[np.ndarray]):
        """The top-k (vals, pos) of rows [:b], on the host."""
        if q.is_cuda:
            self.q.copy_(q)
        else:
            self.q_host.copy_(q)
            self.q.copy_(self.q_host, non_blocking=True)
        if b != self.b:
            self.q_valid[:b].fill_(True)
            self.q_valid[b:].fill_(False)
            self.b = b
        if live is None:
            if self.live_host is not None:
                self.live.fill_(True)
                self.live_host = None
        elif self.live_host is None or not np.array_equal(self.live_host, live):
            self.live.copy_(torch.from_numpy(live))
            self.live_host = live.copy()
        self.graph.replay()
        for wrapper, n in self.tally.items():
            wrapper.launches += n
        self.vals_host.copy_(self.vals, non_blocking=True)
        self.pos_host.copy_(self.pos, non_blocking=True)
        torch.cuda.current_stream().synchronize()
        return self.vals_host[:b].clone(), self.pos_host[:b].clone()


def _on_card(dev: torch.device) -> bool:
    """Whether a plan on ``dev`` runs as a captured graph (else eagerly)."""
    return dev.type == "cuda"


@dataclasses.dataclass
class SearchPlan:
    """One search configuration: ``fn(q, q_valid, live, arrays) -> (vals,
    pos)`` runs its stages eagerly.  The plan holds no tensor and no graph:
    the graphs live with the index (``execute``'s ``graphs``)."""

    key: PlanKey
    fn: Callable
    dim: int
    n_total: int

    def execute(self, q: torch.Tensor, b: int, live: Optional[np.ndarray], arrays: tuple,
                graphs: Dict[PlanKey, _Graph], stats: PlanStats
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(vals, pos) [>= b, k] of ``q`` [bucket, dim], zero-padded after row
        ``b``: a replay of the index's graph of this plan on the card (rows
        [:b], on the host), captured first if ``graphs`` has none over
        ``arrays``; the stages eagerly on the CPU."""
        dev = arrays[0].device
        if not _on_card(dev):
            return self.fn(q.to(dev), *self._masks(b, live, dev), arrays)
        graph = graphs.get(self.key)
        if graph is None or not graph.reads(arrays):
            # Graphs of another segment set (before an add, or over other
            # tensors) can never be replayed again: free them first.
            for key in [key for key in graphs
                        if key.fingerprint != self.key.fingerprint or key == self.key]:
                del graphs[key]
            graph = graphs[self.key] = _Graph(self.fn, arrays, self.key.bucket, self.dim,
                                              self.n_total, stats)
        return graph.replay(q, b, live)

    def run_eager(self, q: torch.Tensor, b: int, live: Optional[np.ndarray],
                  arrays: tuple) -> Tuple[torch.Tensor, torch.Tensor]:
        """The stages run eagerly on the index's device, no graph, at
        whatever number of rows ``q`` has (the bucket, or the raw b)."""
        dev = arrays[0].device
        return self.fn(q.to(dev), *self._masks(b, live, dev, rows=q.shape[0]), arrays)

    def _masks(self, b: int, live: Optional[np.ndarray], dev: torch.device,
               rows: Optional[int] = None):
        q_valid = torch.arange(self.key.bucket if rows is None else rows, device=dev) < b
        live_t = (torch.ones(self.n_total, dtype=torch.bool, device=dev) if live is None
                  else torch.from_numpy(live).to(dev))
        return q_valid, live_t


def plan_key_digest(key: PlanKey) -> str:
    """Short stable fingerprint of a PlanKey (debug logs, trace attrs)."""
    return hashlib.sha256(repr(key).encode()).hexdigest()[:12]


class PlanCache:
    """PlanKey -> SearchPlan: LRU with hit/miss/capture/eviction counts.

    Bounded because mutation mints new fingerprints (every add() or
    compact() changes the segment signature).  A plan holds only its key
    and its stages' closure (scalars), so an evicted plan pins no index and
    no card memory; the graphs live with their index.  Every event lands in
    ``stats`` and in the metrics registry (``plan_cache.*`` counters, size
    and capacity gauges).
    """

    def __init__(self, maxsize: int = 256) -> None:
        self._plans: "collections.OrderedDict[PlanKey, SearchPlan]" = \
            collections.OrderedDict()
        self.maxsize = maxsize
        self.stats = PlanStats()
        self._publish_gauges()

    def _publish_gauges(self) -> None:
        obs.set_gauge("plan_cache.size", len(self._plans))
        obs.set_gauge("plan_cache.capacity", self.maxsize)
        for c in ("hits", "misses", "captures", "evictions"):
            obs.inc(f"plan_cache.{c}", 0)   # snapshots carry the whole family

    def get_or_build(self, key: PlanKey, builder: Callable[[], SearchPlan]) -> SearchPlan:
        plan = self._plans.get(key)
        if plan is not None:
            self._plans.move_to_end(key)
            self.stats.hits += 1
            obs.inc("plan_cache.hits")
            return plan
        self.stats.misses += 1
        obs.inc("plan_cache.misses")
        plan = builder()
        self._plans[key] = plan
        while len(self._plans) > self.maxsize:
            old_key, _ = self._plans.popitem(last=False)   # least recently used
            self.stats.evictions += 1
            obs.inc("plan_cache.evictions")
            if _LOG.isEnabledFor(logging.DEBUG):
                _LOG.debug("plan cache evicted %s (bucket=%d k=%d knobs=%s)",
                           plan_key_digest(old_key), old_key.bucket, old_key.k,
                           dict(old_key.knobs))
        self._publish_gauges()
        return plan

    def clear(self) -> None:
        self._plans.clear()
        self.stats = PlanStats()
        self._publish_gauges()

    def __len__(self) -> int:
        return len(self._plans)


_CACHE = PlanCache()


def plan_cache() -> PlanCache:
    """The process-wide plan cache (shared across indexes and tenants)."""
    return _CACHE


# ---------------------------------------------------------------------------
# Knobs and fingerprints.
# ---------------------------------------------------------------------------

def _std_sig(std: Any) -> Optional[tuple]:
    return None if std is None else (float(std.mean), float(std.inv_std))


def _enc_sig(enc) -> tuple:
    return (enc.n, enc.seed, enc.bits, enc.n4_dims, enc.dim, enc.dim_pad,
            _std_sig(enc.std), enc.perm is not None, enc.coarse)


_BACKEND_KNOBS = {"BruteForceIndex": frozenset({"rescore_mult"})}


def _validate_knobs(backend: Any, kwargs: dict) -> None:
    kind = type(backend).__name__
    unknown = sorted(set(kwargs) - _BACKEND_KNOBS.get(kind, frozenset()))
    if unknown:
        raise TypeError(f"unexpected search kwargs for the {kind} backend: {unknown}")


def _normalize_knobs(backend: Any, extras: Sequence[Any], kwargs: dict, k: int) -> dict:
    """``rescore_mult=r > 0`` selects the binarized cascade with m = r*k
    survivors per segment; None or 0 is the full scan, a negative one or an
    index without coarse codes raises, and when every segment would rescore
    all of its rows (r*k >= the largest segment) the knob normalizes away and
    the plan is the full scan's."""
    rm = kwargs.get("rescore_mult")
    rm = 0 if rm is None else int(rm)
    if rm < 0:
        raise ValueError(f"rescore_mult must be >= 0, got {rm}")
    if rm == 0:
        return {}
    encs = [backend.enc] + [s.enc for s in extras]
    if any(e.ccodes is None for e in encs):
        raise ValueError(
            "rescore_mult requires an index built with a binarized coarse code "
            "(MonaVec.build(..., coarse='sign'|'crumb'))")
    if rm * k >= max(e.n for e in encs):
        return {}   # a rescore of every row is the full scan
    return {"rescore_mult": rm}


def resolve_knobs(backend: Any, state: Any, k: int, *, tuned: Any = None,
                  **kwargs: Any) -> dict:
    """The knobs a search with these arguments runs with; {} is the full scan."""
    if tuned is not None:
        raise _unported("tuned knobs", "A11")
    _validate_knobs(backend, kwargs)
    extras = state.extras if state is not None else []
    return dict(_normalize_knobs(backend, extras, kwargs, k))


def _fingerprint(backend: Any, extras: Sequence[Any]) -> tuple:
    segs = (_enc_sig(backend.enc),) + tuple(_enc_sig(s.enc) for s in extras)
    return (type(backend).__name__, backend.enc.metric, segs)


# ---------------------------------------------------------------------------
# Plan construction.
# ---------------------------------------------------------------------------

def _build_plan(backend: Any, extras: Sequence[Any], key: PlanKey, knobs: dict) -> SearchPlan:
    """The stages of one plan as one function of (q, q_valid, live, arrays).

    The closure holds only scalars (seeds, shapes, metric), never a
    segment, so a plan in the LRU pins no index; the tensors come in as
    ``arrays``: (packed, qnorms[, ccodes]) per segment, then the base's
    permutation index or None.
    """
    enc0 = backend.enc
    metric, bits, n4, std = enc0.metric, enc0.bits, enc0.n4_dims, enc0.std
    seeds = (enc0.seed,) + tuple(s.enc.seed for s in extras)
    seg_ns = (enc0.n,) + tuple(s.enc.n for s in extras)
    offsets = [0] + np.cumsum(seg_ns).tolist()
    n_total, n_segs, k = offsets[-1], len(seeds), key.k

    def rotate(q: torch.Tensor, perm: Optional[torch.Tensor]) -> list:
        """The query prepared once and rotated under each segment's seed
        (``quantize.encode_query``'s ops, so each equals its bytes)."""
        prepared = prepare(q, metric, std)
        rots = []
        for seed in seeds:
            rot = rhdh_apply(prepared, seed, normalized=False)
            rots.append(rot if perm is None else rot[..., perm])
        return rots

    if "rescore_mult" in knobs:
        kind = enc0.coarse
        m = knobs["rescore_mult"] * k
        seg_ms = [min(m, n) for n in seg_ns]
        m_total = sum(seg_ms)

        def fn(q, q_valid, live, arrays):
            score_cols, pos_cols = [], []
            for i, q_rot in enumerate(rotate(q, arrays[-1])):
                packed, qnorms, ccodes = arrays[3 * i: 3 * i + 3]
                off = offsets[i]
                proxy = bin_mod.coarse_scan_stage(q_rot, ccodes, kind=kind)
                cand = bin_mod.survivor_topk_stage(proxy, live[off: off + seg_ns[i]],
                                                   m=seg_ms[i])
                score_cols.append(bin_mod.gathered_rescore_stage(
                    q_rot, packed, qnorms, cand, bits=bits, metric=metric, n4_dims=n4))
                pos_cols.append(cand if off == 0 else torch.where(cand >= 0, cand + off, -1))
            scores = score_cols[0] if n_segs == 1 else torch.cat(score_cols, dim=1)
            gpos = pos_cols[0] if n_segs == 1 else torch.cat(pos_cols, dim=1)
            if m_total < k:    # k above the budget: pad to the [b, k] contract
                scores = torch.nn.functional.pad(scores, (0, k - m_total), value=_NEG)
                gpos = torch.nn.functional.pad(gpos, (0, k - m_total), value=-1)
            vals, sel = topk(scores, k)
            vals = torch.where(q_valid[:, None], vals, _NEG)
            pos = torch.gather(gpos, 1, sel).long()
            return vals, torch.where(vals > _NEG, pos, -1)
    else:
        def fn(q, q_valid, live, arrays):
            cols = [adjust_scores(bf_mod.scan_stage(q_rot, arrays[2 * i], bits=bits,
                                                    n4_dims=n4), arrays[2 * i + 1], metric)
                    for i, q_rot in enumerate(rotate(q, arrays[-1]))]
            scores = cols[0] if n_segs == 1 else torch.cat(cols, dim=1)
            scores.masked_fill_(~live[None, :], _NEG)    # in place: no second [b, n]
            if n_total < k:    # k > n: pad to the [b, k] contract
                scores = torch.nn.functional.pad(scores, (0, k - n_total), value=_NEG)
            vals, pos = topk(scores, k)
            vals = torch.where(q_valid[:, None], vals, _NEG)
            return vals, torch.where(vals > _NEG, pos, -1)

    return SearchPlan(key=key, fn=fn, dim=enc0.dim, n_total=n_total)


def _bind_arrays(backend: Any, extras: Sequence[Any], with_codes: bool) -> tuple:
    """The tensors a plan reads, in ``fn``'s order."""
    out: list = []
    for enc in [backend.enc] + [s.enc for s in extras]:
        out.extend((enc.packed, enc.qnorms, enc.ccodes) if with_codes
                   else (enc.packed, enc.qnorms))
    out.append(backend.enc.perm_index)
    return tuple(out)


# ---------------------------------------------------------------------------
# Execution.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Call:
    """One search resolved to its plan and inputs."""

    plan: SearchPlan
    q: torch.Tensor               # [bucket, dim] f32, zero-padded after row b
    b: int
    live: Optional[np.ndarray]    # [n_total] bool, None when every row is live
    arrays: tuple
    ids: np.ndarray
    kind: str


def _resolve(backend: Any, state: Any, queries, k: int, allow: Optional[Allowlist],
             where, where_mask, meta, tuned, kwargs: dict) -> _Call:
    if where is not None or where_mask is not None or meta:
        raise _unported("where= / where_mask= (metadata predicates)", "A6")
    if tuned is not None:
        raise _unported("tuned knobs", "A11")
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    _validate_knobs(backend, kwargs)
    extras = state.extras if state is not None else []
    knobs = _normalize_knobs(backend, extras, kwargs, k)
    kind = type(backend).__name__
    enc = backend.enc
    q = torch.atleast_2d(torch.as_tensor(queries, dtype=torch.float32))
    if q.shape[-1] != enc.dim:
        raise ValueError(f"queries have dim {q.shape[-1]}, the index has {enc.dim}")
    b = int(q.shape[0])
    bucket = shape_bucket(b)
    obs.inc("engine.searches", backend=kind)
    obs.inc("engine.query_rows", b, backend=kind)

    base_n = enc.n
    live: Optional[np.ndarray] = None
    if state is not None:
        live = seg.live_mask(state, allow, base_n)
    elif allow is not None:
        live = np.asarray(allow.mask, dtype=bool)
        if live.shape[0] != base_n:
            raise ValueError(f"allowlist mask covers {live.shape[0]} rows but the index "
                             f"has {base_n}; build it from the index ids")

    key = PlanKey(fingerprint=_fingerprint(backend, extras), bucket=bucket, k=k,
                  device=str(enc.device), knobs=tuple(sorted(knobs.items())))
    with obs.timed_span("plan_lookup", histogram="engine.stage_us",
                        labels={"backend": kind, "stage": "plan_lookup"}) as sp:
        misses_before = _CACHE.stats.misses
        plan = _CACHE.get_or_build(key, lambda: _build_plan(backend, extras, key, knobs))
        if sp is not None and obs.current_trace() is not None:   # a digest costs ~20 us
            sp.attrs.update(plan=plan_key_digest(key), bucket=bucket, k=k,
                            hit=_CACHE.stats.misses == misses_before)
    if bucket != b:
        q = torch.nn.functional.pad(q, (0, 0, 0, bucket - b))
    ids = (backend.ids if not extras else
           np.concatenate([backend.ids] + [s.ids for s in extras]))
    return _Call(plan=plan, q=q, b=b, live=live, ids=ids, kind=kind,
                 arrays=_bind_arrays(backend, extras, "rescore_mult" in knobs))


def _finish(call: _Call, vals: torch.Tensor, pos: torch.Tensor, b: int):
    with obs.timed_span("sync", histogram="engine.stage_us",
                        labels={"backend": call.kind, "stage": "sync"}):
        vals = vals[:b].cpu().numpy()
        pos = pos[:b].cpu().numpy()
    return vals, seg.rows_to_ids(pos, call.ids)


def search_backend(
    backend: Any,
    state: Any,                  # SegmentedState or None (a static index)
    queries,
    k: int,
    *,
    allow: Optional[Allowlist] = None,
    where=None,
    meta=None,
    where_mask: Optional[np.ndarray] = None,
    tuned: Any = None,
    **kwargs,
) -> Tuple[np.ndarray, np.ndarray]:
    """Bucketed plan search: (scores [b, k] f32, external ids [b, k] u64),
    numpy on the host.

    Exactly ``k`` columns always; inadmissible slots carry SENTINEL_ID and a
    NEG score.  On the card the plan's graph is replayed (captured at the
    first search of its key over these tensors); on the CPU its stages run.
    """
    call = _resolve(backend, state, queries, k, allow, where, where_mask, meta, tuned,
                    kwargs)
    with obs.timed_span("execute", histogram="engine.stage_us",
                        labels={"backend": call.kind, "stage": "execute"},
                        attrs={"backend": call.kind, "rows": call.b,
                               "bucket": call.plan.key.bucket}):
        vals, pos = call.plan.execute(call.q, call.b, call.live, call.arrays, backend.graphs,
                                      _CACHE.stats)
    return _finish(call, vals, pos, call.b)


def search_eager(backend: Any, state: Any, queries, k: int, *,
                 allow: Optional[Allowlist] = None, bucketed: bool = True,
                 **kwargs) -> Tuple[np.ndarray, np.ndarray]:
    """``search_backend``'s plan with its stages run eagerly, no graph: at
    the bucket (``bucketed``), or on the raw b queries unpadded.  The
    witness a graph replay and a bucketed run are held against."""
    call = _resolve(backend, state, queries, k, allow, None, None, None, None, kwargs)
    q = call.q if bucketed else call.q[:call.b]
    vals, pos = call.plan.run_eager(q, call.b, call.live, call.arrays)
    return _finish(call, vals, pos, call.b)


def search_sharded(*args, **kwargs):
    raise _unported("sharded search", "A12")


# ---------------------------------------------------------------------------
# The searcher handle.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Searcher:
    """A bound (index, k, knobs) handle: ``searcher(queries)``.

    Made by ``MonaVec.searcher(...)``.  Its plan resolves through the shared
    cache on every call, so it follows the index's current mutation state
    (add/delete/compact select another plan or only another live mask).
    ``warmup(batch_size)`` builds the plan of that bucket and, on the card,
    captures its graph, so serving never pays a capture inside a measured
    window.
    """

    index: Any
    k: int = 10
    knobs: dict = dataclasses.field(default_factory=dict)
    # Extra metric labels, e.g. (("namespace", ns), ("collection", name)) from
    # TenantRegistry.searcher: each call then counts one ``tenancy.requests``
    # and lands in ``tenancy.search_us`` / ``tenancy.errors`` under them.
    labels: tuple = ()

    def __call__(self, queries, *, allow: Optional[Allowlist] = None
                 ) -> Tuple[np.ndarray, np.ndarray]:
        kw = dict(self.knobs)
        if allow is not None:
            kw["allow"] = allow
        if not self.labels:
            return self.index.search(queries, self.k, **kw)
        labels = dict(self.labels)
        obs.inc("tenancy.requests", **labels)
        try:
            with obs.timed_span("tenant_search", histogram="tenancy.search_us",
                                labels=labels):
                return self.index.search(queries, self.k, **kw)
        except Exception:
            obs.inc("tenancy.errors", kind="search", **labels)
            raise

    def warmup(self, batch_size: int = 1) -> "Searcher":
        bucket = shape_bucket(batch_size)
        self(np.zeros((bucket, self.index.backend.enc.dim), dtype=np.float32))
        return self
