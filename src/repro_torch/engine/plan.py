"""Search plans and the shape-bucketed plan cache (counterpart of
``repro/engine/plan.py``; DESIGN.md §7).

Every search of a BruteForce or IVF index, static or mutated, runs through a
``SearchPlan``: the whole query path (rotate the query under each segment's
seed -> predicate mask -> per-segment scan, or coarse proxy / survivor top-m
/ gathered rescore, or IVF probe / gathered scan / merge -> metric
adjustment -> live mask -> stable top-k -> -1 marking),
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

The live mask (tombstones, allowlist and ``where_mask``) is an input of the
plan, never part of its key, so ``delete()`` mints no plan and no graph.  A
``where=`` predicate over the index's metadata columns is a mask stage ANDed
into the live mask before every top-k and before survivor selection: its
structure joins the fingerprint, the columns' key planes are bound tensors
of the index, and its constants are inputs of the graph (copied in before a
replay, like the queries), so two predicates of one structure share one plan
and one graph.  An IVF plan rotates, probes and scans the base segment
(``ivf.search_stage``), scans each extra segment in full and merges
(``segments.merge_stage``).  Tuned knobs are ROADMAP A11, sharded search A12
and the stage observer A15.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import logging
from typing import Any, Callable, Container, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import obs
from ..core import binary as bin_mod
from ..core import bruteforce as bf_mod
from ..core import ivf as ivf_mod
from ..core import predicate as pred
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
    static inputs (queries, valid rows, live mask, predicate constants) and
    outputs, the bound tensors it holds, and the kernel launches one replay
    runs."""

    def __init__(self, plan: "SearchPlan", call: "_Call", stats: PlanStats) -> None:
        arrays, bucket = call.arrays, plan.key.bucket
        dev = arrays[0].device
        self.arrays = arrays      # held: no address the graph reads is reused under it
        self.segments = call.segments
        self.q = torch.zeros((bucket, plan.dim), dtype=torch.float32, device=dev)
        self.q_valid = torch.zeros(bucket, dtype=torch.bool, device=dev)
        self.live = torch.ones(plan.n_total, dtype=torch.bool, device=dev)
        self.b = 0                # rows q_valid marks
        self.live_host: Optional[np.ndarray] = None    # None: every row live
        # Predicate constants: copied in here, before the capture (a capture
        # may hold no host-to-device copy), and again before a replay whose
        # constants differ.
        self.consts_host = [np.array(c) for c in call.consts]
        self.consts = tuple(torch.from_numpy(c.copy()).to(dev) for c in self.consts_host)
        # Pinned host buffers: the queries go in and the top-k comes out by
        # asynchronous copies, with one wait for the stream per search.
        self.q_host = torch.empty((bucket, plan.dim), dtype=torch.float32, pin_memory=True)
        with torch.cuda.device(dev):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):      # warm-up; its result is discarded
                plan.fn(self.q, self.q_valid, self.live, arrays, self.consts)
            torch.cuda.current_stream().wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with cuda_build.capture_tally() as tally, torch.cuda.graph(self.graph):
                self.vals, self.pos = plan.fn(self.q, self.q_valid, self.live, arrays,
                                              self.consts)
        self.tally = dict(tally)
        self.vals_host = torch.empty(self.vals.shape, dtype=self.vals.dtype, pin_memory=True)
        self.pos_host = torch.empty(self.pos.shape, dtype=self.pos.dtype, pin_memory=True)
        stats.captures += 1
        obs.inc("plan_cache.captures")

    def reads(self, arrays: tuple) -> bool:
        """Whether this graph was captured over exactly these tensors."""
        return _same_tensors(arrays, self.arrays)

    def replay(self, call: "_Call"):
        """The top-k (vals, pos) of rows [:b], on the host."""
        q, b, live = call.q, call.b, call.live
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
        for i, c in enumerate(call.consts):
            if not np.array_equal(self.consts_host[i], c):
                self.consts[i].copy_(torch.from_numpy(np.array(c)))
                self.consts_host[i] = np.array(c)
        self.graph.replay()
        for wrapper, n in self.tally.items():
            wrapper.launches += n
        self.vals_host.copy_(self.vals, non_blocking=True)
        self.pos_host.copy_(self.pos, non_blocking=True)
        torch.cuda.current_stream().synchronize()
        return self.vals_host[:b].clone(), self.pos_host[:b].clone()


def _same_tensors(a: tuple, b: tuple) -> bool:
    return len(a) == len(b) and all(x is y for x, y in zip(a, b))


def graphs_to_free(held: Dict[PlanKey, Any], key: PlanKey, segments: tuple,
                   cached: Container[PlanKey]) -> list:
    """The keys of the held graphs to free before ``key`` is captured over
    the segment set ``segments`` (each segment's code tensor, base first):
    the graph under ``key`` itself, every graph over another segment set,
    which can never be replayed again, and every graph whose plan left the
    plan LRU ``cached``, so an index holds at most the LRU's capacity of
    graphs whatever filter shapes its callers send.  Graphs of other cached
    plans over the same segments stay (a filtered, an unfiltered, an
    ``nprobe=8`` and an ``nprobe=16`` plan of one index keep a graph each)."""
    return [k for k, g in held.items()
            if k == key or k not in cached or not _same_tensors(g.segments, segments)]


def _on_card(dev: torch.device) -> bool:
    """Whether a plan on ``dev`` runs as a captured graph (else eagerly)."""
    return dev.type == "cuda"


@dataclasses.dataclass
class SearchPlan:
    """One search configuration: ``fn(q, q_valid, live, arrays, consts) ->
    (vals, pos)`` runs its stages eagerly.  The plan holds no tensor and no
    graph: the graphs live with the index (``execute``'s ``graphs``)."""

    key: PlanKey
    fn: Callable
    dim: int
    n_total: int

    def execute(self, call: "_Call", graphs: Dict[PlanKey, _Graph], cache: "PlanCache"
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(vals, pos) [>= b, k] of ``call.q`` [bucket, dim], zero-padded
        after row ``b``: a replay of the index's graph of this plan on the
        card (rows [:b], on the host), captured first if ``graphs`` has none
        over ``call.arrays`` (freeing ``graphs_to_free``'s, with ``cache``
        the plan LRU); the stages eagerly on the CPU."""
        if not _on_card(call.arrays[0].device):
            return self.run_eager(call, call.q)
        graph = graphs.get(self.key)
        if graph is None or not graph.reads(call.arrays):
            for key in graphs_to_free(graphs, self.key, call.segments, cache):
                del graphs[key]
            graph = graphs[self.key] = _Graph(self, call, cache.stats)
        return graph.replay(call)

    def run_eager(self, call: "_Call", q: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The stages run eagerly on the index's device, no graph, at
        whatever number of rows ``q`` has (the bucket, or the raw b)."""
        dev = call.arrays[0].device
        q_valid = torch.arange(q.shape[0], device=dev) < call.b
        live = (torch.ones(self.n_total, dtype=torch.bool, device=dev) if call.live is None
                else torch.from_numpy(call.live).to(dev))
        consts = tuple(torch.from_numpy(np.array(c)).to(dev) for c in call.consts)
        return self.fn(q.to(dev), q_valid, live, call.arrays, consts)


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

    def __contains__(self, key: PlanKey) -> bool:
        return key in self._plans


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


_BACKEND_KNOBS = {bf_mod.BruteForceIndex: frozenset({"rescore_mult"}),
                  ivf_mod.IvfFlatIndex: frozenset({"nprobe"})}
_IVF_NPROBE = 8      # the default nprobe


def _validate_knobs(backend: Any, kwargs: dict) -> None:
    unknown = sorted(set(kwargs) - _BACKEND_KNOBS.get(type(backend), frozenset()))
    if unknown:
        raise TypeError(f"unexpected search kwargs for the {type(backend).__name__} "
                        f"backend: {unknown}")


def _normalize_knobs(backend: Any, extras: Sequence[Any], kwargs: dict, k: int) -> dict:
    """IVF: ``nprobe`` (default 8) clamped to ``nlist``.  BruteForce:
    ``rescore_mult=r > 0`` selects the binarized cascade with m = r*k
    survivors per segment; None or 0 is the full scan, a negative one or an
    index without coarse codes raises, and when every segment would rescore
    all of its rows (r*k >= the largest segment) the knob normalizes away and
    the plan is the full scan's."""
    if isinstance(backend, ivf_mod.IvfFlatIndex):
        nprobe = kwargs.get("nprobe")
        nprobe = _IVF_NPROBE if nprobe is None else int(nprobe)
        if nprobe < 1:
            raise ValueError(f"nprobe must be >= 1, got {nprobe}")
        return {"nprobe": min(nprobe, backend.nlist)}
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
    """The knobs a search with these arguments runs with (nprobe clamped to
    nlist, rescore_mult collapsed to the full scan); {} is the full scan."""
    if tuned is not None:
        raise _unported("tuned knobs", "A11")
    _validate_knobs(backend, kwargs)
    extras = state.extras if state is not None else []
    return dict(_normalize_knobs(backend, extras, kwargs, k))


def _fingerprint(backend: Any, extras: Sequence[Any], knobs: dict) -> tuple:
    segs = (_enc_sig(backend.enc),) + tuple(_enc_sig(s.enc) for s in extras)
    head: tuple = (type(backend).__name__, backend.enc.metric, segs)
    if isinstance(backend, ivf_mod.IvfFlatIndex):
        head += ((backend.nlist, backend.max_candidates(knobs["nprobe"])),)
    return head


def _ivf_head(backend: Any) -> tuple:
    """The IVF lists a plan reads ahead of its segments' tensors
    (centroids, order, offsets); none for BruteForce."""
    if isinstance(backend, ivf_mod.IvfFlatIndex):
        return backend.centroids, backend.order_t, backend.offsets_t
    return ()


# ---------------------------------------------------------------------------
# Plan construction.
# ---------------------------------------------------------------------------

def _build_plan(backend: Any, extras: Sequence[Any], key: PlanKey, knobs: dict,
                where: Optional[pred.Predicate] = None) -> SearchPlan:
    """The stages of one plan as one function of (q, q_valid, live, arrays,
    consts).

    The closure holds only scalars (seeds, shapes, metric) and the
    predicate's structure, never a segment or a constant, so a plan in the
    LRU pins no index; the tensors come in as ``arrays`` (``_bind_arrays``:
    the IVF head, (packed, qnorms[, ccodes]) per segment, the base's
    permutation index or None, then one metadata key plane per predicate
    leaf) and the predicate's constant keys as ``consts``.
    """
    enc0 = backend.enc
    metric, bits, n4, std = enc0.metric, enc0.bits, enc0.n4_dims, enc0.std
    seeds = (enc0.seed,) + tuple(s.enc.seed for s in extras)
    seg_ns = (enc0.n,) + tuple(s.enc.n for s in extras)
    offsets = [0] + np.cumsum(seg_ns).tolist()
    n_total, n_segs, k = offsets[-1], len(seeds), key.k
    is_ivf = isinstance(backend, ivf_mod.IvfFlatIndex)
    cascade = "rescore_mult" in knobs
    n_head = len(_ivf_head(backend))
    at_perm = n_head + (3 if cascade else 2) * n_segs
    where_fn = None if where is None else pred.build_stage_fn(where)

    def rotate(q: torch.Tensor, perm: Optional[torch.Tensor]) -> list:
        """The query prepared once and rotated under each segment's seed
        (``quantize.encode_query``'s ops, so each equals its bytes)."""
        prepared = prepare(q, metric, std)
        rots = []
        for seed in seeds:
            rot = rhdh_apply(prepared, seed, normalized=False)
            rots.append(rot if perm is None else rot[..., perm])
        return rots

    def masked_live(live: torch.Tensor, arrays: tuple, consts: tuple) -> torch.Tensor:
        """The live mask AND the predicate's mask (boolean algebra only)."""
        if where_fn is None:
            return live
        cols = arrays[at_perm + 1:]
        return where_fn(live, *[t for pair in zip(cols, consts) for t in pair])

    def finish(q_valid, vals, pos):
        vals = torch.where(q_valid[:, None], vals, _NEG)
        return vals, torch.where(vals > _NEG, pos, -1)

    if cascade:
        kind = enc0.coarse
        m = knobs["rescore_mult"] * k
        seg_ms = [min(m, n) for n in seg_ns]
        m_total = sum(seg_ms)

        def fn(q, q_valid, live, arrays, consts):
            live = masked_live(live, arrays, consts)
            score_cols, pos_cols = [], []
            for i, q_rot in enumerate(rotate(q, arrays[at_perm])):
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
            return finish(q_valid, vals, torch.gather(gpos, 1, sel).long())
    elif is_ivf:
        nprobe = knobs["nprobe"]
        max_cand = backend.max_candidates(nprobe)
        base_n = seg_ns[0]

        def fn(q, q_valid, live, arrays, consts):
            live = masked_live(live, arrays, consts)
            centroids, order, offs = arrays[:n_head]
            rots = rotate(q, arrays[at_perm])
            vals, pos = ivf_mod.search_stage(
                rots[0], centroids, order, offs, arrays[n_head], arrays[n_head + 1],
                live[:base_n], k=k,
                nprobe=nprobe, max_cand=max_cand, metric=metric, bits=bits, n4_dims=n4)
            if n_segs > 1:     # the extra segments: full scans, merged
                side = torch.cat([adjust_scores(
                    bf_mod.scan_stage(rots[i], arrays[n_head + 2 * i], bits=bits,
                                      n4_dims=n4),
                    arrays[n_head + 1 + 2 * i], metric) for i in range(1, n_segs)], dim=1)
                side.masked_fill_(~live[None, base_n:], _NEG)
                vals, pos = seg.merge_stage(vals, pos, side, base_n, k)
            return finish(q_valid, vals, pos)
    else:
        def fn(q, q_valid, live, arrays, consts):
            live = masked_live(live, arrays, consts)
            cols = [adjust_scores(bf_mod.scan_stage(q_rot, arrays[2 * i], bits=bits,
                                                    n4_dims=n4), arrays[2 * i + 1], metric)
                    for i, q_rot in enumerate(rotate(q, arrays[at_perm]))]
            scores = cols[0] if n_segs == 1 else torch.cat(cols, dim=1)
            scores.masked_fill_(~live[None, :], _NEG)    # in place: no second [b, n]
            if n_total < k:    # k > n: pad to the [b, k] contract
                scores = torch.nn.functional.pad(scores, (0, k - n_total), value=_NEG)
            return finish(q_valid, *topk(scores, k))

    return SearchPlan(key=key, fn=fn, dim=enc0.dim, n_total=n_total)


def _bind_arrays(backend: Any, extras: Sequence[Any], with_codes: bool,
                 where_cols: tuple = ()) -> tuple:
    """The tensors a plan reads, in ``fn``'s order."""
    out = list(_ivf_head(backend))
    for enc in [backend.enc] + [s.enc for s in extras]:
        out.extend((enc.packed, enc.qnorms, enc.ccodes) if with_codes
                   else (enc.packed, enc.qnorms))
    out.append(backend.enc.perm_index)
    return tuple(out) + where_cols


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
    segments: tuple               # each segment's code tensor: the segment set
    consts: tuple                 # the predicate's constant keys (numpy int64)
    ids: np.ndarray
    kind: str


def _resolve(backend: Any, state: Any, queries, k: int, allow: Optional[Allowlist],
             where, where_mask, meta, tuned, kwargs: dict) -> _Call:
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
    n_total = base_n + sum(s.enc.n for s in extras)
    live: Optional[np.ndarray] = None
    if state is not None:
        live = seg.live_mask(state, allow, base_n)
    elif allow is not None:
        live = np.asarray(allow.mask, dtype=bool)
        if live.shape[0] != base_n:
            raise ValueError(f"allowlist mask covers {live.shape[0]} rows but the index "
                             f"has {base_n}; build it from the index ids")
    if where_mask is not None:
        wm = np.asarray(where_mask, dtype=bool)
        if wm.shape != (n_total,):
            raise ValueError(f"where_mask covers {wm.shape} rows but the index has {n_total}")
        live = wm.copy() if live is None else live & wm

    fingerprint = _fingerprint(backend, extras, knobs)
    consts: tuple = ()
    where_cols: tuple = ()
    if where is not None:
        if meta is None or not meta:
            raise ValueError("where= requires an index built with metadata columns")
        if meta.n_rows != n_total:
            raise ValueError(f"metadata has {meta.n_rows} rows but the index has {n_total}")
        pred.validate(where, meta)
        fingerprint += (("where", pred.structure(where, meta)),)
        consts = pred.constant_keys(where, meta)
        where_cols = tuple(meta[c].on(enc.device) for c in pred.leaf_columns(where))
    key = PlanKey(fingerprint=fingerprint, bucket=bucket, k=k, device=str(enc.device),
                  knobs=tuple(sorted(knobs.items())))
    with obs.timed_span("plan_lookup", histogram="engine.stage_us",
                        labels={"backend": kind, "stage": "plan_lookup"}) as sp:
        misses_before = _CACHE.stats.misses
        plan = _CACHE.get_or_build(key, lambda: _build_plan(backend, extras, key, knobs,
                                                            where))
        if sp is not None and obs.current_trace() is not None:   # a digest costs ~20 us
            sp.attrs.update(plan=plan_key_digest(key), bucket=bucket, k=k,
                            hit=_CACHE.stats.misses == misses_before)
    if bucket != b:
        q = torch.nn.functional.pad(q, (0, 0, 0, bucket - b))
    ids = (backend.ids if not extras else
           np.concatenate([backend.ids] + [s.ids for s in extras]))
    return _Call(plan=plan, q=q, b=b, live=live, ids=ids, kind=kind, consts=consts,
                 segments=tuple(e.packed for e in [enc] + [s.enc for s in extras]),
                 arrays=_bind_arrays(backend, extras, "rescore_mult" in knobs, where_cols))


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
    where: Optional[pred.Predicate] = None,
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
    ``where=`` is a predicate over ``meta``'s columns (its structure in the
    plan key, its constants inputs); ``where_mask=`` an [n_total] bool row
    mask the caller evaluated, ANDed into the live mask on the host.
    """
    call = _resolve(backend, state, queries, k, allow, where, where_mask, meta, tuned,
                    kwargs)
    with obs.timed_span("execute", histogram="engine.stage_us",
                        labels={"backend": call.kind, "stage": "execute"},
                        attrs={"backend": call.kind, "rows": call.b,
                               "bucket": call.plan.key.bucket}):
        vals, pos = call.plan.execute(call, backend.graphs, _CACHE)
    return _finish(call, vals, pos, call.b)


def search_eager(backend: Any, state: Any, queries, k: int, *,
                 allow: Optional[Allowlist] = None, where: Optional[pred.Predicate] = None,
                 meta=None, where_mask: Optional[np.ndarray] = None, bucketed: bool = True,
                 **kwargs) -> Tuple[np.ndarray, np.ndarray]:
    """``search_backend``'s plan with its stages run eagerly, no graph: at
    the bucket (``bucketed``), or on the raw b queries unpadded.  The
    witness a graph replay and a bucketed run are held against."""
    call = _resolve(backend, state, queries, k, allow, where, where_mask, meta, None, kwargs)
    vals, pos = call.plan.run_eager(call, call.q if bucketed else call.q[:call.b])
    return _finish(call, vals, pos, call.b)


def search_sharded(*args, **kwargs):
    raise _unported("sharded search", "A12")


# ---------------------------------------------------------------------------
# The searcher handle.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Searcher:
    """A bound (index, k, where, knobs) handle: ``searcher(queries)``.

    Made by ``MonaVec.searcher(...)``.  Its plan resolves through the shared
    cache on every call, so it follows the index's current mutation state
    (add/delete/compact select another plan or only another live mask).
    ``warmup(batch_size)`` builds the plan of that bucket and, on the card,
    captures its graph, so serving never pays a capture inside a measured
    window.
    """

    index: Any
    k: int = 10
    where: Optional[pred.Predicate] = None
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
        if self.where is not None:
            kw["where"] = self.where
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
