"""Search plans and the shape-bucketed plan cache (counterpart of
``repro/engine/plan.py``; DESIGN.md §7).

Every search of a BruteForce, IVF or HNSW index, static or mutated, runs
through a ``SearchPlan``: the whole query path (rotate the query under each
segment's seed -> predicate mask -> per-segment scan, or coarse proxy /
survivor top-m / gathered rescore, or IVF probe / gathered scan / merge, or
HNSW descent / beam / merge -> metric adjustment -> live mask -> stable
top-k -> -1 marking),
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

An HNSW plan's loops end when the data says so, which no graph can hold.
Its stages are a ``Program`` and its ``_Graph`` several captured graphs
over one set of static state tensors: the start (rotation, mask, first
entry score), one block of ``Loop.block`` iterations for each loop (the
greedy descent of each upper level, the level-0 beam), the stages between
loops, and the finish.  A search replays each block until its loop's flag,
copied to pinned host memory after the block, says no query has work left;
the frozen-state semantics make a step past convergence change no byte, so
the replays equal the eager stages whatever the number of blocks.

The live mask (tombstones, allowlist and ``where_mask``) is an input of the
plan, never part of its key, so ``delete()`` mints no plan and no graph.  A
``where=`` predicate over the index's metadata columns is a mask stage ANDed
into the live mask before every top-k and before survivor selection: its
structure joins the fingerprint, the columns' key planes are bound tensors
of the index, and its constants are inputs of the graph (copied in before a
replay, like the queries), so two predicates of one structure share one plan
and one graph.  An IVF plan rotates, probes and scans the base segment
(``ivf.search_stage``), scans each extra segment in full and merges
(``segments.merge_stage``), and an HNSW plan does the same after its beam.

Knobs resolve as an explicit keyword first, then an autotune result's
(``tuned=``, ``tune.TuneResult``), then the engine's default.  A tuned boost
curve widens ``nprobe`` / ``rescore_mult`` on a selective filtered search:
the filter's exact count (``tune.selectivity``, a host sync taken here while
the search resolves, never inside a capture) picks the multiplier before the
plan is keyed, so a boosted budget is an ordinary plan key with its own
graph.

A ``ShardedMonaVec`` search (``search_sharded``) is a ``ShardedPlan``: the
rotation, each shard's local scan or cascade and stable top-k, and the
stable cross-shard merge (``dist.retrieval``).  Its graphs live with the
sharded index: one graph when every shard is on one device, else one per
device and the merge's on the first.

Every stage of a plan (rotate, predicate_mask, scan, coarse_scan,
survivor_topk, gathered_rescore, finalize, merge, main; shard_scan or
cascade_shard_scan on a sharded plan) reports to the stage observer
(``set_stage_observer``, driven by ``repro_torch.analysis``) whenever its
Python runs eagerly: every CPU search, the warm-up on the card and
``run_eager``.  Never while a stream captures: an observer inside a capture
would run once and never on a replay.  A capture records instead a CUDA
timing event at each stage's start and end, nodes of the graph that every
replay runs; under a trace (``repro_torch.obs``) a replay reads them, and
times its copies in and out, into ``device.*`` spans after its
``stream_wait``.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import hashlib
import logging
from typing import Any, Callable, Container, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import obs
from ..core import binary as bin_mod
from ..core import bruteforce as bf_mod
from ..core import hnsw as hnsw_mod
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


# Stage-capture hook (repro_torch.analysis): when installed, every plan
# stage run eagerly reports (backend kind, stage name, stage function, its
# operands) before it runs, so the determinism audit reruns exactly the
# functions and operands the engine runs.  One ``is not None`` check a stage
# call when none is installed.
_STAGE_OBSERVER: Optional[Callable[[str, str, Callable, tuple], None]] = None


def set_stage_observer(
    observer: Optional[Callable[[str, str, Callable, tuple], None]],
) -> Optional[Callable[[str, str, Callable, tuple], None]]:
    """Install (or clear, with None) the stage-capture hook; returns the
    previous observer so callers can restore it.  Plans built while an
    observer is installed report through the module-level slot, so clearing
    the hook also silences plans already cached."""
    global _STAGE_OBSERVER
    prev = _STAGE_OBSERVER
    _STAGE_OBSERVER = observer
    return prev


def observe(kind: str, stage: str, fn: Callable, args: tuple) -> None:
    """Report one eager run of ``fn(*args)`` to the installed observer; no
    report while a stream captures (the capture records the stage once and
    every replay runs it without Python)."""
    if _STAGE_OBSERVER is not None and not (
            torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()):
        _STAGE_OBSERVER(kind, stage, fn, args)


# The stage events of the graph ``_Captured`` is capturing (None otherwise):
# every stage of the capture appends (span name, start, end) to it.
_STAGE_EVENTS: Optional[list] = None


def observed(kind: str, stage: str, fn: Callable, clocked: bool = False) -> Callable:
    """``fn`` as a plan stage: its calls report to the stage observer.
    While a graph is captured, CUDA timing events at its start and end
    become nodes of the graph (read as ``device.<stage>`` spans after a
    replay); run eagerly under a trace, a ``clocked`` stage (a plan on the
    CPU, where the host runs it) is timed by the host clock into the same
    span."""
    name = "device." + stage

    def run(*args):
        if _STAGE_OBSERVER is not None:
            observe(kind, stage, fn, args)
        if _STAGE_EVENTS is not None:
            start = torch.cuda.Event(enable_timing=True, external=True)
            end = torch.cuda.Event(enable_timing=True, external=True)
            start.record()
            out = fn(*args)
            end.record()
            _STAGE_EVENTS.append((name, start, end))
            return out
        tr = obs.current_trace() if clocked else None
        if tr is None:
            return fn(*args)
        t0 = obs.clock()
        out = fn(*args)
        tr.add(name, t0, obs.clock(), kind=obs.DEVICE)
        return out
    return run


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


def _pinned(like: torch.Tensor) -> torch.Tensor:
    """A pinned host buffer of ``like``'s shape and dtype."""
    return torch.empty(like.shape, dtype=like.dtype, pin_memory=True)


def _warm_up(dev: torch.device, fn: Callable) -> None:
    """Run ``fn`` eagerly on a side stream and wait for it; its result is
    discarded."""
    with torch.cuda.device(dev):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)


def _wait() -> None:
    """Wait for the current stream."""
    torch.cuda.current_stream().synchronize()


def _stream_wait() -> None:
    """``_wait`` (looked up at the call) in a ``stream_wait`` span."""
    with obs.wait_span("stream_wait"):
        _wait()


#: The anchor's error bound (s) to stop at, and its tries.
_ANCHOR_ERR_S, _ANCHOR_TRIES = 10e-6, 8


def _anchor(tr: obs.QueryTrace, event: "torch.cuda.Event") -> None:
    """Take ``tr``'s anchor (in a ``trace.anchor`` span): ``event`` recorded
    on the current stream, the host clock read just before the record and
    just after the event is seen to have run (a spin on ``query``, which
    also drains the stream); the midpoint is its host time and half the
    bracket its error bound, tried again (up to ``_ANCHOR_TRIES``) while
    that bound is over ``_ANCHOR_ERR_S``."""
    stream = torch.cuda.current_stream()
    with obs.span("trace.anchor"):
        for _ in range(_ANCHOR_TRIES):
            t0 = obs.clock()
            event.record(stream)
            while not event.query():
                pass
            t1 = obs.clock()
            if t1 - t0 <= 2 * _ANCHOR_ERR_S:
                break
    tr.set_anchor(event, (t0 + t1) / 2, (t1 - t0) / 2)


class _Captured:
    """One captured CUDA graph: ``fn``'s outputs (its static tensors), the
    kernel launches one replay runs, added to the wrappers per replay, and
    its stages' timing events (graph nodes: each replay records them)."""

    def __init__(self, fn: Callable, dev: torch.device) -> None:
        global _STAGE_EVENTS
        self.graph = torch.cuda.CUDAGraph()
        self.events: list = []
        _STAGE_EVENTS = self.events
        try:
            with torch.cuda.device(dev), cuda_build.capture_tally() as tally, \
                    torch.cuda.graph(self.graph):
                self.out = fn()
        finally:
            _STAGE_EVENTS = None
        self.tally = dict(tally)

    def replay(self) -> None:
        self.graph.replay()
        for wrapper, n in self.tally.items():
            wrapper.launches += n

    def read_events(self, tr: obs.QueryTrace) -> None:
        """The latest replay's stages as device spans of ``tr`` (after the
        wait that ended it, before the next replay records them again)."""
        for name, start, end in self.events:
            tr.add_events(name, start, end)


class _Graph:
    """The captured CUDA graphs of a plan over one set of bound tensors: its
    static inputs (queries, valid rows, live mask, predicate constants) and
    outputs, and the bound tensors it holds.

    A plan of straight-line stages is one graph.  A plan with loops
    (``SearchPlan.program``) is several, replayed in order and sharing one
    set of static state tensors: the start and the stages before the first
    loop, then for each loop a block of ``Loop.block`` iterations that
    writes its state back in place, replayed until the loop's ``more``
    flag, copied to pinned host memory after each block, reads False (a
    step past convergence changes no byte), then the stages after it, the
    last with the finish.  ``last_blocks`` holds the block replays of each
    loop in the latest search."""

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
        self.q_host = _pinned(self.q)
        # Under a trace: timing events around the copies in and out, and the
        # anchor's (made at the first traced replay, reused by the next).
        self.trace_events: Optional[list] = None
        self.parts: list = []     # (_Captured, is a loop block), in replay order
        self.last_blocks: list = []
        if plan.program is None:
            _warm_up(dev, lambda: plan.fn(self.q, self.q_valid, self.live, arrays, self.consts))
            part = _Captured(lambda: plan.fn(self.q, self.q_valid, self.live, arrays,
                                             self.consts), dev)
            self.parts.append((part, False))
            self.graph, self.tally = part.graph, part.tally    # the one graph, its launches
            self.vals, self.pos = part.out
        else:
            # The warm-up runs every segment once, each block's steps included.
            _warm_up(dev, lambda: self._segments(plan.program, arrays, lambda fn, loop: fn()))
            self.graph = self.tally = None
            self.vals, self.pos = self._segments(plan.program, arrays, self._capture_part(dev))
            self.flag_host = _pinned(next(part for part, loop in self.parts if loop).out)
        self.vals_host = _pinned(self.vals)
        self.pos_host = _pinned(self.pos)
        stats.captures += 1
        obs.inc("plan_cache.captures")

    def _capture_part(self, dev: torch.device) -> Callable:
        def capture(fn: Callable, loop: bool):
            part = _Captured(fn, dev)
            self.parts.append((part, loop))
            return part.out
        return capture

    def _segments(self, prog: "Program", arrays: tuple, run: Callable):
        """Run ``prog`` on the static inputs as its replay segments, each
        through ``run(fn, is_loop_block) -> fn's outputs``; returns (vals, pos)."""
        items = list(prog.middle)
        lead = []
        while items and not isinstance(items[0], hnsw_mod.Loop):
            lead.append(items.pop(0))

        def first():
            ctx, st = prog.start(self.q, self.q_valid, self.live, arrays, self.consts)
            env = prog.env(ctx, arrays)
            for stage in lead:
                st = stage(env, st)
            return ctx, st

        ctx, st = run(first, False)
        env = prog.env(ctx, arrays)
        while True:
            loop = items.pop(0)
            stages = []
            while items and not isinstance(items[0], hnsw_mod.Loop):
                stages.append(items.pop(0))

            def block(st=st, loop=loop):
                new = st
                for _ in range(loop.block):
                    new = loop.step(env, new)
                for old, t in zip(st, new):
                    if t is not old:
                        old.copy_(t)
                return loop.more(st)

            def after(st=st, stages=stages, last=not items):
                for stage in stages:
                    st = stage(env, st)
                return prog.finish(ctx, st, arrays) if last else st

            run(block, True)
            if not items:
                return run(after, False)
            st = run(after, False)

    def reads(self, arrays: tuple) -> bool:
        """Whether this graph was captured over exactly these tensors."""
        return _same_tensors(arrays, self.arrays)

    def replay_parts(self, blocks: Optional[Sequence[int]] = None,
                     tr: Optional[obs.QueryTrace] = None) -> None:
        """Replay every part in order: each loop's block until its flag
        reads False, or ``blocks[i]`` times for the i-th loop with no check
        (the latest search's counts, to time the device alone).  With
        ``tr`` (anchored), each checked block's stages become its spans."""
        counts = []
        for part, loop in self.parts:
            if not loop:
                part.replay()
                continue
            n = 0
            while True:
                part.replay()
                n += 1
                if blocks is not None:
                    if n == blocks[len(counts)]:
                        break
                    continue
                self.flag_host.copy_(part.out, non_blocking=True)
                _stream_wait()
                if tr is not None:
                    part.read_events(tr)
                if not bool(self.flag_host):
                    break
            counts.append(n)
        self.last_blocks = counts

    def _trace(self) -> Optional[obs.QueryTrace]:
        """The active trace if this graph is on a card, anchored (by this
        graph's anchor event if the trace has none yet)."""
        tr = obs.current_trace()
        if tr is None or not _on_card(self.q.device):
            return None
        if self.trace_events is None:
            self.trace_events = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        if tr.anchor is None:
            _anchor(tr, self.trace_events[4])
        return tr

    def replay(self, call: "_Call"):
        """The top-k (vals, pos) of rows [:b], on the host.  Under a trace on
        the card, timing events around the copies in and out, and the
        stages' events, become device spans after the wait."""
        q, b, live = call.q, call.b, call.live
        tr = self._trace()
        if tr is not None:
            h2d_start, h2d_end, d2h_start, d2h_end = self.trace_events[:4]
            stream = torch.cuda.current_stream()
        if q.is_cuda:
            self.q.copy_(q)
        else:
            self.q_host.copy_(q)
            if tr is not None:
                h2d_start.record(stream)
            self.q.copy_(self.q_host, non_blocking=True)
            if tr is not None:
                h2d_end.record(stream)
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
        self.replay_parts(tr=tr)
        if tr is not None:
            d2h_start.record(stream)
        self.vals_host.copy_(self.vals, non_blocking=True)
        self.pos_host.copy_(self.pos, non_blocking=True)
        if tr is not None:
            d2h_end.record(stream)
        _stream_wait()
        if tr is not None:
            if not q.is_cuda:
                tr.add_events("device.h2d", h2d_start, h2d_end)
            for part, loop in self.parts:
                if not loop:
                    part.read_events(tr)
            tr.add_events("device.d2h", d2h_start, d2h_end)
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


@dataclasses.dataclass(frozen=True)
class Program:
    """The stages of a plan that holds data-dependent loops (HNSW):
    ``start(q, q_valid, live, arrays, consts) -> (ctx, state)``, ``env(ctx,
    arrays)`` the tensors the middle reads, ``middle`` stages ``(env, state)
    -> state`` and ``hnsw.Loop``s, in order (at least one loop), and
    ``finish(ctx, state, arrays) -> (vals, pos)``.  On the card each loop
    runs as replays of a captured block of its steps (``_Graph``)."""

    start: Callable
    env: Callable
    middle: tuple
    finish: Callable

    def run(self, q, q_valid, live, arrays, consts):
        """The stages eagerly, each loop checked on the host every step."""
        ctx, st = self.start(q, q_valid, live, arrays, consts)
        st = hnsw_mod.run_middle(self.middle, self.env(ctx, arrays), st)
        return self.finish(ctx, st, arrays)


@dataclasses.dataclass
class SearchPlan:
    """One search configuration: ``fn(q, q_valid, live, arrays, consts) ->
    (vals, pos)`` runs its stages eagerly; a plan with loops also carries
    them as a ``Program`` (``fn`` is its ``run``).  The plan holds no tensor
    and no graph: the graphs live with the index (``execute``'s ``graphs``)."""

    key: PlanKey
    fn: Callable
    dim: int
    n_total: int
    program: Optional[Program] = None

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
            graph = graphs[self.key] = self.capture(call, cache.stats)
        return graph.replay(call)

    def capture(self, call: "_Call", stats: PlanStats):
        """Capture this plan's graphs over ``call.arrays``."""
        return _Graph(self, call, stats)

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
                  ivf_mod.IvfFlatIndex: frozenset({"nprobe"}),
                  hnsw_mod.HnswIndex: frozenset({"ef"})}
_IVF_NPROBE = 8      # the default nprobe
_HNSW_EF = 64        # the default beam width


def _validate_knobs(backend: Any, kwargs: dict) -> None:
    unknown = sorted(set(kwargs) - _BACKEND_KNOBS.get(type(backend), frozenset()))
    if unknown:
        raise TypeError(f"unexpected search kwargs for the {type(backend).__name__} "
                        f"backend: {unknown}")


def _normalize_knobs(backend: Any, extras: Sequence[Any], kwargs: dict, k: int,
                     tuned: Any = None) -> dict:
    """An explicit keyword wins; a knob given as None, or not given, takes
    ``tuned.knobs``'s value, else the engine default.  IVF: ``nprobe``
    (default 8) clamped to ``nlist``.  HNSW: ``ef`` (default 64) widened to
    ``max(ef, k)``, since only beam members can enter the result set.
    BruteForce: ``rescore_mult=r > 0`` selects the binarized cascade with m
    = r*k survivors per segment; None or 0 is the full scan, a negative one
    or an index without coarse codes raises, and when every segment would
    rescore all of its rows (r*k >= the largest segment) the knob normalizes
    away and the plan is the full scan's."""
    tuned_knobs = {} if tuned is None else dict(getattr(tuned, "knobs", {}))
    if isinstance(backend, ivf_mod.IvfFlatIndex):
        nprobe = kwargs.get("nprobe")
        nprobe = int(tuned_knobs.get("nprobe", _IVF_NPROBE) if nprobe is None else nprobe)
        if nprobe < 1:
            raise ValueError(f"nprobe must be >= 1, got {nprobe}")
        return {"nprobe": min(nprobe, backend.nlist)}
    if isinstance(backend, hnsw_mod.HnswIndex):
        ef = kwargs.get("ef")
        return {"ef": max(int(tuned_knobs.get("ef", _HNSW_EF) if ef is None else ef), k)}
    rm = kwargs.get("rescore_mult")
    if rm is None:
        rm = tuned_knobs.get("rescore_mult")
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


def _boost_knobs(backend: Any, extras: Sequence[Any], knobs: dict, k: int,
                 mult: int) -> dict:
    """The candidate budget scaled by a boost-curve multiplier, after
    normalization and before plan keying: IVF probes more lists (clamped to
    ``nlist``), the cascade widens its survivor budget (collapsing to the
    full scan when it covers every segment).  The HNSW beam is not boosted:
    ``ef`` gates the traversal before the live mask is known."""
    if isinstance(backend, ivf_mod.IvfFlatIndex):
        return {"nprobe": min(knobs["nprobe"] * int(mult), backend.nlist)}
    if isinstance(backend, bf_mod.BruteForceIndex) and "rescore_mult" in knobs:
        rm = knobs["rescore_mult"] * int(mult)
        if rm * k >= max(e.n for e in [backend.enc] + [s.enc for s in extras]):
            return {}   # boosted into a rescore of every row: the full scan
        return {"rescore_mult": rm}
    return knobs


def resolve_knobs(backend: Any, state: Any, k: int, *, tuned: Any = None,
                  **kwargs: Any) -> dict:
    """The knobs a search with these arguments runs with (explicit keyword,
    then ``tuned.knobs``, then the default; nprobe clamped to nlist, ef
    widened to k, rescore_mult collapsed to the full scan); {} is the full
    scan.  The per-search selectivity boost is not included."""
    _validate_knobs(backend, kwargs)
    extras = state.extras if state is not None else []
    return dict(_normalize_knobs(backend, extras, kwargs, k, tuned))


def _fingerprint(backend: Any, extras: Sequence[Any], knobs: dict) -> tuple:
    segs = (_enc_sig(backend.enc),) + tuple(_enc_sig(s.enc) for s in extras)
    head: tuple = (type(backend).__name__, backend.enc.metric, segs)
    if isinstance(backend, ivf_mod.IvfFlatIndex):
        head += ((backend.nlist, backend.max_candidates(knobs["nprobe"])),)
    elif isinstance(backend, hnsw_mod.HnswIndex):
        head += ((backend.m, backend.entry_point, backend.max_level,
                  int(backend.neighbors0.shape[1])),)
    return head


def _head(backend: Any) -> tuple:
    """The backend's tensors a plan reads ahead of its segments' tensors:
    IVF's lists (centroids, order, offsets), HNSW's neighbour tables
    (level 0, the upper levels or None); none for BruteForce."""
    if isinstance(backend, ivf_mod.IvfFlatIndex):
        return backend.centroids, backend.order_t, backend.offsets_t
    if isinstance(backend, hnsw_mod.HnswIndex):
        return backend.nbr0_t, backend.nbr_hi_t
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
    the IVF or HNSW head, (packed, qnorms[, ccodes]) per segment, the base's
    permutation index or None, then one metadata key plane per predicate
    leaf) and the predicate's constant keys as ``consts``.  Each stage is a
    function of its tensors alone (``observed``), under the reference's
    stage names.
    """
    enc0 = backend.enc
    metric, bits, n4, std = enc0.metric, enc0.bits, enc0.n4_dims, enc0.std
    seeds = (enc0.seed,) + tuple(s.enc.seed for s in extras)
    seg_ns = (enc0.n,) + tuple(s.enc.n for s in extras)
    offsets = [0] + np.cumsum(seg_ns).tolist()
    n_total, n_segs, k = offsets[-1], len(seeds), key.k
    base_n = seg_ns[0]
    kind = type(backend).__name__
    # Each stage under the reference's name; where the host runs the plan,
    # a trace times the stages by the host clock.
    stage = functools.partial(observed, kind, clocked=not _on_card(torch.device(key.device)))
    is_ivf = isinstance(backend, ivf_mod.IvfFlatIndex)
    cascade = "rescore_mult" in knobs
    is_hnsw = isinstance(backend, hnsw_mod.HnswIndex)
    n_head = len(_head(backend))
    at_perm = n_head + (3 if cascade else 2) * n_segs
    where_fn = (None if where is None
                else stage("predicate_mask", pred.build_stage_fn(where)))

    def rotate_all(q: torch.Tensor, perm: Optional[torch.Tensor]) -> list:
        """The query prepared once and rotated under each segment's seed
        (``quantize.encode_query``'s ops, so each equals its bytes)."""
        prepared = prepare(q, metric, std)
        rots = []
        for seed in seeds:
            rot = rhdh_apply(prepared, seed, normalized=False)
            rots.append(rot if perm is None else rot[..., perm])
        return rots
    rotate = stage("rotate", rotate_all)

    def masked_live(live: torch.Tensor, arrays: tuple, consts: tuple) -> torch.Tensor:
        """The live mask AND the predicate's mask (boolean algebra only)."""
        if where_fn is None:
            return live
        cols = arrays[at_perm + 1:]
        return where_fn(live, *[t for pair in zip(cols, consts) for t in pair])

    def finish(q_valid, vals, pos):
        vals = torch.where(q_valid[:, None], vals, _NEG)
        return vals, torch.where(vals > _NEG, pos, -1)

    def scan_segment(q_rot, packed, qnorms):
        """One segment's metric-adjusted full scan [b, n_i]."""
        return adjust_scores(bf_mod.scan_stage(q_rot, packed, bits=bits, n4_dims=n4),
                             qnorms, metric)
    scan = stage("scan", scan_segment)

    def merge_extras(q_valid, live, vals, pos, *side_cols):
        """The extra segments' scans, masked and merged into the base
        segment's candidate-set top-k (IVF, HNSW), then the -1 marking."""
        if side_cols:
            side = torch.cat(side_cols, dim=1)
            side.masked_fill_(~live[None, base_n:], _NEG)
            vals, pos = seg.merge_stage(vals, pos, side, base_n, k)
        return finish(q_valid, vals, pos)
    merge = stage("merge", merge_extras)

    def side_scans(rots, arrays) -> list:
        return [scan(rots[i], arrays[n_head + 2 * i], arrays[n_head + 1 + 2 * i])
                for i in range(1, n_segs)]

    if cascade:
        coarse_kind = enc0.coarse
        m = knobs["rescore_mult"] * k
        seg_ms = [min(m, n) for n in seg_ns]
        m_total = sum(seg_ms)

        def coarse_scan(q_rot, ccodes):
            return bin_mod.coarse_scan_stage(q_rot, ccodes, kind=coarse_kind)
        coarse = stage("coarse_scan", coarse_scan)

        def make_survivors(m_i: int) -> Callable:
            def survivor_topk(proxy, live_s):
                return bin_mod.survivor_topk_stage(proxy, live_s, m=m_i)
            return stage("survivor_topk", survivor_topk)
        survivors = [make_survivors(m_i) for m_i in seg_ms]

        def gathered_rescore(q_rot, packed, qnorms, cand):
            return bin_mod.gathered_rescore_stage(q_rot, packed, qnorms, cand, bits=bits,
                                                  metric=metric, n4_dims=n4)
        rescore = stage("gathered_rescore", gathered_rescore)

        def select(q_valid, *cols):
            """The survivors' scores and rows (n_segs columns each), top-k."""
            scores = cols[0] if n_segs == 1 else torch.cat(cols[:n_segs], dim=1)
            gpos = cols[n_segs] if n_segs == 1 else torch.cat(cols[n_segs:], dim=1)
            if m_total < k:    # k above the budget: pad to the [b, k] contract
                scores = torch.nn.functional.pad(scores, (0, k - m_total), value=_NEG)
                gpos = torch.nn.functional.pad(gpos, (0, k - m_total), value=-1)
            vals, sel = topk(scores, k)
            return finish(q_valid, vals, torch.gather(gpos, 1, sel).long())
        finalize = stage("finalize", select)

        def fn(q, q_valid, live, arrays, consts):
            live = masked_live(live, arrays, consts)
            score_cols, pos_cols = [], []
            for i, q_rot in enumerate(rotate(q, arrays[at_perm])):
                packed, qnorms, ccodes = arrays[3 * i: 3 * i + 3]
                off = offsets[i]
                proxy = coarse(q_rot, ccodes)
                cand = survivors[i](proxy, live[off: off + seg_ns[i]])
                score_cols.append(rescore(q_rot, packed, qnorms, cand))
                pos_cols.append(cand if off == 0 else torch.where(cand >= 0, cand + off, -1))
            return finalize(q_valid, *score_cols, *pos_cols)
    elif is_ivf:
        nprobe = knobs["nprobe"]
        max_cand = backend.max_candidates(nprobe)

        def ivf_main(q_rot, centroids, order, offs, packed, qnorms, live0):
            return ivf_mod.search_stage(q_rot, centroids, order, offs, packed, qnorms, live0,
                                        k=k, nprobe=nprobe, max_cand=max_cand, metric=metric,
                                        bits=bits, n4_dims=n4)
        main = stage("main", ivf_main)

        def fn(q, q_valid, live, arrays, consts):
            live = masked_live(live, arrays, consts)
            rots = rotate(q, arrays[at_perm])
            vals, pos = main(rots[0], *arrays[:n_head], arrays[n_head], arrays[n_head + 1],
                             live[:base_n])
            return merge(q_valid, live, vals, pos, *side_scans(rots, arrays))
    elif is_hnsw:
        h_start, h_middle, h_finish = hnsw_mod.search_program(
            entry=backend.entry_point, ef=knobs["ef"], k=k, metric=metric, bits=bits,
            n4_dims=n4, max_level=backend.max_level)
        # The program's parts report as stage "main": its start, each loop's
        # step and the stages between them, its finish.  A loop's host check
        # (``Loop.more`` read back) drives the program and is no stage.
        o_start, o_finish = stage("main", h_start), stage("main", h_finish)
        o_middle = tuple(
            dataclasses.replace(item, step=stage("main", item.step))
            if isinstance(item, hnsw_mod.Loop) else stage("main", item)
            for item in h_middle)

        def start(q, q_valid, live, arrays, consts):
            live = masked_live(live, arrays, consts)
            ctx = (q_valid, live, *rotate(q, arrays[at_perm]))
            return ctx, o_start(env(ctx, arrays))

        def env(ctx, arrays):
            """hnsw's stage environment: the base segment's rotated queries,
            codes and norms, the neighbour tables, its live rows, q_valid."""
            return (ctx[2], arrays[n_head], arrays[n_head + 1], arrays[0], arrays[1],
                    ctx[1][:base_n], ctx[0])

        def end(ctx, st, arrays):
            vals, pos = o_finish(env(ctx, arrays), st)
            return merge(ctx[0], ctx[1], vals, pos, *side_scans(ctx[2:], arrays))

        program = Program(start=start, env=env, middle=o_middle, finish=end)
        return SearchPlan(key=key, fn=program.run, dim=enc0.dim, n_total=n_total,
                          program=program)
    else:
        def select_all(q_valid, live, *cols):
            """The segments' scores, dead rows NEG, top-k."""
            scores = cols[0] if n_segs == 1 else torch.cat(cols, dim=1)
            scores.masked_fill_(~live[None, :], _NEG)    # in place: no second [b, n]
            if n_total < k:    # k > n: pad to the [b, k] contract
                scores = torch.nn.functional.pad(scores, (0, k - n_total), value=_NEG)
            return finish(q_valid, *topk(scores, k))
        finalize = stage("finalize", select_all)

        def fn(q, q_valid, live, arrays, consts):
            live = masked_live(live, arrays, consts)
            cols = [scan(q_rot, arrays[2 * i], arrays[2 * i + 1])
                    for i, q_rot in enumerate(rotate(q, arrays[at_perm]))]
            return finalize(q_valid, live, *cols)

    return SearchPlan(key=key, fn=fn, dim=enc0.dim, n_total=n_total)


def _bind_arrays(backend: Any, extras: Sequence[Any], with_codes: bool,
                 where_cols: tuple = ()) -> tuple:
    """The tensors a plan reads, in ``fn``'s order."""
    out = list(_head(backend))
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
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    _validate_knobs(backend, kwargs)
    extras = state.extras if state is not None else []
    knobs = _normalize_knobs(backend, extras, kwargs, k, tuned)
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
    boost = None if tuned is None else getattr(tuned, "boost", None)
    boosted = boost is not None and (where is not None or where_mask is not None) and bool(knobs)
    # The selectivity's denominator: the live and allowed rows before the
    # caller's filter ("1%" is 1% of what an unfiltered search would rank).
    pre_filter_n = 0
    if boosted:
        pre_filter_n = n_total if live is None else int(np.count_nonzero(live))
    if where_mask is not None:
        wm = np.asarray(where_mask, dtype=bool)
        if wm.shape != (n_total,):
            raise ValueError(f"where_mask covers {wm.shape} rows but the index has {n_total}")
        live = wm.copy() if live is None else live & wm

    consts: tuple = ()
    where_cols: tuple = ()
    if where is not None:
        if meta is None or not meta:
            raise ValueError("where= requires an index built with metadata columns")
        if meta.n_rows != n_total:
            raise ValueError(f"metadata has {meta.n_rows} rows but the index has {n_total}")
        pred.validate(where, meta)
        consts = pred.constant_keys(where, meta)
        where_cols = tuple(meta[c].on(enc.device) for c in pred.leaf_columns(where))
    if boosted and pre_filter_n > 0:
        # The filter's exact count, then the curve's multiplier, before the
        # plan key is formed (a host sync, outside any capture).
        if where is not None:
            from ..tune.selectivity import estimate_matches
            matched = estimate_matches(where, meta, live, device=enc.device)
        else:
            matched = int(np.count_nonzero(live))
        mult = boost.multiplier(matched / pre_filter_n)
        if mult > 1:
            knobs = _boost_knobs(backend, extras, knobs, k, mult)
            obs.inc("engine.boost_applied", backend=kind, mult=str(mult))

    fingerprint = _fingerprint(backend, extras, knobs)
    if where is not None:
        fingerprint += (("where", pred.structure(where, meta)),)
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
    ``tuned=`` (a ``tune.TuneResult``) gives knob defaults and, with a boost
    curve, the selectivity boost of a filtered search.
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


@dataclasses.dataclass
class ShardedPlan(SearchPlan):
    """A sharded search's plan: on each distinct device of the mesh, the
    rotation and that device's shards' local stages (``ShardScan.local``),
    then the merge on the first device.  ``fn`` runs it all, device after
    device: eagerly on the CPU, and on the card as one captured graph when
    every shard is on one device.  Over several devices ``_MeshGraph``
    captures one graph per device and one for the merge."""

    scan: Any = None
    groups: tuple = ()        # mesh.groups: (device, shard indices), first device first
    width: int = 2            # tensors bound per shard: packed, qnorms[, ccodes]
    per: int = 0              # rows per shard
    rotate: Optional[Callable] = None

    def __post_init__(self) -> None:
        self.fn = self._run
        self.stage = "shard_scan" if self.scan.kind is None else "cascade_shard_scan"

    def local(self, group: int, q: torch.Tensor, masks: dict, arrays: tuple) -> list:
        """(scores, global ids) of each shard of ``groups[group]``, in order:
        the queries rotated on the group's device, then each shard's stage
        (``masks[s]`` its admissible rows, or None), reported to the stage
        observer as ``scan.local(s, n_valid, q_rot, packed, qnorms, ccodes,
        mask)``."""
        _, shards = self.groups[group]
        q_rot = self.rotate(q, arrays[len(arrays) - len(self.groups) + group])
        w = self.width
        out = []
        for s in shards:
            args = (q_rot, *arrays[w * s: w * (s + 1)]) + (None,) * (3 - w) + (masks[s],)
            stage = functools.partial(self.scan.local, s, self.scan.n_valid)
            observe("ShardedMonaVec", self.stage, stage, args)
            out.append(stage(*args))
        return out

    def merge(self, vals: list, gids: list):
        """The stable cross-shard merge of the shards' candidates, a stage."""
        observe("ShardedMonaVec", self.stage, self.scan.merge, (vals, gids))
        return self.scan.merge(vals, gids)

    def _masks(self, live: torch.Tensor, shards) -> dict:
        per = self.per
        return {s: live[s * per: (s + 1) * per] if self.scan.with_mask else None
                for s in shards}

    def _run(self, q, q_valid, live, arrays, consts):
        outs: dict = {}
        for g, (dev, shards) in enumerate(self.groups):
            got = self.local(g, q.to(dev), self._masks(live.to(dev), shards), arrays)
            outs.update(zip(shards, got))
        order = sorted(outs)
        return self.merge([outs[s][0] for s in order], [outs[s][1] for s in order])

    def capture(self, call: "_Call", stats: PlanStats):
        if len(self.groups) == 1:
            return _Graph(self, call, stats)
        return _MeshGraph(self, call, stats)


class _MeshGraph:
    """A sharded plan's graphs over shards on several devices: one graph per
    device (the rotation and its shards' local stages, over static queries
    and masks of its own) and the merge's graph on the first device.  A
    replay copies the inputs in, replays each device's graph, records an
    event on each, makes the first device's stream wait for all of them,
    copies every shard's [bucket, k_local] candidates into static buffers
    there and replays the merge: no host sync per shard.  Not yet run on
    more than one card (ROADMAP A12)."""

    def __init__(self, plan: ShardedPlan, call: "_Call", stats: PlanStats) -> None:
        bucket, per = plan.key.bucket, plan.per
        self.plan = plan
        self.arrays, self.segments = call.arrays, call.segments
        self.q_host = _pinned(torch.zeros((bucket, plan.dim), dtype=torch.float32))
        self.live_host: Optional[np.ndarray] = None
        self.inputs, self.parts = [], []
        for g, (dev, shards) in enumerate(plan.groups):
            q = torch.zeros((bucket, plan.dim), dtype=torch.float32, device=dev)
            live = torch.ones(per * len(shards), dtype=torch.bool, device=dev)
            masks = {s: live[i * per: (i + 1) * per] if plan.scan.with_mask else None
                     for i, s in enumerate(shards)}

            def run(g=g, q=q, masks=masks):
                return plan.local(g, q, masks, self.arrays)

            _warm_up(dev, run)
            self.parts.append(_Captured(run, dev))
            self.inputs.append((q, live))
        self.dev0 = plan.groups[0][0]
        cand: dict = {}
        for (_, shards), part in zip(plan.groups, self.parts):
            for s, (v, gid) in zip(shards, part.out):
                cand[s] = (torch.empty_like(v, device=self.dev0),
                           torch.empty_like(gid, device=self.dev0))
        self.cand = [cand[s] for s in sorted(cand)]

        def merge():
            return plan.merge([c[0] for c in self.cand], [c[1] for c in self.cand])

        _warm_up(self.dev0, merge)
        self.merge = _Captured(merge, self.dev0)
        self.vals, self.pos = self.merge.out
        self.vals_host, self.pos_host = _pinned(self.vals), _pinned(self.pos)
        stats.captures += 1
        obs.inc("plan_cache.captures")

    def reads(self, arrays: tuple) -> bool:
        return _same_tensors(arrays, self.arrays)

    def replay(self, call: "_Call"):
        plan, b = self.plan, call.b
        self.q_host.copy_(call.q)
        copy_live = call.live is not None and (
            self.live_host is None or not np.array_equal(self.live_host, call.live))
        done = []
        for ((dev, shards), part, (q, live)) in zip(plan.groups, self.parts, self.inputs):
            with torch.cuda.device(dev):
                q.copy_(self.q_host, non_blocking=True)
                if copy_live:
                    live.copy_(torch.from_numpy(np.concatenate(
                        [call.live[s * plan.per: (s + 1) * plan.per] for s in shards])))
                part.replay()
                event = torch.cuda.Event()
                event.record()
                done.append(event)
        if copy_live:
            self.live_host = call.live.copy()
        with torch.cuda.device(self.dev0):
            stream = torch.cuda.current_stream()
            for event in done:
                stream.wait_event(event)
            for (_, shards), part in zip(plan.groups, self.parts):
                for s, (v, gid) in zip(shards, part.out):
                    self.cand[s][0].copy_(v, non_blocking=True)
                    self.cand[s][1].copy_(gid, non_blocking=True)
            self.merge.replay()
            self.vals_host.copy_(self.vals, non_blocking=True)
            self.pos_host.copy_(self.pos, non_blocking=True)
            _wait()
        return self.vals_host[:b].clone(), self.pos_host[:b].clone()


def search_sharded(index: Any, queries, k: int, *, where_mask: Optional[np.ndarray] = None,
                   rescore_mult: Optional[int] = None, tuned: Any = None,
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """A ``ShardedMonaVec`` search as a cached plan: the same bucketing, the
    same counters and the same [b, k] sentinel-padded contract as the
    single-device engine.

    ``where_mask`` is an [n] boolean row-admissibility mask, applied in
    every shard before its local top-k: slots with no admissible row come
    back SENTINEL_ID / NEG, as on the single-device filtered path.  On the
    card it is an input of the plan's graph, copied in before a replay.

    ``rescore_mult=r > 0`` (else ``tuned.knobs``'s) selects the binarized
    cascade inside each shard (coarse proxy -> local survivor top-m ->
    gathered rescore -> local top-k), normalized as on one device: when
    m = r*k covers the corpus the knob drops away and the plan is the plain
    sharded scan (the m = n bit-identity pin).  A tuned boost curve widens r
    by the mask's exact popcount, taken on the host before the plan key."""
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    enc, mesh, n = index.enc, index.mesh, index.n
    q = torch.atleast_2d(torch.as_tensor(queries, dtype=torch.float32))
    if q.shape[-1] != enc.dim:
        raise ValueError(f"queries have dim {q.shape[-1]}, the index has {enc.dim}")
    b = int(q.shape[0])
    bucket = shape_bucket(b)
    k_eff = min(k, n)
    masked = where_mask is not None
    if masked:
        where_mask = np.asarray(where_mask, dtype=bool)
        if where_mask.shape != (n,):
            raise ValueError(f"where_mask covers {where_mask.shape} rows but the index has {n}")
    if rescore_mult is None and tuned is not None:
        rescore_mult = dict(getattr(tuned, "knobs", {})).get("rescore_mult")
    rm = 0 if rescore_mult is None else int(rescore_mult)
    if rm < 0:
        raise ValueError(f"rescore_mult must be >= 0, got {rm}")
    boost = None if tuned is None else getattr(tuned, "boost", None)
    if boost is not None and masked and rm > 0 and n > 0:
        # A sharded corpus is static (no tombstones): the selectivity is the
        # mask's exact popcount over the whole corpus.
        mult = boost.multiplier(int(np.count_nonzero(where_mask)) / n)
        if mult > 1:
            rm *= int(mult)
            obs.inc("engine.boost_applied", backend="ShardedMonaVec", mult=str(mult))
    if rm > 0 and enc.ccodes is None:
        raise ValueError(
            "rescore_mult requires an index built with a binarized coarse code "
            "(MonaVec.build(..., coarse='sign'|'crumb'))")
    if rm * k_eff >= n:
        rm = 0              # a rescore of every row is the full scan
    cascade = rm > 0
    # Content-keyed like search_backend: the plan holds scalars only (no
    # tensor, no index), and same-configuration corpora on one mesh share it.
    key = PlanKey(
        fingerprint=("ShardedMonaVec", tuple(str(d) for d in mesh.devices),
                     tuple(shards for _, shards in mesh.groups), n, _enc_sig(enc),
                     enc.metric, masked),
        bucket=bucket, k=k_eff, device=str(mesh.devices[0]),
        knobs=(("rescore_mult", rm),) if cascade else ())
    per, n_pad = index.shards[0].packed.shape[0], enc.n

    def build() -> ShardedPlan:
        from ..dist.retrieval import make_cascade_topk_shardmap, make_scan_topk_shardmap
        common = dict(metric=enc.metric, k=k_eff, bits=enc.bits, n4_dims=enc.n4_dims,
                      n_valid=n, with_mask=masked)
        scan = (make_cascade_topk_shardmap(mesh, kind=enc.coarse, m=rm * k_eff, **common)
                if cascade else make_scan_topk_shardmap(mesh, **common))
        metric, std, seed = enc.metric, enc.std, enc.seed

        def rotate(q: torch.Tensor, perm: Optional[torch.Tensor]) -> torch.Tensor:
            # quantize.encode_query's ops, so the bytes are the unsharded plan's.
            rot = rhdh_apply(prepare(q, metric, std), seed, normalized=False)
            return rot if perm is None else rot[..., perm]

        return ShardedPlan(key=key, fn=None, dim=enc.dim, n_total=n_pad, scan=scan,
                           groups=mesh.groups, width=3 if cascade else 2, per=per,
                           rotate=rotate)

    kind = "ShardedMonaVec"
    obs.inc("engine.searches", backend=kind)
    obs.inc("engine.query_rows", b, backend=kind)
    with obs.timed_span("plan_lookup", histogram="engine.stage_us",
                        labels={"backend": kind, "stage": "plan_lookup"}) as sp:
        plan = _CACHE.get_or_build(key, build)
        if sp is not None and obs.current_trace() is not None:
            sp.attrs.update(plan=plan_key_digest(key), shards=mesh.size)
    if bucket != b:
        q = torch.nn.functional.pad(q, (0, 0, 0, bucket - b))
    live = None if not masked else np.concatenate(
        [where_mask, np.zeros(n_pad - n, dtype=bool)])
    call = _Call(plan=plan, q=q, b=b, live=live, arrays=index.bound(cascade),
                 segments=tuple(s.packed for s in index.shards), consts=(), ids=index.ids,
                 kind=kind)
    stage = "cascade_shard_scan" if cascade else "shard_scan"
    with obs.timed_span(stage, histogram="engine.stage_us",
                        labels={"backend": kind, "stage": stage},
                        attrs={"shards": mesh.size, "rows": b}):
        vals, gids = plan.execute(call, index.graphs, _CACHE)
    with obs.timed_span("sync", histogram="engine.stage_us",
                        labels={"backend": kind, "stage": "sync"}):
        vals = vals[:b].cpu().numpy()
        gids = gids[:b].cpu().numpy()
    # Inadmissible slots (filtered rows, dead cascade survivors, padding)
    # are -inf until here; they take the engine-wide sentinels NEG and
    # SENTINEL_ID, the reference's order of conversion.
    bad = ~np.isfinite(vals)
    vals = np.where(bad, _NEG, vals).astype(np.float32)
    ids = np.where(bad, seg.SENTINEL_ID, index.ids[np.where(bad, 0, gids)])
    if k_eff < k:   # k > n: sentinel-pad to the full [b, k] contract
        vals = np.pad(vals, ((0, 0), (0, k - k_eff)), constant_values=_NEG)
        ids = np.pad(ids, ((0, 0), (0, k - k_eff)), constant_values=seg.SENTINEL_ID)
    return vals, ids


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
        enc = self.index.enc if hasattr(self.index, "enc") else self.index.backend.enc
        self(np.zeros((shape_bucket(batch_size), enc.dim), dtype=np.float32))
        return self
