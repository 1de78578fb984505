"""HNSW backend (counterpart of ``repro/core/hnsw.py``; paper §3.4.3):
fp32 build on the host, packed-code beam search on the device.

The build is the reference's, line for line, in numpy on the host
(``build_graph``): insertion in data order, a level stream drawn from
``np.random.RandomState(seed & 0x7FFFFFFF)``, heaps keyed by (score, id),
f32 ``vecs @ q`` build scores (L2: ``<q, v> - |v|^2 / 2``) and the
``lexsort`` prune by (score desc, id asc).  It is a pure function of the
rotated f32 rows, so the same rows give the same graph, byte for byte, and
the graph is the reference's whenever the rotated rows are.  Only the
rotation and the encode run on the index's device (B2, then the
quantizer); the corpus is rotated once and both uses read those bytes.

The search is the reference's lock-step batched beam: a greedy descent of
width 1 through the upper levels, then a level-0 beam of width ``ef`` with a
visited bitmap and stable top-k merges.  Every scoring step is one
``ops.score_gathered`` call over the [b, rows] candidates (B4 / B5 on the
card, at m = 1, M and 2M).  Converged queries are frozen by masked updates,
so an iteration run after every query has converged changes no byte of the
state: ``search_program`` exposes each loop as a ``Loop`` whose ``step``
may be repeated past convergence, which lets the engine run it on the card
as replays of a captured block of iterations (``engine.plan``).  Rows of
the batch that ``q_valid`` marks as padding start converged.

The visited bitmap is [b, n + 1]: a scatter writes True at each fresh
candidate and at column n for every other slot, so a padded (-1) neighbour
can never clear a visited bit (the reference clamps -1 to row 0 and ORs).
"""

from __future__ import annotations

import dataclasses
import heapq
import math
import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ..kernels import ops
from . import quantize as qz
from .allowlist import NEG
from .rhdh import rhdh_apply
from .scoring import topk
from .standardize import COSINE, L2, prepare

_NEG = float(NEG)

#: The stage factories the determinism audit must witness (analysis/grid.py).
PLAN_STAGES = ("search_stage",)


def recommended_m(n: int) -> int:
    """Auto-M policy (paper contribution #4): graph diameter grows with N."""
    return 32 if n < 1_000_000 else 64


def _build_scores(q: np.ndarray, vecs: np.ndarray, metric: str) -> np.ndarray:
    """FP32 build-time scores of q against rows of vecs (higher = closer)."""
    raw = vecs @ q
    if metric == L2:
        return raw - 0.5 * np.sum(vecs * vecs, axis=1)
    return raw


def build_graph(rot: np.ndarray, *, metric: str, m: int, ef_construction: int, seed: int
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int, int]:
    """The HNSW graph of the rotated f32 rows ``rot`` [n, d']: (neighbors0
    [n, 2M] int32, neighbors_hi [max_level, n, M] int32, both -1 padded,
    node_level [n] int8, entry_point, max_level), the reference's build."""
    n = int(rot.shape[0])
    m0 = 2 * m
    ml = 1.0 / math.log(m)
    level_rng = np.random.RandomState(seed & 0x7FFFFFFF)
    levels = np.minimum(
        (-np.log(np.maximum(level_rng.uniform(size=n), 1e-12)) * ml).astype(np.int32),
        31,
    )
    max_level = int(levels.max()) if n else 0

    nbr0 = np.full((n, m0), -1, dtype=np.int32)
    nbr_hi = np.full((max_level, n, m), -1, dtype=np.int32) if max_level else np.zeros(
        (0, n, m), dtype=np.int32
    )

    def neighbors(node: int, level: int) -> np.ndarray:
        arr = nbr0[node] if level == 0 else nbr_hi[level - 1, node]
        return arr[arr >= 0]

    def set_neighbors(node: int, level: int, nbrs: np.ndarray) -> None:
        cap = m0 if level == 0 else m
        arr = np.full(cap, -1, dtype=np.int32)
        arr[: len(nbrs)] = nbrs[:cap]
        if level == 0:
            nbr0[node] = arr
        else:
            nbr_hi[level - 1, node] = arr

    def search_layer(q: np.ndarray, entry: int, ef: int, level: int) -> List[Tuple[float, int]]:
        """Classic ef-beam over one layer; deterministic heap keys (score, id)."""
        s0 = float(_build_scores(q, rot[entry: entry + 1], metric)[0])
        visited = {entry}
        cand = [(-s0, entry)]                 # max-heap by score
        res = [(s0, entry)]                   # min-heap of size ef
        heapq.heapify(cand)
        heapq.heapify(res)
        while cand:
            cs, c = heapq.heappop(cand)
            if -cs < res[0][0] and len(res) >= ef:
                break
            nbrs = [v for v in neighbors(c, level) if v not in visited]
            if not nbrs:
                continue
            visited.update(nbrs)
            nb = np.asarray(nbrs, dtype=np.int64)
            ss = _build_scores(q, rot[nb], metric)
            for s, v in zip(ss, nb):
                if len(res) < ef or s > res[0][0]:
                    heapq.heappush(res, (float(s), int(v)))
                    heapq.heappush(cand, (-float(s), int(v)))
                    if len(res) > ef:
                        heapq.heappop(res)
        return sorted(res, key=lambda t: (-t[0], t[1]))

    entry_point = 0
    cur_max = int(levels[0]) if n else 0
    for i in range(1, n):
        q = rot[i]
        li = int(levels[i])
        ep = entry_point
        # Greedy descent through layers above li.
        for lv in range(cur_max, li, -1):
            improved = True
            cur_s = float(_build_scores(q, rot[ep: ep + 1], metric)[0])
            while improved:
                improved = False
                nb = neighbors(ep, lv)
                if len(nb) == 0:
                    continue
                ss = _build_scores(q, rot[nb.astype(np.int64)], metric)
                j = int(np.argmax(ss))
                if ss[j] > cur_s:
                    cur_s, ep, improved = float(ss[j]), int(nb[j]), True
        # Insert at layers min(li, cur_max) .. 0.
        for lv in range(min(li, cur_max), -1, -1):
            res = search_layer(q, ep, ef_construction, lv)
            cap = m0 if lv == 0 else m
            sel = np.asarray([v for _, v in res[:m]], dtype=np.int32)
            set_neighbors(i, lv, sel)
            # Bidirectional connect with deterministic prune-by-score.
            for v in sel:
                ex = neighbors(int(v), lv)
                if i not in ex:
                    ex = np.append(ex, i).astype(np.int32)
                if len(ex) > cap:
                    ss = _build_scores(rot[int(v)], rot[ex.astype(np.int64)], metric)
                    keep = np.lexsort((ex, -ss))[:cap]   # score desc, id asc
                    ex = ex[keep]
                set_neighbors(int(v), lv, ex)
            ep = int(res[0][1])
        if li > cur_max:
            cur_max = li
            entry_point = i
    return nbr0, nbr_hi, levels.astype(np.int8), entry_point, cur_max


@dataclasses.dataclass
class HnswIndex:
    enc: qz.Encoded
    ids: np.ndarray                 # [n] external ids, on the host
    neighbors0: np.ndarray          # [n, 2M] int32, -1 padded (level 0), on the host
    neighbors_hi: np.ndarray        # [max_level, n, M] int32 (levels 1..max)
    node_level: np.ndarray          # [n] int8
    entry_point: int
    max_level: int
    m: int
    # Build-time beam width, persisted in INDEX_PARAMS.param2 so that
    # compact() rebuilds with it; None = unknown (a file without it).
    ef_construction: Optional[int] = None
    # The neighbour tables on the codes' device (int32), staged once, at
    # build and at load: the engine binds them, never copies them per search.
    nbr0_t: torch.Tensor = dataclasses.field(init=False, repr=False, compare=False)
    nbr_hi_t: Optional[torch.Tensor] = dataclasses.field(init=False, repr=False,
                                                         compare=False)
    # Seconds of the build's rotation (and its copy to the host), encode and
    # host graph, as ``build`` measured them; None for a loaded index.
    build_seconds: Optional[dict] = dataclasses.field(default=None, init=False, repr=False,
                                                      compare=False)
    # The engine's captured CUDA graphs over this index, by plan key (as
    # ``BruteForceIndex.graphs``: they live and die with the index).
    graphs: dict = dataclasses.field(default_factory=dict, init=False, repr=False,
                                     compare=False)

    def __post_init__(self):
        dev = self.enc.device
        self.neighbors0 = np.ascontiguousarray(self.neighbors0, dtype=np.int32)
        self.neighbors_hi = np.ascontiguousarray(self.neighbors_hi, dtype=np.int32)
        self.node_level = np.asarray(self.node_level, dtype=np.int8)
        self.entry_point, self.max_level = int(self.entry_point), int(self.max_level)
        self.nbr0_t = torch.from_numpy(self.neighbors0.copy()).to(dev)
        self.nbr_hi_t = (torch.from_numpy(self.neighbors_hi.copy()).to(dev)
                         if self.max_level else None)

    @staticmethod
    def build(vectors: torch.Tensor, *, ids: Optional[np.ndarray] = None,
              metric: str = COSINE, seed: int = 0x6D6F6E61, bits: int = 4, std=None,
              m: Optional[int] = None, ef_construction: int = 100,
              clock: Callable[[], float] = time.perf_counter) -> "HnswIndex":
        """Rotate and encode ``vectors`` on their device, then build the
        graph of the rotated rows on the host (``build_graph``).  ``clock``
        times the three steps into ``build_seconds``."""
        n = int(vectors.shape[0])
        if m is None:
            m = recommended_m(n)
        t0 = clock()
        rot = rhdh_apply(prepare(vectors.to(torch.float32), metric, std), seed,
                         normalized=False)
        rot_host = rot.cpu().numpy()
        t1 = clock()
        enc = qz.encode_rotated(rot, dim=int(vectors.shape[1]), metric=metric, seed=seed,
                                bits=bits, std=std)
        if rot.is_cuda:
            torch.cuda.synchronize(rot.device)
        t2 = clock()
        del rot
        nbr0, nbr_hi, levels, entry, max_level = build_graph(
            rot_host, metric=metric, m=m, ef_construction=ef_construction, seed=seed)
        t3 = clock()
        if ids is None:
            ids = np.arange(n, dtype=np.uint64)
        index = HnswIndex(enc=enc, ids=np.asarray(ids, dtype=np.uint64), neighbors0=nbr0,
                          neighbors_hi=nbr_hi, node_level=levels, entry_point=entry,
                          max_level=max_level, m=m, ef_construction=ef_construction)
        index.build_seconds = {"rotate": t1 - t0, "encode": t2 - t1, "graph": t3 - t2}
        return index

    def search(self, queries, k: int, *, ef: int = 64, allow=None, **kwargs
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Beam-search the graph through the engine; the beam auto-widens to
        ``max(ef, k)``.  Always exactly ``k`` columns, a slot with no
        admissible row carrying SENTINEL_ID and a NEG score."""
        from ..engine.plan import search_backend
        return search_backend(self, None, queries, k, allow=allow, ef=ef, **kwargs)


# ---------------------------------------------------------------------------
# The beam search, as stages and loops.
# ---------------------------------------------------------------------------

#: Iterations in one captured block of a loop on the card: the descent
#: through an upper level takes a few, the level-0 beam about ef to 3 ef.
DESCENT_BLOCK = 4
BEAM_BLOCK = 16


@dataclasses.dataclass(frozen=True)
class Loop:
    """A data-dependent loop: ``step(env, state) -> state`` runs one
    iteration and ``more(state)`` (a 0-d bool tensor) says whether one would
    change anything.  A step taken once ``more`` is False leaves every byte
    of the state as it was, so the loop may run as repeated blocks of
    ``block`` steps, checked between blocks.  A step may update the state's
    visited bitmap in place."""

    step: Callable
    more: Callable
    block: int
    name: str


# The environment every stage reads: (q_rot [b, d'], packed, qnorms,
# nbr0 [n, 2M] int32, nbr_hi [L, n, M] int32 or None, allow [n] bool,
# q_valid [b] bool).

def _scores(env, rows: torch.Tensor, bits: int, n4_dims: int, metric: str) -> torch.Tensor:
    """Adjusted scores [b, r] of ``rows`` [b, r] for every query; -1 slots NEG."""
    q_rot, packed, qnorms = env[0], env[1], env[2]
    return ops.score_gathered(packed, q_rot, rows, bits=bits, n4_dims=n4_dims,
                              qnorms=qnorms, metric=metric)


def search_program(*, entry: int, ef: int, k: int, metric: str, bits: int, n4_dims: int,
                   max_level: int) -> Tuple[Callable, tuple, Callable]:
    """The search as (start(env) -> state, middle, finish(env, state) ->
    (vals [b, k], rows [b, k])): ``middle`` holds stages ``(env, state) ->
    state`` and ``Loop``s, in order: for each upper level from the top, its
    entry score and its greedy descent loop; then the beam's start and the
    beam loop."""
    kw = dict(bits=bits, n4_dims=n4_dims, metric=metric)

    def start(env):
        b = env[0].shape[0]
        return (torch.full((b,), entry, dtype=torch.long, device=env[0].device),)

    def descent_start(env, st):
        cur = st[0]
        return cur, _scores(env, cur[:, None], **kw)[:, 0], env[6].clone()

    def descent_step(level: int):
        def step(env, st):
            cur, cur_s, improved = st
            nbrs = env[4][level - 1][cur].long()                    # [b, M]
            ss = _scores(env, nbrs, **kw)
            j = torch.argmax(ss, dim=1, keepdim=True)               # the first maximum
            best_s = torch.gather(ss, 1, j)[:, 0]
            # A query stops improving once its best neighbour does not beat
            # the current score; frozen queries never restart.
            better = (best_s > cur_s) & improved
            return (torch.where(better, torch.gather(nbrs, 1, j)[:, 0], cur),
                    torch.where(better, best_s, cur_s), better)
        return step

    def beam_start(env, st):
        ep = st[0]
        b, dev = ep.shape[0], ep.device
        n = env[1].shape[0]
        s_entry = _scores(env, ep[:, None], **kw)[:, 0]
        scores = torch.cat([s_entry[:, None],
                            torch.full((b, ef - 1), _NEG, dtype=torch.float32, device=dev)], 1)
        ids = torch.cat([ep[:, None], torch.full((b, ef - 1), -1, dtype=torch.long,
                                                 device=dev)], 1)
        # Padding rows start with their entry expanded: no frontier.
        expanded = torch.zeros((b, ef), dtype=torch.bool, device=dev)
        expanded[:, 0] = ~env[6]
        visited = torch.zeros((b, n + 1), dtype=torch.bool, device=dev)
        visited.scatter_(1, ep[:, None], True)
        allow_ep = env[5][ep][:, None]
        return (scores, ids, expanded, visited, torch.where(allow_ep, scores, _NEG),
                torch.where(allow_ep, ids, -1))

    def beam_step(env, st):
        scores, ids, expanded, visited, r_scores, r_ids = st
        n = visited.shape[1] - 1
        frontier = ~expanded & (ids >= 0)
        active = torch.any(frontier, dim=1)                                 # [b]
        sel = torch.argmax(torch.where(frontier, scores, _NEG), dim=1, keepdim=True)
        slots = torch.arange(ef, device=ids.device)
        expanded = expanded | ((slots[None, :] == sel) & active[:, None])
        nbrs = env[3][torch.gather(ids, 1, sel)[:, 0].clamp(min=0)].long()  # [b, 2M]
        nv = nbrs.clamp(min=0)
        fresh = (nbrs >= 0) & ~torch.gather(visited, 1, nv) & active[:, None]
        # In place; every slot writes True, the non-fresh ones at column n.
        visited.scatter_(1, torch.where(fresh, nv, n), True)
        # Only fresh candidates are scored: the others are NEG either way.
        ns = _scores(env, torch.where(fresh, nbrs, -1), **kw)
        # Beam merge: the existing beam first, then the new candidates (stable).
        top_s, pos = topk(torch.cat([scores, ns], 1), ef)
        all_i = torch.cat([ids, nbrs], 1)
        all_e = torch.cat([expanded, torch.zeros_like(nbrs, dtype=torch.bool)], 1)
        # Result merge: allowed fresh candidates only.
        ns_res = torch.where(env[5][nv], ns, _NEG)
        r_top, r_pos = topk(torch.cat([r_scores, ns_res], 1), ef)
        ri = torch.cat([r_ids, nbrs], 1)
        # Freeze converged queries: their state must not churn.
        keep = active[:, None]
        return (torch.where(keep, top_s, scores),
                torch.where(keep, torch.gather(all_i, 1, pos), ids),
                torch.where(keep, torch.gather(all_e, 1, pos), expanded),
                visited,
                torch.where(keep, r_top, r_scores),
                torch.where(keep, torch.gather(ri, 1, r_pos), r_ids))

    def finish(env, st):
        r_scores, r_ids = st[4], st[5]
        r_ids = torch.where(r_scores > _NEG, r_ids, -1)
        vals, pos = topk(r_scores, k)
        return vals, torch.gather(r_ids, 1, pos)

    middle: list = []
    for level in range(max_level, 0, -1):
        middle += [descent_start,
                   Loop(step=descent_step(level), more=lambda st: torch.any(st[2]),
                        block=DESCENT_BLOCK, name=f"descent{level}")]
    middle += [beam_start,
               Loop(step=beam_step, more=lambda st: torch.any(~st[2] & (st[1] >= 0)),
                    block=BEAM_BLOCK, name="beam")]
    return start, tuple(middle), finish


def run_middle(middle: tuple, env, st, trace: Optional[list] = None):
    """Run stages and loops eagerly, each loop to convergence (one host
    check per iteration); ``trace`` gets each loop's iterations."""
    for item in middle:
        if isinstance(item, Loop):
            iters = 0
            while bool(item.more(st)):
                st = item.step(env, st)
                iters += 1
            if trace is not None:
                trace.append(iters)
        else:
            st = item(env, st)
    return st


def search_stage(q_rot: torch.Tensor, packed: torch.Tensor, qnorms: torch.Tensor,
                 nbr0: torch.Tensor, nbr_hi: Optional[torch.Tensor],
                 allow_mask: torch.Tensor, *, entry: int, ef: int, k: int, metric: str,
                 bits: int, n4_dims: int, max_level: int,
                 q_valid: Optional[torch.Tensor] = None, trace: Optional[list] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The lock-step batched beam over the whole query batch, run eagerly:
    (vals [b, k], rows [b, k]), NEG / -1 where no admissible row was found.
    The allowlist routes over every node, but only allowed nodes enter the
    result set.  ``ef >= k`` (the engine widens it)."""
    if q_valid is None:
        q_valid = torch.ones(q_rot.shape[0], dtype=torch.bool, device=q_rot.device)
    start, middle, finish = search_program(entry=entry, ef=ef, k=k, metric=metric,
                                           bits=bits, n4_dims=n4_dims, max_level=max_level)
    env = (q_rot, packed, qnorms, nbr0, nbr_hi, allow_mask, q_valid)
    return finish(env, run_middle(middle, env, start(env), trace))
