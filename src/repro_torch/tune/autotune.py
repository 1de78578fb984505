"""Recall-targeted, training-free knob autotuning (counterpart of
``repro/tune/autotune.py``; DESIGN.md §12).

Sweep each backend's knob ladder against an exact oracle and persist the
cheapest setting meeting a recall target, deterministically:

  * sample queries are LIVE CORPUS ROWS (strided over the live positions,
    rebuilt from the codes on the index's device and copied to the host)
    plus seeded gaussian jitter drawn on the host with numpy, as the
    reference draws it, so sigma and the noise are the reference's;
  * the oracle is a full scan over the SAME codes (a ``BruteForceIndex``
    around the backend's own encoding), so recall isolates what the knob
    controls, candidate generation, from quantization error;
  * recall is an exact hit-count rational; the chosen rung is the SMALLEST
    one meeting the target (the ladders are cost-monotone), so no clock
    enters the result and tuning again gives the same bytes.

Every rung and every oracle search runs through the engine
(``engine.plan.search_backend``): on the card, a replay of its plan's CUDA
graph.  The same machinery tunes the selectivity BOOST CURVE: at seeded
selectivity probes (1%, 10%, 50%) the smallest knob multiplier restoring
the target under a filter, applied per search by ``engine.plan`` through
the exact count of ``tune.selectivity``.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import numpy as np

from .. import obs
from ..core import segments as seg
from ..core.bruteforce import BruteForceIndex
from ..core.hnsw import HnswIndex
from ..core.ivf import IvfFlatIndex
from .result import BoostCurve, BoostPoint, KnobRung, TuneResult

#: Boost-curve selectivity probes and the multiplier ladder swept at each.
BOOST_SELECTIVITIES = (0.01, 0.1, 0.5)
BOOST_MULTS = (1, 2, 4, 8, 16, 32)

_NOISE = 0.15      # query jitter, in units of the sampled rows' std


# ---------------------------------------------------------------------------
# Seeded sample queries and the exact oracle.
# ---------------------------------------------------------------------------

def sample_queries(index: Any, n_queries: int, seed: int) -> np.ndarray:
    """[n_q, dim] f32 on the host: strided live corpus rows plus seeded
    gaussian jitter.  Strided selection over the live positions covers every
    segment and every IVF list in proportion; the jitter keeps the queries
    off the stored rows."""
    encs = [index.backend.enc] + [s.enc for s in index.mut.extras]
    live = seg.live_mask(index.mut, None, index.backend.enc.n)
    positions = np.flatnonzero(live)
    if positions.size == 0:
        raise ValueError("autotune: the index has no live rows")
    n_q = int(min(n_queries, positions.size))
    sel = positions[np.linspace(0, positions.size - 1, n_q).round().astype(np.int64)]
    sel = np.unique(sel)

    offsets = np.concatenate([[0], np.cumsum([e.n for e in encs])])
    rows: List[np.ndarray] = []
    for i, enc in enumerate(encs):
        local = sel[(sel >= offsets[i]) & (sel < offsets[i + 1])] - offsets[i]
        if local.size:
            rows.append(seg.reconstruct_rows(enc, local).cpu().numpy())
    base = np.concatenate(rows).astype(np.float32)
    rng = np.random.RandomState(seed & 0xFFFFFFFF)
    sigma = float(np.std(base)) or 1.0
    noise = (_NOISE * sigma) * rng.randn(*base.shape)
    return (base + noise.astype(np.float32)).astype(np.float32)


def _oracle_backend(index: Any) -> BruteForceIndex:
    """Exact full scan over the backend's OWN encoding."""
    return BruteForceIndex(enc=index.backend.enc, ids=index.backend.ids)


def _engine_state(index: Any) -> Any:
    return None if index.mut.is_static else index.mut


def _search_ids(backend: Any, state: Any, queries: np.ndarray, k: int,
                where_mask: Optional[np.ndarray] = None, **kwargs: Any) -> np.ndarray:
    from ..engine.plan import search_backend
    return search_backend(backend, state, queries, k, where_mask=where_mask, **kwargs)[1]


def measure_recall(ids: np.ndarray, oracle_ids: np.ndarray) -> float:
    """Exact recall@k: |pred & oracle| / |oracle|, sentinels excluded.  Rows
    where the oracle has no admissible result count in neither term; an
    all-sentinel oracle (an empty filter) is 1.0."""
    num = den = 0
    sent = int(seg.SENTINEL_ID)
    for row_pred, row_gold in zip(np.asarray(ids), np.asarray(oracle_ids)):
        gold = {int(x) for x in row_gold if int(x) != sent}
        den += len(gold)
        num += len(gold & {int(x) for x in row_pred})
    return 1.0 if den == 0 else num / den


# ---------------------------------------------------------------------------
# Knob ladders (ascending: cheapest first; cost is monotone in each knob).
# ---------------------------------------------------------------------------

def knob_ladder(index: Any, k: int) -> Tuple[Optional[str], Tuple[int, ...]]:
    """(knob name, ascending values) for this backend; (None, ()) when there
    is nothing to tune (a plain BruteForce full scan is the oracle)."""
    backend = index.backend
    if isinstance(backend, IvfFlatIndex):
        vals = []
        p = 1
        while p < backend.nlist:
            vals.append(p)
            p <<= 1
        vals.append(int(backend.nlist))          # the always-exact ceiling
        return "nprobe", tuple(vals)
    if isinstance(backend, HnswIndex):
        n = int(backend.enc.n)
        lo, cap = max(k, 8), min(max(n, 8), 1024)
        vals = []
        e = lo
        while e < cap:
            vals.append(e)
            e <<= 1
        vals.append(cap)
        return "ef", tuple(vals)
    # BruteForce: only the cascade has a knob, when every segment has coarse codes.
    encs = [backend.enc] + [s.enc for s in index.mut.extras]
    if any(e.ccodes is None for e in encs):
        return None, ()
    max_n = max(e.n for e in encs)
    vals = []
    rm = 1
    while rm * k < max_n:
        vals.append(rm)
        rm <<= 1
    vals.append(rm)     # collapses to the full scan: recall 1.0 by construction
    return "rescore_mult", tuple(vals)


def _pick(rungs: Sequence[KnobRung], target: float) -> Tuple[KnobRung, bool]:
    """The smallest rung meeting the target, else the best-recall rung (ties
    to the smaller value: rungs ascend)."""
    for r in rungs:
        if r.recall >= target:
            return r, True
    best = rungs[0]
    for r in rungs[1:]:
        if r.recall > best.recall:
            best = r
    return best, False


# ---------------------------------------------------------------------------
# The tuner.
# ---------------------------------------------------------------------------

def _tune_boost(index: Any, knob: str, chosen: int, queries: np.ndarray, k: int,
                recall_target: float, seed: int) -> Optional[BoostCurve]:
    """The smallest knob multiplier restoring the target at each selectivity
    probe.  Probe masks are seeded Bernoulli draws over ALL rows (tombstoned
    ones too); the oracle is the filtered full scan, so recall isolates the
    candidate generation's loss under the mask."""
    backend, state = index.backend, _engine_state(index)
    oracle = _oracle_backend(index)
    n_total = int(index.n_total)
    points = []
    for i, s in enumerate(BOOST_SELECTIVITIES):
        rng = np.random.RandomState((seed * 1000003 + i) % (1 << 32))
        mask = rng.rand(n_total) < s
        if not mask.any():
            continue                      # a degenerate probe at this corpus size
        gold = _search_ids(oracle, state, queries, k, where_mask=mask)
        mult, recall = 1, 0.0
        for mult in BOOST_MULTS:
            ids = _search_ids(backend, state, queries, k, where_mask=mask,
                              **{knob: chosen * mult})
            recall = measure_recall(ids, gold)
            if recall >= recall_target:
                break
        points.append(BoostPoint(selectivity=float(s), mult=int(mult), recall=float(recall)))
    return BoostCurve(points=tuple(points)) if points else None


def autotune(index: Any, *, recall_target: float = 0.95, k: int = 10, n_queries: int = 32,
             seed: int = 0xA07001, boost: bool = True) -> TuneResult:
    """Sweep the backend's knob ladder against the exact oracle and return
    the cheapest setting meeting ``recall@k >= recall_target``: a pure
    function of (corpus bytes, arguments); wall time lands only in the
    ``tune.autotune_us`` histogram."""
    if not (0.0 < recall_target <= 1.0):
        raise ValueError(f"recall_target must be in (0, 1], got {recall_target}")
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    backend, state = index.backend, _engine_state(index)
    kind = type(backend).__name__
    with obs.timed_span("autotune", histogram="tune.autotune_us", labels={"backend": kind}):
        queries = sample_queries(index, n_queries, seed)
        knob, values = knob_ladder(index, k)
        if knob is None:
            result = TuneResult(
                recall_target=float(recall_target), k=int(k),
                n_queries=int(queries.shape[0]), seed=int(seed),
                met_target=True, knobs={}, ladder={}, boost=None)
        else:
            gold = _search_ids(_oracle_backend(index), state, queries, k)
            rungs = tuple(
                KnobRung(value=int(v), recall=float(measure_recall(
                    _search_ids(backend, state, queries, k, **{knob: v}), gold)))
                for v in values)
            chosen, met = _pick(rungs, recall_target)
            curve = None
            if boost and isinstance(backend, (IvfFlatIndex, BruteForceIndex)):
                curve = _tune_boost(index, knob, chosen.value, queries, k, recall_target,
                                    seed)
            result = TuneResult(
                recall_target=float(recall_target), k=int(k),
                n_queries=int(queries.shape[0]), seed=int(seed),
                met_target=met, knobs={knob: int(chosen.value)},
                ladder={knob: rungs}, boost=curve)
    obs.inc("tune.runs", backend=kind, met_target=str(result.met_target))
    return result


__all__ = ["BOOST_MULTS", "BOOST_SELECTIVITIES", "autotune", "knob_ladder",
           "measure_recall", "sample_queries"]
