"""The port's exact selectivity counts and the engine's boost (ROADMAP A11,
DESIGN.md §12) on the CPU against the reference.

* ``estimate_matches`` equals the host count ``evaluate(p) & live`` and the
  reference's count for random predicates over random typed columns
  (hypothesis), with and without a live mask;
* a cache hit equals a miss; the counts are keyed on the columns' version
  tokens, so a store rebuilt by append, gather or load never serves a
  stale count; the caches are bounded and share one stage a structure;
* the count runs while the search resolves, before the plan's graph is
  captured, never inside it;
* on a tuned index with a boost curve, ``where=`` and ``where_mask=``
  searches widen ``nprobe`` / ``rescore_mult`` as the reference does
  (``engine.boost_applied``, the same multipliers) and give its ids.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings, strategies as st

from repro import obs as robs
from repro.core import MonaVec as RefMonaVec
from repro.core import metadata as rmd
from repro.core import predicate as rpred
from repro.tune import BoostCurve as RefBoostCurve
from repro.tune import BoostPoint as RefBoostPoint
from repro.tune import TuneResult as RefTuneResult
from repro.tune.selectivity import estimate_matches as ref_estimate_matches
from repro_torch import MonaVec, obs
from repro_torch.core import metadata as md
from repro_torch.core import predicate as tpred
from repro_torch.core.convert import tune_from_fields
from repro_torch.core.predicate import Eq, Ge, In, Lt
from repro_torch.engine import plan as plan_mod
from repro_torch.tune import selectivity
from repro_torch.tune.selectivity import clear_caches, estimate_matches, make_popcount_fn
from tests.test_torch_predicate import _ast, _columns, _to_ref
from tests.torch_harness import (SENTINEL, assert_search_matches, port_stream,
                                 reference_full_scores, reference_stream, segmented_tolerance)

DIM = 16
_N = 96
_COLS = _columns(_N, 7)
_STORE = md.MetaStore.build(_COLS, _N)
_RSTORE = rmd.MetaStore.build(_COLS, _N)


@pytest.fixture(autouse=True)
def _follow_reference_stream():
    with port_stream(reference_stream()):
        yield


def _host_count(p, store, live=None) -> int:
    m = tpred.evaluate(p, store)
    return int(np.count_nonzero(m if live is None else m & live))


@settings(max_examples=40, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.too_slow])
@given(p=_ast, live_seed=st.one_of(st.none(), st.integers(0, 2 ** 16)))
def test_count_equals_the_host_count_and_the_reference(p, live_seed):
    live = (None if live_seed is None
            else np.random.RandomState(live_seed).rand(_N) < 0.5)
    got = estimate_matches(p, _STORE, live, device="cpu")
    assert got == _host_count(p, _STORE, live)
    rlive = np.ones(_N, bool) if live is None else live
    assert got == ref_estimate_matches(_to_ref(p), _RSTORE, rlive)
    fn = make_popcount_fn(p)
    args = [torch.from_numpy(np.array(a)) for a in tpred.flatten_args(p, _STORE)]
    out = fn(torch.from_numpy(rlive), *args)
    assert out.dtype == torch.int64 and out.ndim == 0 and int(out) == got


@settings(max_examples=20, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.too_slow])
@given(p=_ast, seed=st.integers(0, 2 ** 14))
def test_cache_hit_equals_miss_and_mutation_is_never_stale(p, seed):
    """A cold count (caches cleared), a warm repeat, and the counts of the
    store after append and gather (new column versions, same predicate
    object) each equal their own host count."""
    rng = np.random.RandomState(seed)
    store = md.MetaStore.build(_columns(24, seed), 24)
    clear_caches()
    before = obs.registry().snapshot()
    cold = estimate_matches(p, store, device="cpu")
    warm = estimate_matches(p, store, device="cpu")
    moved = obs.counter_deltas(obs.registry().snapshot(), before)
    assert cold == warm == _host_count(p, store)
    assert moved.get("tune.selectivity_cache.misses") == 1
    assert moved.get("tune.selectivity_cache.hits") == 1
    new = _columns(8, seed + 1)
    store.append(new, 8)
    assert estimate_matches(p, store, device="cpu") == _host_count(p, store)
    kept = store.gather(rng.rand(store.n_rows) < 0.6)
    assert estimate_matches(p, kept, device="cpu") == _host_count(p, kept)
    # Same row count, other values: the version tokens still tell them apart.
    other = md.MetaStore.build(_columns(24, seed + 2), 24)
    assert estimate_matches(p, other, device="cpu") == _host_count(p, other)


def test_versions_caches_and_bounds(tmp_path):
    store = md.MetaStore.build(_columns(40, 3), 40)
    versions = {c.version for c in store.columns.values()}
    assert len(versions) == 3
    store.append(_columns(5, 4), 5)
    assert versions.isdisjoint(c.version for c in store.columns.values())
    clear_caches()
    for v in range(300):
        estimate_matches(Eq("i", v - 150), store, device="cpu")
    assert len(selectivity._COUNT_CACHE) == selectivity._COUNT_CACHE_MAX == 256
    assert len(selectivity._FN_CACHE) == 1          # one stage a structure
    estimate_matches(Eq("i", 0) & Ge("f", 0.0), store, device="cpu")
    assert len(selectivity._FN_CACHE) == 2
    # A loaded index's columns are new objects with new versions.
    idx = MonaVec.build(np.random.RandomState(5).randn(40, DIM).astype(np.float32),
                        meta=_columns(40, 3), device="cpu")
    idx.save(str(tmp_path / "m.mvec"))
    back = MonaVec.load(str(tmp_path / "m.mvec"), device="cpu")
    assert {c.version for c in back.meta.columns.values()}.isdisjoint(
        c.version for c in idx.meta.columns.values())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        estimate_matches(Eq("i", 0), store)      # cached, and still on the card by default


class _RecordingGraph:
    """A stand-in for ``plan._Graph`` that records when a capture happens."""

    events: list = []

    def __init__(self, plan, call, stats):
        self.plan, self.arrays, self.segments = plan, call.arrays, call.segments
        stats.captures += 1
        _RecordingGraph.events.append("capture")

    reads = plan_mod._Graph.reads

    def replay(self, call):
        _RecordingGraph.events.append("replay")
        vals, pos = self.plan.run_eager(call, call.q)
        return vals[:call.b], pos[:call.b]


def test_count_runs_before_the_capture_and_outside_it(monkeypatch):
    """The popcount's host read belongs to resolving the search: it comes
    before the capture of a new plan, and a repeat with new constants counts
    again and replays, capturing nothing."""
    monkeypatch.setattr(plan_mod, "_on_card", lambda dev: True)
    monkeypatch.setattr(plan_mod, "_Graph", _RecordingGraph)
    real = selectivity.estimate_matches

    def counting(*args, **kwargs):
        _RecordingGraph.events.append("count")
        return real(*args, **kwargs)

    monkeypatch.setattr(selectivity, "estimate_matches", counting)
    _RecordingGraph.events = []
    rng = np.random.RandomState(9)
    idx = MonaVec.build(rng.randn(200, DIM).astype(np.float32), index="ivf", nlist=8,
                        meta={"g": np.arange(200) % 50}, device="cpu")
    idx.tuned = tune_from_fields(RefTuneResult(
        recall_target=0.9, k=5, n_queries=8, seed=0, met_target=True, knobs={"nprobe": 1},
        ladder={}, boost=RefBoostCurve((RefBoostPoint(0.05, 4, 1.0),))))
    q = rng.randn(3, DIM).astype(np.float32)
    idx.search(q, 5, where=Lt("g", 2))
    assert _RecordingGraph.events == ["count", "capture", "replay"]
    idx.search(q, 5, where=Lt("g", 1))
    assert _RecordingGraph.events[3:] == ["count", "replay"]


# ---------------------------------------------------------------------------
# Boosted filtered searches against the reference.
# ---------------------------------------------------------------------------

def _boosted_pair(tmp_path, index: str):
    """A reference IVF or sign-cascade index with metadata and tombstones,
    tuned by hand (knob 1 / rescore 1, boost x8 at <= 2%, x2 at <= 20%), and
    the port's over its file."""
    rng = np.random.RandomState(21)
    n = 600
    centers = rng.randn(8, DIM) * 2.0
    x = (centers[rng.randint(0, 8, n)] + rng.randn(n, DIM) * 0.3).astype(np.float32)
    kw = {"index": "ivf", "nlist": 16} if index == "ivf" else {"coarse": "sign"}
    ref = RefMonaVec.build(jnp.asarray(x), metric="cosine",
                           meta={"g": np.arange(n) % 100}, **kw)
    ref.delete(ref.ids[::9])
    knob = "nprobe" if index == "ivf" else "rescore_mult"
    ref.tuned = RefTuneResult(
        recall_target=0.9, k=5, n_queries=8, seed=0, met_target=True, knobs={knob: 1},
        ladder={}, boost=RefBoostCurve((RefBoostPoint(0.02, 8, 1.0),
                                        RefBoostPoint(0.2, 2, 1.0))))
    ref.save(str(tmp_path / "b.mvec"))
    return ref, MonaVec.load(str(tmp_path / "b.mvec"), device="cpu"), rng


def _boosts(registry, name="engine.boost_applied") -> dict:
    return {k.split("mult=")[1].strip('"}'): v for k, v in
            registry.snapshot()["counters"].items() if k.startswith(name)}


@pytest.mark.parametrize("index", ["ivf", "sign"])
def test_boosted_filtered_searches_give_the_reference_ids(index, tmp_path):
    ref, idx, rng = _boosted_pair(tmp_path, index)
    q = rng.randn(6, DIM).astype(np.float32)
    n = idx.n_total
    cases = [("where", Lt("g", 1), rpred.Lt("g", 1)),            # ~1%: x8
             ("where", In("g", [3, 4, 5, 6, 7, 8, 9, 10]),
              rpred.In("g", (3, 4, 5, 6, 7, 8, 9, 10))),           # ~8%: x2
             ("where", Ge("g", 50), rpred.Ge("g", 50)),            # ~50%: none
             ("where_mask", np.arange(n) % 100 < 1, None),
             ("where_mask", np.arange(n) % 100 < 10, None)]
    robs.registry().reset()
    obs.registry().reset()
    for kind, p, rp in cases:
        if kind == "where":
            got = idx.search(q, 5, where=p)
            want = ref.search(jnp.asarray(q), 5, where=rp)
            mask = tpred.evaluate(p, idx.meta)
        else:
            got = idx.search(q, 5, where_mask=p)
            want = ref.search(jnp.asarray(q), 5, where_mask=p)
            mask = p
        assert np.array_equal(got[1] == SENTINEL, want[1] == SENTINEL)
        assert_search_matches(got, want, reference_full_scores(ref, q), idx.ids,
                              segmented_tolerance(idx, q))
        real = got[1][got[1] != SENTINEL].astype(np.int64)
        assert mask[np.searchsorted(idx.ids, real)].all()
    assert _boosts(obs.registry()) == _boosts(robs.registry()) == {"8": 2, "2": 2}
    # Unfiltered searches take the tuned knob and no boost.
    assert idx.resolved_knobs(5) == ref.resolved_knobs(5)
    base = idx.search(q, 5)
    assert base[1].tobytes() == idx.search(q, 5, **idx.resolved_knobs(5))[1].tobytes()
    assert _boosts(obs.registry()) == {"8": 2, "2": 2}
