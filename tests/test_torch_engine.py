"""The port's engine (plan cache, shape buckets, Searcher) on the CPU, held
to the reference's engine contract (tests/test_engine.py) and to the
reference's live output.

On the CPU a plan runs its stages eagerly, so:

* a batch of b queries run in its bucket returns the bytes of the rows of
  the full-bucket batch, and the bytes of the plan's stages run eagerly on
  the raw b queries unpadded (``engine.search_eager``);
* the port's results equal the reference's over the same segments, ids
  except ties within the f32 rule (``torch_harness``);
* the cache counts hits and misses as the reference's does; captures stay
  0 here (CUDA graphs are the card's, held in ``chip_smoke.py``).
"""

import gc
import weakref

import numpy as np
import pytest
import torch

from repro import obs as robs
from repro.core import MonaVec as RefMonaVec
from repro_torch import MonaVec, engine
from repro_torch import obs
from repro_torch.core.segments import SENTINEL_ID
from repro_torch.engine import plan as plan_mod
from repro_torch.kernels import cuda_build
from tests.torch_harness import (assert_segmented_search_matches, port_stream,
                                 reference_over_port, reference_stream)

BUCKET = 8
DIM = 32


@pytest.fixture(autouse=True)
def _follow_reference_stream():
    with port_stream(reference_stream()):
        yield


def _vecs(rng, n, dim=DIM):
    return rng.randn(n, dim).astype(np.float32)


def _index(rng, n, *, metric="cosine", bits=4, avg_bits=None, coarse=None):
    x = _vecs(rng, n)
    std = MonaVec.fit(x) if metric == "l2" else None
    return MonaVec.build(x, metric=metric, bits=bits, avg_bits=avg_bits, std=std,
                         coarse=coarse, device="cpu")


def _mutate(idx, rng):
    idx.add(_vecs(rng, 3))
    idx.add(_vecs(rng, 25))
    idx.delete(idx.ids[::7])


def _same(a, b) -> bool:
    return a[0].tobytes() == b[0].tobytes() and a[1].tobytes() == b[1].tobytes()


def _eager(idx, queries, k, **kw):
    return engine.search_eager(idx.backend, None if idx.mut.is_static else idx.mut, queries,
                               k, bucketed=False, **kw)


# ---------------------------------------------------------------------------
# Bucketing.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mutated", [False, True])
@pytest.mark.parametrize("metric", ["cosine", "dot", "l2"])
@pytest.mark.parametrize("path", ["full", "sign", "crumb"])
def test_bucketing_prefix_identity(path, metric, mutated):
    """b < bucket runs equal the full-bucket run's rows and the eager raw-b
    stages, byte for byte; the full bucket equals the reference's output."""
    rng = np.random.RandomState(11)
    idx = _index(rng, 60, metric=metric, coarse=None if path == "full" else path)
    if mutated:
        _mutate(idx, rng)
    kw = {} if path == "full" else {"rescore_mult": 2}
    q = _vecs(rng, BUCKET)
    full = idx.search(q, 5, **kw)
    assert _same(full, _eager(idx, q, 5, **kw))
    for b in (1, 3, 5, 7):
        got = idx.search(q[:b], 5, **kw)
        assert _same(got, (full[0][:b], full[1][:b]))
        assert _same(got, _eager(idx, q[:b], 5, **kw))
    assert_segmented_search_matches(idx, reference_over_port(idx), q, 5, **kw)


@pytest.mark.parametrize("bits,avg_bits", [(2, None), (4, 3.0), (4, None)])
def test_bucketing_prefix_identity_across_bits(bits, avg_bits):
    rng = np.random.RandomState(12)
    idx = _index(rng, 50, bits=bits, avg_bits=avg_bits, coarse="crumb")
    _mutate(idx, rng)
    q = _vecs(rng, 16)
    for kw in ({}, {"rescore_mult": 3}):
        full = idx.search(q, 6, **kw)
        for b in (2, 9, 15):
            got = idx.search(q[:b], 6, **kw)
            assert _same(got, (full[0][:b], full[1][:b]))
            assert _same(got, _eager(idx, q[:b], 6, **kw))
        assert_segmented_search_matches(idx, reference_over_port(idx), q, 6, **kw)


@pytest.mark.parametrize("bits", [2, 4])
def test_plain_gathered_rescore_does_not_depend_on_the_batch(bits):
    """The CPU rescore of a query's candidates has the same bytes whether
    the query comes alone or among 64 (a plain bmm at b=1 sums another way)."""
    from repro_torch.kernels import ref
    rng = np.random.RandomState(13)
    n, d, m, big = 200, 64, 16, 64
    packed = torch.from_numpy(rng.randint(0, 256, size=(n, d * bits // 8)).astype(np.uint8))
    q = torch.from_numpy(_vecs(rng, big, d))
    cand = torch.from_numpy(rng.randint(-1, n, size=(big, m)).astype(np.int32))
    fn = ref.gather_nibble_dot_ref if bits == 4 else ref.gather_crumb_dot_ref
    full = fn(packed, q, cand)
    for b in (1, 5, 13):
        assert fn(packed, q[:b], cand[:b]).numpy().tobytes() == full[:b].numpy().tobytes()


@pytest.mark.parametrize("dim", [32, 9000])
def test_row_norms_do_not_depend_on_the_batch(dim):
    """A row's norm has the same bytes in any batch (the query's prepare
    stage), and is the L2 norm."""
    from repro_torch.core.standardize import row_norms
    x = torch.from_numpy(np.random.RandomState(14).randn(100, dim).astype(np.float32))
    full = row_norms(x)
    for b in (1, 5, 13, 64):
        assert row_norms(x[:b]).numpy().tobytes() == full[:b].numpy().tobytes()
        assert row_norms(x[b:b + 1]).numpy().tobytes() == full[b:b + 1].numpy().tobytes()
    torch.testing.assert_close(full, torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                               rtol=1e-6, atol=0)


def test_shape_bucket_matches_reference():
    from repro.engine import shape_bucket as ref_bucket
    for b in (0, 1, 5, 8, 9, 13, 64, 65, 100, 1000):
        assert engine.shape_bucket(b) == ref_bucket(b)


# ---------------------------------------------------------------------------
# The [b, k] contract.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mutated", [False, True])
def test_exactly_k_columns(mutated):
    """k > n returns exactly k columns, SENTINEL/NEG padded, static and
    mutated, as the reference does."""
    k, n = 12, 7
    rng = np.random.RandomState(21)
    idx = _index(rng, n)
    if mutated:
        idx.add(_vecs(rng, 2))
        idx.delete([1, 3])
    s, i = idx.search(_vecs(rng, 3), k)
    n_real = idx.n_live
    assert i.shape == (3, k) and s.shape == (3, k)
    assert (i[:, n_real:] == SENTINEL_ID).all() and (i[:, :n_real] != SENTINEL_ID).all()
    for row in i[:, :n_real]:
        assert len(set(row.tolist())) == n_real
    assert_segmented_search_matches(idx, reference_over_port(idx), _vecs(rng, 3), k)


# ---------------------------------------------------------------------------
# The plan cache.
# ---------------------------------------------------------------------------

def test_same_bucket_no_second_miss_and_no_capture_on_the_cpu():
    rng = np.random.RandomState(31)
    idx = _index(rng, 40)
    q = _vecs(rng, BUCKET)
    cache = engine.plan_cache()
    cache.clear()
    idx.search(q, 5)
    first = cache.stats.snapshot()
    assert first.misses == 1 and first.hits == 0 and first.captures == 0
    for b in (BUCKET, 7, 5):
        idx.search(q[:b], 5)
    d = cache.stats.since(first)
    assert d.misses == 0 and d.captures == 0 and d.hits == 3
    assert len(cache) == 1
    plan = next(iter(cache._plans.values()))
    assert plan.key.bucket == BUCKET and plan.key.device == "cpu" and not idx.backend.graphs


def test_searcher_tracks_mutation_and_warmup():
    """add() changes the segment signature: the handle finds a new plan
    instead of serving a stale one; warmup builds a bucket's plan ahead."""
    rng = np.random.RandomState(32)
    idx = _index(rng, 30)
    search = idx.searcher(k=4).warmup(4)
    cache = engine.plan_cache()
    before = cache.stats.snapshot()
    q = _vecs(rng, 4)
    s1, i1 = search(q)
    assert cache.stats.since(before).misses == 0
    idx.add(_vecs(rng, 3), ids=[1000, 1001, 1002])
    before = cache.stats.snapshot()
    s2, i2 = search(q)
    assert cache.stats.since(before).misses == 1
    assert set(map(int, np.unique(i2))) - set(map(int, np.unique(i1))) <= {1000, 1001, 1002}
    assert _same((s2, i2), idx.search(q, 4))


def test_distinct_knobs_distinct_plans():
    rng = np.random.RandomState(33)
    idx = _index(rng, 64, coarse="sign")
    q = _vecs(rng, 4)
    cache = engine.plan_cache()
    cache.clear()
    idx.search(q, 5, rescore_mult=2)
    idx.search(q, 5, rescore_mult=4)
    idx.search(q, 5)
    assert cache.stats.misses == 3
    idx.search(q, 5, rescore_mult=4)
    assert cache.stats.hits == 1


def test_knob_normalization_shares_plans():
    """rescore_mult of None and 0, and any budget that covers every row,
    normalize to the full scan before keying: one plan."""
    rng = np.random.RandomState(34)
    idx = _index(rng, 40, coarse="crumb")
    q = _vecs(rng, 4)
    cache = engine.plan_cache()
    cache.clear()
    idx.search(q, 5)
    for rm in (None, 0, 8, 100):
        idx.search(q, 5, rescore_mult=rm)
    assert cache.stats.misses == 1 and cache.stats.hits == 4
    assert idx.resolved_knobs(5, rescore_mult=8) == {}


def test_tombstones_do_not_invalidate():
    """delete() changes the live mask, an input of the plan: same plan,
    new results."""
    rng = np.random.RandomState(35)
    idx = _index(rng, 30)
    idx.add(_vecs(rng, 4))
    q = _vecs(rng, 4)
    _, i1 = idx.search(q, 3)
    cache = engine.plan_cache()
    before = cache.stats.snapshot()
    idx.delete([int(i1[0, 0])])
    _, i2 = idx.search(q, 3)
    d = cache.stats.since(before)
    assert d.misses == 0 and d.hits == 1
    assert int(i1[0, 0]) not in i2[0].tolist()


def test_lru_evicts_and_frees_graphs():
    """The LRU counts its evictions and hits; a cached plan holds no tensor
    and no graph, so an index dropped while its plans stay cached is freed
    (its graphs live with it, not with the plan)."""
    cache = plan_mod.PlanCache(maxsize=2)
    keys = [plan_mod.PlanKey(("x", i), 8, 1, "cpu", ()) for i in range(3)]
    for key in keys:
        cache.get_or_build(key, lambda key=key: plan_mod.SearchPlan(key=key, fn=None, dim=1,
                                                                    n_total=1))
    assert len(cache) == 2 and cache.stats.evictions == 1 and cache.stats.misses == 3
    assert list(cache._plans) == keys[1:]
    cache.get_or_build(keys[1], lambda: None)
    assert cache.stats.hits == 1
    cache.clear()
    assert len(cache) == 0

    rng = np.random.RandomState(39)
    idx = _index(rng, 40, coarse="sign")
    idx.search(_vecs(rng, 3), 4)
    idx.search(_vecs(rng, 3), 4, rescore_mult=1)
    packed = weakref.ref(idx.backend.enc.packed)
    assert len(engine.plan_cache()) >= 2
    del idx
    gc.collect()
    assert packed() is None


class _FakeGraph:
    """A stand-in for ``plan._Graph`` on the CPU: "captures" by holding the
    plan's stages and tensors, "replays" by running them."""

    live: list = []

    def __init__(self, plan, call, stats):
        self.plan, self.arrays, self.segments = plan, call.arrays, call.segments
        stats.captures += 1
        _FakeGraph.live.append(weakref.ref(self))

    reads = plan_mod._Graph.reads

    def replay(self, call):
        vals, pos = self.plan.run_eager(call, call.q)
        return vals[:call.b], pos[:call.b]

    @staticmethod
    def alive() -> int:
        gc.collect()
        return sum(r() is not None for r in _FakeGraph.live)


@pytest.fixture
def fake_capture(monkeypatch):
    """Run the card's graph path on the CPU with ``_FakeGraph`` captures."""
    monkeypatch.setattr(plan_mod, "_on_card", lambda dev: True)
    monkeypatch.setattr(plan_mod, "_Graph", _FakeGraph)
    _FakeGraph.live = []
    gc.collect()
    yield _FakeGraph


@pytest.mark.parametrize("path", ["full", "sign"])
def test_repeated_add_and_search_keeps_one_graph_per_key(fake_capture, path):
    """A serving loop of add() then search holds one graph per plan key, over
    the current segments only: graphs of an older segment set are freed, so
    neither the store nor the graphs alive grow with the number of adds."""
    rng = np.random.RandomState(40)
    idx = _index(rng, 40, coarse=None if path == "full" else "sign")
    kw = {} if path == "full" else {"rescore_mult": 1}
    q = _vecs(rng, 5)
    cache = engine.plan_cache()
    before = cache.stats.snapshot()
    for round_ in range(6):
        got = idx.search(q, 4, **kw)
        assert _same(got, engine.search_eager(idx.backend, None if idx.mut.is_static
                                              else idx.mut, q, 4, **kw))
        idx.search(q[:3], 4, **kw)             # same bucket: the same graph
        assert len(idx.backend.graphs) == 1 and fake_capture.alive() == 1
        (graph,) = idx.backend.graphs.values()
        assert graph.reads(plan_mod._bind_arrays(idx.backend, idx.mut.extras, bool(kw)))
        del graph
        idx.add(_vecs(rng, 7))
        assert not idx.backend.graphs and fake_capture.alive() == 0
    assert cache.stats.since(before).captures == 6


def test_graphs_live_with_their_index(fake_capture):
    """delete() keeps the graph (the live mask is an input); a new bucket or
    knob adds one; compact() and enable_coarse() replace the backend and free
    the old graphs; dropping the index frees the rest."""
    rng = np.random.RandomState(41)
    idx = _index(rng, 50, coarse="crumb")
    q = _vecs(rng, 4)
    idx.search(q, 3)
    idx.delete(idx.ids[:5])
    before = engine.plan_cache().stats.snapshot()
    _, ids = idx.search(q, 3)
    assert engine.plan_cache().stats.since(before).captures == 0
    assert not np.isin(ids, idx.ids[:5]).any()
    idx.search(_vecs(rng, 20), 3)
    idx.search(q, 3, rescore_mult=1)
    assert len(idx.backend.graphs) == 3 and fake_capture.alive() == 3
    idx.compact()
    assert not idx.backend.graphs and fake_capture.alive() == 0
    idx.search(q, 3)
    idx.enable_coarse("sign")
    assert not idx.backend.graphs and fake_capture.alive() == 0
    idx.search(q, 3, rescore_mult=1)
    assert fake_capture.alive() == 1
    del idx
    assert fake_capture.alive() == 0


def test_counters_carry_the_reference_names():
    """One search in each package moves the same counters (names and
    labels), the port's captures standing where the reference counts
    traces; the port's cache pre-registers its whole counter family."""
    rng = np.random.RandomState(36)
    x = _vecs(rng, 30)
    moved = []
    for pkg_obs, cache, index in ((obs, engine.plan_cache(), MonaVec.build(x, device="cpu")),
                                  (robs, __import__("repro.engine").engine.plan_cache(),
                                   RefMonaVec.build(x))):
        cache.clear()
        before = pkg_obs.registry().snapshot()["counters"]
        index.search(x[:2], 3)
        after = pkg_obs.registry().snapshot()["counters"]
        moved.append({k for k, v in after.items()
                      if k.startswith(("plan_cache.", "engine.")) and v != before.get(k)})
    assert moved[0] == moved[1] - {"plan_cache.traces"}
    assert 'engine.searches{backend="BruteForceIndex"}' in moved[0]
    names = obs.registry().snapshot()["counters"]
    assert {f"plan_cache.{c}" for c in ("hits", "misses", "captures", "evictions")} <= set(names)


@pytest.mark.parametrize("what,item", [("where", "A6"), ("tuned", "A11"),
                                       ("sharded", "A12"), ("observer", "A15")])
def test_unported_engine_paths_name_their_item(what, item):
    """The stage observer (A15) is ported: installing one returns the
    previous observer, a search reports its stages under the reference's
    names, and clearing it silences the cached plan.  ``where=`` (A6)
    is ported: on an index with metadata it equals the search with the
    predicate's allowlist, through ``search`` and through a bound
    ``searcher``; an index without metadata refuses it.  Tuned knobs (A11)
    are ported: a TuneResult's knob is the default an explicit keyword
    overrides, and the search equals the explicit one.  Sharded search
    (A12) is ported: on one shard it gives the unsharded search's bytes."""
    from repro_torch.core import predicate as tpred
    from repro_torch.core.allowlist import Allowlist

    rng = np.random.RandomState(37)
    idx = _index(rng, 20)
    q = _vecs(rng, 2)
    if what == "where":
        idx.meta = MonaVec.build(_vecs(rng, 20), meta={"g": np.arange(20) % 3},
                                 device="cpu").meta
        p = tpred.Ne("g", 1)
        mask = tpred.evaluate(p, idx.meta)
        want = idx.search(q, 3, allow=Allowlist(mask=mask, n_allowed=int(mask.sum())))
        for got in (idx.search(q, 3, where=p), idx.searcher(k=3, where=p)(q)):
            assert got[0].tobytes() == want[0].tobytes()
            assert got[1].tobytes() == want[1].tobytes()
        idx.meta = None
    elif what == "tuned":
        from repro_torch.tune import TuneResult

        idx.enable_coarse("sign")
        tuned = TuneResult(recall_target=0.9, k=3, n_queries=4, seed=0, met_target=True,
                           knobs={"rescore_mult": 2}, ladder={})
        assert engine.resolve_knobs(idx.backend, None, 3, tuned=tuned) == {"rescore_mult": 2}
        assert engine.resolve_knobs(idx.backend, None, 3, tuned=tuned, rescore_mult=0) == {}
        want = engine.search_backend(idx.backend, None, q, 3, rescore_mult=2)
        got = engine.search_backend(idx.backend, None, q, 3, tuned=tuned)
        assert got[0].tobytes() == want[0].tobytes() and got[1].tobytes() == want[1].tobytes()
    elif what == "sharded":
        sharded = idx.shard()
        want = idx.search(q, 3)
        for got in (engine.search_sharded(sharded, q, 3), sharded.searcher(k=3)(q)):
            assert got[0].tobytes() == want[0].tobytes()
            assert got[1].tobytes() == want[1].tobytes()
    else:
        seen = []
        prev = engine.set_stage_observer(lambda kind, stage, fn, args: seen.append(
            (kind, stage, fn(*args) is not None)))
        try:
            want = idx.search(q, 3)
            assert sorted(set(seen)) == [("BruteForceIndex", s, True)
                                         for s in ("finalize", "rotate", "scan")]
        finally:
            assert engine.set_stage_observer(prev) is not None
        seen.clear()
        got = idx.search(q, 3)
        assert seen == [] and got[1].tobytes() == want[1].tobytes()
    with pytest.raises(ValueError, match="where= requires an index built with metadata"):
        idx.searcher(k=3, where=object())(q)


def test_knob_errors_match_reference():
    rng = np.random.RandomState(38)
    x = _vecs(rng, 20)
    idx = MonaVec.build(x, device="cpu")
    ref = RefMonaVec.build(x)
    for bad, err in (({"ef": 9}, TypeError), ({"rescore_mult": 2}, ValueError)):
        with pytest.raises(err) as want:
            ref.search(x[:2], 3, **bad)
        with pytest.raises(err) as got:
            idx.search(x[:2], 3, **bad)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="k must be >= 1"):
        idx.search(x[:2], 0)


# ---------------------------------------------------------------------------
# Launch accounting under capture (the card's path, with capture faked).
# ---------------------------------------------------------------------------

def test_launches_go_to_the_capture_tally_while_capturing(monkeypatch):
    def wrapper():
        pass
    wrapper.launches = 0
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    cuda_build.count_launch(wrapper)
    assert wrapper.launches == 1
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    with cuda_build.capture_tally() as tally:
        cuda_build.count_launch(wrapper)
        cuda_build.count_launch(wrapper)
    cuda_build.count_launch(wrapper)        # a capture outside a tally: nobody's
    assert wrapper.launches == 1 and tally == {wrapper: 2}
