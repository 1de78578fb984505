"""The port's HNSW index through files, mutation, knobs and the engine, on
the CPU, against the reference.

* a reference-written HNSW file, static (v6) and segmented (v8), loads in
  the port and searches to the reference's ids; a port-written file loads
  in the reference; load -> save is byte-identical both ways;
* ``compact`` rebuilds with the same M and ef_construction (as the
  reference's tests/test_segments.py), also after a static save;
* ``ef`` is normalized to ``max(ef, k)`` (default 64) and keyed, and a knob
  of another backend raises the reference's TypeError;
* the engine's card path, run here with stand-in captures that replay by
  rerunning each captured segment: the block replays of the plan's loops
  return the bytes of its eager stages at b in {1, 13, 64, 100}, on a
  static and on a mutated index, and a warmed-up searcher captures nothing
  more.
"""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import MonaVec as RefMonaVec
from repro.engine import plan as rplan
from repro_torch import MonaVec, engine
from repro_torch.core import hnsw as thnsw
from repro_torch.core.convert import segmented_from_arrays
from repro_torch.engine import plan as plan_mod
from tests.torch_harness import (SENTINEL, _segments_of, port_stream, reference_stream,
                                 segmented_tolerance)

DIM = 48


@pytest.fixture(autouse=True)
def _follow_reference_stream():
    with port_stream(reference_stream()):
        yield


def _vecs(rng, n, dim=DIM):
    centers = rng.randn(6, dim) * 2
    return (centers[rng.randint(0, 6, n)] + rng.randn(n, dim)).astype(np.float32)


def _sha(path) -> str:
    with open(path, "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()


def _ref_mutated(seed: int, n: int = 400):
    """A reference HNSW index with one added segment and deletions."""
    rng = np.random.RandomState(seed)
    ref = RefMonaVec.build(jnp.asarray(_vecs(rng, n)), index="hnsw", m=8, ef_construction=40)
    ref.add(jnp.asarray(_vecs(rng, 60)))
    ref.delete(list(range(0, n + 60, 9)))
    return ref, rng


def _assert_same_search(port, ref, q, k, **kw):
    """Ids equal, scores within the port's f32 rule, sentinels alike."""
    got = port.search(q, k, **kw)
    want = ref.search(jnp.asarray(q), k, **kw)
    assert got[1].tobytes() == want[1].tobytes()
    tol = segmented_tolerance(port, q)
    real = got[1] != SENTINEL
    row_of = {int(v): i for i, v in enumerate(port.ids)}
    rows = np.array([[row_of.get(int(v), 0) for v in r] for r in got[1]])
    bound = np.take_along_axis(tol, rows, axis=1)
    assert np.all(np.abs(got[0] - want[0])[real] <= bound[real])
    return got


# ---------------------------------------------------------------------------
# Files.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mutated", [False, True])
def test_reference_file_loads_in_the_port(tmp_path, mutated):
    rng = np.random.RandomState(31)
    if mutated:
        ref, rng = _ref_mutated(31)
    else:
        ref = RefMonaVec.build(jnp.asarray(_vecs(rng, 400)), index="hnsw", m=8,
                               ef_construction=40)
    path = str(tmp_path / "ref.mvec")
    ref.save(path)
    assert open(path, "rb").read()[4] == (8 if mutated else 6)
    port = MonaVec.load(path, device="cpu")
    be = port.backend
    assert isinstance(be, thnsw.HnswIndex) and be.ef_construction == 40 and be.m == 8
    assert be.neighbors0.tobytes() == ref.backend.neighbors0.tobytes()
    q = _vecs(rng, 10)
    got = _assert_same_search(port, ref, q, 10, ef=32)
    if mutated:
        dead = ref.ids[np.concatenate([ref.mut.base_tombs] + [s.tombs for s in ref.mut.extras])]
        assert not np.isin(got[1], dead).any()
    again = str(tmp_path / "again.mvec")
    port.save(again)
    assert _sha(again) == _sha(path)


@pytest.mark.parametrize("mutated", [False, True])
def test_port_file_loads_in_the_reference(tmp_path, mutated):
    rng = np.random.RandomState(32)
    port = MonaVec.build(_vecs(rng, 400), index="hnsw", m=8, ef_construction=40,
                         device="cpu")
    if mutated:
        port.add(_vecs(rng, 50))
        port.delete(list(range(0, 450, 7)))
    path = str(tmp_path / "port.mvec")
    port.save(path)
    ref = RefMonaVec.load(path)
    assert ref.backend.ef_construction == 40 and ref.backend.max_level == port.backend.max_level
    _assert_same_search(port, ref, _vecs(rng, 10), 10, ef=24)
    again = str(tmp_path / "again.mvec")
    ref.save(again)
    assert _sha(again) == _sha(path)


def test_segmented_from_arrays_carries_a_mutated_reference_index():
    ref, rng = _ref_mutated(33)
    be = ref.backend
    enc = be.enc
    segs = [{"packed": np.asarray(e.packed), "qnorms": np.asarray(e.qnorms), "seed": e.seed,
             "ids": ids, "tombs": tombs} for e, ids, tombs in _segments_of(ref)]
    port = segmented_from_arrays(
        segs, next_ordinal=ref.mut.next_ordinal, metric=enc.metric, bits=enc.bits,
        dim=enc.dim, dim_pad=enc.dim_pad, device="cpu",
        hnsw={"neighbors0": be.neighbors0, "neighbors_hi": be.neighbors_hi,
              "node_level": be.node_level, "entry_point": be.entry_point,
              "max_level": be.max_level, "m": be.m, "ef_construction": be.ef_construction})
    _assert_same_search(port, ref, _vecs(rng, 10), 5, ef=17)
    bad = dict(neighbors0=be.neighbors0 + 10_000, neighbors_hi=be.neighbors_hi,
               node_level=be.node_level, entry_point=be.entry_point,
               max_level=be.max_level, m=be.m)
    with pytest.raises(ValueError, match="neighbour"):
        segmented_from_arrays(segs[:1], next_ordinal=1, metric=enc.metric, bits=enc.bits,
                              dim=enc.dim, dim_pad=enc.dim_pad, device="cpu", hnsw=bad)


def test_compact_keeps_m_and_ef_construction(tmp_path):
    """As the reference's test_hnsw_compact_keeps_ef_construction and
    test_hnsw_ef_construction_survives_static_save."""
    rng = np.random.RandomState(34)
    idx = MonaVec.build(_vecs(rng, 16), index="hnsw", ef_construction=48, device="cpu")
    static = str(tmp_path / "static.mvec")
    idx.save(static)
    assert open(static, "rb").read()[4] == 6
    assert MonaVec.load(static, device="cpu").backend.ef_construction == 48
    idx.add(_vecs(rng, 4))
    idx.delete([3])
    p = str(tmp_path / "h.mvec")
    idx.save(p)
    idx2 = MonaVec.load(p, device="cpu")
    assert idx2.backend.ef_construction == 48 and idx2.backend.m == 32
    assert idx2.compact() == 1
    assert idx2.backend.ef_construction == 48 and idx2.backend.m == 32
    assert idx2.mut.is_static and idx2.n_total == 19
    ids = idx2.search(_vecs(rng, 3), 5)[1]
    assert not np.isin(ids, [3]).any()


# ---------------------------------------------------------------------------
# Knobs.
# ---------------------------------------------------------------------------

def test_ef_is_normalized_keyed_and_validated():
    rng = np.random.RandomState(35)
    x = _vecs(rng, 120)
    port = MonaVec.build(x, index="hnsw", m=8, ef_construction=32, device="cpu")
    ref = RefMonaVec.build(jnp.asarray(x), index="hnsw", m=8, ef_construction=32)
    for k, kw in ((10, {}), (100, {}), (10, {"ef": 17}), (20, {"ef": 5}), (5, {"ef": None})):
        want = rplan.resolve_knobs(ref.backend, None, k, **kw)
        assert port.resolved_knobs(k, **kw) == want == {"ef": max(kw.get("ef") or 64, k)}
    cache = engine.plan_cache()
    q = _vecs(rng, 3)
    before = cache.stats.snapshot()
    port.search(q, 10, ef=5)
    port.search(q, 10, ef=6)          # both widen to 10: one plan
    port.search(q, 10, ef=17)
    delta = cache.stats.since(before)
    assert (delta.misses, delta.hits) == (2, 1)
    for index in (port, ref):
        with pytest.raises(TypeError, match="unexpected search kwargs"):
            index.search(q if index is port else jnp.asarray(q), 5, nprobe=4)
    with pytest.raises(ValueError, match="requires the bruteforce"):
        MonaVec.build(x, index="hnsw", coarse="sign", device="cpu")
    with pytest.raises(TypeError, match="requires the bruteforce backend"):
        port.enable_coarse("sign")


# ---------------------------------------------------------------------------
# The engine's block replays, with stand-in captures.
# ---------------------------------------------------------------------------

class _StandInCapture:
    """``plan._Captured`` on the CPU: "captures" by running ``fn`` once (its
    outputs become the static tensors) and "replays" by running it again and
    writing the results into those tensors, as a graph replay writes its
    outputs in place."""

    def __init__(self, fn, dev):
        self.fn, self.tally = fn, {}
        self.out = fn()

    def replay(self):
        def copy(dst, src):
            if isinstance(dst, torch.Tensor):
                dst.copy_(src)
            else:
                for d, s in zip(dst, src):
                    copy(d, s)
        copy(self.out, self.fn())


@pytest.fixture
def stand_in_capture(monkeypatch):
    monkeypatch.setattr(plan_mod, "_on_card", lambda dev: True)
    monkeypatch.setattr(plan_mod, "_Captured", _StandInCapture)
    monkeypatch.setattr(plan_mod, "_pinned",
                        lambda like: torch.empty(like.shape, dtype=like.dtype))
    monkeypatch.setattr(plan_mod, "_warm_up", lambda dev, fn: fn())
    monkeypatch.setattr(plan_mod, "_wait", lambda: None)


def _same(a, b) -> bool:
    return a[0].tobytes() == b[0].tobytes() and a[1].tobytes() == b[1].tobytes()


@pytest.mark.parametrize("mutated", [False, True])
def test_block_replays_equal_the_eager_stages(stand_in_capture, mutated):
    rng = np.random.RandomState(36)
    idx = MonaVec.build(_vecs(rng, 500), index="hnsw", m=8, ef_construction=32,
                        device="cpu")
    if mutated:
        idx.add(_vecs(rng, 40))
        idx.delete(list(range(0, 540, 11)))
    state = None if idx.mut.is_static else idx.mut
    q = _vecs(rng, 100)
    for b in (1, 13, 64, 100):
        got = idx.search(q[:b], 10, ef=24)
        want = engine.search_eager(idx.backend, state, q[:b], 10, ef=24, bucketed=False)
        assert _same(got, want), b
        full = idx.search(q[:engine.shape_bucket(b)], 10, ef=24)
        assert _same(got, (full[0][:b], full[1][:b]))
    graph = idx.backend.graphs[max(idx.backend.graphs, key=lambda key: key.bucket)]
    loops = idx.backend.max_level + 1
    assert len(graph.parts) == 2 * loops + 1 and len(graph.last_blocks) == loops
    assert graph.last_blocks[-1] > 1          # the beam took more than one block
    # Replaying the latest block counts again changes no byte of the result.
    vals = graph.vals.clone()
    graph.replay_parts(graph.last_blocks)
    assert torch.equal(vals, graph.vals)


def test_warmed_searcher_captures_nothing_more(stand_in_capture):
    rng = np.random.RandomState(37)
    idx = MonaVec.build(_vecs(rng, 300), index="hnsw", m=8, ef_construction=32,
                        device="cpu")
    search = idx.searcher(k=10, ef=32).warmup(64)
    cache = engine.plan_cache()
    before = cache.stats.snapshot()
    for i in range(10):
        search(_vecs(rng, 40 + i))
    delta = cache.stats.since(before)
    assert (delta.captures, delta.misses) == (0, 0)
    assert len(idx.backend.graphs) == 1
    idx.add(_vecs(rng, 5))
    assert not idx.backend.graphs            # they read the old segment set
