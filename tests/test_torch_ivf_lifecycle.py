"""The port's IVF index under mutation, in files and in the engine's
graphs, on the CPU against the reference (paper §3.4.2, DESIGN.md §6-§7).

* add / delete on an index carried across from the reference search as the
  reference's does (the tolerance rule of ``torch_harness``), and compact
  clusters the live rows again, as the port's own build of them;
* the v8 IVF fixture loads, saves its own bytes and searches as the
  reference does, and port-written IVF files load in the reference;
* the engine keeps a graph per plan of one segment set (the eviction rule,
  run on the CPU with stand-in graphs).
"""

import os
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import MonaVec as RefMonaVec
from repro.core import predicate as rpred
from repro_torch import MonaVec, engine
from repro_torch.core.convert import ivf_from_arrays
from repro_torch.core.ivf import IvfFlatIndex
from repro_torch.core.predicate import Eq, In
from repro_torch.engine import plan as plan_mod
from tests.test_torch_ivf import DIM, _compare, _port_of, _ref_ivf, _sha, _vecs
from tests.torch_harness import SENTINEL, _segments_of, port_stream, reference_stream

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


@pytest.fixture(autouse=True)
def _follow_reference_stream():
    with port_stream(reference_stream()):
        yield


def test_add_delete_search_against_the_reference():
    ref, rng, _ = _ref_ivf(meta=True)
    ref.add(jnp.asarray(_vecs(rng, 30)),
            meta={"lang": np.array(["en"] * 30), "date": np.arange(30, dtype=np.int64)})
    ref.add(jnp.asarray(_vecs(rng, 10)),
            meta={"lang": np.array(["es"] * 10), "date": np.arange(10, dtype=np.int64)})
    ref.delete(np.concatenate([ref.ids[:240:7], ref.ids[240::4]]))
    idx = _port_of(ref)
    q = _vecs(rng, 6)
    for nprobe in (1, 5):
        got, _ = _compare(idx, ref, q, 10, nprobe=nprobe)
        dead = np.concatenate([ids[t] for _, ids, t in _segments_of(idx)])
        assert not np.isin(got[1], dead).any()
    rp = rpred.Eq("lang", "en")
    _compare(idx, ref, q, 10, ref_kw={"nprobe": 3, "where": rp}, nprobe=3,
             where=Eq("lang", "en"))


def test_compact_reclusters_the_live_rows(tmp_path):
    """compact() decodes the live rows and builds again with
    nlist = min(nlist, n_live), carrying the metadata; two equal op
    sequences give equal files, the result is the port's own build over the
    reconstructed rows, and it matches the reference's compaction."""
    from repro_torch.core import segments as seg

    ref, rng, _ = _ref_ivf(n=60, nlist=12, meta=True)
    y = _vecs(rng, 8)
    idx, twin = _port_of(ref), _port_of(ref)
    for index in (idx, twin):
        index.add(y, meta={"lang": np.array(["en"] * 8), "date": np.arange(8)})
    dead = idx.ids[::6]
    for index in (idx, twin):
        index.delete(dead)
    live_vecs = torch.cat([seg.reconstruct_vectors(e)[torch.from_numpy(~t)]
                           for e, _, t in _segments_of(idx)])
    live_ids = np.concatenate([i[~t] for _, i, t in _segments_of(idx)])
    n_live = idx.n_live
    assert idx.compact() == len(dead) and twin.compact() == len(dead)
    be = idx.backend
    assert isinstance(be, IvfFlatIndex) and idx.mut.is_static and be.nlist == 12
    assert np.array_equal(idx.ids, live_ids) and idx.meta.n_rows == n_live
    own = IvfFlatIndex.build(live_vecs, ids=live_ids, metric="cosine", seed=be.enc.seed,
                             nlist=12)
    assert torch.equal(be.enc.packed, own.enc.packed) and np.array_equal(be.order, own.order)
    a, b = str(tmp_path / "a.mvec"), str(tmp_path / "b.mvec")
    idx.save(a)
    twin.save(b)
    assert _sha(a) == _sha(b)
    # The reference's compaction after the same ops: the same ids, columns
    # and cells; codes and assignments may part only where a rotated value
    # or a centroid score lands on a boundary in its last bits (one row at
    # most here), and centroids agree to 1e-5 of their scale.
    ref.add(jnp.asarray(y), meta={"lang": np.array(["en"] * 8), "date": np.arange(8)})
    ref.delete(dead)
    ref.compact()
    rb = ref.backend
    assert np.array_equal(idx.ids, ref.ids) and rb.nlist == be.nlist
    for name, col in idx.meta.columns.items():
        assert col.values.tobytes() == ref.meta[name].values.tobytes()
    r_cents = np.asarray(rb.centroids)
    assert np.abs(be.centroids.numpy() - r_cents).max() <= 1e-5 * np.abs(r_cents).max()
    assert (np.asarray(rb.enc.packed) != be.enc.packed.numpy()).any(axis=1).sum() <= 1

    def assignment(b_):
        out = np.empty(b_.enc.n, dtype=np.int64)
        out[b_.order] = np.repeat(np.arange(b_.nlist), np.diff(b_.offsets))
        return out
    assert (assignment(rb) != assignment(be)).sum() <= 1
    # Fewer live rows than cells: the cells shrink to the rows.
    small = MonaVec.build(_vecs(rng, 20), index="ivf", nlist=8, device="cpu")
    small.delete(small.ids[:15])
    small.compact()
    assert small.backend.nlist == 5 and small.n_total == 5


# ---------------------------------------------------------------------------
# Files.
# ---------------------------------------------------------------------------

def test_golden_v8_ivf_loads_saves_and_searches(tmp_path):
    src = os.path.join(GOLDEN, "v8_segmented_ivf.mvec")
    idx, ref = MonaVec.load(src, device="cpu"), RefMonaVec.load(src)
    assert isinstance(idx.backend, IvfFlatIndex) and len(idx.mut.extras) == 2
    assert np.array_equal(idx.backend.centroids.numpy(), np.asarray(ref.backend.centroids))
    out = str(tmp_path / "v8.mvec")
    idx.save(out)
    assert _sha(out) == _sha(src)
    q = np.random.RandomState(5).randn(4, 16).astype(np.float32)
    for nprobe in (1, 2, 3):
        _compare(idx, ref, q, 5, nprobe=nprobe)


@pytest.mark.parametrize("bits", [4, 2])
def test_port_written_ivf_files_load_in_the_reference(bits, tmp_path):
    rng = np.random.RandomState(31)
    idx = MonaVec.build(_vecs(rng, 150), index="ivf", nlist=6, train_iters=5, bits=bits,
                        metric="l2", meta={"g": rng.randint(0, 3, 150)}, device="cpu")
    path = str(tmp_path / "static.mvec")
    idx.save(path)
    assert open(path, "rb").read()[4] == 9
    idx.add(_vecs(rng, 12), meta={"g": np.zeros(12, np.int64)})
    idx.delete(idx.ids[::10])
    mpath = str(tmp_path / "mutated.mvec")
    idx.save(mpath)
    for p in (path, mpath):
        ref = RefMonaVec.load(p)
        again = str(tmp_path / "again.mvec")
        ref.save(again)
        assert _sha(again) == _sha(p)
        port = MonaVec.load(p, device="cpu")
        q = _vecs(rng, 4)
        _compare(port, ref, q, 6, nprobe=3)
        rp = rpred.Eq("g", 1)
        _compare(port, ref, q, 6, ref_kw={"nprobe": 3, "where": rp}, nprobe=3, where=Eq("g", 1))


def test_ivf_from_arrays_checks_what_it_is_given():
    ref, _, _ = _ref_ivf(n=60, nlist=4)
    be, enc = ref.backend, ref.backend.enc
    kw = dict(ids=be.ids, centroids=np.asarray(be.centroids), order=be.order,
              offsets=be.offsets, nlist=4, seed=enc.seed, metric=enc.metric, bits=4,
              dim=DIM, dim_pad=enc.dim_pad, device="cpu")
    idx = ivf_from_arrays(np.asarray(enc.packed), np.asarray(enc.qnorms), **kw)
    assert isinstance(idx.backend, IvfFlatIndex) and idx.mut.is_static
    for bad in ({"order": be.order[::-1][:-1]}, {"offsets": be.offsets[:-1]},
                {"centroids": np.zeros((4, 3), np.float32)}):
        with pytest.raises(ValueError):
            ivf_from_arrays(np.asarray(enc.packed), np.asarray(enc.qnorms), **{**kw, **bad})


# ---------------------------------------------------------------------------
# Graphs: one per plan of one segment set.
# ---------------------------------------------------------------------------

def test_graph_eviction_is_keyed_on_the_segment_set():
    """A new plan over the same segments keeps every other cached plan's
    graph; the graph under its own key, graphs over another segment set and
    graphs whose plan left the plan LRU go."""
    a, b, c = object(), object(), object()
    k = [plan_mod.PlanKey(fingerprint=(i,), bucket=8, k=10, device="cuda:0", knobs=())
         for i in range(4)]
    held = {k[0]: SimpleNamespace(segments=(a,)), k[1]: SimpleNamespace(segments=(a,)),
            k[2]: SimpleNamespace(segments=(a, b))}
    cached = set(k)
    assert plan_mod.graphs_to_free(held, k[3], (a,), cached) == [k[2]]
    assert plan_mod.graphs_to_free(held, k[1], (a,), cached) == [k[1], k[2]]
    assert plan_mod.graphs_to_free(held, k[3], (a, b), cached) == [k[0], k[1]]
    assert plan_mod.graphs_to_free(held, k[3], (a, c), cached) == [k[0], k[1], k[2]]
    assert plan_mod.graphs_to_free({}, k[0], (a,), cached) == []
    assert plan_mod.graphs_to_free(held, k[3], (a,), {k[1], k[3]}) == [k[0], k[2]]


def test_graphs_held_stay_within_the_plan_lru(monkeypatch):
    """Callers sending ever new filter shapes (here ``In`` sets of growing
    size, each a new plan) leave an index at most the plan LRU's capacity of
    graphs, and the graphs beyond it are freed, not merely unlisted."""
    from tests.test_torch_engine import _FakeGraph

    monkeypatch.setattr(plan_mod, "_on_card", lambda dev: True)
    monkeypatch.setattr(plan_mod, "_Graph", _FakeGraph)
    monkeypatch.setattr(engine.plan_cache(), "maxsize", 4)
    _FakeGraph.live = []
    rng = np.random.RandomState(35)
    n = 200
    tags = np.array([f"t{i}" for i in range(12)])
    cols = {"tag": tags[rng.randint(0, len(tags), n)]}
    for index in (MonaVec.build(_vecs(rng, n), meta=cols, device="cpu"),
                  MonaVec.build(_vecs(rng, n), index="ivf", nlist=8, train_iters=3,
                                meta=cols, device="cpu")):
        q = _vecs(rng, 3)
        for size in range(1, len(tags) + 1):
            p = In("tag", list(tags[:size]))
            s, i = index.search(q, 5, where=p)
            assert np.isin(i[i != SENTINEL], index.ids[np.isin(cols["tag"], tags[:size])]
                           ).all()
            assert len(index.backend.graphs) <= 4
        assert set(index.backend.graphs) <= set(engine.plan_cache()._plans)
    assert _FakeGraph.alive() <= 8


def test_mixed_traffic_captures_once_per_plan(monkeypatch):
    """Unfiltered, filtered, nprobe 8 and nprobe 16 searches of one index
    (run on the CPU with stand-in graphs) capture once each, then replay."""
    from tests.test_torch_engine import _FakeGraph

    monkeypatch.setattr(plan_mod, "_on_card", lambda dev: True)
    monkeypatch.setattr(plan_mod, "_Graph", _FakeGraph)
    _FakeGraph.live = []
    rng = np.random.RandomState(33)
    n = 300
    cols = {"lang": np.array(["en", "de"])[rng.randint(0, 2, n)]}
    x = _vecs(rng, n)
    flat = MonaVec.build(x, meta=cols, device="cpu")
    ivf = MonaVec.build(x, index="ivf", nlist=20, train_iters=4, meta=cols, device="cpu")
    q = _vecs(rng, 5)
    traffic = [(flat, {}), (flat, {"where": Eq("lang", "en")}), (ivf, {"nprobe": 8}),
               (ivf, {"nprobe": 16}), (ivf, {"nprobe": 16, "where": Eq("lang", "de")})]
    cache = engine.plan_cache()
    first = [index.search(q, 5, **kw) for index, kw in traffic]
    before = cache.stats.snapshot()
    for _ in range(3):
        for (index, kw), want in zip(traffic, first):
            got = index.search(q, 5, **kw)
            assert got[0].tobytes() == want[0].tobytes() and \
                got[1].tobytes() == want[1].tobytes()
    assert cache.stats.since(before).captures == 0
    assert len(flat.backend.graphs) == 2 and len(ivf.backend.graphs) == 3
    # Other constants of one structure: the same graph, another answer.
    de = flat.search(q, 5, where=Eq("lang", "de"))
    assert cache.stats.since(before).captures == 0
    assert np.isin(de[1], flat.ids[cols["lang"] == "de"]).all()
    eager = engine.search_eager(flat.backend, None, q, 5, where=Eq("lang", "de"),
                                meta=flat.meta)
    assert de[0].tobytes() == eager[0].tobytes() and de[1].tobytes() == eager[1].tobytes()
