"""The port's HNSW backend on the CPU against the reference (paper §3.4.3).

The same numpy inputs go through ``repro`` and ``repro_torch``:

* ``build_graph`` fed the reference's own rotated rows returns the
  reference's graph exactly (neighbour tables, levels, entry point, top
  level): the build is host numpy in both;
* ``search_stage`` fed the reference's graph, codes, norms and rotated
  queries returns the ids of the reference's ``use_kernel=False`` search
  exactly and its scores within the port's f32 rule (``torch_harness``),
  at 4 and 2 bits, cosine and l2, several beam widths, k above ef (the
  engine widens the beam), and a 10% allowlist;
* a padded neighbour list never clears a visited bit, and the argmax and
  top-k take the first of equal scores, as the reference's do;
* the whole path (``MonaVec.build(index="hnsw", device="cpu")``) lands
  within 0.01 of the reference's recall@10 with ids equal in 99% of slots,
  and a search through ``MonaVec`` over the reference's own index, with an
  allowlist or a ``where=`` predicate, returns the reference's ids.

Files, mutation, knobs and the engine's block replays:
tests/test_torch_hnsw_lifecycle.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import MonaVec as RefMonaVec
from repro.core import hnsw as rhnsw
from repro.core import quantize as rqz
from repro.core.allowlist import Allowlist as RefAllowlist
from repro.core.predicate import Eq as RefEq
from repro.core.rhdh import rhdh_apply as ref_rhdh_apply
from repro.core.standardize import prepare as ref_prepare
from repro_torch import MonaVec
from repro_torch.core import hnsw as thnsw
from repro_torch.core.allowlist import Allowlist
from repro_torch.core.convert import encoded_from_arrays, hnsw_from_arrays, meta_from_arrays
from repro_torch.core.predicate import Eq
from repro_torch.core.scoring import topk
from tests.torch_harness import (SENTINEL, adjusted_tolerance, dot_tolerance, port_stream,
                                 reference_stream)

DIM = 64
SEED = 0x6D6F6E61


@pytest.fixture(autouse=True)
def _follow_reference_stream():
    with port_stream(reference_stream()):
        yield


def _vecs(rng, n, dim=DIM):
    """Clustered rows, so the graph has structure to route over."""
    centers = rng.randn(8, dim) * 2
    return (centers[rng.randint(0, 8, n)] + rng.randn(n, dim)).astype(np.float32)


_REF = {}


def _ref_index(metric: str, bits: int, n: int = 800):
    """One reference HNSW build per (metric, bits), shared by the tests."""
    key = (metric, bits, n)
    if key not in _REF:
        x = _vecs(np.random.RandomState(11), n)
        _REF[key] = (rhnsw.HnswIndex.build(jnp.asarray(x), metric=metric, bits=bits, m=8,
                                           ef_construction=40), x)
    return _REF[key]


def _port_of(ref, meta=None):
    """The port's MonaVec over the reference's codes and graph."""
    enc = ref.enc
    return hnsw_from_arrays(
        np.asarray(enc.packed), np.asarray(enc.qnorms), ids=ref.ids,
        neighbors0=ref.neighbors0, neighbors_hi=ref.neighbors_hi, node_level=ref.node_level,
        entry_point=ref.entry_point, max_level=ref.max_level, m=ref.m,
        ef_construction=ref.ef_construction, seed=enc.seed, metric=enc.metric,
        bits=enc.bits, dim=enc.dim, dim_pad=enc.dim_pad, meta=meta, device="cpu")


# ---------------------------------------------------------------------------
# The build.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("metric", ["cosine", "l2"])
@pytest.mark.parametrize("n,seed", [(1, SEED), (2, SEED), (40, 24), (800, SEED)])
def test_build_graph_equals_the_reference(metric, n, seed):
    """Fed the reference's rotated rows, the port's build returns its graph;
    seed 24 draws no upper level for 40 rows at m=8 (max_level 0)."""
    x = _vecs(np.random.RandomState(12), n)
    ref = rhnsw.HnswIndex.build(jnp.asarray(x), metric=metric, seed=seed, m=8,
                                ef_construction=40)
    rot = np.asarray(ref_rhdh_apply(ref_prepare(jnp.asarray(x), metric, None), seed,
                                    normalized=False))
    nbr0, nbr_hi, levels, entry, max_level = thnsw.build_graph(
        rot, metric=metric, m=8, ef_construction=40, seed=seed)
    assert nbr0.dtype == np.int32 and nbr_hi.dtype == np.int32 and levels.dtype == np.int8
    assert nbr0.tobytes() == ref.neighbors0.tobytes()
    assert nbr_hi.shape == ref.neighbors_hi.shape
    assert nbr_hi.tobytes() == ref.neighbors_hi.tobytes()
    assert levels.tobytes() == ref.node_level.tobytes()
    assert (entry, max_level) == (ref.entry_point, ref.max_level)
    if seed == 24:
        assert max_level == 0 and nbr_hi.shape == (0, n, 8)


def test_recommended_m_matches_the_reference():
    for n in (1, 999_999, 1_000_000, 5_000_000):
        assert thnsw.recommended_m(n) == MonaVec.recommended_m(n) == rhnsw.recommended_m(n)


# ---------------------------------------------------------------------------
# The beam.
# ---------------------------------------------------------------------------

def _stage_vs_reference(ref, q, k, ef, allow_mask=None):
    """The port's search_stage on the reference's arrays against the
    reference's use_kernel=False search of the same queries."""
    enc = ref.enc
    n = enc.n
    r_allow = None if allow_mask is None else RefAllowlist(mask=allow_mask,
                                                          n_allowed=int(allow_mask.sum()))
    want_s, want_i = ref.search(jnp.asarray(q), k, ef=ef, allow=r_allow, use_kernel=False)
    q_rot = np.array(rqz.encode_query(jnp.asarray(q), enc))
    tenc = encoded_from_arrays(np.asarray(enc.packed), np.asarray(enc.qnorms), seed=enc.seed,
                               metric=enc.metric, bits=enc.bits, dim=enc.dim,
                               dim_pad=enc.dim_pad, device="cpu")
    live = torch.ones(n, dtype=torch.bool) if allow_mask is None else torch.from_numpy(
        allow_mask)
    trace = []
    vals, rows = thnsw.search_stage(
        torch.from_numpy(q_rot), tenc.packed, tenc.qnorms, torch.from_numpy(ref.neighbors0),
        torch.from_numpy(ref.neighbors_hi) if ref.max_level else None, live,
        entry=ref.entry_point, ef=max(ef, k), k=k, metric=enc.metric, bits=enc.bits,
        n4_dims=0, max_level=ref.max_level, trace=trace)
    vals, rows = vals.numpy(), rows.numpy()
    got_i = np.where(rows >= 0, ref.ids[np.maximum(rows, 0)], SENTINEL)
    assert got_i.tobytes() == want_i.tobytes()
    tol = adjusted_tolerance(dot_tolerance(q_rot, np.asarray(enc.packed), enc.bits),
                             np.asarray(enc.qnorms), enc.metric)
    real = rows >= 0
    bound = np.take_along_axis(tol, np.maximum(rows, 0), axis=1)
    assert np.all(np.abs(vals - want_s)[real] <= bound[real])
    assert np.all(vals[~real] == want_s[~real])
    assert len(trace) == ref.max_level + 1 and trace[-1] > 0
    return got_i


_STAGE_CASES = [(4, "cosine", 17, 5), (4, "cosine", 24, 10), (4, "cosine", 128, 10),
                (4, "cosine", 17, 100), (2, "cosine", 24, 10), (4, "l2", 24, 10),
                (2, "l2", 128, 10)]


@pytest.mark.parametrize("bits,metric,ef,k", _STAGE_CASES)
def test_search_stage_equals_the_reference(bits, metric, ef, k):
    """k=100 above ef=17: the beam widens to 100 rows in both packages."""
    ref, _ = _ref_index(metric, bits)
    q = _vecs(np.random.RandomState(13), 12)
    ids = _stage_vs_reference(ref, q, k, ef)
    assert (ids != SENTINEL).all()


@pytest.mark.parametrize("bits", [4, 2])
def test_search_stage_allowlist_equals_the_reference(bits):
    """A 10% allowlist: routing over every node, only allowed rows returned,
    at least 95% of the slots filled (the reference's own test)."""
    ref, _ = _ref_index("cosine", bits)
    mask = np.zeros(ref.enc.n, dtype=bool)
    mask[::10] = True
    q = _vecs(np.random.RandomState(14), 12)
    ids = _stage_vs_reference(ref, q, 5, 128, allow_mask=mask)
    real = ids != SENTINEL
    assert real.mean() >= 0.95 and (ids[real].astype(np.int64) % 10 == 0).all()


def test_padded_neighbours_never_clear_a_visited_bit():
    """Row 0 is the entry and every neighbour list is -1 padded: the
    reference's scatter clamps -1 to row 0 and ORs, a plain index_put would
    let a padded slot's False win.  The visited bit of row 0 stays set
    through every step, row 0 enters the result once, and the ids equal the
    reference's on the same hand-made graph."""
    n, m = 6, 2
    nbr0 = np.full((n, 2 * m), -1, dtype=np.int32)
    nbr0[0, :1] = [1]                 # 0 -> 1, three padded slots
    nbr0[1, :2] = [0, 2]
    nbr0[2, :3] = [1, 3, 0]
    nbr0[3, :2] = [4, 5]
    nbr0[4, :1] = [3]
    nbr0[5, :1] = [3]
    x = _vecs(np.random.RandomState(15), n, dim=16)
    enc = rqz.encode(jnp.asarray(x), metric="cosine", seed=SEED, bits=4)
    ref = rhnsw.HnswIndex(enc=enc, ids=np.arange(n, dtype=np.uint64), neighbors0=nbr0,
                          neighbors_hi=np.zeros((0, n, m), np.int32),
                          node_level=np.zeros(n, np.int8), entry_point=0, max_level=0, m=m)
    q = _vecs(np.random.RandomState(16), 3, dim=16)
    want = ref.search(jnp.asarray(q), 6, ef=6, use_kernel=False)[1]

    tenc = encoded_from_arrays(np.asarray(enc.packed), np.asarray(enc.qnorms), seed=SEED,
                               metric="cosine", bits=4, dim=16, dim_pad=16, device="cpu")
    q_rot = torch.from_numpy(np.asarray(rqz.encode_query(jnp.asarray(q), enc)))
    env = (q_rot, tenc.packed, tenc.qnorms, torch.from_numpy(nbr0), None,
           torch.ones(n, dtype=torch.bool), torch.ones(3, dtype=torch.bool))
    start, middle, finish = thnsw.search_program(entry=0, ef=6, k=6, metric="cosine",
                                                 bits=4, n4_dims=0, max_level=0)
    beam_start, loop = middle
    st = beam_start(env, start(env))
    steps = 0
    while bool(loop.more(st)):
        st = loop.step(env, st)
        steps += 1
        assert st[3][:, 0].all(), "a padded neighbour cleared row 0's visited bit"
    assert steps > 0
    rows = finish(env, st)[1].numpy()
    for r in rows:
        real = r[r >= 0]
        assert len(set(real.tolist())) == len(real) and (real == 0).sum() == 1
    assert np.where(rows >= 0, rows, -1).astype(np.uint64).tobytes() == \
        np.where(want == SENTINEL, np.uint64(0xFFFFFFFFFFFFFFFF), want).tobytes()
    # A step past convergence changes no byte of the state.
    again = loop.step(env, tuple(t.clone() for t in st))
    assert all(torch.equal(a, b) for a, b in zip(again, st))


def test_ties_go_to_the_first_index():
    """``torch.argmax`` returns the first maximum (as ``jnp.argmax``) and
    ``scoring.topk`` lets the lower index win (as ``lax.top_k``)."""
    s = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0]])
    assert int(torch.argmax(s, dim=1)) == 1
    assert topk(s, 3)[1].tolist() == [[1, 2, 4]]
    assert int(jnp.argmax(jnp.asarray(s.numpy()), axis=1)[0]) == 1


# ---------------------------------------------------------------------------
# The whole path.
# ---------------------------------------------------------------------------

def _recall(found: np.ndarray, exact: np.ndarray) -> float:
    return float(np.mean([len(set(a.tolist()) & set(b.tolist())) / exact.shape[1]
                          for a, b in zip(found, exact)]))


@pytest.mark.parametrize("metric", ["cosine", "l2"])
def test_whole_path_recall_and_ids_match_the_reference(metric):
    """Port build + search on the CPU against the reference's: recall@10
    within 0.01 of it and ids equal in at least 99% of slots (a code flip
    of the rotation may move an edge or a score)."""
    rng = np.random.RandomState(17)
    x, q = _vecs(rng, 1000), _vecs(rng, 40)
    port = MonaVec.build(x, index="hnsw", metric=metric, m=8, ef_construction=48,
                         device="cpu")
    ref = RefMonaVec.build(jnp.asarray(x), index="hnsw", metric=metric, m=8,
                           ef_construction=48)
    got = port.search(q, 10, ef=32)[1]
    want = ref.search(jnp.asarray(q), 10, ef=32)[1]
    if metric == "cosine":
        xn = x / np.linalg.norm(x, axis=1, keepdims=True)
        exact = np.argsort(-(q @ xn.T), axis=1, kind="stable")[:, :10]
    else:
        exact = np.argsort(((q[:, None, :] - x[None]) ** 2).sum(-1), axis=1,
                           kind="stable")[:, :10]
    assert abs(_recall(got, exact) - _recall(want, exact)) <= 0.01
    assert np.mean(got == want) >= 0.99


@pytest.mark.parametrize("filt", ["allow", "where"])
def test_filtered_search_over_the_reference_index(filt):
    """``MonaVec.search`` over the reference's own index (codes and graph
    carried across with ``hnsw_from_arrays``) with a 10% allowlist or a
    ``where=`` predicate returns the reference's ids, all admissible."""
    ref_be, x = _ref_index("cosine", 4)
    n = ref_be.enc.n
    g = np.arange(n) % 10
    ref = RefMonaVec(backend=ref_be)
    port = _port_of(ref_be, meta=meta_from_arrays({"g": ("i64", g, None)}))
    q = _vecs(np.random.RandomState(18), 12)
    if filt == "allow":
        mask = g == 3
        got = port.search(q, 5, ef=64, allow=Allowlist(mask=mask, n_allowed=int(mask.sum())))
        want = ref.search(jnp.asarray(q), 5, ef=64,
                          allow=RefAllowlist(mask=mask, n_allowed=int(mask.sum())))
    else:
        from repro.core.metadata import MetaStore as RefMetaStore
        ref.meta = RefMetaStore.build({"g": g}, n)
        got = port.search(q, 5, ef=64, where=Eq("g", 3))
        want = ref.search(jnp.asarray(q), 5, ef=64, where=RefEq("g", 3))
    assert got[1].tobytes() == want[1].tobytes()
    real = got[1] != SENTINEL
    assert real.mean() >= 0.95 and (got[1][real].astype(np.int64) % 10 == 3).all()
