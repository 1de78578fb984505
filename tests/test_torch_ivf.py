"""The port's IVF backend on the CPU against the reference (paper §3.4.2).

The same numpy inputs go through ``repro`` and ``repro_torch``:

* ``_seeded_init`` is host numpy in both: the same rotated rows in, the
  same rows chosen;
* ``_kmeans`` from one init: the products are summed in another order
  (XLA against MKL), so centroids are held to 1e-5 a coordinate and
  assignments equal except where a row's two best centroid scores tie
  within 1e-5 (counted);
* on an index carried across with ``convert.ivf_from_arrays``, the probe
  lists equal the reference's except where centroid scores tie within the
  f32 rule (counted: none at these seeds), the candidate matrices of equal
  probe lists are equal exactly, and searches match under the tolerance
  rule (``torch_harness``): ids equal except ties, scores within it,
  sentinel slots equal;
* allowlists and ``where=`` mask the candidates before the top-k.

Mutation, files and graphs: tests/test_torch_ivf_lifecycle.py.
"""

import hashlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import MonaVec as RefMonaVec
from repro.core import ivf as rivf
from repro.core import predicate as rpred
from repro.core import quantize as rqz
from repro.core.allowlist import Allowlist as RefAllowlist
from repro.core.rhdh import rhdh_apply as ref_rhdh_apply
from repro.core.standardize import prepare as ref_prepare
from repro_torch import MonaVec, engine
from repro_torch.core import ivf as tivf
from repro_torch.core import predicate as tpred
from repro_torch.core.allowlist import Allowlist
from repro_torch.core.convert import meta_from_arrays, segmented_from_arrays
from repro_torch.core.predicate import Eq, Ge
from repro_torch.core.scoring import topk
from repro_torch.engine import plan as plan_mod
from tests.torch_harness import (SENTINEL, _segments_of, assert_search_matches,
                                 dot_tolerance, port_stream, reference_full_scores,
                                 reference_stream, segmented_tolerance)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
DIM = 32


@pytest.fixture(autouse=True)
def _follow_reference_stream():
    with port_stream(reference_stream()):
        yield


def _vecs(rng, n, dim=DIM):
    """Clustered rows: 6 centers plus noise, so the cells are uneven."""
    centers = rng.randn(6, dim) * 3
    return (centers[rng.randint(0, 6, n)] + rng.randn(n, dim)).astype(np.float32)


def _sha(path) -> str:
    with open(path, "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()


def _port_of(ref):
    """The port's IVF MonaVec over the reference's segments, lists and metadata."""
    be = ref.backend
    enc = be.enc
    std = enc.std
    segs = [{"packed": np.asarray(e.packed), "qnorms": np.asarray(e.qnorms), "seed": e.seed,
             "ids": ids, "tombs": tombs} for e, ids, tombs in _segments_of(ref)]
    meta = None if ref.meta is None else meta_from_arrays(
        {n: (c.kind, c.values, c.vocab) for n, c in ref.meta.columns.items()})
    return segmented_from_arrays(
        segs, next_ordinal=ref.mut.next_ordinal, metric=enc.metric, bits=enc.bits,
        dim=enc.dim, dim_pad=enc.dim_pad, std_mean=None if std is None else std.mean,
        std_inv_std=None if std is None else std.inv_std, meta=meta, device="cpu",
        ivf={"centroids": np.asarray(be.centroids), "order": be.order,
             "offsets": be.offsets, "nlist": be.nlist})


def _ref_ivf(metric="cosine", bits=4, n=240, nlist=12, seed=3, meta=False):
    rng = np.random.RandomState(seed)
    x = _vecs(rng, n)
    cols = None
    if meta:
        cols = {"lang": np.array(["en", "de", "fr"])[rng.randint(0, 3, n)],
                "date": rng.randint(0, 100, n).astype(np.int64)}
    ref = RefMonaVec.build(jnp.asarray(x), metric=metric, bits=bits, index="ivf", nlist=nlist,
                           train_iters=8, meta=cols)
    return ref, rng, x


def _compare(idx, ref, q, k, ref_kw=None, **kw):
    got = idx.search(q, k, **kw)
    want = ref.search(jnp.asarray(q), k, **(kw if ref_kw is None else ref_kw))
    assert np.array_equal(got[1] == SENTINEL, want[1] == SENTINEL)
    assert_search_matches(got, want, reference_full_scores(ref, q), idx.ids,
                          segmented_tolerance(idx, q))
    return got, want


# ---------------------------------------------------------------------------
# Clustering.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("metric", ["cosine", "dot", "l2"])
def test_seeded_init_picks_the_reference_rows(metric):
    rng = np.random.RandomState(21)
    x = _vecs(rng, 300)
    rot = np.asarray(ref_rhdh_apply(ref_prepare(jnp.asarray(x), metric, None), 7,
                                    normalized=False))
    want = rivf._seeded_init(rot, 16, 7, metric)
    got = tivf._seeded_init(rot, 16, 7, metric)
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("metric", ["cosine", "dot", "l2"])
def test_kmeans_from_one_init_matches_the_reference(metric):
    rng = np.random.RandomState(22)
    x = np.asarray(ref_rhdh_apply(ref_prepare(jnp.asarray(_vecs(rng, 400)), metric, None), 9,
                                  normalized=False))
    init = rivf._seeded_init(x, 10, 9, metric)
    r_cents, r_assign = rivf._kmeans(jnp.asarray(x), jnp.asarray(init), n_clusters=10,
                                     metric=metric, iters=12)
    t_cents, t_assign = tivf._kmeans(torch.from_numpy(x), torch.from_numpy(init),
                                     n_clusters=10, metric=metric, iters=12)
    r_cents, r_assign = np.asarray(r_cents), np.asarray(r_assign)
    scale = np.abs(r_cents).max()
    assert np.abs(t_cents.numpy() - r_cents).max() <= 1e-5 * scale
    diff = np.flatnonzero(t_assign.numpy() != r_assign)
    # A row may change cell only where its two best centroid scores tie.
    if metric == "l2":
        s = -((x[:, None, :] - r_cents[None]) ** 2).sum(-1)
    else:
        s = x @ r_cents.T
    top2 = np.sort(s[diff], axis=1)[:, -2:]
    assert (top2[:, 1] - top2[:, 0] <= 1e-5 * np.abs(s).max()).all()
    assert diff.size <= 2, f"{diff.size} assignments differ"


def test_kmeans_keeps_an_empty_cluster_and_never_scatters(monkeypatch):
    """An empty cluster keeps its centroid; the sums are one product."""
    x = torch.tensor([[1.0, 0.0], [0.9, 0.1], [0.0, 1.0]])
    init = torch.tensor([[1.0, 0.0], [0.0, 1.0], [-1.0, 0.0]])
    for name in ("index_add", "scatter_add"):
        monkeypatch.setattr(torch.Tensor, f"{name}_", lambda *a, **k: pytest.fail(name))
    cents, assign = tivf._kmeans(x, init, n_clusters=3, metric="dot", iters=3)
    assert assign.tolist() == [0, 0, 1]
    assert torch.equal(cents[2], init[2])
    r_cents, r_assign = rivf._kmeans(jnp.asarray(x.numpy()), jnp.asarray(init.numpy()),
                                     n_clusters=3, metric="dot", iters=3)
    assert np.allclose(cents.numpy(), np.asarray(r_cents), atol=1e-6)


def test_build_is_deterministic_and_sane(tmp_path):
    rng = np.random.RandomState(23)
    x = _vecs(rng, 200)
    paths = []
    for i in range(2):
        idx = MonaVec.build(x, index="ivf", nlist=8, train_iters=6, device="cpu")
        paths.append(str(tmp_path / f"{i}.mvec"))
        idx.save(paths[-1])
    assert _sha(paths[0]) == _sha(paths[1])
    be = idx.backend
    assert be.nlist == 8 and be.offsets[0] == 0 and be.offsets[-1] == 200
    assert np.array_equal(np.sort(be.order), np.arange(200))
    assert torch.allclose(torch.linalg.vector_norm(be.centroids, dim=1), torch.ones(8),
                          atol=1e-5)
    assert be.order_t.dtype == torch.int64 and torch.equal(be.order_t,
                                                           torch.from_numpy(be.order))


# ---------------------------------------------------------------------------
# The probe scan on a carried-across index.
# ---------------------------------------------------------------------------

def _ref_intermediates(ref, q, k, nprobe, monkeypatch):
    """The reference's probe lists and candidate matrix of one search_stage
    call (run unjitted, its topk and score_gathered recorded)."""
    seen = {}
    real_topk, real_score = rivf.topk, rivf.ops.score_gathered

    def rec_topk(s, kk):
        out = real_topk(s, kk)
        seen.setdefault("probe", np.asarray(out[1]))
        return out

    def rec_score(packed, q_rot, cand, **kw):
        seen["cand"] = np.asarray(cand)
        return real_score(packed, q_rot, cand, **kw)

    monkeypatch.setattr(rivf, "topk", rec_topk)
    monkeypatch.setattr(rivf.ops, "score_gathered", rec_score)
    be = ref.backend
    q_rot = rqz.encode_query(jnp.asarray(q), be.enc)
    max_cand = be.max_candidates(nprobe)
    vals, rows = rivf.search_stage(
        q_rot, be.centroids, be.order_j, be.offsets_j, be.enc.packed, be.enc.qnorms, None,
        k=k, nprobe=nprobe, max_cand=max_cand, metric=be.enc.metric, bits=be.enc.bits,
        n4_dims=be.enc.n4_dims, use_kernel=False, interpret=False)
    monkeypatch.undo()
    return np.asarray(q_rot), seen["probe"], seen["cand"], max_cand


@pytest.mark.parametrize("metric", ["cosine", "dot", "l2"])
def test_probe_lists_and_candidates_equal_the_reference(metric, monkeypatch):
    ref, rng, _ = _ref_ivf(metric)
    idx = _port_of(ref)
    be = idx.backend
    q = _vecs(rng, 6)
    ties = 0
    for nprobe in (1, 4, be.nlist):
        q_rot, r_probe, r_cand, max_cand = _ref_intermediates(ref, q, 10, nprobe, monkeypatch)
        assert be.max_candidates(nprobe) == max_cand
        cs = tivf.probe_scores(torch.from_numpy(q_rot), be.centroids, metric)
        probe = topk(cs, nprobe)[1]
        cand = tivf.candidates(probe, be.order_t, be.offsets_t, max(max_cand, 10)).numpy()
        same = (probe.numpy() == r_probe).all(axis=1)
        # A probe list may differ only where two centroid scores tie within
        # the f32 rule of the product (1e-5 * sum |q_i c_i| + 1e-6).
        tol = 1e-5 * (np.abs(q_rot) @ np.abs(be.centroids.numpy()).T) + 1e-6
        for b in np.flatnonzero(~same):
            ties += 1
            j = np.flatnonzero(probe.numpy()[b] != r_probe[b])[0]
            s = cs.numpy()[b]
            a, c = probe.numpy()[b, j], r_probe[b, j]
            assert abs(s[a] - s[c]) <= tol[b, a] + tol[b, c]
        assert np.array_equal(cand[same], r_cand[same])
        assert cand.shape == r_cand.shape and cand.dtype == np.int64
    assert ties == 0


@pytest.mark.parametrize("bits", [4, 2])
@pytest.mark.parametrize("metric", ["cosine", "dot", "l2"])
def test_search_matches_the_reference(metric, bits):
    ref, rng, _ = _ref_ivf(metric, bits)
    idx = _port_of(ref)
    q = _vecs(rng, 6)
    for nprobe in (1, 4, 12):
        _compare(idx, ref, q, 10, nprobe=nprobe)
    _compare(idx, ref, q, 10, ref_kw={}, nprobe=None)     # the default, 8
    _compare(idx, ref, q, 300, nprobe=2)                   # k above the candidates


@pytest.mark.parametrize("metric", ["cosine", "l2"])
def test_all_cells_is_the_full_scan(metric):
    """At nprobe = nlist every row is a candidate: the port's IVF search is
    its own full scan's, ids equal except ties and scores within the rule
    (on the card byte-equal: chip_smoke.py phase 7b)."""
    ref, rng, x = _ref_ivf(metric)
    idx = _port_of(ref)
    be = idx.backend
    full = MonaVec.from_arrays(be.enc.packed.numpy(), be.enc.qnorms.numpy(), seed=be.enc.seed,
                               metric=metric, bits=4, dim=DIM, dim_pad=be.enc.dim_pad,
                               ids=be.ids, device="cpu")
    q = _vecs(rng, 6)
    got, want = idx.search(q, 10, nprobe=be.nlist), full.search(q, 10)
    scores = full.backend.scores(torch.from_numpy(q)).numpy()
    q_rot = rqz.encode_query(jnp.asarray(q), ref.backend.enc)
    tol = dot_tolerance(np.asarray(q_rot), be.enc.packed.numpy())
    if metric == "cosine":
        tol = tol / be.enc.qnorms.numpy()[None, :]
    assert_search_matches(got, want, scores, be.ids, tol)


def test_allowlist_and_where_on_ivf():
    ref, rng, _ = _ref_ivf(meta=True)
    idx = _port_of(ref)
    q = _vecs(rng, 5)
    mask = np.arange(idx.n_total) % 4 != 1
    _compare(idx, ref, q, 8, ref_kw={"nprobe": 4, "allow": RefAllowlist(mask=mask,
                                                                       n_allowed=int(mask.sum()))},
             nprobe=4, allow=Allowlist(mask=mask, n_allowed=int(mask.sum())))
    p = Eq("lang", "en") & Ge("date", 30)
    rp = rpred.And(rpred.Eq("lang", "en"), rpred.Ge("date", 30))
    got, _ = _compare(idx, ref, q, 8, ref_kw={"nprobe": 4, "where": rp}, nprobe=4, where=p)
    admissible = idx.ids[tpred.evaluate(p, idx.meta)]
    assert np.isin(got[1][got[1] != SENTINEL], admissible).all()
    oracle = idx.search(q, 8, nprobe=4, where_mask=tpred.evaluate(p, idx.meta))
    assert oracle[0].tobytes() == got[0].tobytes() and oracle[1].tobytes() == got[1].tobytes()


def test_knobs_and_plan_keys():
    ref, rng, _ = _ref_ivf()
    idx = _port_of(ref)
    assert idx.resolved_knobs(10) == ref.resolved_knobs(10) == {"nprobe": 8}
    assert idx.resolved_knobs(10, nprobe=64) == ref.resolved_knobs(10, nprobe=64) == \
        {"nprobe": 12}
    with pytest.raises(TypeError, match="unexpected search kwargs"):
        idx.resolved_knobs(10, rescore_mult=2)
    with pytest.raises(ValueError, match="nprobe must be >= 1"):
        idx.search(_vecs(rng, 1), 3, nprobe=0)
    be = idx.backend
    fp = plan_mod._fingerprint(be, [], {"nprobe": 4})
    assert fp[-1] == (12, be.max_candidates(4))
    cache = engine.plan_cache()
    q = _vecs(rng, 3)
    before = cache.stats.snapshot()
    idx.search(q, 5, nprobe=12)
    idx.search(q, 5, nprobe=40)          # clamped to 12: the same plan
    idx.search(q, 5, nprobe=4)
    delta = cache.stats.since(before)
    assert delta.misses == 2 and delta.hits == 1
    with pytest.raises(TypeError, match="requires the bruteforce backend"):
        idx.enable_coarse("sign")
    with pytest.raises(TypeError, match="unexpected build kwargs"):
        MonaVec.build(_vecs(rng, 10), nlist=4, device="cpu")
