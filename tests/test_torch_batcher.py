"""The port's MicroBatcher and TenantRegistry on the CPU, held to the
reference's contract (tests/test_engine.py::TestMicroBatcher,
tests/test_tenancy.py) and to the reference's batcher on the same corpora.

A coalesced request returns the bytes a direct search of its rows returns
(bucketing keeps each row's bytes, tests/test_torch_engine.py); against the
reference's batcher the rule is the port's f32 rule over one shared
encoding.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from repro import engine as rengine
from repro import obs as robs
from repro.core import TenantRegistry as RefTenantRegistry
from repro_torch import MonaVec, engine, obs
from repro_torch.core.tenancy import PUBLIC_NAMESPACE, TenantRegistry
from tests.torch_harness import (assert_search_matches, port_stream, reference_full_scores,
                                 reference_over_port, reference_stream, segmented_tolerance)

DIM = 32


@pytest.fixture(autouse=True)
def _follow_reference_stream():
    with port_stream(reference_stream()):
        yield


def _vecs(rng, n, dim=DIM):
    return rng.randn(n, dim).astype(np.float32)


def _registry(corpora):
    reg = TenantRegistry()
    for tok, x in corpora.items():
        reg.put(tok, "docs", MonaVec.build(x, metric="cosine", device="cpu"))
    return reg


def test_coalesced_equals_direct():
    rng = np.random.RandomState(41)
    reg = _registry({"a": _vecs(rng, 60)})
    mb = engine.MicroBatcher(reg)
    requests = [_vecs(rng, m) for m in (3, 1, 5, 2)]
    tickets = [mb.submit("a", "docs", q, k=4) for q in requests]
    assert mb.pending == 4 and mb.pending_rows == 11
    assert mb.flush() == 1                      # one coalesced plan call
    direct = reg.get("a", "docs")
    for q, t in zip(requests, tickets):
        s_d, i_d = direct.search(q, 4)
        s_mb, i_mb = t.result()
        assert i_mb.tobytes() == i_d.tobytes() and s_mb.tobytes() == s_d.tobytes()
    assert (mb.stats.requests, mb.stats.rows, mb.stats.executions, mb.stats.flushes) == \
        (4, 11, 1, 1)


@pytest.mark.parametrize("mutated", [False, True])
def test_coalesced_matches_the_reference_batcher(mutated):
    """Both packages' batchers over one set of segments: the same groups and
    executions, results within the f32 rule, cascade knobs included."""
    rng = np.random.RandomState(40)
    idx = MonaVec.build(_vecs(rng, 80), coarse="sign", device="cpu")
    if mutated:
        idx.add(_vecs(rng, 20))
        idx.delete(idx.ids[::9])
    ref = reference_over_port(idx)
    reg, rreg = TenantRegistry(), RefTenantRegistry()
    reg.put("a", "docs", idx)
    rreg.put("a", "docs", ref)
    mb, rmb = engine.MicroBatcher(reg), rengine.MicroBatcher(rreg, use_kernel=False)
    requests = [(_vecs(rng, m), kw) for m, kw in ((2, {}), (3, {"rescore_mult": 2}),
                                                  (4, {}), (1, {"rescore_mult": 2}))]
    tickets = [(mb.submit("a", "docs", q, k=5, **kw), rmb.submit("a", "docs", q, k=5, **kw))
               for q, kw in requests]
    assert mb.flush() == rmb.flush() == 2
    for (q, _), (t, rt) in zip(requests, tickets):
        assert_search_matches(t.result(), rt.result(), reference_full_scores(ref, q),
                              idx.ids, segmented_tolerance(idx, q))


def test_namespace_isolation():
    rng = np.random.RandomState(42)
    xa, xb = _vecs(rng, 40), _vecs(rng, 40)
    reg = _registry({"a": xa, "b": xb})
    mb = engine.MicroBatcher(reg)
    qa, qb = xa[:3] + 0.01, xb[:3] + 0.01
    ta = mb.submit("a", "docs", qa, k=1)
    tb = mb.submit("b", "docs", qb, k=1)
    ta2 = mb.submit("a", "docs", qa, k=1)
    assert mb.flush() == 2                      # one execution per tenant
    np.testing.assert_array_equal(ta.result()[1][:, 0], np.arange(3, dtype=np.uint64))
    np.testing.assert_array_equal(tb.result()[1][:, 0], np.arange(3, dtype=np.uint64))
    np.testing.assert_array_equal(ta2.result()[1], ta.result()[1])
    assert not np.array_equal(ta.result()[0], tb.result()[0])


def test_result_autoflushes():
    rng = np.random.RandomState(43)
    mb = engine.MicroBatcher(_registry({"a": _vecs(rng, 20)}))
    t = mb.submit("a", "docs", _vecs(rng, 2), k=3)
    assert not t.done()
    s, i = t.result()
    assert t.done() and i.shape == (2, 3) and mb.pending == 0


def test_rejected_token_raises_at_submit():
    mb = engine.MicroBatcher(TenantRegistry(verifier=lambda tok: None))
    with pytest.raises(PermissionError):
        mb.submit("bad-token", "docs", np.zeros((1, DIM), np.float32))


def test_missing_collection_raises_at_submit():
    rng = np.random.RandomState(45)
    mb = engine.MicroBatcher(_registry({"a": _vecs(rng, 20)}))
    with pytest.raises(KeyError):
        mb.submit("a", "nope", _vecs(rng, 1))
    assert mb.pending == 0


def test_group_failure_is_isolated():
    rng = np.random.RandomState(46)
    mb = engine.MicroBatcher(_registry({"a": _vecs(rng, 20), "b": _vecs(rng, 20)}))
    bad = mb.submit("a", "docs", _vecs(rng, 2), k=3, ef=9)    # BruteForce rejects ef
    good = mb.submit("b", "docs", _vecs(rng, 2), k=3)
    mb.flush()
    assert good.result()[1].shape == (2, 3)
    with pytest.raises(TypeError, match="unexpected search kwargs"):
        bad.result()


def test_max_batch_splits_whole_requests():
    rng = np.random.RandomState(44)
    mb = engine.MicroBatcher(_registry({"a": _vecs(rng, 30)}), max_batch=4)
    tickets = [mb.submit("a", "docs", _vecs(rng, 3), k=2) for _ in range(3)]
    assert mb.flush() == 3      # 3-row requests never pair up under max_batch=4
    for t in tickets:
        assert t.result()[1].shape == (3, 2)


@pytest.mark.parametrize("what,item", [("where", "A6"), ("text", "A10")])
def test_unported_requests_raise_at_submit(what, item):
    """``text=`` raises naming A10 at submit.  ``where=`` (A6) is ported:
    equal predicates coalesce into one execution, other constants form
    another group, and each request gets its solo filtered search."""
    from repro_torch.core.predicate import Eq

    rng = np.random.RandomState(47)
    if what == "text":
        mb = engine.MicroBatcher(_registry({"a": _vecs(rng, 10)}))
        with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
            mb.submit("a", "docs", _vecs(rng, 1), **{what: "x"})
        assert mb.pending == 0
        return
    reg = TenantRegistry()
    index = MonaVec.build(_vecs(rng, 30), meta={"g": np.arange(30) % 3}, device="cpu")
    reg.put("a", "docs", index)
    mb = engine.MicroBatcher(reg)
    qs = [_vecs(rng, 2) for _ in range(3)]
    preds = [Eq("g", 1), Eq("g", 1), Eq("g", 2)]
    tickets = [mb.submit("a", "docs", q, k=4, where=p) for q, p in zip(qs, preds)]
    assert mb.flush() == 2
    for q, p, t in zip(qs, preds, tickets):
        got, want = t.result(), index.search(q, 4, where=p)
        assert got[0].tobytes() == want[0].tobytes() and got[1].tobytes() == want[1].tobytes()


def test_batcher_and_tenancy_counters_carry_the_reference_names():
    """The same traffic through both packages moves the same metrics: counter
    and histogram keys (names and labels) whose counts grew, and gauges."""
    rng = np.random.RandomState(48)
    x = _vecs(rng, 20)
    prefixes = ("batcher.", "tenancy.")
    moved = []
    for pkg_obs, reg, mb_cls, build, kw in (
            (obs, TenantRegistry(), engine.MicroBatcher,
             lambda: MonaVec.build(x, device="cpu"), {}),
            (robs, RefTenantRegistry(), rengine.MicroBatcher,
             lambda: __import__("repro.core", fromlist=["MonaVec"]).MonaVec.build(
                 jnp.asarray(x)), {"use_kernel": False})):
        before = pkg_obs.registry().snapshot()
        reg.put("a", "docs", build())
        mb = mb_cls(reg, **kw)
        mb.submit("a", "docs", x[:2], k=3)
        mb.submit("a", "docs", x[:1], k=3, ef=1)
        mb.flush()
        reg.searcher("a", "docs", k=2)(x[:1])
        with pytest.raises(KeyError):
            reg.get("a", "nope")
        after = pkg_obs.registry().snapshot()
        moved.append((
            {k for k, v in after["counters"].items()
             if k.startswith(prefixes) and v != before["counters"].get(k)},
            {k for k, h in after["histograms"].items() if k.startswith(prefixes)
             and h["count"] != before["histograms"].get(k, {}).get("count")},
            {k for k in after["gauges"] if k.startswith(prefixes)}))
    assert moved[0] == moved[1]
    assert 'batcher.executions{namespace="a"}' in moved[0][0]


# ---------------------------------------------------------------------------
# TenantRegistry.
# ---------------------------------------------------------------------------

def test_registry_namespaces_and_401():
    reg = TenantRegistry(verifier=lambda tok: {"good": "u"}.get(tok))
    assert reg.resolve_namespace(None) == PUBLIC_NAMESPACE
    rng = np.random.RandomState(49)
    idx = MonaVec.build(_vecs(rng, 12, 8), device="cpu")
    assert reg.put("good", "c", idx) == "u"
    assert reg.collections("good") == ["c"] and reg.get("good", "c") is idx
    for call in (lambda: reg.put("bad", "c", idx), lambda: reg.get("bad", "c"),
                 lambda: reg.collections("bad"),
                 lambda: reg.add("bad", "c", np.zeros((1, 8), np.float32)),
                 lambda: reg.delete("bad", "c", [1]), lambda: reg.compact("bad", "c"),
                 lambda: reg.searcher("bad", "c")):
        with pytest.raises(PermissionError, match="401"):
            call()
    with pytest.raises(KeyError, match="not found in namespace"):
        reg.get("good", "nope")
    with pytest.raises(NotImplementedError, match="ROADMAP A11"):
        reg.autotune("good", "c")


def test_registry_mutation_is_per_namespace():
    """Two tenants sharing a collection name mutate disjoint indexes, and a
    tenant's searcher follows its own mutations."""
    rng = np.random.RandomState(50)
    reg = TenantRegistry()
    reg.put("alice", "corpus", MonaVec.build(_vecs(rng, 12, 8), device="cpu"))
    reg.put("bob", "corpus", MonaVec.build(_vecs(rng, 12, 8), device="cpu"))
    search = reg.searcher("alice", "corpus", k=16)
    assert search.labels == (("namespace", "alice"), ("collection", "corpus"))
    new_ids = reg.add("alice", "corpus", _vecs(rng, 4, 8))
    assert new_ids.tolist() == [12, 13, 14, 15]
    assert reg.delete("alice", "corpus", [0, 13]) == 2
    a, b = reg.get("alice", "corpus"), reg.get("bob", "corpus")
    assert (a.n_total, a.n_live) == (16, 14) and b.n_total == b.n_live == 12
    q = _vecs(rng, 2, 8)
    _, ids_b = b.search(q, 12)
    assert set(ids_b[0].astype(np.int64).tolist()) == set(range(12))
    _, ids_a = search(q)                        # k=16 over 14 live rows
    assert set(ids_a[0, :14].astype(np.int64).tolist()) == set(range(16)) - {0, 13}
    assert (ids_a[:, 14:] == np.uint64(2 ** 64 - 1)).all()
    assert reg.compact("alice", "corpus") == 2
    assert reg.get("alice", "corpus").n_total == 14
