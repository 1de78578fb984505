"""The port's filtered cascades, the engine's handling of predicates and
the v9 / v10 files on the CPU against the reference (DESIGN.md §8, §11).

The rules are tests/test_torch_filtered.py's: ids equal except where scores
tie within the f32 rule, sentinel slots equal, and byte for byte the port's
own search with the ``Allowlist(evaluate(p))`` oracle; the v9 and v10
fixtures load, save their own bytes and search as the reference does, and
files cross between the packages.
"""

import hashlib
import os

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import MonaVec as RefMonaVec
from repro.core.allowlist import Allowlist as RefAllowlist
from repro_torch import MonaVec, engine
from repro_torch.core import predicate as tpred
from repro_torch.core.allowlist import Allowlist
from repro_torch.core.predicate import Eq, Ge, Gt, In, Lt, Ne
from tests.test_torch_filtered import PREDICATES, _filtered_matches, _pair, _vecs
from tests.test_torch_predicate import I64_MAX, I64_MIN, _assert_same_store, _columns, _to_ref
from tests.torch_harness import (SENTINEL, assert_search_matches, port_stream,
                                 reference_full_scores, reference_stream, segmented_tolerance)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


@pytest.fixture(autouse=True)
def _follow_reference_stream():
    with port_stream(reference_stream()):
        yield


@pytest.mark.parametrize("mutated", [False, True], ids=["static", "mutated"])
@pytest.mark.parametrize("coarse", ["sign", "crumb"])
def test_filtered_cascade_matches_reference(coarse, mutated):
    """The predicate gates survivor selection: with rescore_mult 2 every
    survivor is admissible, as in the reference."""
    idx, ref, rng = _pair("cosine", 4, mutated, coarse=coarse)
    q = _vecs(rng, 5)
    for p in PREDICATES[:3]:
        got = _filtered_matches(idx, ref, q, 6, p, rescore_mult=2)
        assert (got[1] != SENTINEL).all()


def test_allowlist_and_predicate_compose():
    idx, ref, rng = _pair("cosine", 4, True)
    q = _vecs(rng, 4)
    p = Ge("f", 0.0)
    allow_mask = np.arange(idx.n_total) % 3 != 0
    allow = Allowlist(mask=allow_mask, n_allowed=int(allow_mask.sum()))
    got = idx.search(q, 7, allow=allow, where=p)
    want = ref.search(jnp.asarray(q), 7, allow=RefAllowlist(mask=allow_mask,
                                                           n_allowed=int(allow_mask.sum())),
                      where=_to_ref(p))
    assert np.array_equal(got[1] == SENTINEL, want[1] == SENTINEL)
    assert_search_matches(got, want, reference_full_scores(ref, q), idx.ids,
                          segmented_tolerance(idx, q))
    both = allow_mask & tpred.evaluate(p, idx.meta)
    oracle = idx.search(q, 7, allow=Allowlist(mask=both, n_allowed=int(both.sum())))
    assert got[0].tobytes() == oracle[0].tobytes() and got[1].tobytes() == oracle[1].tobytes()
    # where_mask is the same mask given on the host.
    wm = idx.search(q, 7, allow=allow, where_mask=tpred.evaluate(p, idx.meta))
    assert wm[0].tobytes() == got[0].tobytes() and wm[1].tobytes() == got[1].tobytes()


@pytest.mark.parametrize("rescore_mult", [None, 2])
def test_predicate_matching_no_row(rescore_mult):
    idx, ref, rng = _pair("cosine", 4, False, coarse="sign")
    q = _vecs(rng, 3)
    kw = {} if rescore_mult is None else {"rescore_mult": rescore_mult}
    for p in (Gt("f", np.inf), Eq("s", "violet"), Lt("i", I64_MIN)):
        scores, ids = idx.search(q, 5, where=p, **kw)
        assert (ids == SENTINEL).all() and (scores == np.float32(-3.0e38)).all()
        r_scores, r_ids = ref.search(jnp.asarray(q), 5, where=_to_ref(p), **kw)
        assert np.array_equal(r_ids, ids) and np.array_equal(r_scores, scores)


def test_same_structure_new_constants_is_one_plan():
    idx, _, rng = _pair("cosine", 4, True)
    q = _vecs(rng, 3)
    cache = engine.plan_cache()
    idx.search(q, 5, where=Eq("s", "red") & Lt("i", 10))
    consts = (-20, 0, 30, I64_MAX)
    oracles = []
    for c in consts:
        mask = tpred.evaluate(Eq("s", "blue") & Lt("i", c), idx.meta)
        oracles.append(idx.search(q, 5, allow=Allowlist(mask=mask, n_allowed=int(mask.sum()))))
    before = cache.stats.snapshot()
    for c, oracle in zip(consts, oracles):
        got = idx.search(q, 5, where=Eq("s", "blue") & Lt("i", c))
        assert got[0].tobytes() == oracle[0].tobytes() and got[1].tobytes() == oracle[1].tobytes()
    delta = cache.stats.since(before)
    assert delta.misses == 0 and delta.hits == len(consts)
    idx.search(q, 5, where=Eq("s", "blue") & In("i", [1, 2]))      # another structure
    assert cache.stats.since(before).misses == 1


def test_where_errors():
    idx, _, rng = _pair("cosine", 4, False)
    q = _vecs(rng, 2)
    with pytest.raises(TypeError, match="ordering comparison 'lt' is not defined on str"):
        idx.search(q, 3, where=Lt("s", "a"))
    with pytest.raises(KeyError, match="unknown metadata column 'nope'"):
        idx.search(q, 3, where=Eq("nope", 1))
    plain = MonaVec.build(_vecs(rng, 20), device="cpu")
    with pytest.raises(ValueError, match="where= requires an index built with metadata"):
        plain.search(q, 3, where=Eq("s", "red"))
    with pytest.raises(ValueError, match="where_mask covers"):
        idx.search(q, 3, where_mask=np.ones(5, bool))


def test_searcher_binds_where():
    idx, _, rng = _pair("cosine", 4, True)
    q = _vecs(rng, 3)
    p = Eq("s", "green")
    s = idx.searcher(k=4, where=p).warmup(3)
    got = s(q)
    want = idx.search(q, 4, where=p)
    assert got[0].tobytes() == want[0].tobytes() and got[1].tobytes() == want[1].tobytes()


# ---------------------------------------------------------------------------
# Build, add and compact with metadata.
# ---------------------------------------------------------------------------

def test_build_add_compact_carry_the_columns():
    rng = np.random.RandomState(11)
    x, y = _vecs(rng, 50), _vecs(rng, 12)
    cols, extra = _columns(50, 11), _columns(12, 12)
    idx = MonaVec.build(x, meta=cols, device="cpu")
    ref = RefMonaVec.build(jnp.asarray(x), meta=cols)
    _assert_same_store(idx.meta, ref.meta)
    with pytest.raises(ValueError, match="pass meta= for the batch"):
        idx.add(y)
    with pytest.raises(ValueError, match="do not match the index schema"):
        idx.add(y, meta={"i": extra["i"]})
    assert idx.n_total == 50 and idx.meta.n_rows == 50      # nothing committed
    idx.add(y, meta=extra)
    ref.add(jnp.asarray(y), meta=extra)
    dead = np.concatenate([idx.ids[::5], idx.ids[50::3]])
    idx.delete(dead)
    ref.delete(dead)
    _assert_same_store(idx.meta, ref.meta)
    idx.compact()
    ref.compact()
    _assert_same_store(idx.meta, ref.meta)
    assert np.array_equal(idx.ids, ref.ids) and idx.meta.n_rows == idx.n_total
    p = Eq("s", "red") | Gt("i", 20)
    _, ids = idx.search(x[:4], 6, where=p)
    mask = tpred.evaluate(p, idx.meta)
    assert np.isin(ids[ids != SENTINEL], idx.ids[mask]).all()
    with pytest.raises(ValueError, match="built without metadata"):
        MonaVec.build(x, device="cpu").add(y, meta=extra)


# ---------------------------------------------------------------------------
# Files: v9 and v10 with metadata.
# ---------------------------------------------------------------------------

def _sha(path) -> str:
    with open(path, "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()


@pytest.mark.parametrize("name", ["v9_meta_bruteforce.mvec", "v10_coarse_bruteforce.mvec"])
def test_golden_meta_files_load_save_and_search(name, tmp_path):
    src = os.path.join(GOLDEN, name)
    idx, ref = MonaVec.load(src, device="cpu"), RefMonaVec.load(src)
    _assert_same_store(idx.meta, ref.meta)
    out = str(tmp_path / name)
    idx.save(out)
    assert _sha(out) == _sha(src)
    q = np.random.RandomState(5).randn(3, idx.backend.enc.dim).astype(np.float32)
    price = sorted(idx.meta["price"].values.tolist())[len(idx.meta["price"].values) // 2]
    kw = {"rescore_mult": 2} if idx.backend.enc.coarse else {}
    preds = [None, Lt("price", price), Ne("cat", "red") | In("cat", ["violet"])]
    if "score" in idx.meta.columns:
        preds.append(Ne("cat", "red") & Ge("score", 0.0))
    for p in preds:
        got = idx.search(q, 4, where=p, **kw)
        want = ref.search(jnp.asarray(q), 4, where=None if p is None else _to_ref(p), **kw)
        assert np.array_equal(got[1] == SENTINEL, want[1] == SENTINEL)
        assert_search_matches(got, want, reference_full_scores(ref, q), idx.ids,
                              segmented_tolerance(idx, q))


@pytest.mark.parametrize("coarse", [None, "crumb"])
def test_port_written_meta_files_load_in_the_reference(coarse, tmp_path):
    rng = np.random.RandomState(13)
    idx = MonaVec.build(_vecs(rng, 60), meta=_columns(60, 13), coarse=coarse, device="cpu")
    idx.add(_vecs(rng, 9), meta=_columns(9, 14))
    idx.delete(idx.ids[::7])
    path = str(tmp_path / "port.mvec")
    idx.save(path)
    assert open(path, "rb").read()[4] == (10 if coarse else 9)
    ref = RefMonaVec.load(path)
    _assert_same_store(idx.meta, ref.meta)
    again = str(tmp_path / "again.mvec")
    ref.save(again)
    assert _sha(again) == _sha(path)
    q = _vecs(rng, 3)
    kw = {"rescore_mult": 2} if coarse else {}
    p = Ge("f", 0.0) & ~Eq("s", "cyan")
    got = idx.search(q, 5, where=p, **kw)
    want = ref.search(jnp.asarray(q), 5, where=_to_ref(p), **kw)
    assert np.array_equal(got[1] == SENTINEL, want[1] == SENTINEL)
    assert_search_matches(got, want, reference_full_scores(ref, q), idx.ids,
                          segmented_tolerance(idx, q))
    loaded = MonaVec.load(path, device="cpu")
    again_got = loaded.search(q, 5, where=p, **kw)
    assert again_got[0].tobytes() == got[0].tobytes() and \
        again_got[1].tobytes() == got[1].tobytes()
