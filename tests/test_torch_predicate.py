"""The port's metadata columns and predicates on the CPU against the
reference (DESIGN.md §8).

The same numpy inputs go through ``repro`` and ``repro_torch``:

* metadata keys, vocabularies and values, ``structure``, ``evaluate`` and
  the mask stage are integers and booleans: equal exactly (the port's int64
  key plane ``u64 ^ 2^63`` splits into the reference's uint32 planes);
* a validation error has the reference's type and message.

Filtered search and the v9 / v10 files: tests/test_torch_filtered.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings, strategies as st

from repro.core import metadata as rmd
from repro.core import predicate as rpred
from repro_torch.core import metadata as md
from repro_torch.core import predicate as tpred
from repro_torch.core.predicate import And, Eq, Ge, Gt, In, Le, Lt, Ne, Not, Or
from tests.torch_harness import port_stream, reference_stream

DIM = 24
I64_MIN, I64_MAX = np.iinfo(np.int64).min, np.iinfo(np.int64).max
STRS = ("red", "green", "blue", "cyan")


@pytest.fixture(autouse=True)
def _follow_reference_stream():
    with port_stream(reference_stream()):
        yield


def _columns(n: int, seed: int) -> dict:
    """i64 with int64 min/max, f64 with -0.0, +0.0, +inf, -inf, and str."""
    rng = np.random.RandomState(seed)
    i64 = rng.randint(-50, 50, n).astype(np.int64)
    i64[:4] = [I64_MIN, I64_MAX, -1, 0]
    f64 = np.round(rng.randn(n) * 4.0, 1)
    f64[:4] = [-0.0, 0.0, np.inf, -np.inf]
    strs = np.array(STRS)[rng.randint(0, len(STRS), n)]
    return {"i": i64, "f": f64, "s": strs}


def _stores(n: int, seed: int):
    cols = _columns(n, seed)
    return md.MetaStore.build(cols, n), rmd.MetaStore.build(cols, n)


def _to_ref(p):
    """The reference's AST of a port predicate."""
    if isinstance(p, (And, Or)):
        return getattr(rpred, type(p).__name__)(_to_ref(p.lhs), _to_ref(p.rhs))
    if isinstance(p, Not):
        return rpred.Not(_to_ref(p.inner))
    if isinstance(p, In):
        return rpred.In(p.col, p.values)
    return getattr(rpred, type(p).__name__)(p.col, p.value)


def _port_mask(p, store, live=None):
    """The port's mask stage as the plan runs it: key planes and constants."""
    args = [torch.from_numpy(np.array(a)) for a in tpred.flatten_args(p, store)]
    live = torch.ones(store.n_rows, dtype=torch.bool) if live is None else live
    return tpred.build_stage_fn(p)(live, *args).numpy()


def _ref_mask(p, store):
    args = tuple(jnp.asarray(a) for a in rpred.flatten_args(_to_ref(p), store))
    return np.asarray(rpred.build_stage_fn(_to_ref(p))(jnp.ones(store.n_rows, bool), *args))


# ---------------------------------------------------------------------------
# Metadata columns.
# ---------------------------------------------------------------------------

def _assert_same_store(got: md.MetaStore, want: rmd.MetaStore) -> None:
    assert got.schema == want.schema and got.n_rows == want.n_rows
    for name, c in got.columns.items():
        r = want[name]
        assert c.values.dtype == r.values.dtype and c.values.tobytes() == r.values.tobytes()
        assert c.vocab == r.vocab
        # The int64 plane is the u64 key with its top bit flipped.
        hi, lo = md.split_key(c.skey.view(np.uint64) ^ np.uint64(1 << 63))
        assert hi.tobytes() == r.key_hi.tobytes() and lo.tobytes() == r.key_lo.tobytes()


def test_store_keys_values_and_vocab_equal_the_reference():
    got, want = _stores(64, 1)
    _assert_same_store(got, want)
    assert got["f"].values[0] == 0.0 and not np.signbit(got["f"].values[0])
    assert got["i"].skey[0] == I64_MIN and got["i"].skey[1] == I64_MAX
    # Unsigned order on the keys is signed order on the plane, row for row.
    for name in ("i", "f"):
        vals, skey = got[name].values, got[name].skey
        order = np.argsort(vals, kind="stable")
        assert (np.diff(skey[order]) >= 0).all()
        assert np.array_equal(np.diff(skey[order]) == 0, np.diff(vals[order]) == 0)


def test_append_and_gather_equal_the_reference():
    got, want = _stores(40, 2)
    extra = {"i": np.array([I64_MAX, 7, -3]), "f": np.array([-0.0, np.inf, 2.5]),
             "s": np.array(["violet", "red", "violet"])}
    got.append(extra, 3)
    want.append(extra, 3)
    _assert_same_store(got, want)
    assert got["s"].vocab[-1] == "violet"
    keep = np.arange(43) % 3 != 1
    _assert_same_store(got.gather(keep), want.gather(keep))
    for name in ("i", "f", "s"):
        assert all(np.array_equal(a, b) for a, b in zip(got.slice(5, 20).values(),
                                                         want.slice(5, 20).values()))


@pytest.mark.parametrize("case", ["nan", "rows", "2d", "name", "dtype", "bytes"])
def test_build_errors_match_the_reference(case):
    data, n = {"x": np.arange(4)}, 4
    if case == "nan":
        data = {"x": np.array([1.0, np.nan, 2.0, 3.0])}
    elif case == "rows":
        n = 5
    elif case == "2d":
        data = {"x": np.zeros((4, 2))}
    elif case == "name":
        data = {"": np.arange(4)}
    elif case == "dtype":
        data = {"x": np.array([1 + 2j] * 4)}
    else:
        data = {"x": np.array([b"a", b"b", b"c", b"d"], dtype=object)}
    errors = []
    for mod in (md, rmd):
        with pytest.raises(Exception) as e:
            mod.MetaStore.build(data, n)
        errors.append((type(e.value), str(e.value)))
    assert errors[0] == errors[1]


@pytest.mark.parametrize("case", ["schema", "rows", "kind", "str_kind"])
def test_append_errors_match_the_reference_and_change_nothing(case):
    stores = _stores(10, 3)
    batch = {"i": np.arange(2), "f": np.ones(2), "s": np.array(["red", "new"])}
    n = 2
    if case == "schema":
        batch.pop("f")
    elif case == "rows":
        n = 3
    elif case == "kind":
        batch["i"] = np.array(["a", "b"])
    else:
        batch["s"] = np.array([1, 2])
    errors = []
    for store in stores:
        before = {k: (c.values.copy(), list(c.vocab or [])) for k, c in store.columns.items()}
        with pytest.raises(Exception) as e:
            store.append(batch, n)
        errors.append((type(e.value), str(e.value)))
        for k, c in store.columns.items():     # validated before any column changed
            assert np.array_equal(c.values, before[k][0]) and list(c.vocab or []) == before[k][1]
    assert errors[0] == errors[1]


@pytest.mark.parametrize("kind,value", [
    ("i64", I64_MIN), ("i64", I64_MAX), ("i64", -1), ("i64", np.int32(5)),
    ("f64", -0.0), ("f64", 0.0), ("f64", np.inf), ("f64", -np.inf), ("f64", 3),
    ("f64", np.float32(1.5)), ("str", "red"), ("str", "absent"),
    ("i64", 1 << 63), ("i64", True), ("i64", 1.0), ("f64", float("nan")), ("f64", "x"),
    ("str", 3)])
def test_encode_constant_equals_the_reference(kind, value):
    vocab = {s: i for i, s in enumerate(STRS)}
    try:
        want = rmd.encode_constant(kind, value, vocab)
    except TypeError as e:
        with pytest.raises(TypeError) as got:
            md.encode_constant(kind, value, vocab)
        assert str(got.value) == str(e)
        return
    assert md.encode_constant(kind, value, vocab) == want
    assert md.signed_key(want).view(np.uint64) ^ np.uint64(1 << 63) == np.uint64(want)


# ---------------------------------------------------------------------------
# Predicates: validation, structure, evaluate, the mask stage.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p", [
    Lt("s", "red"), Eq("nope", 1), Eq("i", "x"), Eq("f", "x"), Eq("s", 3),
    Eq("f", float("nan")), In("i", (1, 2.5)), Ge("i", True), Eq("i", 1 << 64)],
    ids=str)
def test_validate_errors_match_the_reference(p):
    store, rstore = _stores(16, 4)
    with pytest.raises(Exception) as want:
        rpred.validate(_to_ref(p), rstore)
    with pytest.raises(Exception) as got:
        tpred.validate(p, store)
    assert type(got.value) is type(want.value) and str(got.value) == str(want.value)


def test_in_needs_a_value_in_both_packages():
    for mod in (tpred, rpred):
        with pytest.raises(ValueError, match="In\\(\\) needs at least one value"):
            mod.In("i", ())


_EDGE = {"i": (I64_MIN, I64_MAX, -1, 0, 3, 49),
         "f": (-np.inf, np.inf, -0.0, 0.0, 1.5, -2.2, 1e300),
         "s": STRS + ("violet",)}
_leaf = st.one_of(
    st.builds(lambda op, c, v: op(c, v), st.sampled_from([Eq, Ne, Lt, Le, Gt, Ge]),
              st.just("i"), st.sampled_from(_EDGE["i"])),
    st.builds(lambda op, c, v: op(c, v), st.sampled_from([Eq, Ne, Lt, Le, Gt, Ge]),
              st.just("f"), st.sampled_from(_EDGE["f"])),
    st.builds(lambda op, v: op("s", v), st.sampled_from([Eq, Ne]), st.sampled_from(_EDGE["s"])),
    st.sampled_from(["i", "f", "s"]).flatmap(
        lambda col: st.lists(st.sampled_from(_EDGE[col]), min_size=1, max_size=3).map(
            lambda vs: In(col, vs))))
_ast = st.recursive(_leaf, lambda ch: st.one_of(
    st.builds(And, ch, ch), st.builds(Or, ch, ch), st.builds(Not, ch)), max_leaves=6)
_STORES = _stores(96, 5)


@settings(max_examples=80, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(p=_ast)
def test_random_predicates_agree_with_the_reference(p):
    """structure, evaluate, the reference's stage and the port's stage."""
    store, rstore = _STORES
    rp = _to_ref(p)
    tpred.validate(p, store)
    rpred.validate(rp, rstore)
    assert tpred.structure(p, store) == rpred.structure(rp, rstore)
    host = tpred.evaluate(p, store)
    assert np.array_equal(host, rpred.evaluate(rp, rstore))
    assert np.array_equal(_port_mask(p, store), host)
    assert np.array_equal(_ref_mask(p, rstore), host)
    assert tpred.leaf_columns(p) == tuple(leaf.col for leaf in tpred._leaves(p))
    # The port's operands are the reference's: key planes and constant keys.
    for (a, b), (ch, cl, kh, kl) in zip(
            zip(*[iter(tpred.flatten_args(p, store))] * 2),
            zip(*[iter(rpred.flatten_args(rp, rstore))] * 4)):
        for plane, hi, lo in ((a, ch, cl), (b, kh, kl)):
            u64 = np.asarray(plane).view(np.uint64) ^ np.uint64(1 << 63)
            h, lo_ = md.split_key(u64)
            assert np.array_equal(h, np.asarray(hi)) and np.array_equal(lo_, np.asarray(lo))


def test_stage_ands_the_live_mask_and_predicates_hash():
    store, _ = _stores(30, 6)
    p = Ge("f", 0.0) | In("s", ["red", "blue"])
    live = torch.arange(30) % 2 == 0
    assert np.array_equal(_port_mask(p, store, live), tpred.evaluate(p, store) & live.numpy())
    assert hash(p) == hash(Ge("f", 0.0) | In("s", ("red", "blue")))
    assert p == Or(Ge("f", 0.0), In("s", ("red", "blue")))
    assert tpred.leaf_columns(p & Lt("f", 2.0)) == ("f", "s", "f")
