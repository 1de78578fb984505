"""The port's autotuner (ROADMAP A11, DESIGN.md §12) on the CPU against the
reference.

The same index goes through both packages (the reference's, carried over by
its own ``.mvec`` file), and the port is held to:

* ``knob_ladder`` equal to the reference's for IVF, HNSW, a plain
  BruteForce index and sign / crumb cascades (mutated too);
* ``sample_queries`` equal to the reference's within 1e-6 absolute (the
  rows are rebuilt through the inverse rotation, summed in another order;
  the jitter is the same numpy draw);
* the ``TuneResult`` equal to the reference's exactly: IVF with metadata and
  the boost curve, a small HNSW, a BruteForce cascade with the boost curve,
  and a mutated crumb cascade (the boost probes drawn over every row,
  tombstoned ones too);
* knob precedence (explicit keyword, tuned knob, default) and the clamps,
  as ``tests/test_autotune.py`` holds the reference to them;
* ``tuned`` through add / delete / compact and ``TenantRegistry.autotune``,
  and ``build(autotune=True | float | dict)``;
* v11 files: the golden fixture loads, searches with the reference's ids
  under its tuned knobs and round-trips byte for byte; re-tuned with the
  fixture's arguments it writes the fixture's bytes; files cross between the
  packages both ways; a truncated TUNE block raises naming it;
* the reference's autotune benchmark at its smoke shape
  (``benchmarks/autotune_bench.py``, ``benchmarks/baselines/BENCH_autotune.json``):
  tuned recall@10 0.9625, 0.55 unboosted and 1.0 boosted at 1% selectivity,
  exactly, on the legacy threefry stream the baselines were written on.

Boosted filtered searches and the selectivity counts:
tests/test_torch_selectivity.py.
"""

import dataclasses
import hashlib
import os

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import Lt as RefLt
from repro.core import MonaVec as RefMonaVec
from repro.tune import knob_ladder as ref_knob_ladder
from repro.tune import sample_queries as ref_sample_queries
from repro_torch import MonaVec
from repro_torch.core.convert import tune_from_fields
from repro_torch.core.predicate import Lt
from repro_torch.core.tenancy import TenantRegistry
from repro_torch.data.synthetic import embedding_corpus, queries_from_corpus
from repro_torch.tune import (BoostCurve, BoostPoint, KnobRung, TuneResult, knob_ladder,
                              measure_recall, sample_queries)
from tests.torch_harness import (jax_stream, port_over_reference, port_stream,
                                 reference_over_port, reference_stream, reference_tune)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
DIM = 16


@pytest.fixture(autouse=True)
def _follow_reference_stream():
    with port_stream(reference_stream()):
        yield


def _corpus(n, seed=5, dim=DIM):
    """Eight tight clusters (the reference's tests/test_autotune.py corpus)."""
    rng = np.random.RandomState(seed)
    centers = rng.randn(8, dim).astype(np.float32) * 2.0
    return centers[rng.randint(0, 8, n)] + rng.randn(n, dim).astype(np.float32) * 0.3


def _sha(path) -> str:
    with open(path, "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()


def _cross(ref, tmp_path, name="ref.mvec"):
    """The port's index over the reference's file."""
    path = str(tmp_path / name)
    ref.save(path)
    return MonaVec.load(path, device="cpu")


def _ref_ivf_meta():
    n = 1200
    attr = np.random.RandomState(3).randint(0, 100, n).astype(np.int64)
    return RefMonaVec.build(jnp.asarray(_corpus(n)), metric="cosine", index="ivf", nlist=16,
                            meta={"attr": attr})


def _ref_hnsw():
    return RefMonaVec.build(jnp.asarray(_corpus(300)), metric="cosine", index="hnsw", m=4,
                            ef_construction=16)


def _ref_cascade(coarse="sign", mutated=False):
    ref = RefMonaVec.build(jnp.asarray(_corpus(400)), metric="cosine", coarse=coarse)
    if mutated:
        ref.add(jnp.asarray(_corpus(100, seed=8)))
        ref.delete(ref.ids[::7])
    return ref


_LADDER_CASES = {
    "ivf": lambda: RefMonaVec.build(jnp.asarray(_corpus(200)), metric="cosine", index="ivf",
                                    nlist=12, train_iters=5),
    "hnsw": lambda: RefMonaVec.build(jnp.asarray(_corpus(120)), metric="cosine",
                                     index="hnsw", m=4, ef_construction=16),
    "bruteforce": lambda: RefMonaVec.build(jnp.asarray(_corpus(60)), metric="cosine"),
    "sign": lambda: _ref_cascade("sign"),
    "crumb_mutated": lambda: _ref_cascade("crumb", mutated=True),
}


@pytest.mark.parametrize("case", sorted(_LADDER_CASES))
def test_knob_ladder_and_sample_queries_equal_the_reference(case, tmp_path):
    ref = _LADDER_CASES[case]()
    idx = _cross(ref, tmp_path)
    for k in (1, 4, 10):
        assert knob_ladder(idx, k) == ref_knob_ladder(ref, k)
    for n_q, seed in ((16, 0xA07001), (5, 3), (1000, 11)):
        got = sample_queries(idx, n_q, seed)
        want = np.asarray(ref_sample_queries(ref, n_q, seed))
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


_TUNE_CASES = {
    "ivf_meta_boost": (_ref_ivf_meta, dict(recall_target=0.9, k=5, n_queries=16)),
    "hnsw": (_ref_hnsw, dict(recall_target=0.9, k=4, n_queries=8)),
    "sign_boost": (_ref_cascade, dict(recall_target=0.8, k=5, n_queries=16)),
}


_TUNED_REF: dict = {}


def _tuned_ref(case):
    """(the reference's index before tuning, after tuning), one per case."""
    if case not in _TUNED_REF:
        make, kw = _TUNE_CASES[case]
        ref = make()
        before = dataclasses.replace(ref)
        _TUNED_REF[case] = before, ref.autotune(**kw)
    return _TUNED_REF[case]


@pytest.mark.parametrize("case", sorted(_TUNE_CASES))
def test_tune_result_equals_the_reference(case, tmp_path):
    """Exactly: knobs, every rung's recall, the boost curve; and the two
    packages' v11 files of the tuned index are the same bytes."""
    before, ref = _tuned_ref(case)
    idx = _cross(before, tmp_path)
    assert idx.tuned is None
    idx.autotune(**_TUNE_CASES[case][1])
    assert idx.tuned == tune_from_fields(ref.tuned)
    assert reference_tune(idx.tuned) == ref.tuned
    assert (idx.tuned.boost is not None) == (case != "hnsw")
    ref.save(str(tmp_path / "ref11.mvec"))
    idx.save(str(tmp_path / "port11.mvec"))
    assert _sha(tmp_path / "ref11.mvec") == _sha(tmp_path / "port11.mvec")


def test_mutated_cascade_tunes_as_the_reference():
    """Over an index with an added segment and tombstones (carried across by
    ``torch_harness.port_over_reference``): the sample queries skip dead
    rows and the boost probes are drawn over every row."""
    ref = _ref_cascade("crumb", mutated=True)
    idx = port_over_reference(ref)
    kw = dict(recall_target=0.8, k=5, n_queries=16)
    ref.autotune(**kw)
    idx.autotune(**kw)
    assert idx.tuned == tune_from_fields(ref.tuned)
    again = reference_over_port(idx)
    assert again.tuned == ref.tuned


def test_determinism_and_validation(tmp_path):
    make = lambda: MonaVec.build(_corpus(600), metric="cosine", index="ivf", nlist=8,
                                 device="cpu")
    a = make().autotune(recall_target=0.9, k=5, n_queries=16)
    b = make().autotune(recall_target=0.9, k=5, n_queries=16)
    assert a.tuned == b.tuned and a.tuned.met_target
    rungs = a.tuned.ladder["nprobe"]
    assert [r.value for r in rungs] == [1, 2, 4, 8] and rungs[-1].recall == 1.0
    chosen = a.tuned.knobs["nprobe"]
    assert all(r.recall < 0.9 for r in rungs if r.value < chosen)
    a.save(str(tmp_path / "a.mvec"))
    b.save(str(tmp_path / "b.mvec"))
    assert open(tmp_path / "a.mvec", "rb").read()[4] == 11
    assert _sha(tmp_path / "a.mvec") == _sha(tmp_path / "b.mvec")
    back = MonaVec.load(str(tmp_path / "a.mvec"), device="cpu")
    assert back.tuned == a.tuned
    back.save(str(tmp_path / "c.mvec"))
    assert _sha(tmp_path / "c.mvec") == _sha(tmp_path / "a.mvec")
    for bad in (dict(recall_target=0.0), dict(recall_target=1.5), dict(k=0)):
        with pytest.raises(ValueError):
            a.autotune(**bad)
    assert measure_recall(np.array([[1, 2, 3], [4, 5, 6]]),
                          np.array([[1, 2, 9], [7, 8, 9]])) == pytest.approx(2 / 6)
    sent = np.uint64(2 ** 64 - 1)
    assert measure_recall(np.array([[1, 2]], np.uint64), np.full((1, 2), sent)) == 1.0
    flat = MonaVec.build(_corpus(60), metric="cosine", device="cpu")
    assert flat.autotune(recall_target=0.9, k=5, n_queries=8).tuned.knobs == {}
    assert flat.tuned.met_target and flat.tuned.ladder == {} and flat.tuned.boost is None


def test_precedence_and_clamps():
    """Explicit keyword > tuned knob > engine default, the clamps last
    (``tests/test_autotune.py::TestResolutionPrecedence``)."""
    idx = MonaVec.build(_corpus(600), metric="cosine", index="ivf", nlist=8, device="cpu")
    assert idx.resolved_knobs(5) == {"nprobe": 8}             # min(8, nlist)
    idx.autotune(recall_target=0.9, k=5, n_queries=16)
    tuned_np = idx.tuned.knobs["nprobe"]
    assert idx.resolved_knobs(5) == {"nprobe": tuned_np}
    assert idx.resolved_knobs(5, nprobe=None) == {"nprobe": tuned_np}
    assert idx.resolved_knobs(5, nprobe=2) == {"nprobe": 2}
    assert idx.resolved_knobs(5, nprobe=999) == {"nprobe": 8}
    q = _corpus(6, seed=9)
    untuned = MonaVec.build(_corpus(600), metric="cosine", index="ivf", nlist=8, device="cpu")
    assert idx.search(q, 5)[1].tobytes() == untuned.search(q, 5, nprobe=tuned_np)[1].tobytes()
    assert idx.searcher(k=5)(q)[1].tobytes() == idx.search(q, 5)[1].tobytes()

    h = MonaVec.build(_corpus(300), metric="cosine", index="hnsw", m=4, ef_construction=16,
                      device="cpu")
    h.autotune(recall_target=0.5, k=4, n_queries=8)
    ef = h.tuned.knobs["ef"]
    assert h.resolved_knobs(4) == {"ef": max(ef, 4)}
    assert h.resolved_knobs(64, ef=4) == {"ef": 64}

    c = MonaVec.build(_corpus(400), metric="cosine", coarse="sign", device="cpu")
    c.tuned = TuneResult(recall_target=0.8, k=5, n_queries=8, seed=0, met_target=True,
                         knobs={"rescore_mult": 4}, ladder={})
    assert c.resolved_knobs(5) == {"rescore_mult": 4}
    assert c.resolved_knobs(5, rescore_mult=0) == {}
    assert c.resolved_knobs(100) == {}                       # 4 * 100 >= 400: the full scan
    with pytest.raises(ValueError, match="rescore_mult must be >= 0"):
        c.resolved_knobs(5, rescore_mult=-1)


def test_tuned_survives_the_lifecycle_and_the_registry():
    reg = TenantRegistry()
    idx = MonaVec.build(_corpus(600), metric="cosine", index="ivf", nlist=8, device="cpu")
    reg.put(None, "c", idx)
    res = reg.autotune(None, "c", recall_target=0.9, k=5, n_queries=16)
    assert res is idx.tuned and res.knobs
    searcher = idx.searcher(k=5)
    idx.add(_corpus(40, seed=8))
    idx.delete(idx.ids[::7])
    assert idx.tuned is res and idx.resolved_knobs(5) == {"nprobe": res.knobs["nprobe"]}
    q = _corpus(4, seed=9)
    assert searcher(q)[1].tobytes() == idx.search(q, 5, nprobe=res.knobs["nprobe"])[1].tobytes()
    reg.compact(None, "c")
    assert idx.tuned is res and "nprobe" in idx.resolved_knobs(5)
    # A searcher reads index.tuned on every call (autotune_bench.py swaps it).
    idx.tuned = dataclasses.replace(res, knobs={"nprobe": 1})
    assert searcher(q)[1].tobytes() == idx.search(q, 5, nprobe=1)[1].tobytes()


@pytest.mark.parametrize("autotune", [True, 0.9, {"recall_target": 0.8, "k": 4,
                                                   "n_queries": 8, "seed": 3}])
def test_build_autotune(autotune):
    x = _corpus(400)
    idx = MonaVec.build(x, metric="cosine", index="ivf", nlist=8, autotune=autotune,
                        device="cpu")
    if autotune is True:
        want = MonaVec.build(x, metric="cosine", index="ivf", nlist=8, device="cpu").autotune()
    elif isinstance(autotune, dict):
        want = MonaVec.build(x, metric="cosine", index="ivf", nlist=8,
                             device="cpu").autotune(**autotune)
    else:
        want = MonaVec.build(x, metric="cosine", index="ivf", nlist=8,
                             device="cpu").autotune(recall_target=autotune)
    assert idx.tuned == want.tuned and idx.tuned.recall_target == (
        0.95 if autotune is True else 0.9 if autotune == 0.9 else 0.8)
    assert MonaVec.build(x, autotune=False, device="cpu").tuned is None


# ---------------------------------------------------------------------------
# v11 files.
# ---------------------------------------------------------------------------

def test_golden_v11_loads_searches_retunes_and_round_trips(tmp_path):
    """The fixture (tests/golden/make_fixtures.py, legacy threefry stream):
    the port reads its TuneResult, searches with the reference's ids under
    the tuned knobs, writes its bytes back, and re-tuned with the fixture's
    arguments writes them again."""
    src = os.path.join(GOLDEN, "v11_tuned_ivf.mvec")
    with port_stream(False), jax_stream(False):
        idx = MonaVec.load(src, device="cpu")
        ref = RefMonaVec.load(src)
        assert idx.tuned == tune_from_fields(ref.tuned) and idx.tuned.boost is not None
        q = np.random.RandomState(4).randn(5, DIM).astype(np.float32)
        for kw, rkw in (({}, {}), ({"where": Lt("price", 3)}, {"where": RefLt("price", 3)})):
            assert np.array_equal(idx.search(q, 4, **kw)[1],
                                  ref.search(jnp.asarray(q), 4, **rkw)[1])
        idx.save(str(tmp_path / "same.mvec"))
        assert _sha(tmp_path / "same.mvec") == _sha(src)
        idx.tuned = None
        idx.autotune(recall_target=0.9, k=4, n_queries=8, seed=11)
        idx.save(str(tmp_path / "retuned.mvec"))
    assert _sha(tmp_path / "retuned.mvec") == _sha(src)


def test_v11_files_cross_both_ways(tmp_path):
    port = MonaVec.build(_corpus(300), metric="cosine", index="ivf", nlist=6,
                         meta={"g": np.arange(300) % 5}, device="cpu")
    port.autotune(recall_target=0.9, k=5, n_queries=8)
    port.save(str(tmp_path / "port.mvec"))
    ref = RefMonaVec.load(str(tmp_path / "port.mvec"))
    assert ref.tuned == reference_tune(port.tuned)
    ref.save(str(tmp_path / "ref.mvec"))
    assert _sha(tmp_path / "ref.mvec") == _sha(tmp_path / "port.mvec")
    # The reverse over a cascade without metadata: v11 with COARSE_KIND set.
    ref = _tuned_ref("sign_boost")[1]
    back = _cross(ref, tmp_path, "sign.mvec")
    assert back.tuned == tune_from_fields(ref.tuned)
    assert back.backend.enc.coarse == "sign"
    back.save(str(tmp_path / "sign_again.mvec"))
    assert _sha(tmp_path / "sign_again.mvec") == _sha(tmp_path / "sign.mvec")


def test_truncated_tune_block_raises(tmp_path):
    with open(os.path.join(GOLDEN, "v11_tuned_ivf.mvec"), "rb") as fh:
        data = fh.read()
    for cut in (1, 9, 40):      # into the payload, its length and the rungs
        path = tmp_path / f"cut{cut}.mvec"
        path.write_bytes(data[:-cut])
        with pytest.raises(ValueError, match="truncated in block 'tune"):
            MonaVec.load(str(path), device="cpu")


def test_boost_curve_semantics():
    c = BoostCurve(points=(BoostPoint(0.01, 16, 0.9), BoostPoint(0.1, 4, 0.95)))
    assert [c.multiplier(s) for s in (0.005, 0.01, 0.05, 0.5)] == [16, 16, 4, 1]
    with pytest.raises(ValueError, match="must ascend"):
        BoostCurve(points=(BoostPoint(0.1, 4, 0.9), BoostPoint(0.01, 16, 0.9)))
    assert KnobRung(1, 0.5) == KnobRung(value=1, recall=0.5)


# ---------------------------------------------------------------------------
# The reference's autotune benchmark at its smoke shape.
# ---------------------------------------------------------------------------

def _recall_at_10(pred_ids, gt_ids) -> float:
    """``benchmarks/common.recall_at_10``."""
    return float(np.mean([len(set(a.tolist()) & set(b.tolist())) / gt_ids.shape[1]
                          for a, b in zip(pred_ids.astype(np.int64), gt_ids)]))


def test_autotune_bench_smoke_figures():
    """``bench_autotune(n=8192, dim=64, batch_q=8)`` on the port's CPU path:
    tuned recall 0.9625 against the safe arm (nprobe = nlist), 0.55
    unboosted and 1.0 boosted at 1% selectivity, the committed baseline's
    figures exactly (the baselines were written on the legacy stream; on
    the other stream both packages give 1.0 / 0.7875 / 1.0)."""
    n, dim, nlist, k = 8192, 64, 64, 10
    corpus = embedding_corpus(97, n, dim)
    attr = np.random.RandomState(97).randint(0, 100, size=n).astype(np.int64)
    queries = queries_from_corpus(corpus, 197, 8)
    with port_stream(False):
        idx = MonaVec.build(corpus, metric="cosine", index="ivf", nlist=nlist,
                            meta={"attr": attr}, device="cpu")
        idx.autotune(recall_target=0.95, k=k)
        tuned = idx.tuned
        gt = idx.searcher(k=k, nprobe=nlist)(queries)[1]
        rec_tuned = _recall_at_10(idx.searcher(k=k)(queries)[1], gt)
        where = Lt("attr", 1)
        gt_f = idx.searcher(k=k, nprobe=nlist, where=where)(queries)[1]
        idx.tuned = dataclasses.replace(tuned, boost=None)
        rec_plain = _recall_at_10(idx.searcher(k=k, where=where)(queries)[1], gt_f)
        idx.tuned = tuned
        rec_boost = _recall_at_10(idx.searcher(k=k, where=where)(queries)[1], gt_f)
    assert tuned.knobs == {"nprobe": 16} and tuned.met_target
    assert (rec_tuned, rec_plain, rec_boost) == (0.9625, 0.55, 1.0)
