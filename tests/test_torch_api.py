"""End-to-end parity of the port's MonaVec (build -> search -> save/load) with
repro.core.MonaVec, and `.mvec` files crossing between the two packages.

Ids must be equal except where two rows' scores tie within the stated
tolerance; scores agree within it.  Every test runs the port on the
threefry stream the reference uses in this process.
"""

import hashlib
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import BruteForceIndex as RefBruteForceIndex
from repro.core import MonaVec as RefMonaVec
from repro.core import quantize as qz, rhdh, standardize
from repro.core.allowlist import Allowlist as RefAllowlist
from repro.core.standardize import GlobalStd as RefGlobalStd
from repro_torch import MonaVec
from repro_torch.core import quantize as tqz
from repro_torch.core.allowlist import NEG, Allowlist
from repro_torch.core.segments import SENTINEL_ID
from tests.golden import make_fixtures as gold
from tests.torch_harness import (adjusted_tolerance, assert_search_matches, code_flip_rows,
                                 dot_tolerance, port_stream, reference_stream)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


@pytest.fixture(autouse=True)
def _follow_reference_stream():
    with port_stream(reference_stream()):
        yield


def _tolerance(idx: MonaVec, queries: np.ndarray) -> np.ndarray:
    enc = idx.backend.enc
    q_rot = tqz.encode_query(torch.from_numpy(queries), enc).numpy()
    return adjusted_tolerance(dot_tolerance(q_rot, enc.packed.numpy()),
                              enc.qnorms.numpy(), enc.metric)


def _reference_over(idx: MonaVec) -> RefMonaVec:
    """The reference's index over the port's own encoded corpus, so that a
    search comparison does not hinge on a boundary flip of the encode."""
    enc = idx.backend.enc
    std = None if enc.std is None else RefGlobalStd(enc.std.mean, enc.std.inv_std)
    ref_enc = qz.Encoded(packed=jnp.asarray(enc.packed.numpy()),
                         qnorms=jnp.asarray(enc.qnorms.numpy()), seed=enc.seed,
                         metric=enc.metric, bits=enc.bits, dim=enc.dim,
                         dim_pad=enc.dim_pad, std=std)
    return RefMonaVec(RefBruteForceIndex(enc=ref_enc, ids=idx.ids))


def _compare(idx: MonaVec, ref: RefMonaVec, queries: np.ndarray, k: int, **kw):
    got = idx.search(queries, k, **kw)
    want = ref.search(jnp.asarray(queries), k, **{
        key: RefAllowlist(mask=v.mask, n_allowed=v.n_allowed) for key, v in kw.items()})
    full = np.asarray(ref.backend.scores(jnp.asarray(queries)))
    assert_search_matches(got, want, full, idx.ids, _tolerance(idx, queries))
    return got, want


@pytest.mark.parametrize("metric", ["cosine", "dot", "l2"])
def test_search_matches_reference(metric):
    """Each package builds from the same vectors; the codes agree (up to
    boundary flips) and both search the port's index alike."""
    rng = np.random.RandomState(1)
    corpus = (rng.randn(1500, 96) * 2 + 0.5).astype(np.float32)
    queries = corpus[rng.randint(0, 1500, size=9)] + 0.3 * rng.randn(9, 96).astype(np.float32)
    ref_std = RefMonaVec.fit(corpus) if metric == "l2" else None
    std = MonaVec.fit(corpus) if metric == "l2" else None
    ref_built = RefMonaVec.build(jnp.asarray(corpus), metric=metric, std=ref_std, seed=21)
    idx = MonaVec.build(corpus, metric=metric, std=std, seed=21, device="cpu")
    prepared = standardize.prepare(jnp.asarray(corpus), metric, ref_std)
    code_flip_rows(idx.backend.enc.packed.numpy(), np.asarray(ref_built.backend.enc.packed),
                   np.asarray(rhdh.rhdh_apply(prepared, 21, normalized=False)),
                   np.asarray(prepared))
    ref = _reference_over(idx)
    got, _ = _compare(idx, ref, queries, 10)
    assert got[0].shape == (9, 10) and got[0].dtype == np.float32
    full = idx.backend.scores(torch.from_numpy(queries)).numpy()
    ref_full = np.asarray(ref.backend.scores(jnp.asarray(queries)))
    assert np.all(np.abs(full - ref_full) <= _tolerance(idx, queries))


def test_search_on_the_reference_encoding():
    """One encoded corpus (the reference's arrays) feeds both packages."""
    rng = np.random.RandomState(2)
    corpus = (rng.randn(800, 60) * 5 + 1).astype(np.float32)
    std = RefMonaVec.fit(corpus)
    ref = RefMonaVec.build(jnp.asarray(corpus), metric="l2", std=std, seed=5)
    enc = ref.backend.enc
    idx = MonaVec.from_arrays(np.asarray(enc.packed), np.asarray(enc.qnorms), seed=enc.seed,
                              metric="l2", bits=4, dim=enc.dim, dim_pad=enc.dim_pad,
                              ids=ref.backend.ids, std_mean=std.mean,
                              std_inv_std=std.inv_std, device="cpu")
    _compare(idx, ref, corpus[:7] + 0.1, 12)


def test_k_larger_than_n_pads_with_sentinel():
    rng = np.random.RandomState(3)
    corpus = rng.randn(5, 24).astype(np.float32)
    queries = rng.randn(3, 24).astype(np.float32)
    idx = MonaVec.build(corpus, device="cpu")
    scores, ids = idx.search(queries, 8)
    assert scores.shape == ids.shape == (3, 8)
    assert (ids[:, 5:] == SENTINEL_ID).all() and (scores[:, 5:] == NEG).all()
    assert sorted(ids[0, :5].tolist()) == list(range(5))
    _compare(idx, _reference_over(idx), queries, 8)


def test_allowlist_matches_reference():
    rng = np.random.RandomState(4)
    corpus = rng.randn(600, 40).astype(np.float32)
    ext = (1000 + 3 * np.arange(600)).astype(np.uint64)
    idx = MonaVec.build(corpus, ids=ext, device="cpu")
    ref = _reference_over(idx)
    queries = rng.randn(4, 40).astype(np.float32)
    allow = Allowlist.from_ids(ext[::2].tolist(), ext)
    got, _ = _compare(idx, ref, queries, 10, allow=allow)
    assert np.isin(got[1], ext[::2]).all()
    # Fewer allowed rows than k: exactly the allowed rows, then sentinels.
    few = Allowlist.from_ids([int(ext[7]), int(ext[400]), int(ext[599])], ext)
    scores, ids = _compare(idx, ref, queries, 10, allow=few)[0]
    assert (np.sort(ids[:, :3], axis=1) == np.sort(ext[[7, 400, 599]])).all()
    assert (ids[:, 3:] == SENTINEL_ID).all() and (scores[:, 3:] == NEG).all()
    with pytest.raises(ValueError, match="allowlist mask covers"):
        idx.search(queries, 3, allow=Allowlist(mask=np.ones(3, bool), n_allowed=3))


def test_single_query_vector():
    rng = np.random.RandomState(5)
    corpus = rng.randn(50, 16).astype(np.float32)
    idx = MonaVec.build(corpus, device="cpu")
    scores, ids = idx.search(corpus[4], 3)
    assert scores.shape == ids.shape == (1, 3) and ids[0, 0] == 4


def _sha(path) -> str:
    with open(path, "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()


def test_golden_v6_load_save_is_identity(tmp_path):
    with open(os.path.join(GOLDEN, "digests.json")) as fh:
        digest = json.load(fh)["v6_bruteforce.mvec"]
    idx = MonaVec.load(os.path.join(GOLDEN, "v6_bruteforce.mvec"), device="cpu")
    out = tmp_path / "v6.mvec"
    idx.save(str(out))
    assert _sha(out) == digest


def test_golden_v6_rebuilt_under_legacy_stream():
    """The fixtures were written on JAX's legacy threefry stream: on that
    stream the port rebuilds the fixture's packed bytes."""
    idx = MonaVec.load(os.path.join(GOLDEN, "v6_bruteforce.mvec"), device="cpu")
    with port_stream(False):
        rebuilt = MonaVec.build(gold._data(32, 16, 100), metric="cosine", seed=7, device="cpu")
    np.testing.assert_array_equal(rebuilt.backend.enc.packed.numpy(),
                                  idx.backend.enc.packed.numpy())
    np.testing.assert_allclose(rebuilt.backend.enc.qnorms.numpy(),
                               idx.backend.enc.qnorms.numpy(), rtol=1e-6)


def test_golden_v6_search_matches_reference():
    rng = np.random.RandomState(6)
    path = os.path.join(GOLDEN, "v6_bruteforce.mvec")
    queries = rng.randn(5, 16).astype(np.float32)
    _compare(MonaVec.load(path, device="cpu"), RefMonaVec.load(path), queries, 6)


def test_port_file_loads_in_reference(tmp_path):
    rng = np.random.RandomState(7)
    corpus = rng.randn(400, 40).astype(np.float32)
    idx = MonaVec.build(corpus, metric="cosine", seed=99, device="cpu")
    path = str(tmp_path / "port.mvec")
    idx.save(path)
    ref = RefMonaVec.load(path)
    np.testing.assert_array_equal(np.asarray(ref.backend.enc.packed),
                                  idx.backend.enc.packed.numpy())
    _compare(idx, ref, rng.randn(6, 40).astype(np.float32), 10)


@pytest.mark.parametrize("metric", ["cosine", "l2"])
def test_reference_file_loads_in_port(metric, tmp_path):
    rng = np.random.RandomState(8)
    corpus = (rng.randn(300, 24) * 4).astype(np.float32)
    std = RefMonaVec.fit(corpus) if metric == "l2" else None
    ref = RefMonaVec.build(jnp.asarray(corpus), metric=metric, std=std,
                           ids=np.arange(300, dtype=np.uint64) * 7)
    path = str(tmp_path / "ref.mvec")
    ref.save(path)
    idx = MonaVec.load(path, device="cpu")
    ref_std = RefMonaVec.load(path).backend.enc.std
    got_std = idx.backend.enc.std
    assert (got_std is None) == (ref_std is None) == (std is None)
    if std is not None:
        assert (got_std.mean, got_std.inv_std) == (ref_std.mean, ref_std.inv_std)
    _compare(idx, ref, rng.randn(4, 24).astype(np.float32) * 4, 10)
    again = str(tmp_path / "again.mvec")
    idx.save(again)
    assert _sha(again) == _sha(path)


@pytest.mark.parametrize("name,version", [("v8_segmented_ivf.mvec", 8),
                                          ("v9_meta_bruteforce.mvec", 9),
                                          ("v10_coarse_bruteforce.mvec", 10),
                                          ("v11_tuned_ivf.mvec", 11)])
def test_load_rejects_other_versions(name, version, tmp_path):
    """Only v11 (autotune results) is refused now, naming ROADMAP A11: the
    v8 fixture (an IVF index, A7), v9 and v10 (metadata columns, A6) load
    and save their own bytes (their searches: tests/test_torch_ivf.py and
    tests/test_torch_predicate.py)."""
    src = os.path.join(GOLDEN, name)
    if version == 11:
        with pytest.raises(NotImplementedError, match="ROADMAP A11"):
            MonaVec.load(src, device="cpu")
        return
    idx = MonaVec.load(src, device="cpu")
    assert (idx.meta is not None) == (version != 8)
    out = str(tmp_path / name)
    idx.save(out)
    assert _sha(out) == _sha(src)


@pytest.mark.parametrize("cut", [10, 56, 80, -1])
def test_truncated_file_raises(cut, tmp_path):
    with open(os.path.join(GOLDEN, "v6_bruteforce.mvec"), "rb") as fh:
        data = fh.read()
    path = tmp_path / "cut.mvec"
    path.write_bytes(data[:cut])
    with pytest.raises(ValueError, match="truncated"):
        MonaVec.load(str(path), device="cpu")


@pytest.mark.parametrize("version", [5, 12])
def test_unknown_versions_raise(version, tmp_path):
    with open(os.path.join(GOLDEN, "v6_bruteforce.mvec"), "rb") as fh:
        data = bytearray(fh.read())
    data[4] = version
    path = tmp_path / "v.mvec"
    path.write_bytes(bytes(data))
    with pytest.raises(ValueError, match=f"unsupported .mvec version {version}"):
        MonaVec.load(str(path), device="cpu")


def test_garbage_tail_raises(tmp_path):
    with open(os.path.join(GOLDEN, "v6_bruteforce.mvec"), "rb") as fh:
        data = fh.read()
    path = tmp_path / "tail.mvec"
    path.write_bytes(data + b"\x00")
    with pytest.raises(ValueError, match="garbage tail"):
        MonaVec.load(str(path), device="cpu")


@pytest.mark.parametrize("index,roadmap", [("ivf", "ROADMAP A7"), ("hnsw", "ROADMAP A8")])
def test_unported_indexes_raise(index, roadmap):
    """HNSW raises naming A8; IVF (A7) is ported and builds and searches."""
    x = np.random.RandomState(3).randn(40, 8).astype(np.float32)
    if index == "hnsw":
        with pytest.raises(NotImplementedError, match=roadmap):
            MonaVec.build(x, index=index, device="cpu")
    else:
        idx = MonaVec.build(x, index=index, nlist=4, train_iters=3, device="cpu")
        scores, ids = idx.search(x[:3], 5, nprobe=4)
        assert ids[:, 0].tolist() == [0, 1, 2] and scores.shape == (3, 5)
    with pytest.raises(ValueError, match="unknown index"):
        MonaVec.build(np.zeros((4, 8), np.float32), index="annoy", device="cpu")
