"""The port's 2-bit and mixed 4/2-bit precision on the CPU against the reference.

The same numpy inputs go through ``repro`` (its jnp path, and its Pallas
kernels in interpret mode) and through ``repro_torch`` on the CPU, where each
kernel wrapper takes its plain version:

* packed codes, permutations, split sizes, coarse codes and survivor lists
  are integers and must be equal exactly (codes up to a one-level flip of a
  value on a Lloyd-Max boundary, ``torch_harness.code_flip_rows``);
* raw scores agree within 1e-5 * sum_i |q_i * deq_i| + 1e-6, deq the 4-bit
  or 2-bit centroid of each dim (``torch_harness.dot_tolerance``); norms
  within rtol 1e-6;
* whole searches run on one shared encoding (the reference's arrays through
  ``from_arrays``), so ids may differ only where scores tie within that
  tolerance;
* v6 (bits 2 and 3), v7 and static v10 files with a permutation cross
  between the packages both ways, and a load -> save gives the same bytes.
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
from repro.core import binary as rbinary
from repro.core import quantize as rqz
from repro.core import rhdh, standardize
from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro_torch import MonaVec
from repro_torch.core import binary
from repro_torch.core import quantize as tqz
from repro_torch.core import rhdh as trhdh
from repro_torch.core import standardize as tstd
from repro_torch.core.bruteforce import BruteForceIndex
from repro_torch.kernels import gather_dot as tgather_dot
from repro_torch.kernels import nibble_dot as tnibble
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from tests.golden import make_fixtures as gold
from tests.torch_harness import (adjusted_tolerance, assert_search_matches, code_flip_rows,
                                 dot_tolerance, port_stream, reference_stream)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
MODES = ["bits2", "mixed", "mixed_perm"]
KINDS = ["sign", "crumb"]
# (bits, n4_dims) at d'=64: 2-bit, and mixed splits with an empty 4-bit
# block, n4 % 8 == 4 (a coarse byte spans both blocks), n4 % 32 != 0, half,
# and an empty 2-bit block.
SPLITS = [(2, 0), (3, 0), (3, 4), (3, 12), (3, 32), (3, 64)]


@pytest.fixture(autouse=True)
def _follow_reference_stream():
    with port_stream(reference_stream()):
        yield


def _sha(path) -> str:
    with open(path, "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()


def _corpus(n, d, seed=5):
    """Anisotropic rows (spectrum exp(-i/12)), where the permutation matters."""
    rng = np.random.RandomState(seed)
    return (rng.randn(n, d) * np.exp(-np.arange(d) / 12.0) + 0.05).astype(np.float32)


def _queries(x, b, seed=6):
    rng = np.random.RandomState(seed)
    return (x[rng.randint(0, len(x), size=b)]
            + 0.05 * rng.randn(b, x.shape[1])).astype(np.float32)


def _ref_rot(x, metric="cosine", std=None, seed=7):
    prepared = standardize.prepare(jnp.asarray(x), metric, std)
    return np.asarray(rhdh.rhdh_apply(prepared, seed, normalized=False)), np.asarray(prepared)


def _ref_index(x, mode, *, metric="cosine", std=None, seed=7, ids=None, coarse=None):
    """The reference's index: bits=2, mixed leading (avg_bits=3.0), or mixed
    with the variance permutation of the first 64 rotated rows (v7)."""
    if mode == "bits2":
        return RefMonaVec.build(jnp.asarray(x), metric=metric, std=std, seed=seed, bits=2,
                                ids=ids, coarse=coarse)
    if mode == "mixed":
        return RefMonaVec.build(jnp.asarray(x), metric=metric, std=std, seed=seed,
                                avg_bits=3.0, ids=ids, coarse=coarse)
    perm = rqz.variance_permutation(jnp.asarray(_ref_rot(x[:64], metric, std, seed)[0]))
    enc = rqz.encode_mixed(jnp.asarray(x), metric=metric, seed=seed, avg_bits=3.0, std=std,
                           perm=perm)
    if ids is None:
        ids = np.arange(len(x), dtype=np.uint64)
    ref = RefMonaVec(RefBruteForceIndex(enc=enc, ids=np.asarray(ids, dtype=np.uint64)))
    return ref if coarse is None else ref.enable_coarse(coarse)


def _shared(ref: RefMonaVec) -> MonaVec:
    """The port's index over the reference's encoding (coarse code derived
    by the port)."""
    enc = ref.backend.enc
    std = enc.std
    idx = MonaVec.from_arrays(np.asarray(enc.packed), np.asarray(enc.qnorms), seed=enc.seed,
                              metric=enc.metric, bits=enc.bits, dim=enc.dim,
                              dim_pad=enc.dim_pad, ids=ref.backend.ids, n4_dims=enc.n4_dims,
                              perm=enc.perm, std_mean=None if std is None else std.mean,
                              std_inv_std=None if std is None else std.inv_std, device="cpu")
    return idx if enc.coarse is None else idx.enable_coarse(enc.coarse)


def _tolerance(idx: MonaVec, queries: np.ndarray) -> np.ndarray:
    enc = idx.backend.enc
    q_rot = tqz.encode_query(torch.from_numpy(queries), enc).numpy()
    return adjusted_tolerance(dot_tolerance(q_rot, enc.packed.numpy(), enc.bits, enc.n4_dims),
                              enc.qnorms.numpy(), enc.metric)


def _compare(idx: MonaVec, ref: RefMonaVec, queries, k, rm=None):
    got = idx.search(queries, k, rescore_mult=rm)
    want = ref.search(jnp.asarray(queries), k, rescore_mult=rm)
    full = np.asarray(ref.backend.scores(jnp.asarray(queries)))
    assert_search_matches(got, want, full, idx.ids, _tolerance(idx, queries))
    return got, want


# ---------------------------------------------------------------------------
# Packing, split sizes, permutations and codes.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(37, 64), (5, 4), (3, 2, 8)])
def test_pack_2bit_round_trips_and_equals_reference(shape):
    codes = np.random.RandomState(1).randint(0, 4, size=shape).astype(np.uint8)
    packed = tqz.pack_2bit(torch.from_numpy(codes)).numpy()
    np.testing.assert_array_equal(packed, np.asarray(rqz.pack_2bit(jnp.asarray(codes))))
    np.testing.assert_array_equal(tqz.unpack_2bit(torch.from_numpy(packed)).numpy(), codes)
    np.testing.assert_array_equal(np.asarray(rqz.unpack_2bit(jnp.asarray(packed))), codes)
    with pytest.raises(ValueError, match="dim % 4 == 0"):
        tqz.pack_2bit(torch.zeros(3, 6, dtype=torch.uint8))


@pytest.mark.parametrize("avg_bits", [2.0, 2.5, 3.0, 3.5, 4.5])
@pytest.mark.parametrize("dim_pad", [16, 64, 1024])
def test_allocate_bits_equals_reference(avg_bits, dim_pad):
    n4 = tqz.allocate_bits(dim_pad, avg_bits)
    assert n4 == rqz.allocate_bits(dim_pad, avg_bits)
    assert n4 % 4 == 0 and 0 <= n4 <= dim_pad
    assert tqz.bytes_per_vector(dim_pad, 3, n4) == n4 // 2 + (dim_pad - n4) // 4


@pytest.mark.parametrize("n,d,data_seed", [(32, 16, 100), (300, 96, 2)])
@pytest.mark.parametrize("metric", ["cosine", "dot", "l2"])
def test_encode_2bit_codes_match_reference(n, d, data_seed, metric):
    """2-bit codes equal, except a one-level flip of a value on a boundary."""
    x = gold._data(n, d, data_seed)
    std = standardize.GlobalStd.fit(x) if metric == "l2" else None
    ref = rqz.encode(jnp.asarray(x), metric=metric, seed=7, bits=2, std=std)
    ref_rot, prepared = _ref_rot(x, metric, std)
    got = tqz.encode(torch.from_numpy(x), metric=metric, seed=7, bits=2,
                     std=None if std is None else tstd.GlobalStd(std.mean, std.inv_std))
    assert (got.bits, got.dim, got.dim_pad, got.n4_dims) == (2, d, ref.dim_pad, 0)
    assert got.packed.shape == (n, ref.dim_pad // 4)
    flipped = code_flip_rows(got.packed.numpy(), np.asarray(ref.packed), ref_rot, prepared,
                             bits=2)
    same = np.setdiff1d(np.arange(n), flipped)
    np.testing.assert_allclose(got.qnorms.numpy()[same], np.asarray(ref.qnorms)[same],
                               rtol=1e-6)
    np.testing.assert_array_equal(tqz.decode(got).numpy()[same],
                                  np.asarray(rqz.decode(ref))[same])


def _golden_sample():
    """The rotated sample ``make_fixtures.build_v7_perm_bruteforce`` takes its
    permutation from (24 x 16, seed 7)."""
    x = gold._data(24, 16, 101) * np.exp(-np.arange(16) / 4).astype(np.float32)
    return x, 7


def _fig3_sample():
    """The rotated sample of the paper's Fig. 3 (``benchmarks/paper_tables.py``):
    the first 512 rows of the anisotropic 1024-dim corpus, seed 2."""
    rng = np.random.RandomState(19)
    d = 1024
    x = (rng.randn(512, d) * np.exp(-np.arange(d) / 80).astype(np.float32)).astype(np.float32)
    return x, 2


@pytest.mark.parametrize("sample", ["golden_v7", "fig3"])
@pytest.mark.parametrize("rotation", ["shared", "own"])
def test_variance_permutation_equals_reference(sample, rotation):
    """On the same rotated sample, and on each package's own rotation of it."""
    x, seed = {"golden_v7": _golden_sample, "fig3": _fig3_sample}[sample]()
    ref_rot, _ = _ref_rot(x, seed=seed)
    want = rqz.variance_permutation(jnp.asarray(ref_rot))
    if rotation == "shared":
        rot = torch.from_numpy(ref_rot.copy())
    else:
        rot = trhdh.rhdh_apply(tstd.prepare(torch.from_numpy(x), "cosine"), seed,
                               normalized=False)
    got = tqz.variance_permutation(rot)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n4_dims", [0, 4, 12, 32, 64])
@pytest.mark.parametrize("with_perm", [False, True])
def test_encode_mixed_matches_reference(n4_dims, with_perm):
    x = _corpus(200, 48)
    ref_rot, prepared = _ref_rot(x)
    perm = rqz.variance_permutation(jnp.asarray(ref_rot[:64])) if with_perm else None
    ref = rqz.encode_mixed(jnp.asarray(x), seed=7, n4_dims=n4_dims, perm=perm)
    got = tqz.encode_mixed(torch.from_numpy(x), seed=7, n4_dims=n4_dims, perm=perm)
    assert (got.bits, got.n4_dims, got.dim_pad) == (3, n4_dims, 64)
    assert got.packed.shape == (200, n4_dims // 2 + (64 - n4_dims) // 4)
    if with_perm:
        np.testing.assert_array_equal(got.perm, perm)
        ref_rot = ref_rot[:, perm]
    flipped = code_flip_rows(got.packed.numpy(), np.asarray(ref.packed), ref_rot, prepared,
                             bits=3, n4_dims=n4_dims)
    same = np.setdiff1d(np.arange(200), flipped)
    np.testing.assert_allclose(got.qnorms.numpy()[same], np.asarray(ref.qnorms)[same],
                               rtol=1e-6)
    # Decode of one shared encoding: a table lookup and the inverse permutation.
    shared = _shared(RefMonaVec(RefBruteForceIndex(enc=ref, ids=np.arange(200,
                                                                          dtype=np.uint64))))
    np.testing.assert_array_equal(tqz.decode(shared.backend.enc).numpy(),
                                  np.asarray(rqz.decode(ref)))


@pytest.mark.parametrize("avg_bits,n4", [(2.0, 0), (2.5, 16), (3.0, 32), (4.0, None),
                                         (4.5, 64)])
def test_build_avg_bits_follows_the_reference_rule(avg_bits, n4):
    """avg_bits other than 4 is the mixed encode (leading dims); exactly 4 is
    the plain 4-bit encode, as in the reference's BruteForceIndex.build."""
    x = _corpus(120, 40)
    got = MonaVec.build(x, avg_bits=avg_bits, seed=7, device="cpu").backend.enc
    ref = RefMonaVec.build(jnp.asarray(x), avg_bits=avg_bits, seed=7).backend.enc
    assert (got.bits, got.n4_dims) == (ref.bits, ref.n4_dims)
    assert got.bits == (4 if n4 is None else 3) and (n4 is None or got.n4_dims == n4)
    ref_rot, prepared = _ref_rot(x)
    code_flip_rows(got.packed.numpy(), np.asarray(ref.packed), ref_rot, prepared,
                   bits=got.bits, n4_dims=got.n4_dims)


def test_golden_v7_rebuilds_on_the_legacy_stream():
    """The golden v7 file's permutation and codes, rebuilt by the port the
    way make_fixtures builds them (the fixtures use the legacy stream)."""
    x, seed = _golden_sample()
    with port_stream(False):
        rot = trhdh.rhdh_apply(tstd.prepare(torch.from_numpy(x), "cosine"), seed,
                               normalized=False)
        perm = tqz.variance_permutation(rot)
        enc = tqz.encode_mixed(torch.from_numpy(x), metric="cosine", seed=seed,
                               avg_bits=3.0, perm=perm)
    golden = MonaVec.load(os.path.join(GOLDEN, "v7_perm_bruteforce.mvec"), device="cpu")
    np.testing.assert_array_equal(perm, golden.backend.enc.perm)
    assert enc.n4_dims == golden.backend.enc.n4_dims == 8
    assert torch.equal(enc.packed, golden.backend.enc.packed)


def test_golden_v7_round_trips_to_its_digest(tmp_path):
    with open(os.path.join(GOLDEN, "digests.json")) as fh:
        digest = json.load(fh)["v7_perm_bruteforce.mvec"]
    path = os.path.join(GOLDEN, "v7_perm_bruteforce.mvec")
    idx = MonaVec.load(path, device="cpu")
    enc = idx.backend.enc
    assert (enc.bits, enc.n4_dims, enc.perm.shape) == (3, 8, (16,))
    again = str(tmp_path / "again.mvec")
    idx.save(again)
    assert _sha(again) == _sha(path) == digest
    ref = RefMonaVec.load(path)
    q = _queries(gold._data(24, 16, 101), 4)
    _compare(idx, ref, q, 5)


# ---------------------------------------------------------------------------
# Raw scores, full and gathered: within the f32 rule.
# ---------------------------------------------------------------------------

def _random_codes(n, bits, n4_dims, d_pad=64, seed=3):
    rng = np.random.RandomState(seed)
    packed = rng.randint(0, 256, size=(n, tqz.bytes_per_vector(d_pad, bits, n4_dims)))
    q = rng.randn(5, d_pad).astype(np.float32)
    return packed.astype(np.uint8), q


@pytest.mark.parametrize("bits,n4_dims", SPLITS)
def test_score_raw_matches_reference_and_interpret_kernels(bits, n4_dims):
    packed, q = _random_codes(300, bits, n4_dims)
    got = tops.score_raw(torch.from_numpy(packed), torch.from_numpy(q), bits=bits,
                         n4_dims=n4_dims).numpy()
    tol = dot_tolerance(q, packed, bits, n4_dims)
    want = np.asarray(rops.score_raw(jnp.asarray(packed), jnp.asarray(q), bits=bits,
                                     n4_dims=n4_dims, use_kernel=False))
    assert got.shape == (5, 300)
    assert np.all(np.abs(got - want) <= tol)
    if bits == 2 or 0 < n4_dims < 64:   # the Pallas path takes no empty block
        want_kernel = np.asarray(rops.score_raw(jnp.asarray(packed), jnp.asarray(q),
                                                bits=bits, n4_dims=n4_dims, use_kernel=True,
                                                interpret=True))
        assert np.all(np.abs(got - want_kernel) <= tol)
    if bits == 3:
        plain = tref.mixed_dot_ref(torch.from_numpy(packed), torch.from_numpy(q), n4_dims)
        assert np.all(np.abs(got - plain.numpy()) <= tol)


# m=30 keeps the cases' original ids; m in {1, 33, 1280} are the rescore
# kernels' tiling edges (a lone candidate, one past a warp, many blocks).
GATHER_CASES = [pytest.param(bits, n4_dims, m, id=f"{bits}-{n4_dims}" + (f"-m{m}" if m != 30
                                                                       else ""))
                for m in (30, 1, 33, 1280) for bits, n4_dims in SPLITS]


@pytest.mark.parametrize("bits,n4_dims,m", GATHER_CASES)
def test_score_gathered_raw_matches_reference(bits, n4_dims, m):
    packed, q = _random_codes(200, bits, n4_dims)
    cand = np.random.RandomState(4).randint(-1, 200, size=(5, m)).astype(np.int32)
    cand[:, ::7] = -1
    cand[:, 3::11] = 200 + np.arange(len(cand[0, 3::11])) % 3   # rows past the corpus
    got = tops.score_gathered_raw(torch.from_numpy(packed), torch.from_numpy(q),
                                  torch.from_numpy(cand), bits=bits, n4_dims=n4_dims).numpy()
    valid = (cand >= 0) & (cand < 200)
    rows = np.clip(cand, 0, 199)
    tol = np.take_along_axis(dot_tolerance(q, packed, bits, n4_dims), rows, 1)
    args = jnp.asarray(packed), jnp.asarray(q), jnp.asarray(rows)
    oracle = (rref.gather_crumb_dot_ref(*args) if bits == 2
              else rref.gather_mixed_dot_ref(*args, n4_dims))
    assert got.shape == (5, m) and (got[~valid] == 0).all()
    assert np.all(np.abs(got - np.asarray(oracle))[valid] <= tol[valid])
    # The reference's tiled paths take no empty block (its gather pads to a
    # zero-width tile); the port skips an empty block.
    if bits == 2 or 0 < n4_dims < 64:
        for kw in ({"use_kernel": False}, {"use_kernel": True, "interpret": True}):
            want = np.asarray(rops.score_gathered_raw(*args, bits=bits, n4_dims=n4_dims, **kw))
            assert np.all(np.abs(got - want)[valid] <= tol[valid])
    full = tops.score_raw(torch.from_numpy(packed), torch.from_numpy(q), bits=bits,
                          n4_dims=n4_dims).numpy()
    assert np.all(np.abs(got - np.take_along_axis(full, rows, 1))[valid] <= tol[valid])


def test_cpu_dispatch_takes_the_plain_2bit_versions_uncounted():
    packed, q = _random_codes(70, 2, 0)
    packed, q = torch.from_numpy(packed), torch.from_numpy(q)
    mixed = torch.from_numpy(_random_codes(70, 3, 8)[0])
    cand = torch.from_numpy(np.random.RandomState(5).randint(0, 70, size=(5, 9)).astype(
        np.int32))
    counters = (tnibble.crumb_dot_cuda, tgather_dot.gather_crumb_dot_cuda,
                tnibble.nibble_dot_cuda, tgather_dot.gather_nibble_dot_cuda)
    before = [f.launches for f in counters]
    assert torch.equal(tops.crumb_score_raw(packed, q), tref.crumb_dot_ref(packed, q))
    assert torch.equal(tops.score_gathered_raw(packed, q, cand, bits=2),
                       tref.gather_crumb_dot_ref(packed, q, cand))
    assert torch.equal(tops.score_raw(mixed, q, bits=3, n4_dims=8),
                       tref.mixed_dot_ref(mixed, q, 8))
    assert torch.equal(tops.score_gathered_raw(mixed, q, cand, bits=3, n4_dims=8),
                       tref.gather_mixed_dot_ref(mixed, q, cand, 8))
    assert [f.launches for f in counters] == before


@pytest.mark.parametrize("bad", ["cpu", "dtype", "shape"])
@pytest.mark.parametrize("fn", ["crumb_dot", "gather_crumb_dot"])
def test_2bit_wrappers_refuse_before_building(bad, fn):
    packed, q = torch.zeros(10, 32, dtype=torch.uint8), torch.zeros(3, 128)
    cand = torch.zeros(3, 5, dtype=torch.int32)
    if bad == "dtype":
        packed = packed.to(torch.int8)
    elif bad == "shape":
        q = torch.zeros(3, 64)           # 2-bit rows of 32 bytes are 128 dims
    with pytest.raises(ValueError):
        if fn == "crumb_dot":
            tnibble.crumb_dot_cuda(packed, q)
        else:
            tgather_dot.gather_crumb_dot_cuda(packed, q, cand)


def test_row_stride_takes_column_views_and_refuses_other_layouts():
    x = torch.zeros(6, 24, dtype=torch.uint8)
    assert tnibble.row_stride("t", x[:, 4:]) == 24
    assert tnibble.row_stride("t", x[:1, 8:]) == 16        # one row: its own width
    with pytest.raises(ValueError, match="contiguous rows"):
        tnibble.row_stride("t", x.T)
    with pytest.raises(ValueError, match="contiguous rows"):
        tnibble.row_stride("t", x[:, ::2])


# ---------------------------------------------------------------------------
# Coarse codes: byte-equal to the reference's.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("bits,n4_dims,d_pad", [(b, n4, 64) for b, n4 in SPLITS]
                         + [(2, 0, 16), (3, 4, 16), (3, 12, 16)])
def test_derive_codes_equal_reference(kind, bits, n4_dims, d_pad):
    packed, _ = _random_codes(150, bits, n4_dims, d_pad=d_pad)
    want = rbinary.derive_codes(jnp.asarray(packed), bits=bits, n4_dims=n4_dims,
                                dim_pad=d_pad, kind=kind)
    got = binary.derive_codes(torch.from_numpy(packed), bits=bits, n4_dims=n4_dims,
                              dim_pad=d_pad, kind=kind)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# Whole searches on a shared encoding.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("metric", ["cosine", "dot", "l2"])
def test_search_matches_reference(mode, metric):
    x = _corpus(900, 48)
    std = RefMonaVec.fit(x) if metric == "l2" else None
    ext = (3 + 5 * np.arange(900)).astype(np.uint64)
    ref = _ref_index(x, mode, metric=metric, std=std, ids=ext)
    idx = _shared(ref)
    assert idx.backend.enc.bits == (2 if mode == "bits2" else 3)
    assert (idx.backend.enc.perm is not None) == (mode == "mixed_perm")
    q = _queries(x, 7)
    got, _ = _compare(idx, ref, q, 10)
    assert got[0].shape == (7, 10) and np.isin(got[1], ext).all()
    full = idx.backend.scores(torch.from_numpy(q)).numpy()
    ref_full = np.asarray(ref.backend.scores(jnp.asarray(q)))
    assert np.all(np.abs(full - ref_full) <= _tolerance(idx, q))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("rm", [2, 8])
def test_cascade_matches_reference(mode, kind, rm):
    x = _corpus(1200, 48)
    ref = _ref_index(x, mode, coarse=kind)
    idx = _shared(ref)
    np.testing.assert_array_equal(idx.backend.enc.ccodes.numpy(),
                                  np.asarray(ref.backend.enc.ccodes))
    q = _queries(x, 6)
    assert idx.resolved_knobs(10, rescore_mult=rm) == {"rescore_mult": rm}
    # Survivors of one rotated query (the reference's) are equal exactly.
    q_rot = np.asarray(rqz.encode_query(jnp.asarray(q), ref.backend.enc))
    want = rbinary.survivor_topk_stage(
        rbinary.coarse_scan_stage(jnp.asarray(q_rot), ref.backend.enc.ccodes, kind=kind),
        jnp.ones(1200, bool), m=10 * rm, vbound=9 * 64)
    got = binary.survivor_topk_stage(
        binary.coarse_scan_stage(torch.from_numpy(q_rot.copy()), idx.backend.enc.ccodes, kind=kind),
        None, m=10 * rm)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    (scores, ids), _ = _compare(idx, ref, q, 10, rm)
    # The rescore is the full scan's scan of the survivors.
    full = idx.backend.scores(torch.from_numpy(q)).numpy()
    row_of = {int(v): i for i, v in enumerate(idx.ids)}
    rows = np.vectorize(row_of.get)(ids)
    tol = np.take_along_axis(_tolerance(idx, q), rows, 1)
    assert np.all(np.abs(scores - np.take_along_axis(full, rows, 1)) <= tol)


# ---------------------------------------------------------------------------
# Files: v6 with bits 2 and 3, v7, static v10 with a permutation.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
def test_files_cross_both_ways(mode, tmp_path):
    x = _corpus(400, 40)
    ref = _ref_index(x, mode, metric="l2", std=RefMonaVec.fit(x),
                     ids=np.arange(400, dtype=np.uint64) * 3)
    ref_path = str(tmp_path / "ref.mvec")
    ref.save(ref_path)
    with open(ref_path, "rb") as fh:
        head = fh.read(56)
    assert head[4] == (7 if mode == "mixed_perm" else 6) and head[45] == 0
    idx = MonaVec.load(ref_path, device="cpu")
    again = str(tmp_path / "again.mvec")
    idx.save(again)
    assert _sha(again) == _sha(ref_path)
    q = _queries(x, 5)
    _compare(idx, RefMonaVec.load(ref_path), q, 10)
    # The port's own encoding, saved by the port, read by the reference.
    port_path = str(tmp_path / "port.mvec")
    idx.save(port_path)
    back = RefMonaVec.load(port_path)
    enc, benc = idx.backend.enc, back.backend.enc
    assert (benc.bits, benc.n4_dims) == (enc.bits, enc.n4_dims)
    np.testing.assert_array_equal(np.asarray(benc.packed), enc.packed.numpy())
    assert (benc.perm is None) == (enc.perm is None)
    if enc.perm is not None:
        np.testing.assert_array_equal(np.asarray(benc.perm), enc.perm)
    _compare(idx, back, q, 10)


@pytest.mark.parametrize("kind", KINDS)
def test_v10_with_a_permutation_crosses_both_ways(kind, tmp_path):
    x = _corpus(500, 48)
    ref = _ref_index(x, "mixed_perm", coarse=kind)
    ref_path = str(tmp_path / "ref.mvec")
    ref.save(ref_path)
    with open(ref_path, "rb") as fh:
        head = fh.read(56)
    assert head[4] == 10 and head[45] == 1 and head[46] == {"sign": 1, "crumb": 2}[kind]
    idx = MonaVec.load(ref_path, device="cpu")
    assert idx.backend.enc.coarse == kind and idx.backend.enc.perm is not None
    again = str(tmp_path / "again.mvec")
    idx.save(again)
    assert _sha(again) == _sha(ref_path)
    q = _queries(x, 5)
    _compare(idx, RefMonaVec.load(ref_path), q, 10, 4)
    a, b = idx.search(q, 10, rescore_mult=4), MonaVec.load(again, device="cpu").search(
        q, 10, rescore_mult=4)
    assert a[0].tobytes() == b[0].tobytes() and a[1].tobytes() == b[1].tobytes()


def test_golden_v10_with_segments_and_metadata_still_raises():
    """Its segments load now; its metadata columns are ROADMAP A6."""
    with pytest.raises(NotImplementedError, match="ROADMAP A6"):
        MonaVec.load(os.path.join(GOLDEN, "v10_coarse_bruteforce.mvec"), device="cpu")


def test_from_arrays_checks_what_it_is_given():
    packed, qn = np.zeros((4, 6), np.uint8), np.ones(4, np.float32)
    kw = dict(qnorms=qn, seed=7, metric="cosine", dim=16, dim_pad=16, device="cpu")
    with pytest.raises(ValueError, match="unsupported bits=5"):
        MonaVec.from_arrays(packed, bits=5, **kw)
    with pytest.raises(ValueError, match="n4_dims=6"):
        MonaVec.from_arrays(packed, bits=3, n4_dims=6, **kw)
    with pytest.raises(ValueError, match="permutation"):
        MonaVec.from_arrays(packed, bits=3, n4_dims=8, perm=np.zeros(16, np.int32), **kw)
    with pytest.raises(ValueError, match="mixed"):
        MonaVec.from_arrays(np.zeros((4, 4), np.uint8), bits=2, n4_dims=8, **kw)
    idx = MonaVec.from_arrays(packed, bits=3, n4_dims=8, perm=np.arange(16)[::-1], **kw)
    assert idx.backend.enc.perm_index.tolist() == list(range(15, -1, -1))


# ---------------------------------------------------------------------------
# The paper's Fig. 3 at a reduced row count.
# ---------------------------------------------------------------------------

def _recall_at_10(found: np.ndarray, exact: np.ndarray) -> float:
    return float(np.mean([len(set(a) & set(b)) / 10.0 for a, b in zip(found, exact)]))


@pytest.fixture(scope="module")
def fig3_data():
    """Fig. 3's anisotropic corpus (spectrum exp(-i/80), d=1024, seed 19), cut
    from 4,000 to 1,000 rows; its 64 queries; exact cosine top-10."""
    rng = np.random.RandomState(19)
    d = 1024
    spectrum = np.exp(-np.arange(d) / 80).astype(np.float32)
    corpus = (rng.randn(4000, d) * spectrum).astype(np.float32)[:1000]
    queries = (rng.randn(64, d) * spectrum).astype(np.float32)
    qn = queries / np.linalg.norm(queries, axis=1, keepdims=True)
    cn = corpus / np.linalg.norm(corpus, axis=1, keepdims=True)
    exact = np.argsort(-(qn.astype(np.float64) @ cn.T.astype(np.float64)), axis=1,
                       kind="stable")[:, :10]
    return corpus, queries, exact


@pytest.mark.parametrize("config", ["pure4bit", "mixed3bit_leading", "mixed3bit_perm_v7",
                                    "pure2bit"])
def test_fig3_recall_equals_reference(config, fig3_data):
    corpus, queries, exact = fig3_data
    if config == "mixed3bit_perm_v7":
        ref_rot, _ = _ref_rot(corpus[:512], seed=2)
        ref_enc = rqz.encode_mixed(jnp.asarray(corpus), metric="cosine", seed=2, avg_bits=3.0,
                                   perm=rqz.variance_permutation(jnp.asarray(ref_rot)))
        rot = trhdh.rhdh_apply(tstd.prepare(torch.from_numpy(corpus[:512]), "cosine"), 2,
                               normalized=False)
        enc = tqz.encode_mixed(torch.from_numpy(corpus), metric="cosine", seed=2, avg_bits=3.0,
                               perm=tqz.variance_permutation(rot))
        idx = MonaVec(BruteForceIndex(enc=enc, ids=np.arange(1000, dtype=np.uint64)))
    else:
        kw = {"pure4bit": {"bits": 4}, "pure2bit": {"bits": 2},
              "mixed3bit_leading": {"avg_bits": 3.0}}[config]
        ref_enc = RefMonaVec.build(jnp.asarray(corpus), seed=2, **kw).backend.enc
        idx = MonaVec.build(corpus, seed=2, device="cpu", **kw)
    ref = RefMonaVec(RefBruteForceIndex(enc=ref_enc, ids=np.arange(1000, dtype=np.uint64)))
    got = _recall_at_10(idx.search(queries, 10)[1], exact)
    want = _recall_at_10(ref.search(jnp.asarray(queries), 10)[1], exact)
    assert got == want
