"""The port's binarized cascade on the CPU against the reference.

The same numpy inputs go through ``repro`` (its jnp path, and its Pallas
kernels in interpret mode where they are cheap) and through ``repro_torch``
on the CPU, where each kernel wrapper takes its plain version:

* coarse codes, query bits and planes, proxies and survivor lists are
  integers and must be equal exactly;
* gathered scores agree within the port's f32 rule (``torch_harness``);
* whole searches run on one shared encoding (the reference's packed codes
  and norms through ``from_arrays``), so the survivor sets are equal and
  ids may differ only where rescores tie within the tolerance;
* static v10 files cross between the packages both ways.
"""

import hashlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import MonaVec as RefMonaVec
from repro.core import binary as rbinary
from repro.core import quantize as qz
from repro.core.allowlist import Allowlist as RefAllowlist
from repro.data import synthetic as rsyn
from repro.kernels import binary_dot as rbinary_dot
from repro.kernels import ops as rops
from repro_torch import MonaVec
from repro_torch.core import binary
from repro_torch.core import lloydmax as tlm
from repro_torch.core import quantize as tqz
from repro_torch.core.allowlist import NEG, Allowlist
from repro_torch.core.segments import SENTINEL_ID
from repro_torch.kernels import binary_dot as tbinary_dot
from repro_torch.kernels import gather_dot as tgather_dot
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from tests.cascade_harness import survivor_oracle
from tests.torch_harness import (adjusted_tolerance, assert_search_matches, dot_tolerance,
                                 port_stream, reference_stream)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
KINDS = ["sign", "crumb"]


@pytest.fixture(autouse=True)
def _follow_reference_stream():
    with port_stream(reference_stream()):
        yield


def _corpus(n, dim, seed=41):
    return rsyn.embedding_corpus(seed, n, dim)


def _queries(corpus, b, seed=141):
    return np.asarray(rsyn.queries_from_corpus(corpus, seed, b))


def _shared(ref: RefMonaVec, kind: str) -> MonaVec:
    """The port's index over the reference's encoding, coarse code derived
    by the port."""
    enc = ref.backend.enc
    std = enc.std
    idx = MonaVec.from_arrays(np.asarray(enc.packed), np.asarray(enc.qnorms), seed=enc.seed,
                              metric=enc.metric, bits=enc.bits, dim=enc.dim,
                              dim_pad=enc.dim_pad, ids=ref.backend.ids,
                              std_mean=None if std is None else std.mean,
                              std_inv_std=None if std is None else std.inv_std, device="cpu")
    return idx.enable_coarse(kind)


def _tolerance(idx: MonaVec, queries: np.ndarray) -> np.ndarray:
    enc = idx.backend.enc
    q_rot = tqz.encode_query(torch.from_numpy(queries), enc).numpy()
    return adjusted_tolerance(dot_tolerance(q_rot, enc.packed.numpy()),
                              enc.qnorms.numpy(), enc.metric)


def _sha(path) -> str:
    with open(path, "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()


# ---------------------------------------------------------------------------
# Coarse codes and query encodings: byte-equal.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dim", [8, 16, 40, 128])
def test_derive_codes_equal_reference(kind, dim):
    ref = RefMonaVec.build(jnp.asarray(_corpus(300, dim)), metric="cosine", seed=3)
    enc = ref.backend.enc
    want = rbinary.derive_codes(enc.packed, bits=4, n4_dims=0, dim_pad=enc.dim_pad, kind=kind)
    got = binary.derive_codes(torch.from_numpy(np.array(enc.packed)), bits=4,
                              dim_pad=enc.dim_pad, kind=kind)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    idx = _shared(ref, kind)
    assert idx.backend.enc.coarse == kind
    np.testing.assert_array_equal(idx.backend.enc.ccodes.numpy(), want)


@pytest.mark.parametrize("d", [8, 16, 256])
def test_query_bits_and_planes_equal_reference(d):
    rng = np.random.RandomState(d)
    q = rng.randn(7, d).astype(np.float32)
    edge = tlm.BOUNDARIES_2BIT[2]
    q[0, :4] = [0.0, -0.0, edge, -edge]               # the 0 and 2-bit boundaries
    np.testing.assert_array_equal(binary.query_sign_bits(torch.from_numpy(q)).numpy(),
                                  np.asarray(rbinary.query_sign_bits(jnp.asarray(q))))
    np.testing.assert_array_equal(binary.query_crumb_planes(torch.from_numpy(q)).numpy(),
                                  np.asarray(rbinary.query_crumb_planes(jnp.asarray(q))))


def test_code_bytes_and_derive_reject_what_the_reference_rejects():
    assert binary.code_bytes(1024, "sign") == rbinary.code_bytes(1024, "sign") == 128
    assert binary.code_bytes(1024, "crumb") == rbinary.code_bytes(1024, "crumb") == 256
    with pytest.raises(ValueError, match="unknown coarse kind"):
        binary.code_bytes(64, "trit")
    with pytest.raises(ValueError, match="dim_pad % 8 == 0"):
        binary.code_bytes(4, "sign")
    for derive in (binary.derive_codes, rbinary.derive_codes):
        with pytest.raises(ValueError, match="unsupported bits=5"):
            derive(torch.zeros(3, 16, dtype=torch.uint8), bits=5, n4_dims=0, dim_pad=64,
                   kind="sign")


def test_constants_equal_reference():
    assert binary.DEFAULT_RESCORE_MULT == rbinary.DEFAULT_RESCORE_MULT
    assert binary.VBOUND_MAX == rbinary.VBOUND_MAX
    assert binary.INT_NEG == rbinary.INT_NEG == torch.iinfo(torch.int32).min
    assert binary.COARSE_KINDS == rbinary.COARSE_KINDS


# ---------------------------------------------------------------------------
# Proxies: exactly equal to the reference's jnp mirrors and interpret kernels.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n,d,b", [(257, 8, 3), (300, 16, 5), (129, 128, 1), (1000, 256, 16)])
def test_proxies_equal_reference(kind, n, d, b):
    rng = np.random.RandomState(n + d)
    cb = binary.code_bytes(d, kind)
    codes = rng.randint(0, 256, size=(n, cb)).astype(np.uint8)
    qcodes = rng.randint(0, 256, size=(b, cb)).astype(np.uint8)
    if kind == "sign":
        got = tops.sign_coarse_raw(torch.from_numpy(codes), torch.from_numpy(qcodes))
        want = rbinary_dot.sign_hamming_jnp(jnp.asarray(codes), jnp.asarray(qcodes))
        kern = rops.sign_coarse_raw(jnp.asarray(codes), jnp.asarray(qcodes),
                                    use_kernel=True, interpret=True)
    else:
        h = cb // 2
        got = tops.crumb_coarse_raw(torch.from_numpy(codes), torch.from_numpy(qcodes))
        want = rbinary_dot.crumb_affinity_jnp(
            jnp.asarray(codes[:, :h]), jnp.asarray(codes[:, h:]), jnp.asarray(qcodes[:, :h]),
            jnp.asarray(qcodes[:, h:]), dim=d)
        kern = rops.crumb_coarse_raw(jnp.asarray(codes), jnp.asarray(qcodes),
                                     use_kernel=True, interpret=True)
    assert got.dtype == torch.int32 and got.shape == (b, n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), np.asarray(kern))


@pytest.mark.parametrize("kind", KINDS)
def test_coarse_stage_equals_reference_on_an_index(kind):
    x = _corpus(500, 96)
    ref = RefMonaVec.build(jnp.asarray(x), metric="l2", std=RefMonaVec.fit(x), coarse=kind)
    enc = ref.backend.enc
    q_rot = np.array(qz.encode_query(jnp.asarray(_queries(x, 6)), enc))
    want = rbinary.coarse_scan_stage(jnp.asarray(q_rot), enc.ccodes, kind=kind,
                                     use_kernel=False)
    got = binary.coarse_scan_stage(torch.from_numpy(q_rot),
                                   _shared(ref, kind).backend.enc.ccodes, kind=kind)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_crumb_affinity_is_the_level_product():
    """The popcount identity: sum_i L(q_i) L(c_i) with L(c) = 2c - 3."""
    rng = np.random.RandomState(5)
    d = 64
    c_codes = rng.randint(0, 4, size=(40, d)).astype(np.uint8)
    q_codes = rng.randint(0, 4, size=(3, d)).astype(np.uint8)

    def planes(codes):
        bits = lambda v: np.packbits(v.astype(np.uint8), axis=-1, bitorder="little")
        return np.concatenate([bits(codes >> 1), bits(codes & 1)], axis=-1)

    got = tref.crumb_affinity_ref(torch.from_numpy(planes(c_codes)),
                                  torch.from_numpy(planes(q_codes))).numpy()
    level = lambda c: 2 * c.astype(np.int64) - 3
    np.testing.assert_array_equal(got, level(q_codes) @ level(c_codes).T)


def _crumb_levels(planes: np.ndarray) -> np.ndarray:
    """[rows, 2 dkp] plane bytes (hi || lo) -> [rows, 8 dkp] int64 levels
    4 hi + 2 lo - 3, bit j of byte k being dim 8k + j."""
    h = planes.shape[1] // 2
    bits = lambda p: np.unpackbits(p, axis=-1, bitorder="little").astype(np.int64)
    return 4 * bits(planes[:, :h]) + 2 * bits(planes[:, h:]) - 3


@pytest.mark.parametrize("b,n,d", [(1, 37, 8), (7, 301, 16), (7, 129, 64), (1, 300, 1024),
                                   (3, 55, 1024)])
def test_crumb_level_product_equals_ref_and_reference(b, n, d):
    """The affinity as the level product (decode the planes to levels, one
    integer product) equals the port's plain version and the reference's
    crumb_affinity_jnp bit for bit, and so does the card kernel's
    arithmetic: the four AND+popcounts over planes zero-padded to its
    32-byte chunks, plus 9 d' minus the rank-1 popcounts, with d' the
    unpadded width (each padded dim would add 9 otherwise)."""
    rng = np.random.RandomState(n + d)
    codes = rng.randint(0, 256, size=(n, d // 4)).astype(np.uint8)
    qcodes = rng.randint(0, 256, size=(b, d // 4)).astype(np.uint8)
    lc, lq = _crumb_levels(codes), _crumb_levels(qcodes)
    assert set(np.unique(lc)) <= {-3, -1, 1, 3}
    want = lq @ lc.T
    port = tref.crumb_affinity_ref(torch.from_numpy(codes), torch.from_numpy(qcodes)).numpy()
    h = d // 8
    ref = np.asarray(rbinary_dot.crumb_affinity_jnp(
        jnp.asarray(codes[:, :h]), jnp.asarray(codes[:, h:]), jnp.asarray(qcodes[:, :h]),
        jnp.asarray(qcodes[:, h:]), dim=d))
    np.testing.assert_array_equal(port, want)
    np.testing.assert_array_equal(ref, want)
    pad = (-h) % 32
    qh, ql, ch, cl = (np.pad(p, ((0, 0), (0, pad))) for p in
                      (qcodes[:, :h], qcodes[:, h:], codes[:, :h], codes[:, h:]))
    pc = lambda p: np.unpackbits(p, axis=-1).sum(axis=-1).astype(np.int64)
    cross = lambda a, c: np.unpackbits(a[:, None, :] & c[None, :, :], axis=-1).sum(axis=-1)
    kernel = (16 * cross(qh, ch) + 8 * cross(qh, cl) + 8 * cross(ql, ch) + 4 * cross(ql, cl)
              - (12 * pc(qh) + 6 * pc(ql))[:, None] - (12 * pc(ch) + 6 * pc(cl))[None, :])
    np.testing.assert_array_equal(kernel + 9 * d, want)
    np.testing.assert_array_equal(kernel + 9 * 8 * (h + pad), want + 9 * 8 * pad)



@pytest.mark.parametrize("b,n,d", [(1, 37, 8), (7, 301, 16), (7, 129, 136), (1, 300, 1024),
                                   (3, 55, 4096)])
def test_sign_and_popc_form_equals_ref_and_reference(b, n, d):
    """The card kernel's arithmetic for the Hamming distance: the sign bytes
    zero-padded to its 32-byte (256-dim) chunks, then pc(q) + pc(c) minus
    twice the sum over chunks of pc(q AND c), equals the port's plain
    version, the reference's sign_hamming_jnp and its interpret-mode
    kernel bit for bit."""
    rng = np.random.RandomState(n + d)
    codes = rng.randint(0, 256, size=(n, d // 8)).astype(np.uint8)
    qcodes = rng.randint(0, 256, size=(b, d // 8)).astype(np.uint8)
    pad = (-(d // 8)) % 32
    qp, cp = (np.pad(p, ((0, 0), (0, pad))) for p in (qcodes, codes))
    pc = lambda p: np.unpackbits(p, axis=-1).sum(axis=-1).astype(np.int64)
    cross = sum(np.unpackbits(qp[:, None, k:k + 32] & cp[None, :, k:k + 32], axis=-1).sum(axis=-1)
                for k in range(0, qp.shape[1], 32))
    kernel = pc(qp)[:, None] + pc(cp)[None, :] - 2 * cross
    port = tref.sign_hamming_ref(torch.from_numpy(codes), torch.from_numpy(qcodes))
    ref = rbinary_dot.sign_hamming_jnp(jnp.asarray(codes), jnp.asarray(qcodes))
    kern = rops.sign_coarse_raw(jnp.asarray(codes), jnp.asarray(qcodes), use_kernel=True,
                                interpret=True)
    assert port.dtype == torch.int32 and port.shape == (b, n)
    np.testing.assert_array_equal(port.numpy(), kernel)
    np.testing.assert_array_equal(np.asarray(ref), kernel)
    np.testing.assert_array_equal(np.asarray(kern), kernel)

# ---------------------------------------------------------------------------
# Gathered rescore: within the port's tolerance of the reference.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,d,b,m", [(300, 128, 3, 40), (129, 16, 5, 7), (500, 256, 16, 80),
                                     (300, 128, 3, 1), (129, 64, 5, 33), (200, 128, 2, 1280)])
def test_gathered_scores_match_reference(n, d, b, m):
    rng = np.random.RandomState(n + m)
    packed = rng.randint(0, 256, size=(n, d // 2)).astype(np.uint8)
    q = rng.randn(b, d).astype(np.float32)
    cand = rng.randint(0, n, size=(b, m)).astype(np.int32)
    cand[0, ::3] = -1
    qnorms = (rng.rand(n) + 0.5).astype(np.float32)
    tol = dot_tolerance(q, packed)                                   # [b, n]
    cand_c = np.maximum(cand, 0)
    # The raw scan also meets rows past the corpus: those and the -1s score 0.
    cand_raw = cand.copy()
    cand_raw[-1, 1::4] = n + np.arange(len(cand_raw[-1, 1::4])) % 3
    valid = (cand_raw >= 0) & (cand_raw < n)
    rows = np.clip(cand_raw, 0, n - 1)
    tol_g = np.take_along_axis(tol, rows, axis=1)
    raw = tops.score_gathered_raw(torch.from_numpy(packed), torch.from_numpy(q),
                                  torch.from_numpy(cand_raw), bits=4).numpy()
    assert raw.shape == (b, m) and (raw[~valid] == 0).all()
    for use_kernel in (False, True):
        want = np.asarray(rops.score_gathered_raw(
            jnp.asarray(packed), jnp.asarray(q), jnp.asarray(rows), bits=4,
            use_kernel=use_kernel, interpret=True))
        assert np.all(np.abs(raw - want)[valid] <= tol_g[valid])
    for metric in ("cosine", "l2"):
        got = tops.score_gathered(torch.from_numpy(packed), torch.from_numpy(q),
                                  torch.from_numpy(cand), bits=4,
                                  qnorms=torch.from_numpy(qnorms), metric=metric).numpy()
        want = np.asarray(rops.score_gathered(
            jnp.asarray(packed), jnp.asarray(q), jnp.asarray(cand), bits=4,
            qnorms=jnp.asarray(qnorms), metric=metric, use_kernel=False))
        dead = cand < 0
        assert (got[dead] == NEG).all() and (want[dead] == NEG).all()
        adj = np.take_along_axis(adjusted_tolerance(tol, qnorms, metric), cand_c, axis=1)
        assert np.all(np.abs(got[~dead] - want[~dead]) <= adj[~dead])


def test_gathered_plain_version_is_the_full_scan_at_the_same_rows():
    rng = np.random.RandomState(9)
    packed = torch.from_numpy(rng.randint(0, 256, size=(200, 64)).astype(np.uint8))
    q = torch.from_numpy(rng.randn(4, 128).astype(np.float32))
    cand = torch.from_numpy(rng.randint(-2, 205, size=(4, 30)).astype(np.int32))
    got = tref.gather_nibble_dot_ref(packed, q, cand)
    full = tref.nibble_dot_ref(packed, q).numpy()
    c = cand.numpy()
    inside = (c >= 0) & (c < 200)
    want = np.where(inside, np.take_along_axis(full, np.clip(c, 0, 199), axis=1), 0.0)
    tol = np.take_along_axis(dot_tolerance(q.numpy(), packed.numpy()), np.clip(c, 0, 199), 1)
    assert np.all(np.abs(got.numpy() - want) <= tol)
    assert (got.numpy()[~inside] == 0).all()


def test_gather_rejects_unsupported_bits():
    with pytest.raises(ValueError, match="unsupported bits=5"):
        tops.score_gathered_raw(torch.zeros(4, 4, dtype=torch.uint8), torch.zeros(1, 16),
                                torch.zeros(1, 2, dtype=torch.int32), bits=5)


# ---------------------------------------------------------------------------
# Survivor top-m: equal to the oracle exactly.
# ---------------------------------------------------------------------------

def _check_survivors(proxy, live, m):
    got = binary.survivor_topk_stage(torch.from_numpy(proxy), torch.from_numpy(live), m=m)
    assert got.dtype == torch.int32 and got.shape == (proxy.shape[0], m)
    np.testing.assert_array_equal(got.numpy(), survivor_oracle(proxy, live, m))


@pytest.mark.parametrize("seed", range(8))
def test_survivors_equal_oracle_on_a_seeded_grid(seed):
    rng = np.random.RandomState(seed)
    n = int(rng.randint(1, 48))
    m = int(rng.randint(1, n + 5))
    proxy = rng.randint(-9 * 64, 9 * 64 + 1, size=(3, n)).astype(np.int32)
    live = rng.rand(n) < rng.rand()
    _check_survivors(proxy, live, m)


@pytest.mark.parametrize("case", ["heavy_ties", "all_dead", "fewer_live_than_m", "m_equals_n"])
def test_survivors_equal_oracle_at_the_edges(case):
    rng = np.random.RandomState(99)
    proxy = rng.randint(-1, 2, size=(4, 300)).astype(np.int32)
    live, m = {"heavy_ties": (rng.rand(300) < 0.8, 37),
               "all_dead": (np.zeros(300, bool), 12),
               "fewer_live_than_m": (rng.rand(300) < 0.03, 40),
               "m_equals_n": (np.ones(300, bool), 300)}[case]
    _check_survivors(proxy, live, m)


def test_survivors_with_no_live_mask_are_all_rows_live():
    rng = np.random.RandomState(4)
    proxy = torch.from_numpy(rng.randint(-3, 4, size=(3, 500)).astype(np.int32))
    want = binary.survivor_topk_stage(proxy, torch.ones(500, dtype=torch.bool), m=60)
    assert torch.equal(binary.survivor_topk_stage(proxy, None, m=60), want)


def test_survivors_equal_the_reference_stage_at_full_proxy_range():
    rng = np.random.RandomState(3)
    d = 1024
    proxy = rng.randint(-9 * d, 9 * d + 1, size=(5, 4096)).astype(np.int32)
    proxy[:, ::7] = 9 * d                                  # ties at the top
    live = rng.rand(4096) < 0.9
    got = binary.survivor_topk_stage(torch.from_numpy(proxy), torch.from_numpy(live), m=320)
    want = rbinary.survivor_topk_stage(jnp.asarray(proxy), jnp.asarray(live), m=320,
                                       vbound=9 * d)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# Whole searches on a shared encoding.
# ---------------------------------------------------------------------------

def _compare(idx: MonaVec, ref: RefMonaVec, queries, k, rm, allow=None):
    got = idx.search(queries, k, rescore_mult=rm, allow=allow)
    ref_allow = None if allow is None else RefAllowlist(mask=allow.mask,
                                                        n_allowed=allow.n_allowed)
    want = ref.search(jnp.asarray(queries), k, rescore_mult=rm, allow=ref_allow)
    full = np.asarray(ref.backend.scores(jnp.asarray(queries)))
    assert_search_matches(got, want, full, idx.ids, _tolerance(idx, queries))
    return got, want


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("rm", [1, 8])
@pytest.mark.parametrize("metric", ["cosine", "l2"])
def test_search_matches_reference(kind, rm, metric):
    x = _corpus(1500, 96)
    ext = (7 + 2 * np.arange(1500)).astype(np.uint64)
    std = RefMonaVec.fit(x) if metric == "l2" else None
    ref = RefMonaVec.build(jnp.asarray(x), metric=metric, std=std, ids=ext, coarse=kind)
    idx = _shared(ref, kind)
    assert idx.resolved_knobs(10, rescore_mult=rm) == ref.resolved_knobs(10, rescore_mult=rm)
    q = _queries(x, 9)
    got, _ = _compare(idx, ref, q, 10, rm)
    assert got[0].shape == (9, 10) and not (got[1] == SENTINEL_ID).any()
    _compare(idx, ref, q, 10, rm, allow=Allowlist.from_ids(ext[::3].tolist(), ext))


@pytest.mark.parametrize("kind", KINDS)
def test_fewer_allowed_rows_than_k_pads_with_sentinels(kind):
    x = _corpus(400, 64)
    ref = RefMonaVec.build(jnp.asarray(x), metric="cosine", coarse=kind)
    idx = _shared(ref, kind)
    q = _queries(x, 4)
    allow = Allowlist.from_ids([5, 77, 301], idx.ids)
    (scores, ids), _ = _compare(idx, ref, q, 10, 8, allow=allow)
    assert (np.sort(ids[:, :3], axis=1) == [5, 77, 301]).all()
    assert (ids[:, 3:] == SENTINEL_ID).all() and (scores[:, 3:] == NEG).all()
    full = idx.search(q, 10, allow=allow)
    np.testing.assert_array_equal(ids, full[1])


def test_allowlist_mask_is_copied_to_a_device_once():
    allow = Allowlist.from_ids([1, 3], np.arange(5, dtype=np.uint64))
    first = allow.mask_on(torch.device("cpu"))
    assert first is allow.mask_on(torch.device("cpu"))
    assert first.dtype == torch.bool and first.tolist() == [False, True, False, True, False]


@pytest.mark.parametrize("kind", KINDS)
def test_cascade_scores_are_the_full_scan_scores_of_their_rows(kind):
    x = _corpus(2000, 64)
    idx = MonaVec.build(x, coarse=kind, device="cpu")
    q = _queries(x, 8)
    scores, ids = idx.search(q, 10, rescore_mult=4)
    full = idx.backend.scores(torch.from_numpy(q)).numpy()
    tol = _tolerance(idx, q)
    rows = ids.astype(np.int64)
    assert np.all(np.abs(scores - np.take_along_axis(full, rows, 1))
                  <= np.take_along_axis(tol, rows, 1))
    again = idx.search(q, 10, rescore_mult=4)
    assert again[0].tobytes() == scores.tobytes() and again[1].tobytes() == ids.tobytes()


# ---------------------------------------------------------------------------
# Knob rules and their messages.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("rm", [0, None, 30, 10_000])
def test_full_rescore_collapses_to_the_full_scan(kind, rm):
    x = _corpus(300, 32)
    idx = MonaVec.build(x, coarse=kind, device="cpu")
    q = _queries(x, 5)
    assert idx.resolved_knobs(10, rescore_mult=rm) == {}
    s0, i0 = idx.search(q, 10)
    s1, i1 = idx.search(q, 10, rescore_mult=rm)
    assert s1.tobytes() == s0.tobytes() and i1.tobytes() == i0.tobytes()


def test_knob_rules_and_messages_match_reference():
    x = _corpus(64, 16)
    q = _queries(x, 2)
    plain = MonaVec.build(x, device="cpu")
    ref_plain = RefMonaVec.build(jnp.asarray(x))
    for index in (plain, ref_plain):
        with pytest.raises(ValueError, match="binarized coarse code"):
            index.search(q, k=5, rescore_mult=2)
    coarse = MonaVec.build(x, coarse="sign", device="cpu")
    ref_coarse = RefMonaVec.build(jnp.asarray(x), coarse="sign")
    for index in (coarse, ref_coarse):
        with pytest.raises(ValueError, match="rescore_mult must be >= 0"):
            index.search(q, k=5, rescore_mult=-1)
        with pytest.raises(TypeError, match="unexpected search kwargs"):
            index.resolved_knobs(5, nprobe=4)
    assert coarse.resolved_knobs(5, rescore_mult=2) == {"rescore_mult": 2}
    assert coarse.resolved_knobs(5) == ref_coarse.resolved_knobs(5) == {}


@pytest.mark.parametrize("index", ["ivf", "hnsw"])
def test_coarse_requires_bruteforce_in_both_packages(index):
    x = _corpus(64, 16)
    with pytest.raises(ValueError, match="requires the bruteforce"):
        MonaVec.build(x, index=index, coarse="sign", device="cpu")
    with pytest.raises(ValueError, match="requires the bruteforce"):
        RefMonaVec.build(jnp.asarray(x), index=index, coarse="sign")


def test_unknown_coarse_kind_raises_in_both_packages():
    x = _corpus(32, 16)
    with pytest.raises(ValueError, match="unknown coarse kind"):
        MonaVec.build(x, coarse="trit", device="cpu")
    with pytest.raises(ValueError, match="unknown coarse kind"):
        RefMonaVec.build(jnp.asarray(x), coarse="trit")
    with pytest.raises(ValueError, match="unknown coarse kind"):
        MonaVec.build(x, device="cpu").enable_coarse("trit")


def test_enable_coarse_after_load_equals_a_coarse_build(tmp_path):
    x = _corpus(200, 48)
    path = str(tmp_path / "v6.mvec")
    MonaVec.build(x, device="cpu").save(path)
    loaded = MonaVec.load(path, device="cpu").enable_coarse("crumb")
    built = MonaVec.build(x, coarse="crumb", device="cpu")
    assert torch.equal(loaded.backend.enc.ccodes, built.backend.enc.ccodes)


# ---------------------------------------------------------------------------
# Static v10 files.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
def test_v10_round_trips(kind, tmp_path):
    x = _corpus(700, 40)
    idx = MonaVec.build(x, metric="l2", std=MonaVec.fit(x), coarse=kind, device="cpu")
    path = str(tmp_path / "c.mvec")
    idx.save(path)
    with open(path, "rb") as fh:
        head = fh.read(56)
    assert head[4] == 10 and head[46] == {"sign": 1, "crumb": 2}[kind] and head[47] == 0
    back = MonaVec.load(path, device="cpu")
    assert back.backend.enc.coarse == kind
    assert torch.equal(back.backend.enc.ccodes, idx.backend.enc.ccodes)
    q = _queries(x, 5)
    for rm in (None, 4):
        a, b = idx.search(q, 10, rescore_mult=rm), back.search(q, 10, rescore_mult=rm)
        assert a[0].tobytes() == b[0].tobytes() and a[1].tobytes() == b[1].tobytes()
    again = str(tmp_path / "again.mvec")
    back.save(again)
    assert _sha(again) == _sha(path)


@pytest.mark.parametrize("kind", KINDS)
def test_port_v10_loads_in_reference(kind, tmp_path):
    x = _corpus(500, 64)
    idx = MonaVec.build(x, coarse=kind, seed=17, device="cpu")
    path = str(tmp_path / "port.mvec")
    idx.save(path)
    ref = RefMonaVec.load(path)
    assert ref.backend.enc.coarse == kind
    np.testing.assert_array_equal(np.asarray(ref.backend.enc.ccodes),
                                  idx.backend.enc.ccodes.numpy())
    _compare(idx, ref, _queries(x, 6), 10, 8)


@pytest.mark.parametrize("kind", KINDS)
def test_reference_v10_loads_in_port_and_saves_its_bytes(kind, tmp_path):
    x = _corpus(600, 24)
    ref = RefMonaVec.build(jnp.asarray(x), metric="l2", std=RefMonaVec.fit(x),
                           ids=np.arange(600, dtype=np.uint64) * 5, coarse=kind)
    path = str(tmp_path / "ref.mvec")
    ref.save(path)
    idx = MonaVec.load(path, device="cpu")
    assert idx.backend.enc.coarse == kind
    again = str(tmp_path / "again.mvec")
    idx.save(again)
    assert _sha(again) == _sha(path)
    _compare(idx, RefMonaVec.load(path), _queries(x, 4), 10, 8)


def test_golden_v10_with_segments_and_metadata_raises():
    """Its segments load now; its metadata columns are ROADMAP A6."""
    with pytest.raises(NotImplementedError, match="ROADMAP A6"):
        MonaVec.load(os.path.join(GOLDEN, "v10_coarse_bruteforce.mvec"), device="cpu")


@pytest.mark.parametrize("what", ["tombstone", "metadata", "coarse_kind", "perm"])
def test_v10_the_port_cannot_represent_raises(what, tmp_path):
    x = _corpus(64, 16)
    path = str(tmp_path / "c.mvec")
    MonaVec.build(x, coarse="sign", device="cpu").save(path)
    data = bytearray(open(path, "rb").read())
    codes = 64 * 2
    if what == "tombstone":
        # The port now holds it: a file whose row 56 is tombstoned (its bit
        # is the top bit of the bitmap's last byte) loads, and never
        # returns that row.
        data[-(8 + codes) - 1] = 0x80
        path2 = tmp_path / "tomb.mvec"
        path2.write_bytes(bytes(data))
        idx = MonaVec.load(str(path2), device="cpu")
        assert idx.n_live == 63 and idx.mut.base_tombs[56] and idx.mut.base_tombs.sum() == 1
        ids = idx.search(x[50:60], 64)[1]
        assert 56 not in ids.tolist() and (ids[:, -1] == SENTINEL_ID).all()
        ids = idx.search(x[50:60], 10, rescore_mult=2)[1]       # the cascade
        assert 56 not in ids.tolist() and ids[6, 0] != SENTINEL_ID
        return
    elif what == "metadata":
        data[47] = 1
        err, match = NotImplementedError, "ROADMAP A6"
    elif what == "coarse_kind":
        data[46] = 3
        err, match = ValueError, "COARSE_KIND"
    else:
        data[45] = 1              # HAS_PERM with no PERM block: a corrupt file
        err, match = ValueError, "'perm'"
    path2 = tmp_path / "bad.mvec"
    path2.write_bytes(bytes(data))
    with pytest.raises(err, match=match):
        MonaVec.load(str(path2), device="cpu")


@pytest.mark.parametrize("cut", [1, 64, 100])
def test_v10_truncated_code_block_raises(cut, tmp_path):
    x = _corpus(64, 16)
    path = str(tmp_path / "c.mvec")
    MonaVec.build(x, coarse="crumb", device="cpu").save(path)
    data = open(path, "rb").read()
    bad = tmp_path / "cut.mvec"
    bad.write_bytes(data[:-cut])
    with pytest.raises(ValueError, match="truncated in block 'coarse codes"):
        MonaVec.load(str(bad), device="cpu")


# ---------------------------------------------------------------------------
# Wrappers on the CPU: plain version, no launch counted; refusals before a build.
# ---------------------------------------------------------------------------

def test_cpu_dispatch_takes_the_plain_versions_uncounted():
    rng = np.random.RandomState(11)
    codes = torch.from_numpy(rng.randint(0, 256, size=(50, 32)).astype(np.uint8))
    qcodes = torch.from_numpy(rng.randint(0, 256, size=(3, 32)).astype(np.uint8))
    packed = torch.from_numpy(rng.randint(0, 256, size=(50, 64)).astype(np.uint8))
    q = torch.from_numpy(rng.randn(3, 128).astype(np.float32))
    cand = torch.from_numpy(rng.randint(0, 50, size=(3, 9)).astype(np.int32))
    counters = (tbinary_dot.sign_hamming_cuda, tbinary_dot.crumb_affinity_cuda,
                tgather_dot.gather_nibble_dot_cuda)
    before = [f.launches for f in counters]
    assert torch.equal(tops.sign_coarse_raw(codes, qcodes), tref.sign_hamming_ref(codes, qcodes))
    assert torch.equal(tops.crumb_coarse_raw(codes, qcodes),
                       tref.crumb_affinity_ref(codes, qcodes))
    assert torch.equal(tops.score_gathered_raw(packed, q, cand, bits=4),
                       tref.gather_nibble_dot_ref(packed, q, cand))
    assert [f.launches for f in counters] == before


@pytest.mark.parametrize("bad", ["cpu", "dtype", "shape"])
@pytest.mark.parametrize("fn", ["sign", "crumb"])
def test_proxy_wrappers_refuse_before_building(bad, fn):
    codes, qcodes = torch.zeros(10, 32, dtype=torch.uint8), torch.zeros(3, 32, dtype=torch.uint8)
    if bad == "dtype":
        codes = codes.to(torch.int8)
    elif bad == "shape":
        qcodes = torch.zeros(3, 16, dtype=torch.uint8)
    wrapper = {"sign": tbinary_dot.sign_hamming_cuda,
               "crumb": tbinary_dot.crumb_affinity_cuda}[fn]
    with pytest.raises(ValueError):
        wrapper(codes, qcodes)


@pytest.mark.parametrize("bad", ["cpu", "dtype", "cand_dtype", "shape"])
def test_gather_wrapper_refuses_before_building(bad):
    packed, q = torch.zeros(10, 64, dtype=torch.uint8), torch.zeros(3, 128)
    cand = torch.zeros(3, 5, dtype=torch.int32)
    if bad == "dtype":
        q = q.double()
    elif bad == "cand_dtype":
        cand = cand.long()
    elif bad == "shape":
        cand = torch.zeros(2, 5, dtype=torch.int32)
    with pytest.raises(ValueError):
        tgather_dot.gather_nibble_dot_cuda(packed, q, cand)
