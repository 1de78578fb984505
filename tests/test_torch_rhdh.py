"""Parity of the port's RHDH rotation (repro_torch.core.rhdh) with repro.core.rhdh.

The sign vector must be bit-equal to JAX's threefry draw on the stream JAX is
using; the transform itself agrees to f32 rounding (other summation order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import rhdh
from repro.kernels import hadamard as jhadamard
from repro.kernels import ref as jref
from repro_torch.core import rhdh as trhdh
from repro_torch.kernels import hadamard as thadamard
from repro_torch.kernels import ref as tref
from tests.torch_harness import jax_stream, port_stream, reference_stream

SEEDS = [0, 7, 0x6D6F6E61, 2**32, 12345678901234, 2**63 + 5, 0xDEADBEEFCAFEBABE]
D_PADS = [8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096]


def _l1_tol(x: np.ndarray) -> np.ndarray:
    """Per-row bound on a reordered signed sum of the row's entries."""
    return 1e-5 * np.abs(x).sum(axis=-1, keepdims=True) + 1e-6


def test_shape_helpers_match_reference():
    for d in range(1, 3000, 37):
        assert trhdh.next_pow2(d) == rhdh.next_pow2(d)
    for lg in range(0, 16):
        assert trhdh._split_pow2(1 << lg) == rhdh._split_pow2(1 << lg)


@pytest.mark.parametrize("n", [1, 2, 8, 64, 256])
def test_hadamard_matrix_matches_reference(n):
    np.testing.assert_array_equal(trhdh.hadamard_matrix(n), rhdh.hadamard_matrix(n))


@pytest.mark.parametrize("seed", SEEDS)
def test_signs_bit_equal_on_reference_stream(seed):
    stream = reference_stream()
    with port_stream(stream):
        for d_pad in D_PADS:
            want = np.asarray(rhdh.rademacher_signs(seed, d_pad))
            got = trhdh.rademacher_signs(seed, d_pad).numpy()
            np.testing.assert_array_equal(got, want, err_msg=f"seed={seed} d'={d_pad}")


@pytest.mark.parametrize("seed", SEEDS)
def test_signs_bit_equal_on_other_stream(seed):
    other = not reference_stream()
    with jax_stream(other), port_stream(other):
        for d_pad in D_PADS:
            want = np.asarray(rhdh.rademacher_signs(seed, d_pad))
            got = trhdh.rademacher_signs(seed, d_pad).numpy()
            np.testing.assert_array_equal(got, want, err_msg=f"seed={seed} d'={d_pad}")


def test_streams_differ_and_cache_keys_on_stream():
    with port_stream(True):
        a = trhdh.rademacher_signs(7, 64).clone()
    with port_stream(False):
        b = trhdh.rademacher_signs(7, 64).clone()
    assert not torch.equal(a, b)
    assert set(a.unique().tolist()) == {-1.0, 1.0}


@pytest.mark.parametrize("d", [8, 16, 64, 128, 256])
def test_plain_fwht_matches_reference(d):
    rng = np.random.RandomState(1)
    x = rng.randn(17, d).astype(np.float32)
    got = trhdh.fwht(torch.from_numpy(x)).numpy()
    want = np.asarray(rhdh.fwht(jnp.asarray(x)))
    assert np.all(np.abs(got - want) <= _l1_tol(x))
    direct = tref.hadamard_ref(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(direct, np.asarray(jref.hadamard_ref(jnp.asarray(x))),
                               rtol=0, atol=float(_l1_tol(x).max()))


@pytest.mark.parametrize("n,d", [(33, 128), (64, 256)])
def test_signed_fwht_matches_pallas_interpret(n, d):
    """The CPU dispatch of the kernel's function against the reference's
    Pallas Hadamard kernel run in interpret mode."""
    rng = np.random.RandomState(2)
    x = rng.randn(n, d - 5).astype(np.float32)
    signs = trhdh.rademacher_signs(11, d)
    got = thadamard.signed_fwht(torch.from_numpy(x), signs, d).numpy()
    xs = np.pad(x, ((0, 0), (0, 5))) * signs.numpy()
    want = np.asarray(jhadamard.fwht_pallas(jnp.asarray(xs), interpret=True))
    assert np.all(np.abs(got - want) <= _l1_tol(xs))


@pytest.mark.parametrize("d", [5, 100, 256])
@pytest.mark.parametrize("normalized", [False, True])
def test_rhdh_apply_matches_reference(d, normalized):
    rng = np.random.RandomState(3)
    x = rng.randn(9, d).astype(np.float32)
    with port_stream(reference_stream()):
        got = trhdh.rhdh_apply(torch.from_numpy(x), 99, normalized=normalized).numpy()
    want = np.asarray(rhdh.rhdh_apply(jnp.asarray(x), 99, normalized=normalized))
    assert got.shape == want.shape == (9, rhdh.next_pow2(d))
    assert np.all(np.abs(got - want) <= _l1_tol(x))


def test_rhdh_inverse_round_trip_and_reference():
    rng = np.random.RandomState(4)
    x = rng.randn(6, 100).astype(np.float32)
    with port_stream(reference_stream()):
        y = trhdh.rhdh_apply(torch.from_numpy(x), 5, normalized=True)
        back = trhdh.rhdh_inverse(y, 5, 100).numpy()
    np.testing.assert_allclose(back, x, atol=1e-5)
    want = np.asarray(rhdh.rhdh_inverse(jnp.asarray(y.numpy()), 5, 100))
    np.testing.assert_allclose(back, want, atol=1e-5)


def test_rotation_preserves_norm_when_normalized():
    rng = np.random.RandomState(5)
    x = rng.randn(4, 300).astype(np.float32)
    y = trhdh.rhdh_apply(torch.from_numpy(x), 3, normalized=True).numpy()
    np.testing.assert_allclose(np.linalg.norm(y, axis=1), np.linalg.norm(x, axis=1),
                               rtol=1e-5)


def _stage_loop_f32(xs: np.ndarray) -> np.ndarray:
    """The butterfly in numpy float32, stage s pairing (i, i + 2^s) -> (a + b, a - b)."""
    y = xs.astype(np.float32).copy()
    n, d_pad = y.shape
    h = 1
    while h < d_pad:
        pairs = y.reshape(n, d_pad // (2 * h), 2, h)
        a, b = pairs[:, :, 0].copy(), pairs[:, :, 1].copy()
        pairs[:, :, 0], pairs[:, :, 1] = a + b, a - b
        h *= 2
    return y


@pytest.mark.parametrize("n,d", [(9, 5), (9, 16), (5, 1000), (3, 4096), (2, 40000)])
def test_butterfly_matches_plain_and_reference(n, d):
    """The kernel's stage-order oracle against the Kronecker plain version,
    the reference's jnp FWHT and its Pallas kernel in interpret mode, within
    1e-5 |x|_1 + 1e-6 a row (another summation order), and bit for bit
    against the same stage loop in numpy."""
    rng = np.random.RandomState(d)
    x = rng.randn(n, d).astype(np.float32)
    d_pad = trhdh.next_pow2(d)
    signs = trhdh.rademacher_signs(17, d_pad)
    got = thadamard.signed_fwht_butterfly(torch.from_numpy(x), signs, d_pad).numpy()
    xs = np.pad(x * signs.numpy()[:d], ((0, 0), (0, d_pad - d)))
    tol = _l1_tol(xs)
    plain = thadamard.signed_fwht_plain(torch.from_numpy(x), signs, d_pad).numpy()
    want = np.asarray(rhdh.fwht(jnp.asarray(xs)))
    kernel = np.asarray(jhadamard.fwht_pallas(jnp.asarray(xs), block_rows=8, interpret=True))
    assert got.shape == (n, d_pad)
    for other in (plain, want, kernel):
        assert np.all(np.abs(got - other) <= tol)
    np.testing.assert_array_equal(got.view(np.uint32), _stage_loop_f32(xs).view(np.uint32))


def test_butterfly_pads_with_positive_zero():
    """The pad is +0.0, as the kernel loads it, not 0 * sign (-0.0 under a
    negative sign): on a zero row the two give other signed zeros."""
    x, signs = torch.zeros(1, 3), -torch.ones(8)
    got = thadamard.signed_fwht_butterfly(x, signs, 8).numpy().view(np.uint32)
    plus_pad = _stage_loop_f32(np.pad((x * signs[:3]).numpy(), ((0, 0), (0, 5))))
    signed_pad = _stage_loop_f32((torch.nn.functional.pad(x, (0, 5)) * signs).numpy())
    np.testing.assert_array_equal(got, plus_pad.view(np.uint32))
    assert not np.array_equal(got, signed_pad.view(np.uint32))


@pytest.mark.parametrize("normalized", [False, True])
def test_rhdh_apply_matches_reference_at_large_d_pad(normalized):
    """d' = 65536, past the single-block limit of the card's kernel: the
    port's CPU path still takes it, as the reference does."""
    rng = np.random.RandomState(7)
    x = rng.randn(3, 40000).astype(np.float32)
    with port_stream(reference_stream()):
        got = trhdh.rhdh_apply(torch.from_numpy(x), 99, normalized=normalized).numpy()
    want = np.asarray(rhdh.rhdh_apply(jnp.asarray(x), 99, normalized=normalized))
    assert got.shape == want.shape == (3, 65536)
    assert np.all(np.abs(got - want) <= _l1_tol(x))
