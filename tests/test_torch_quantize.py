"""Parity of the port's encode pipeline (repro_torch.core.{lloydmax, standardize,
quantize}) with the reference's.

Codes are integers and must be equal, except that a rotated value lying on a
Lloyd-Max boundary may round to the neighbouring level under another
summation order; norms of the dequantized vectors agree to rtol 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lloydmax, quantize as qz, rhdh, standardize
from repro_torch.core import lloydmax as tlm
from repro_torch.core import quantize as tqz
from repro_torch.core import standardize as tstd
from tests.golden import make_fixtures as gold
from tests.torch_harness import code_flip_rows, port_stream, reference_stream


@pytest.mark.parametrize("table", ["CENTROIDS_4BIT", "BOUNDARIES_4BIT", "CENTROIDS_2BIT",
                                   "BOUNDARIES_2BIT"])
def test_frozen_tables_equal(table):
    np.testing.assert_array_equal(getattr(tlm, table), getattr(lloydmax, table))


@pytest.mark.parametrize("bits", [4, 2])
def test_quantize_dequantize_exact(bits):
    rng = np.random.RandomState(1)
    edges = lloydmax.boundaries(bits)
    tiny = np.finfo(np.float32).tiny
    x = np.concatenate([rng.randn(4000).astype(np.float32) * 1.5, edges,
                        np.nextafter(edges, np.float32(-np.inf)),
                        np.nextafter(edges, np.float32(np.inf)),
                        np.array([0.0, -0.0, tiny, -tiny, 40.0, -40.0], np.float32)])
    # XLA's CPU backend flushes subnormals to zero and torch does not; the
    # rotation never yields one, so the comparison leaves them out.
    x = x[(x == 0) | (np.abs(x) >= tiny)].astype(np.float32)
    got = tlm.quantize(torch.from_numpy(x), bits).numpy()
    want = np.asarray(lloydmax.quantize(jnp.asarray(x), bits))
    np.testing.assert_array_equal(got, want)
    codes = np.arange(1 << bits, dtype=np.uint8)
    np.testing.assert_array_equal(tlm.dequantize(torch.from_numpy(codes), bits).numpy(),
                                  np.asarray(lloydmax.dequantize(jnp.asarray(codes), bits)))


def test_pack_unpack_exact():
    rng = np.random.RandomState(2)
    codes = rng.randint(0, 16, size=(37, 64)).astype(np.uint8)
    packed = tqz.pack_4bit(torch.from_numpy(codes)).numpy()
    np.testing.assert_array_equal(packed, np.asarray(qz.pack_4bit(jnp.asarray(codes))))
    np.testing.assert_array_equal(tqz.unpack_4bit(torch.from_numpy(packed)).numpy(), codes)
    with pytest.raises(ValueError):
        tqz.pack_4bit(torch.zeros(3, 5, dtype=torch.uint8))


@pytest.mark.parametrize("metric", ["cosine", "dot", "l2"])
def test_prepare_matches_reference(metric):
    rng = np.random.RandomState(3)
    x = (rng.randn(50, 33) * 3 + 1).astype(np.float32)
    std = standardize.GlobalStd.fit(x) if metric == "l2" else None
    tstd_ = tstd.GlobalStd(std.mean, std.inv_std) if std is not None else None
    got = tstd.prepare(torch.from_numpy(x), metric, tstd_).numpy()
    want = np.asarray(standardize.prepare(jnp.asarray(x), metric, std))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_global_std_fit_matches_reference():
    rng = np.random.RandomState(4)
    x = (rng.randn(200, 16) * 7 - 2).astype(np.float32)
    ref = standardize.GlobalStd.fit(x)
    got = tstd.GlobalStd.fit(torch.from_numpy(x))
    assert (got.mean, got.inv_std) == (ref.mean, ref.inv_std)
    np.testing.assert_array_equal(got.transform(torch.from_numpy(x)).numpy(),
                                  np.asarray(ref.transform(jnp.asarray(x))))


@pytest.mark.parametrize("n,d,data_seed", [(32, 16, 100), (200, 100, 1), (500, 256, 2)])
@pytest.mark.parametrize("metric", ["cosine", "dot", "l2"])
def test_encode_codes_match_reference(n, d, data_seed, metric):
    """Codes equal, except a one-level flip of a value on a Lloyd-Max boundary."""
    x = gold._data(n, d, data_seed)
    std = standardize.GlobalStd.fit(x) if metric == "l2" else None
    ref = qz.encode(jnp.asarray(x), metric=metric, seed=7, std=std)
    prepared = standardize.prepare(jnp.asarray(x), metric, std)
    ref_rot = np.asarray(rhdh.rhdh_apply(prepared, 7, normalized=False))
    with port_stream(reference_stream()):
        got = tqz.encode(torch.from_numpy(x), metric=metric, seed=7,
                         std=None if std is None else tstd.GlobalStd(std.mean, std.inv_std))
    flipped = code_flip_rows(got.packed.numpy(), np.asarray(ref.packed), ref_rot,
                             np.asarray(prepared))
    same = np.setdiff1d(np.arange(n), flipped)
    np.testing.assert_allclose(got.qnorms.numpy()[same], np.asarray(ref.qnorms)[same],
                               rtol=1e-6)
    assert (got.dim, got.dim_pad, got.bits, got.seed) == (ref.dim, ref.dim_pad, 4, 7)
    np.testing.assert_array_equal(tqz.decode(got).numpy()[same],
                                  np.asarray(qz.decode(ref))[same])


@pytest.mark.parametrize("metric", ["cosine", "dot"])
def test_encode_query_matches_reference(metric):
    rng = np.random.RandomState(5)
    x = rng.randn(64, 48).astype(np.float32)
    q = rng.randn(5, 48).astype(np.float32)
    ref = qz.encode(jnp.asarray(x), metric=metric, seed=3)
    with port_stream(reference_stream()):
        enc = tqz.encode(torch.from_numpy(x), metric=metric, seed=3)
        got = tqz.encode_query(torch.from_numpy(q), enc).numpy()
    want = np.asarray(qz.encode_query(jnp.asarray(q), ref))
    assert got.shape == want.shape == (5, 64)
    scale = np.abs(q).sum(axis=1, keepdims=True) / (
        1.0 if metric == "dot" else np.linalg.norm(q, axis=1, keepdims=True))
    assert np.all(np.abs(got - want) <= 1e-5 * scale + 1e-6)


@pytest.mark.parametrize("bits", [3, 5])
def test_other_bit_widths_raise(bits):
    """encode takes 2 or 4 bits, as the reference's does (3 is encode_mixed)."""
    with pytest.raises(ValueError, match="use encode_mixed"):
        tqz.encode(torch.zeros(4, 8), bits=bits)
