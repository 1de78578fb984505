"""The port's Lloyd-Max helpers and the file-version list against the
reference's (``repro.core.lloydmax``, ``repro.core.mvec_format``), on the
CPU: the offline generator and the closed-form distortion give the
reference's numbers, the frozen tables are the generator's fixed point
within ``tests/test_quantize.py``'s tolerance (1e-7), and the uniform
quantizer of Table 7's ablation gives the reference's tables, codes and
encodings (``quantize`` / ``dequantize`` / ``encode(..., table="uniform")``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lloydmax as rlm
from repro.core import mvec_format as rfmt
from repro.core import quantize as rqz
from repro_torch.core import lloydmax as tlm
from repro_torch.core import mvec_format as tfmt
from repro_torch.core import quantize as tqz


@pytest.mark.parametrize("bits", [2, 4])
def test_generate_tables_equal_reference(bits):
    c, b = tlm.generate_tables(bits)
    rc, rb = rlm.generate_tables(bits)
    assert c.dtype == b.dtype == np.float64
    np.testing.assert_array_equal(c, rc)
    np.testing.assert_array_equal(b, rb)
    np.testing.assert_allclose(tlm.centroids(bits), c, atol=1e-7)
    np.testing.assert_allclose(tlm.boundaries(bits), b, atol=1e-7)


@pytest.mark.parametrize("bits", [2, 4])
def test_expected_distortion_equals_reference(bits):
    mse = tlm.expected_distortion(bits)
    assert mse == rlm.expected_distortion(bits)
    g = np.random.RandomState(bits).standard_normal(200_000).astype(np.float32)
    deq = tlm.dequantize(tlm.quantize(torch.from_numpy(g), bits), bits).numpy()
    assert abs(float(np.mean((deq - g) ** 2)) - mse) < 5e-3


@pytest.mark.parametrize("bits", [2, 4])
def test_uniform_tables_equal_reference(bits):
    """The uniform tables are the reference's, and on N(0,1) the Lloyd-Max
    tables quantize with less error (the reason for Table 7's +3.6%)."""
    np.testing.assert_array_equal(tlm.uniform_centroids(bits), rlm.uniform_centroids(bits))
    np.testing.assert_array_equal(tlm.uniform_boundaries(bits), rlm.uniform_boundaries(bits))
    np.testing.assert_array_equal(tlm.uniform_centroids(bits, -1.0, 3.0),
                                  rlm.uniform_centroids(bits, -1.0, 3.0))
    g = np.random.RandomState(1).standard_normal(200_000).astype(np.float32)
    codes = tlm.quantize(torch.from_numpy(g), bits, table="uniform")
    want = rlm.quantize(jnp.asarray(g), bits, table="uniform")
    np.testing.assert_array_equal(codes.numpy(), np.asarray(want))
    uniform = tlm.dequantize(codes, bits, table="uniform").numpy()
    np.testing.assert_array_equal(uniform, np.asarray(rlm.dequantize(want, bits,
                                                                     table="uniform")))
    lloydmax = tlm.dequantize(tlm.quantize(torch.from_numpy(g), bits), bits).numpy()
    assert np.mean((lloydmax - g) ** 2) < np.mean((uniform - g) ** 2)
    with pytest.raises(ValueError, match="unknown table"):
        tlm.quantize(torch.from_numpy(g), bits, table="nf4")


@pytest.mark.parametrize("bits", [2, 4])
def test_encode_uniform_table_equals_reference(bits):
    """``encode(..., table="uniform")``'s quantize, norms and pack, on rows
    both packages were given already rotated: the reference's bytes and
    norms."""
    rot = (np.random.RandomState(bits).standard_normal((64, 128)) * 1.3).astype(np.float32)
    codes, deq = rqz._quantize_rotated(jnp.asarray(rot), bits, "uniform")
    pack = rqz.pack_4bit if bits == 4 else rqz.pack_2bit
    got = tqz.encode_rotated(torch.from_numpy(rot), dim=128, metric="dot", seed=7, bits=bits,
                             std=None, table="uniform")
    np.testing.assert_array_equal(got.packed.numpy(), np.asarray(pack(codes)))
    np.testing.assert_allclose(got.qnorms.numpy(), np.asarray(jnp.linalg.norm(deq, axis=-1)),
                               rtol=1e-6)
    lloydmax = tqz.encode_rotated(torch.from_numpy(rot), dim=128, metric="dot", seed=7,
                                  bits=bits, std=None)
    assert not np.array_equal(lloydmax.packed.numpy(), got.packed.numpy())


def test_supported_versions_equal_reference():
    assert tfmt.SUPPORTED_VERSIONS == rfmt.SUPPORTED_VERSIONS == (6, 7, 8, 9, 10, 11)
