"""The port's 4-bit KV cache (``repro_torch.models.kvcache``) against the
reference's ``repro.models.kvcache`` on the CPU, at head_dim 16, 64, 128 and
80 (padded to d' = 128).

Tolerances: rotations, unrotations and scales within rtol 1e-5 / atol 1e-5
(both packages take the Kronecker product on the CPU, through XLA's and
PyTorch's own reductions); attention outputs over the same cache within
1e-5.  Codes equal the reference's, except one-level flips of values that
lie on a Lloyd-Max boundary to within the rotation's rounding: counted, and
each one checked to be such a value.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lloydmax as rlm
from repro.core import rhdh as rrhdh
from repro.models import kvcache as rkv
from repro_torch.core import rhdh as trhdh
from repro_torch.kernels import hadamard
from repro_torch.models import kvcache as tkv

HEAD_DIMS = [16, 64, 128, 80]
B, S, KV, G = 2, 12, 2, 3


def _specs(dh: int, quantized: bool = True):
    r = rkv.KVSpec(batch=B, max_len=S, n_kv_heads=KV, head_dim=dh, quantized=quantized)
    t = tkv.KVSpec(batch=B, max_len=S, n_kv_heads=KV, head_dim=dh, quantized=quantized)
    return r, t


def _x(dh: int, *lead, seed: int = 0) -> np.ndarray:
    return np.random.RandomState(seed + dh).standard_normal(lead + (dh,)).astype(np.float32)


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dh", HEAD_DIMS)
def test_signs_are_the_references(dh):
    dp = trhdh.next_pow2(dh)
    assert dp == rrhdh.next_pow2(dh)
    np.testing.assert_array_equal(trhdh.rademacher_signs(0x6B76, dp).numpy(),
                                  np.asarray(rrhdh.rademacher_signs(0x6B76, dp)))


@pytest.mark.parametrize("dh", HEAD_DIMS)
def test_rotate_and_unrotate(dh):
    rs, ts = _specs(dh)
    x = _x(dh, B, 1, KV * G)
    z_r = np.asarray(rkv._rotate(jnp.asarray(x), rs))
    z_t = tkv._rotate(torch.tensor(x), ts)
    assert z_t.shape == z_r.shape and z_t.dtype == torch.float32
    _close(z_t, z_r, 1e-5 * max(1.0, np.abs(x).sum(-1).max()))
    # The rotation is the Hadamard wrapper's: on the CPU, its Kronecker form.
    dp = trhdh.next_pow2(dh)
    np.testing.assert_array_equal(
        z_t.numpy(), hadamard.signed_fwht_plain(torch.tensor(x), trhdh.rademacher_signs(
            0x6B76, dp), dp).numpy())
    back_r = np.asarray(rkv._unrotate(jnp.asarray(z_r), rs))
    back_t = tkv._unrotate(torch.tensor(z_r), ts)
    assert back_t.shape == (B, 1, KV * G, dh)
    _close(back_t, back_r)
    _close(back_t, x, 1e-5 * dp)          # an exact inverse up to rounding


def _flips_on_boundaries(got_packed, want_packed, z_ref, scale_ref) -> int:
    got = tkv.unpack_4bit(torch.tensor(got_packed)).numpy().astype(np.int64)
    want = tkv.unpack_4bit(torch.tensor(np.asarray(want_packed))).numpy().astype(np.int64)
    diff = got != want
    if diff.any():
        assert np.abs(got - want)[diff].max() == 1
        zn = np.asarray(z_ref) / np.maximum(np.asarray(scale_ref)[..., None], 1e-12)
        edge = np.asarray(rlm.boundaries(4))[np.minimum(got, want)[diff]]
        assert np.all(np.abs(zn[diff] - edge) <= 1e-4), (zn[diff], edge)
    return int(diff.sum())


@pytest.mark.parametrize("dh", HEAD_DIMS)
def test_quantize_kv(dh):
    rs, ts = _specs(dh)
    x = _x(dh, B, 64, KV, seed=1)
    c_r, s_r = rkv.quantize_kv(jnp.asarray(x), rs)
    c_t, s_t = tkv.quantize_kv(torch.tensor(x), ts)
    assert c_t.dtype == torch.uint8 and tuple(c_t.shape) == c_r.shape
    assert s_t.dtype == torch.float32 and tuple(s_t.shape) == s_r.shape
    _close(s_t, s_r)
    z_r = rkv._rotate(jnp.asarray(x), rs)
    flips = _flips_on_boundaries(c_t.numpy(), c_r, z_r, s_r)
    # ~2 * 64 * 2 * 128 codes: a boundary hit within 1e-4 is rare.
    assert flips <= 4, flips
    # Dequantized rows match through either side's codes.
    _close(tkv.dequantize_k_rotated(c_t, s_t),
           np.asarray(rkv.dequantize_k_rotated(jnp.asarray(c_t.numpy()), s_r)))


@pytest.mark.parametrize("mask_form", ["1S", "B1S"])
@pytest.mark.parametrize("dh", HEAD_DIMS)
def test_quant_attention_decode(dh, mask_form):
    rs, ts = _specs(dh)
    kx, vx = _x(dh, B, S, KV, seed=2), _x(dh, B, S, KV, seed=3)
    kc, ks = rkv.quantize_kv(jnp.asarray(kx), rs)
    vc, vs = rkv.quantize_kv(jnp.asarray(vx), rs)
    q = _x(dh, B, 1, KV * G, seed=4)
    valid = np.arange(S) <= 7
    if mask_form == "1S":
        mask = valid[None, :]
    else:
        mask = np.stack([valid, np.arange(S) <= 3])[:, None, :]
    for softcap in (0.0, 50.0):
        out_r = rkv.quant_attention_decode(jnp.asarray(q), kc, vc, ks, vs, jnp.asarray(mask),
                                           rs, scale=dh ** -0.5, attn_softcap=softcap)
        out_t = tkv.quant_attention_decode(
            torch.tensor(q), *(torch.tensor(np.asarray(a)) for a in (kc, vc, ks, vs)),
            torch.tensor(mask), ts, scale=dh ** -0.5, attn_softcap=softcap)
        assert tuple(out_t.shape) == out_r.shape == (B, 1, KV * G, dh)
        _close(out_t, out_r)


@pytest.mark.parametrize("quantized", [False, True])
def test_init_cache(quantized):
    rs, ts = _specs(80, quantized)
    rc, tc = rkv.init_cache(3, rs), tkv.init_cache(3, ts)
    assert sorted(rc) == sorted(tc)
    for name in rc:
        assert tuple(tc[name].shape) == rc[name].shape
        assert str(tc[name].dtype).replace("torch.", "") == str(rc[name].dtype)
        assert not tc[name].any()
