"""The port's AdamW (``repro_torch.train.optimizer``) against the
reference's ``repro.train.optimizer`` on the CPU, over seeded random trees,
and the reference's own optimizer checks repeated on the port.

Trees hold f32 or bf16 parameters of several shapes (a 0-d leaf among
them); the moments are f32 or bf16; the gradients are scaled so the global
clip is active or not; compression (int8 + error feedback) is on or off;
1 and 5 steps are taken.  Tolerances: the int8 codes equal the reference's
exactly (their dequantized values too, and the error buffers within 1 f32
ulp of the gradient's scale); the global norm within rtol 1e-6; f32
parameters and moments within rtol 1e-6 plus 1e-6 of the leaf's largest
magnitude after 5 steps (both update elementwise in f32 in the reference's
order; the norm's summation order differs, so an active clip scales every
gradient by a factor a few ulp apart, which a moment near zero shows as a
larger relative difference); bf16 leaves within one bf16 ulp (rtol 2^-7) where
a rounding boundary falls between the two f32 results, and equal in at
least 99% of elements.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import optimizer as ropt
from repro_torch.train import optimizer as topt

SHAPES = {"a": (7, 5), "b": (33,), "c": (), "d": (3, 4, 6)}


def _tree(seed: int, dtype: str, scale: float = 1.0):
    rng = np.random.RandomState(seed)
    return {k: (rng.standard_normal(s) * scale).astype(np.float32) for k, s in SHAPES.items()}


def _to_jnp(tree, dtype):
    return {k: jnp.asarray(v).astype(dtype) for k, v in tree.items()}


def _to_torch(tree, dtype):
    return {k: torch.tensor(v).to(dtype) for k, v in tree.items()}


def _np(t):
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.numpy().astype(np.float64)


def _close(got, want, dtype, what):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32), np.float64)
    got = _np(got)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max(initial=0),
                                   err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=1e-30, err_msg=what)
        assert (got == want).mean() >= 0.99 or got.size < 100, what


@pytest.mark.parametrize("steps", [1, 5])
@pytest.mark.parametrize("compress", [False, True], ids=["plain", "int8"])
@pytest.mark.parametrize("clip", [False, True], ids=["noclip", "clip"])
@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_adamw_matches_reference(param_dtype, moment_dtype, clip, compress, steps):
    kw = dict(lr=1e-2, weight_decay=0.05, moment_dtype=moment_dtype, compress_grads=compress,
              clip_norm=1.0 if clip else 1e9)
    rcfg, tcfg = ropt.AdamWConfig(**kw), topt.AdamWConfig(**kw)
    jdt, tdt = jnp.dtype(param_dtype), getattr(torch, param_dtype)
    p0 = _tree(0, param_dtype)
    r_p, t_p = _to_jnp(p0, jdt), _to_torch(p0, tdt)
    r_s, t_s = ropt.init_opt_state(r_p, rcfg), topt.init_opt_state(t_p, tcfg)
    for i in range(steps):
        g = _tree(10 + i, param_dtype, scale=3.0 if clip else 0.01)
        r_p, r_s, r_n = ropt.adamw_update(_to_jnp(g, jdt), r_s, r_p, rcfg)
        t_p, t_s, t_n = topt.adamw_update(_to_torch(g, tdt), t_s, t_p, tcfg)
        np.testing.assert_allclose(float(t_n), float(r_n), rtol=1e-6)
        assert (float(r_n) > 1.0) == clip
    assert int(t_s["step"]) == int(r_s["step"]) == steps
    assert t_s["step"].dtype == torch.int32
    for k in SHAPES:
        assert t_p[k].dtype == tdt and t_s["m"][k].dtype == getattr(torch, moment_dtype)
        _close(t_p[k], r_p[k], param_dtype, f"param {k}")
        _close(t_s["m"][k], r_s["m"][k], moment_dtype, f"m {k}")
        _close(t_s["v"][k], r_s["v"][k], moment_dtype, f"v {k}")
        if compress:
            np.testing.assert_allclose(_np(t_s["ef"][k]), np.asarray(r_s["ef"][k]),
                                       rtol=1e-5, atol=1e-7, err_msg=f"ef {k}")
    assert ("ef" in t_s) == compress


def test_missing_gradient_is_zero():
    """A parameter with no gradient (``router_bias``) is updated as the
    reference updates a zero gradient: its moments decay, weight decay applies."""
    cfg = dict(lr=1e-2, weight_decay=0.1)
    p0 = _tree(1, "float32")
    g = _tree(2, "float32")
    r_g = _to_jnp(g, jnp.float32)
    r_g["c"] = jnp.zeros_like(r_g["c"])
    r_p = _to_jnp(p0, jnp.float32)
    r_p, r_s, _ = ropt.adamw_update(r_g, ropt.init_opt_state(r_p, ropt.AdamWConfig(**cfg)), r_p,
                                    ropt.AdamWConfig(**cfg))
    t_p = _to_torch(p0, torch.float32)
    t_g = _to_torch(g, torch.float32)
    t_g["c"] = None
    t_p, _, _ = topt.adamw_update(t_g, topt.init_opt_state(t_p, topt.AdamWConfig(**cfg)), t_p,
                                  topt.AdamWConfig(**cfg))
    for k in SHAPES:
        _close(t_p[k], r_p[k], "float32", k)
    assert float(t_p["c"]) != float(p0["c"])


def test_update_is_in_place_and_sliced(monkeypatch):
    """The update writes into the given tensors; slicing a leaf changes no byte."""
    p0 = _tree(3, "float32")
    g = _to_torch(_tree(4, "float32"), torch.float32)
    cfg = topt.AdamWConfig(lr=1e-2)
    whole = _to_torch(p0, torch.float32)
    topt.adamw_update(g, topt.init_opt_state(whole, cfg), whole, cfg)
    monkeypatch.setattr(topt, "UPDATE_SLICE", 4)
    sliced = _to_torch(p0, torch.float32)
    ids = {k: t.data_ptr() for k, t in sliced.items()}
    out, _, _ = topt.adamw_update(g, topt.init_opt_state(sliced, cfg), sliced, cfg)
    for k in SHAPES:
        assert out[k].data_ptr() == ids[k]
        assert torch.equal(sliced[k], whole[k]), k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_global_norm(dtype):
    tree = _tree(5, dtype, scale=2.0)
    want = ropt.global_norm(_to_jnp(tree, jnp.dtype(dtype)))
    got = topt.global_norm(_to_torch(tree, getattr(torch, dtype)).values())
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("shape", [(128, 64), (1000,), (3, 7, 11)])
def test_compress_int8_matches_reference(shape):
    """Equal int8 codes and dequantized values, step after step of error
    feedback (codes * scale gives deq back, scale = max |g + ef| / 127)."""
    rng = np.random.RandomState(6)
    r_ef, t_ef = jnp.zeros(shape, jnp.float32), torch.zeros(shape)
    for _ in range(4):
        g = rng.standard_normal(shape).astype(np.float32) * 0.1
        gf = g + t_ef.numpy()
        scale = np.float32(np.abs(gf).max()) / np.float32(127.0)
        r_deq, r_ef = ropt.compress_int8(jnp.asarray(g), r_ef)
        t_deq, t_ef = topt.compress_int8(torch.tensor(g), t_ef)
        np.testing.assert_array_equal(t_deq.numpy(), np.asarray(r_deq))
        codes = np.rint(t_deq.numpy() / scale).astype(np.int8)
        np.testing.assert_array_equal(codes.astype(np.float32) * scale, t_deq.numpy())
        assert np.abs(codes.astype(np.int64)).max() == 127
        np.testing.assert_allclose(t_ef.numpy(), np.asarray(r_ef), rtol=0,
                                   atol=float(np.abs(gf).max()) * 2 ** -23)


def test_compress_rounds_half_to_even():
    """torch.round and jnp.round both round x.5 to the even integer."""
    g = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 63.5], np.float32)
    r, _ = ropt.compress_int8(jnp.asarray(g), jnp.zeros(7))
    t, _ = topt.compress_int8(torch.tensor(g), torch.zeros(7))
    np.testing.assert_array_equal(t.numpy(), np.asarray(r))
    np.testing.assert_array_equal(t.numpy(), [127.0, 0.0, 2.0, 2.0, -0.0, -2.0, 64.0])


# -- the reference's own checks (tests/test_distributed.py), on the port ----

def test_int8_ef_roundtrip_bounded_error(rng):
    g = torch.tensor(rng.randn(128, 64).astype(np.float32))
    deq, new_ef = topt.compress_int8(g, torch.zeros_like(g))
    assert float(torch.max(torch.abs(deq - g))) <= float(torch.max(torch.abs(g))) / 127 + 1e-6
    np.testing.assert_allclose((deq + new_ef).numpy(), g.numpy(), rtol=1e-5, atol=1e-6)


def test_ef_accumulates_over_steps(rng):
    true = [torch.tensor(rng.randn(32).astype(np.float32) * 0.01) for _ in range(50)]
    ef = torch.zeros(32)
    sent = []
    for g in true:
        d, ef = topt.compress_int8(g, ef)
        sent.append(d)
    total_err = torch.abs(sum(sent) - sum(true)).numpy()
    assert total_err.max() < 0.01 * 50 / 127 + 1e-4


def test_training_with_compression_converges(rng):
    w_true = rng.randn(8).astype(np.float32)
    x = torch.tensor(rng.randn(256, 8).astype(np.float32))
    y = x @ torch.tensor(w_true)
    params = {"w": torch.zeros(8)}
    cfg = topt.AdamWConfig(lr=5e-2, weight_decay=0.0, compress_grads=True)
    state = topt.init_opt_state(params, cfg)
    for _ in range(150):
        w = params["w"].clone().requires_grad_(True)
        torch.mean((x @ w - y) ** 2).backward()
        params, state, _ = topt.adamw_update({"w": w.grad}, state, params, cfg)
    assert float(torch.max(torch.abs(params["w"] - torch.tensor(w_true)))) < 0.05


def test_adamw_matches_numpy_impl(rng):
    p = {"w": torch.tensor(rng.randn(5).astype(np.float32))}
    g = {"w": torch.tensor(rng.randn(5).astype(np.float32) * 0.1)}
    p_np, g_np = p["w"].numpy().copy(), g["w"].numpy().copy()
    cfg = topt.AdamWConfig(lr=1e-2, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.01,
                           clip_norm=1e9)
    new_p, _, _ = topt.adamw_update(g, topt.init_opt_state(p, cfg), p, cfg)
    m, v = 0.1 * g_np, 0.05 * g_np ** 2
    mhat, vhat = m / 0.1, v / 0.05
    expect = p_np - 1e-2 * (mhat / (np.sqrt(vhat) + 1e-8) + 0.01 * p_np)
    np.testing.assert_allclose(new_p["w"].numpy(), expect, rtol=1e-5)


def test_clip_norm():
    p = {"w": torch.zeros(4)}
    g = {"w": torch.full((4,), 100.0)}
    cfg = topt.AdamWConfig(clip_norm=1.0)
    _, _, gnorm = topt.adamw_update(g, topt.init_opt_state(p, cfg), p, cfg)
    assert float(gnorm) == pytest.approx(200.0)


def test_moment_dtype_bf16():
    p = {"w": torch.ones(4)}
    state = topt.init_opt_state(p, topt.AdamWConfig(moment_dtype="bfloat16"))
    assert state["m"]["w"].dtype == torch.bfloat16
