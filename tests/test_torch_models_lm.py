"""The port's LM serving forwards (``repro_torch.models``) against the
reference's, on the CPU, at every LM arch's smoke config (f32).

One reference parameter tree per arch (``init_params(cfg, key(0))``, each
leaf through ``np.asarray``) is carried across by ``from_reference_params``;
both packages get the same ``lm_batch`` tokens.  Tolerances: logits, hidden
states, caches and the MoE aux within rtol 1e-5 / atol 1e-5 (matmul and
reduction orders differ between XLA and PyTorch's CPU kernels); the MLA arch
within 1e-4, since its absorbed einsums chain four products per logit.  The
4-bit cache's codes equal the reference's but for counted one-level flips of
values on a Lloyd-Max boundary (``rotated`` by another summation order), and
its decode logits are held within 1e-3 of the reference's over the same
steps.  MoE routing (indices, and which slots are kept or dropped at
capacity) is equal exactly.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
from repro.data import synthetic as rsyn
from repro.models import moe as rmoe
from repro.models import transformer as rtf
from repro_torch import configs as TC
from repro_torch.data import synthetic as tsyn
from repro_torch.models import convert, moe as tmoe, transformer as ttf
from repro_torch.models.kvcache import KVSpec

LM_ARCHS = ["gemma2-2b", "qwen1.5-0.5b", "llama3.2-3b", "deepseek-v3-671b", "olmoe-1b-7b"]
STEPS = 10


def _tol(cfg):
    return 1e-4 if cfg.mla else 1e-5


@functools.lru_cache(maxsize=None)
def _setup(arch_id: str, moe_cf: float = 0.0):
    """(reference cfg, reference params, port cfg, port model, tokens [2, 16])."""
    rcfg = RC.get(arch_id).make_smoke()
    tcfg = TC.get(arch_id).make_smoke()
    if moe_cf and rcfg.moe:
        rcfg = dataclasses.replace(rcfg, moe=dataclasses.replace(rcfg.moe,
                                                                 capacity_factor=moe_cf))
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(tcfg.moe,
                                                                 capacity_factor=moe_cf))
    params = jax.jit(lambda k: rtf.init_params(rcfg, k))(jax.random.key(0))
    model = convert.from_reference_params(tcfg, jax.tree.map(np.asarray, params), device="cpu")
    toks = tsyn.lm_batch(0, 0, 2, 16, tcfg.vocab)["tokens"]
    return rcfg, params, tcfg, model, toks


@functools.lru_cache(maxsize=None)
def _ref_decode(rcfg, quantized):
    return jax.jit(lambda p, c, t, n: rtf.decode_step(p, rcfg, c, t, n, quantized=quantized))


def _close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=tol, atol=tol, err_msg=what)


@pytest.mark.parametrize("arch_id", LM_ARCHS)
def test_forward_matches_reference(arch_id):
    rcfg, params, tcfg, model, toks = _setup(arch_id)
    r_logits, r_h, r_aux, _ = rtf.forward(params, rcfg, jnp.asarray(toks))
    t_logits, t_h, t_aux, _ = ttf.forward(model, tcfg, torch.tensor(toks))
    tol = _tol(tcfg)
    _close(t_logits, r_logits, tol, "logits")
    _close(t_h, r_h, tol, "h_final")
    _close(t_aux, r_aux, tol, "aux")
    assert t_logits.shape == (2, 16, tcfg.vocab) and t_logits.dtype == torch.float32


@pytest.mark.parametrize("arch_id", LM_ARCHS)
def test_prefill_matches_reference(arch_id):
    rcfg, params, tcfg, model, toks = _setup(arch_id)
    r_last, r_caches = rtf.prefill(params, rcfg, jnp.asarray(toks), last_only=True)
    t_last, t_caches = ttf.prefill(model, tcfg, torch.tensor(toks), last_only=True)
    tol = _tol(tcfg)
    _close(t_last, r_last, tol, "last logits")
    assert len(t_caches) == len(r_caches)
    for rc, tc in zip(r_caches, t_caches):
        assert sorted(rc) == sorted(tc)
        for name in rc:
            assert tuple(tc[name].shape) == rc[name].shape
            _close(tc[name], rc[name], tol, name)


def _flips(got: np.ndarray, want: np.ndarray) -> int:
    """One-level code flips between packed 4-bit caches; any larger jump fails."""
    g = np.stack([got & 0xF, got >> 4], -1).astype(np.int64)
    w = np.stack([want & 0xF, want >> 4], -1).astype(np.int64)
    assert np.abs(g - w).max(initial=0) <= 1
    return int((g != w).sum())


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16cache", "4bitcache"])
@pytest.mark.parametrize("arch_id", LM_ARCHS)
def test_decode_matches_reference(arch_id, quantized):
    rcfg, params, tcfg, model, toks = _setup(arch_id)
    r_cache = rtf.init_decode_cache(rcfg, 2, 16, quantized=quantized)
    t_cache = ttf.init_decode_cache(tcfg, 2, 16, quantized=quantized, device="cpu")
    step = _ref_decode(rcfg, quantized)
    lq_tol = 1e-3 if quantized and not tcfg.mla else _tol(tcfg)
    for t in range(STEPS):
        r_lg, r_cache = step(params, r_cache, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
        t_lg, t_cache = ttf.decode_step(model, tcfg, t_cache, torch.tensor(toks[:, t:t + 1]),
                                        t, quantized=quantized)
        _close(t_lg, r_lg, lq_tol, f"step {t} logits")
    flips = 0
    for rc, tc in zip(r_cache, t_cache):
        for name in rc:
            got, want = tc[name].numpy(), np.asarray(rc[name])
            if name.endswith("codes"):
                flips += _flips(got, want)
            else:
                _close(got, want, lq_tol if quantized else _tol(tcfg), name)
    # The rotations' summation orders differ (Kronecker einsums in both, but
    # XLA's and PyTorch's reductions), so a value on a boundary may flip.
    n_codes = sum(t.numel() * 2 for c in t_cache for n, t in c.items() if n.endswith("codes"))
    assert flips <= max(2, n_codes // 10_000), (flips, n_codes)


@pytest.mark.parametrize("arch_id", LM_ARCHS)
def test_decode_matches_forward(arch_id):
    """The reference's own check, on the port: decode logits equal the
    forward's last position (capacity raised so no MoE token drops)."""
    _, _, tcfg, model, toks = _setup(arch_id)
    if tcfg.moe:
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
            tcfg.moe, capacity_factor=float(tcfg.moe.n_experts) / tcfg.moe.top_k))
    cache = ttf.init_decode_cache(tcfg, 2, 16, device="cpu")
    for t in range(STEPS):
        lg, cache = ttf.decode_step(model, tcfg, cache, torch.tensor(toks[:, t:t + 1]), t)
    fl, _, _, _ = ttf.forward(model, tcfg, torch.tensor(toks[:, :STEPS]))
    np.testing.assert_allclose(lg.numpy(), fl[:, -1].numpy(), rtol=2e-2, atol=2e-4)


@pytest.mark.parametrize("arch_id", [a for a in LM_ARCHS if a != "deepseek-v3-671b"])
def test_quantized_decode_close(arch_id):
    """The reference's smoke bounds on the port: argmax agreement >= 0.5 and
    max |logit diff| < 2.0 between the 4-bit and the full-precision cache."""
    _, _, tcfg, model, toks = _setup(arch_id)
    cache_f = ttf.init_decode_cache(tcfg, 2, 16, device="cpu")
    cache_q = ttf.init_decode_cache(tcfg, 2, 16, quantized=True, device="cpu")
    for t in range(STEPS):
        tok = torch.tensor(toks[:, t:t + 1])
        lf, cache_f = ttf.decode_step(model, tcfg, cache_f, tok, t)
        lq, cache_q = ttf.decode_step(model, tcfg, cache_q, tok, t, quantized=True)
    agree = (lf.argmax(-1) == lq.argmax(-1)).float().mean().item()
    assert agree >= 0.5
    assert (lq - lf).abs().max().item() < 2.0


@pytest.mark.parametrize("cf", [0.5, 1.25])
@pytest.mark.parametrize("arch_id", ["deepseek-v3-671b", "olmoe-1b-7b"])
def test_moe_routing_and_capacity_exact(arch_id, cf):
    """route's indices equal the reference's exactly, the same slots are kept
    and dropped at capacity (cf 0.5 drops), and the FFN output matches."""
    rcfg, params, tcfg, model, _ = _setup(arch_id)
    rm = dataclasses.replace(rcfg.moe, capacity_factor=cf)
    tm = dataclasses.replace(tcfg.moe, capacity_factor=cf)
    rp = params["blocks"][-1]
    rp = jax.tree.map(lambda a: a[0], rp)["ffn"]
    tp = model.blocks[-1][0].ffn
    x = np.random.RandomState(1).standard_normal((3, 12, tcfg.d_model)).astype(np.float32)
    r_idx, r_w, r_aux = rmoe.route(jnp.asarray(x.reshape(36, -1)), rp, rm)
    t_idx, t_w, t_aux = tmoe.route(torch.tensor(x.reshape(36, -1)), tp, tm)
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(r_idx))
    _close(t_w, r_w, 1e-6, "weights")
    _close(t_aux, r_aux, 1e-6, "aux")
    # The reference's slotting (moe.py:112-119) against the port's.
    b, s, k, e = 3, 12, tm.top_k, tm.n_experts
    cap = max(1, int(np.ceil(s * k / e * cf)))
    top = np.asarray(r_idx).reshape(b, s * k)
    order = np.argsort(top, axis=1, kind="stable")
    sorted_e = np.take_along_axis(top, order, 1)
    counts = np.stack([np.bincount(r, minlength=e) for r in top])
    starts = np.concatenate([np.zeros((b, 1), int), np.cumsum(counts, 1)[:, :-1]], 1)
    r_keep = (np.arange(s * k)[None] - np.take_along_axis(starts, sorted_e, 1)) < cap
    kept_tokens = {(bi, int(order[bi, p])) for bi, p in zip(*np.nonzero(r_keep))}
    t_keep = tmoe.dispatch_slots(t_idx.reshape(b, s * k), e, cap)["keep"].numpy()
    t_order = tmoe.dispatch_slots(t_idx.reshape(b, s * k), e, cap)["order"].numpy()
    assert kept_tokens == {(bi, int(t_order[bi, p])) for bi, p in zip(*np.nonzero(t_keep))}
    if cf < 1:
        assert not r_keep.all()
    r_y, r_aux2 = rmoe.moe_ffn(rp, jnp.asarray(x), rm)
    t_y, t_aux2 = tmoe.moe_ffn(tp, torch.tensor(x), tm)
    _close(t_y, r_y, 1e-5, "moe_ffn")
    _close(t_aux2, r_aux2, 1e-6, "moe aux")


def test_kv_spec_and_cache_layout():
    rcfg = RC.get("llama3.2-3b").make_smoke()
    tcfg = TC.get("llama3.2-3b").make_smoke()
    r = rtf.kv_spec(rcfg, 2, 16, quantized=True)
    t = ttf.kv_spec(tcfg, 2, 16, quantized=True)
    assert isinstance(t, KVSpec)
    assert (t.batch, t.max_len, t.n_kv_heads, t.head_dim, t.quantized, t.seed) == \
        (r.batch, r.max_len, r.n_kv_heads, r.head_dim, r.quantized, r.seed)
    for q in (False, True):
        rc = rtf.init_decode_cache(rcfg, 2, 16, quantized=q)
        tc = ttf.init_decode_cache(tcfg, 2, 16, quantized=q, device="cpu")
        for a, b in zip(rc, tc):
            assert {n: (v.shape, str(v.dtype)) for n, v in a.items()} == \
                {n: (tuple(v.shape), str(v.dtype).replace("torch.", "")) for n, v in b.items()}


def test_lm_batch_is_the_references():
    for args in [(0, 0, 2, 16, 512), (3, 7, 4, 544, 128256)]:
        np.testing.assert_array_equal(tsyn.lm_batch(*args)["tokens"],
                                      rsyn.lm_batch(*args)["tokens"])
