"""The port's LM training gradients in bf16 against the reference's
``jax.value_and_grad``, on the CPU, at bf16 copies of the LM smoke configs.

Every full-width LM of the registry trains in bf16, and the backward has
rounding points of its own: a bf16 parameter's gradient leaves an f32
product (the head's and the experts' f32 einsums, a biased ``dense``)
rounded once, and gradients that meet from several uses are summed in
bf16 in the reference's order.  Two kinds of check, as
``test_torch_models_bf16.py`` does for the forward:

* module level, where the port can equal the reference byte for byte: the
  tied and untied LM head with the cross-entropy (``_xent_from_hidden``,
  whole and chunked), the routed MoE experts (``moe_ffn`` with no shared
  expert), deepseek-v3's MLA (``mla_attention``) and a biased ``dense``.
  Measured on the CPU: at most 0.1% of the gradient elements differ.  The
  bound is 2% of the elements.  With the head's f32 logit gradient rounded
  to bf16 before its products, 37-41% of the head's gradient elements
  differ (whole) and 54-55% (chunked); with the experts' f32 einsum
  outputs' gradients rounded to bf16, 37-55% of the experts' (and x's)
  elements.  The chunks' bf16 head gradients summed in
  the order autograd meets them (the remainder's first) rather than the
  reference's (the full chunks' sum, then the remainder's): 39%.
* whole model: the loss and the relative L2 distance of every gradient
  leaf (``jax.value_and_grad`` against ``loss.backward``).  The forwards'
  elementwise functions differ in their last f32 bit, which flips bf16
  roundings of the activations, so the leaves are not equal.  Measured
  (this file's inputs): loss within 2.5e-05-3.5e-04 relative; each arch's
  median leaf 0.0086-0.0157, worst leaf 0.0128-0.0200.  deepseek-v3 (the
  one MLA arch) runs the reference's routing: each MoE layer's expert
  selection (integer) is captured from the reference's ``route`` and
  replayed in the port's, while the routing weights and the router's
  gradient come from each package's own scores.  With its own routing its
  sigmoid router flips tokens under those roundings, and its leaves read
  median 0.10, worst 0.30 (its router weights); replayed, median 0.0186
  and worst 0.0334 (at a second token draw 0.0140 / 0.0297).  Its worst
  leaves at both draws are the MLA query path's (``w_dq``, ``q_ln``,
  ``w_uq``, ``w_uk``), in the MTP layer and in the main blocks; why that
  path reads highest is not measured (``mla_attention`` alone matches the
  reference's, ``test_bf16_mla_grads_equal_reference``).  olmoe keeps its
  own (softmax) routing, so the port's bf16 expert selection is held in a
  backward too.  The bounds are about 1.5x those readings: a wrong,
  dropped or misscaled gradient on any leaf fails them; a single extra
  rounding in the backward does not (it is below the forward's spread),
  which is what the module checks are for.

XLA's CPU backend has no BF16 x BF16 -> F32 dot, so the reference's f32
einsums take f32 copies of their bf16 operands here
(``test_torch_models_bf16._f32_einsums``): the products are exact in f32,
and the transpose of the copy rounds the gradient to bf16 once, as the
einsum's own transpose does.
"""

import contextlib
import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
from repro.models import layers as rlayers
from repro.models import mla as rmla
from repro.models import moe as rmoe
from repro.models import transformer as rtf
from repro_torch import configs as TC
from repro_torch.data import synthetic as tsyn
from repro_torch.models import convert, layers as tlayers, mla as tmla, moe as tmoe
from repro_torch.models import transformer as ttf
from repro_torch.train.checkpoint import _leaf_paths
from tests.test_torch_models_bf16 import (LM_ARCHS, MISMATCH_BOUND, _bf16, _f32_einsums,
                                          _randomise_biases)

LOSS_RTOL = 1e-3
# (median, worst) relative L2 distance of a gradient leaf from the reference's.
LEAF_BOUNDS = (0.025, 0.03)
MLA_LEAF_BOUNDS = (0.025, 0.045)        # deepseek-v3, routing replayed: 0.0186 / 0.0334


def _mismatch(got: torch.Tensor, want) -> float:
    return float((got.float().numpy() != np.asarray(jnp.asarray(want).astype(jnp.float32))).mean())


@functools.lru_cache(maxsize=None)
def _tree(arch_id: str):
    rcfg = _bf16(RC.get(arch_id).make_smoke())
    with _f32_einsums():
        tree = jax.tree.map(np.asarray, jax.jit(lambda k: rtf.init_params(rcfg, k))(
            jax.random.key(0)))
    return _randomise_biases(tree, np.random.RandomState(7))


@contextlib.contextmanager
def _captured_routes(routes):
    """Record each reference MoE layer's expert selection into ``routes``,
    keyed by the bytes of that layer's router weights (the layers of a block
    share one traced body, and a remat'd layer routes again in the backward
    pass: every capture of a layer must agree)."""
    route = rmoe.route

    def store(top_idx, router_w):
        key, top_idx = np.asarray(router_w).tobytes(), np.asarray(top_idx)
        assert key not in routes or np.array_equal(routes[key], top_idx)
        routes[key] = top_idx

    def recording(x, p, mcfg):
        out = route(x, p, mcfg)
        jax.debug.callback(store, out[0], p["router"]["w"])
        return out

    rmoe.route = recording
    try:
        yield routes
    finally:
        rmoe.route = route


@contextlib.contextmanager
def _replayed_routes(routes):
    """The port's ``route`` selects the experts captured for its layer: its
    top-k returns them, and the routing weights and the aux loss are
    computed from this call's own scores at those experts."""
    route, topk = tmoe.route, tmoe.topk

    def replaying(x, p, mcfg):
        want = torch.tensor(routes[p.router.w.detach().float().numpy().tobytes()],
                            dtype=torch.long)
        tmoe.topk = lambda scores, k: (torch.gather(scores, 1, want), want)
        try:
            return route(x, p, mcfg)
        finally:
            tmoe.topk = topk

    tmoe.route = replaying
    try:
        yield
    finally:
        tmoe.route = route


@pytest.mark.parametrize("arch_id", LM_ARCHS)
def test_bf16_loss_and_grads_match_reference(arch_id):
    rcfg = _bf16(RC.get(arch_id).make_smoke())
    tcfg = _bf16(TC.get(arch_id).make_smoke())
    tree = _tree(arch_id)
    toks = tsyn.lm_batch(0, 0, 2, 16, tcfg.vocab)["tokens"]
    replay, routes = bool(tcfg.mla), {}
    with _f32_einsums(), _captured_routes(routes) if replay else contextlib.nullcontext():
        r_loss, r_grads = jax.jit(jax.value_and_grad(lambda p, t: rtf.lm_loss(p, rcfg, t)))(
            jax.tree.map(jnp.asarray, tree), jnp.asarray(toks))
        jax.block_until_ready(r_grads)
    assert len(routes) == (tcfg.n_layers - tcfg.moe.first_dense_layers if replay else 0)
    model = convert.from_reference_params(tcfg, tree, device="cpu").requires_grad_(True)
    with _replayed_routes(routes) if replay else contextlib.nullcontext():
        loss = ttf.lm_loss(model, tcfg, torch.tensor(toks))
        loss.backward()
    grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
             for k, p in model.named_parameters()}
    np.testing.assert_allclose(float(loss.detach()), float(r_loss), rtol=LOSS_RTOL)
    got = dict(_leaf_paths(convert.reference_tree(grads)))
    want = dict(_leaf_paths(r_grads))
    assert sorted(got) == sorted(want)
    dist = {}
    for path, w in want.items():
        assert got[path].dtype == convert.to_tensor(np.asarray(w)).dtype, path
        g64 = got[path].double().numpy()
        w64 = np.asarray(jnp.asarray(w).astype(jnp.float32), np.float64)
        norm = np.linalg.norm(w64)
        dist["/".join(path)] = (np.linalg.norm(g64 - w64) / norm if norm > 0
                                else np.linalg.norm(g64))
    values = np.array(list(dist.values()))
    med_bound, worst_bound = MLA_LEAF_BOUNDS if tcfg.mla else LEAF_BOUNDS
    worst = max(dist, key=dist.get)
    assert np.median(values) <= med_bound and dist[worst] <= worst_bound, (
        float(np.median(values)), worst, dist[worst])


@pytest.mark.parametrize("loss_chunk", [0, 4])
@pytest.mark.parametrize("arch_id", ["gemma2-2b", "llama3.2-3b", "olmoe-1b-7b"])
def test_bf16_head_grads_equal_reference(arch_id, loss_chunk):
    """The head's f32 logits' gradient stays f32 into the head's products and
    is rounded to bf16 once a use; the chunks' bf16 gradients are summed as
    the reference's scan sums them (15 targets: three chunks of 4 and a
    remainder of 3)."""
    rcfg = dataclasses.replace(_bf16(RC.get(arch_id).make_smoke()), loss_chunk=loss_chunk)
    tcfg = dataclasses.replace(_bf16(TC.get(arch_id).make_smoke()), loss_chunk=loss_chunk)
    rng = np.random.RandomState(loss_chunk)
    h = rng.standard_normal((2, 15, tcfg.d_model)).astype(np.float32)
    w = (rng.standard_normal((tcfg.vocab, tcfg.d_model)) * 0.05).astype(np.float32)
    t = rng.randint(0, tcfg.vocab, (2, 15))
    if tcfg.tie_embeddings:
        def ref_params(w_):
            return {"embed": w_}
        w_t = torch.tensor(w).to(torch.bfloat16).requires_grad_(True)
        params = types.SimpleNamespace(embed=w_t)
    else:
        w = np.ascontiguousarray(w.T)
        def ref_params(w_):
            return {"lm_head": {"w": w_}}
        w_t = torch.tensor(w).to(torch.bfloat16).requires_grad_(True)
        params = types.SimpleNamespace(lm_head=types.SimpleNamespace(w=w_t, b=None))
    with _f32_einsums():
        r_loss, (r_gw, r_gh) = jax.value_and_grad(
            lambda w_, h_: rtf._xent_from_hidden(ref_params(w_), rcfg, h_, jnp.asarray(t)),
            argnums=(0, 1))(jnp.asarray(w).astype(jnp.bfloat16),
                            jnp.asarray(h).astype(jnp.bfloat16))
    h_t = torch.tensor(h).to(torch.bfloat16).requires_grad_(True)
    loss = ttf._xent_from_hidden(params, tcfg, h_t, torch.tensor(t))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(r_loss), rtol=1e-6)
    assert w_t.grad.dtype == h_t.grad.dtype == torch.bfloat16
    assert _mismatch(w_t.grad, r_gw) <= MISMATCH_BOUND
    assert _mismatch(h_t.grad, r_gh) <= MISMATCH_BOUND


@pytest.mark.parametrize("arch_id", ["deepseek-v3-671b", "olmoe-1b-7b"])
def test_bf16_moe_expert_grads_equal_reference(arch_id):
    """The routed experts' gradients (x and the three expert weights, bf16)
    leave f32 einsums rounded once; the f32 router's gradient within 1e-5 of
    its largest element."""
    rcfg = _bf16(RC.get(arch_id).make_smoke())
    tcfg = _bf16(TC.get(arch_id).make_smoke())
    tree = _tree(arch_id)
    rm = dataclasses.replace(rcfg.moe, n_shared=0)
    tm = dataclasses.replace(tcfg.moe, n_shared=0)
    model = convert.from_reference_params(tcfg, tree, device="cpu")
    tp = model.blocks[-1][0].ffn.requires_grad_(True)
    rp = jax.tree.map(lambda a: jnp.asarray(a[0]), tree["blocks"][-1])["ffn"]
    rng = np.random.RandomState(3)
    x = rng.standard_normal((3, 12, tcfg.d_model)).astype(np.float32)
    ct = rng.standard_normal((3, 12, tcfg.d_model)).astype(np.float32)

    def ref_loss(p, x_):
        y, aux = rmoe.moe_ffn(p, x_, rm)
        return jnp.sum(y.astype(jnp.float32) * ct) + aux

    with _f32_einsums():
        r_gp, r_gx = jax.jit(jax.grad(ref_loss, argnums=(0, 1)))(
            rp, jnp.asarray(x).astype(jnp.bfloat16))
    x_t = torch.tensor(x).to(torch.bfloat16).requires_grad_(True)
    y, aux = tmoe.moe_ffn(tp, x_t, tm)
    ((y.float() * torch.tensor(ct)).sum() + aux).backward()
    assert _mismatch(x_t.grad, r_gx) <= MISMATCH_BOUND
    for name in ("w_gate", "w_up", "w_down"):
        g = getattr(tp, name).grad
        assert g.dtype == torch.bfloat16 and _mismatch(g, r_gp[name]) <= MISMATCH_BOUND, name
    want = np.asarray(r_gp["router"]["w"])
    np.testing.assert_allclose(tp.router.w.grad.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_mla_grads_equal_reference(seed):
    """deepseek-v3's MLA (``mla_attention``, its first layer's weights) in
    bf16: the output and the gradients of x and of every MLA weight equal
    the reference's but for rare last-bit flips (measured: byte-equal at
    these two draws)."""
    arch_id = "deepseek-v3-671b"
    rcfg = _bf16(RC.get(arch_id).make_smoke())
    tcfg = _bf16(TC.get(arch_id).make_smoke())
    tree = _tree(arch_id)
    model = convert.from_reference_params(tcfg, tree, device="cpu")
    tp = model.blocks[0][0].attn.mla.requires_grad_(True)
    rp = jax.tree.map(lambda a: jnp.asarray(a[0]), tree["blocks"][0])["attn"]["mla"]
    rng = np.random.RandomState(seed)
    s = 16
    x = rng.standard_normal((2, s, tcfg.d_model)).astype(np.float32)
    ct = rng.standard_normal((2, s, tcfg.d_model)).astype(np.float32)
    pos, mask = np.arange(s, dtype=np.int32), np.tril(np.ones((s, s), bool))

    def ref_loss(p, x_):
        y = rmla.mla_attention(p, x_, jnp.asarray(pos), jnp.asarray(mask), n_heads=rcfg.n_heads,
                               mla=rcfg.mla, rope_theta=rcfg.rope_theta)
        return jnp.sum(y.astype(jnp.float32) * ct), y

    with _f32_einsums():
        (_, r_y), (r_gp, r_gx) = jax.jit(jax.value_and_grad(
            ref_loss, argnums=(0, 1), has_aux=True))(rp, jnp.asarray(x).astype(jnp.bfloat16))
    x_t = torch.tensor(x).to(torch.bfloat16).requires_grad_(True)
    y = tmla.mla_attention(tp, x_t, torch.tensor(pos), torch.tensor(mask), n_heads=tcfg.n_heads,
                           mla=tcfg.mla, rope_theta=tcfg.rope_theta)
    (y.float() * torch.tensor(ct)).sum().backward()
    assert y.dtype == torch.bfloat16 and _mismatch(y.detach(), r_y) <= MISMATCH_BOUND
    assert _mismatch(x_t.grad, r_gx) <= MISMATCH_BOUND
    for name, p in tp.named_parameters():
        want = functools.reduce(lambda t, k: t[k], name.split("."), r_gp)
        assert p.grad.dtype == torch.bfloat16 and _mismatch(p.grad, want) <= MISMATCH_BOUND, name


@pytest.mark.parametrize("d_in,d_out", [(64, 64), (64, 192), (256, 512)])
def test_bf16_dense_bias_grads_equal_reference(d_in, d_out):
    """A biased bf16 ``dense``: the gradients of w, b and x each leave an f32
    sum or product rounded once."""
    rng = np.random.RandomState(d_in + d_out)
    w = (rng.standard_normal((d_in, d_out)) / np.sqrt(d_in)).astype(np.float32)
    b = (rng.standard_normal((d_out,)) * 0.5).astype(np.float32)
    x = rng.standard_normal((2, 16, d_in)).astype(np.float32)
    ct = rng.standard_normal((2, 16, d_out)).astype(np.float32)
    bf = lambda a: jnp.asarray(a).astype(jnp.bfloat16)  # noqa: E731
    r_g = jax.grad(lambda p, x_: jnp.sum(rlayers.dense(p, x_).astype(jnp.float32) * ct),
                   argnums=(0, 1))(dict(w=bf(w), b=bf(b)), bf(x))
    p = tlayers.Dense(d_in, d_out, bias=True, dtype=torch.bfloat16, device=torch.device("meta"))
    p.w = torch.nn.Parameter(torch.tensor(w).to(torch.bfloat16))
    p.b = torch.nn.Parameter(torch.tensor(b).to(torch.bfloat16))
    x_t = torch.tensor(x).to(torch.bfloat16).requires_grad_(True)
    (tlayers.dense(p, x_t).float() * torch.tensor(ct)).sum().backward()
    assert _mismatch(p.w.grad, r_g[0]["w"]) <= MISMATCH_BOUND
    assert _mismatch(p.b.grad, r_g[0]["b"]) <= MISMATCH_BOUND
    assert _mismatch(x_t.grad, r_g[1]) <= MISMATCH_BOUND
