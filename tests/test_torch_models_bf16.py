"""The port's LM serving forwards in bf16 against the reference's bf16
forwards, on the CPU, at bf16 copies of the LM smoke configs.

Every served config of the registry is bf16, so the rounding rule matters:
where the reference's einsum keeps an f32 output (``preferred_element_type``)
the port must not round the product to bf16 first.  Two kinds of check:

* module level, where the port can equal the reference byte for byte: the
  routed MoE experts (``moe_ffn`` with no shared expert; routing is f32 in
  both, so the same slots are filled) and a bf16 ``dense`` with a non-zero
  bias.  Measured on the CPU: 0 of the outputs differ; with the expert
  einsums or the biased product rounded to bf16 before the f32 step, 58-62%
  (``moe_ffn``) and 30% (``dense``) differ.  The bound is 2% of the elements.
* whole model: ``forward`` logits, then ``decode_step`` over the bf16 and the
  4-bit cache, held by the relative L2 distance of each position's logits.
  The elementwise functions (``exp``, ``tanh``, ``sigmoid``) of XLA and
  PyTorch differ in their last f32 bit, which flips a bf16 rounding now and
  then, so the distance is not 0.  Measured (this file's inputs): medians
  0.0072-0.0096 for forward and the bf16 cache, 0.026-0.033 for the 4-bit
  cache, worst positions <= 0.017 and <= 0.24 (olmoe, a code flip); for
  deepseek's MLA + sigmoid-routed MoE a routing flip moves the positions
  after it (median 0.018, worst 0.45).  The bounds (``BOUNDS``) are about
  1.5x those readings: they catch a gross error, and an MoE expert product
  rounded to bf16 (olmoe's worst forward position 0.20, 4-bit 0.51); a
  biased product rounded twice moves qwen's median only to 0.0086, which
  the module check above catches.  Qwen's q / k / v biases are drawn
  non-zero so that the biased path is exercised.

XLA's CPU backend of the installed jax has no BF16 x BF16 -> F32 batched dot
("Unsupported element type for DotThunk::Execute"), so while the reference
runs here its ``jnp.einsum`` with ``preferred_element_type=float32`` takes f32
copies of bf16 operands: the products of two bf16 values are exact in f32,
so that is the einsum's own result up to the summation order.
"""

import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
from repro.models import layers as rlayers
from repro.models import moe as rmoe
from repro.models import transformer as rtf
from repro_torch import configs as TC
from repro_torch.data import synthetic as tsyn
from repro_torch.models import convert, layers as tlayers, moe as tmoe, transformer as ttf

LM_ARCHS = ["gemma2-2b", "qwen1.5-0.5b", "llama3.2-3b", "deepseek-v3-671b", "olmoe-1b-7b"]
STEPS = 8
MISMATCH_BOUND = 0.02
# (median, worst) relative L2 distance of a position's logits.
BOUNDS = {"forward": (0.015, 0.03), "bf16cache": (0.015, 0.03), "4bitcache": (0.05, 0.35)}
MLA_MOE_BOUNDS = (0.03, 0.7)            # deepseek-v3: routing flips


@contextlib.contextmanager
def _f32_einsums():
    einsum = jnp.einsum

    def f32_einsum(spec, *ops, preferred_element_type=None, **kw):
        if preferred_element_type == jnp.float32:
            ops = [o.astype(jnp.float32) if getattr(o, "dtype", None) == jnp.bfloat16 else o
                   for o in ops]
        return einsum(spec, *ops, preferred_element_type=preferred_element_type, **kw)

    jnp.einsum = f32_einsum
    try:
        yield
    finally:
        jnp.einsum = einsum


def _bf16(cfg):
    return dataclasses.replace(cfg, dtype="bfloat16")


def _randomise_biases(tree, rng):
    """Every ``b`` leaf of a transformer tree (qwen's q / k / v) drawn N(0, 0.5^2)."""
    if isinstance(tree, dict):
        return {k: (rng.standard_normal(v.shape).astype(np.float32) * 0.5).astype(v.dtype)
                if k == "b" else _randomise_biases(v, rng) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_randomise_biases(v, rng) for v in tree]
    return tree


@functools.lru_cache(maxsize=None)
def _setup(arch_id: str):
    """(port cfg, port model, tokens [2, 16], reference outputs by name, the
    reference's parameter tree as numpy)."""
    rcfg = _bf16(RC.get(arch_id).make_smoke())
    tcfg = _bf16(TC.get(arch_id).make_smoke())
    with _f32_einsums():
        tree = jax.tree.map(np.asarray, jax.jit(lambda k: rtf.init_params(rcfg, k))(
            jax.random.key(0)))
        tree = _randomise_biases(tree, np.random.RandomState(7))
        params = jax.tree.map(jnp.asarray, tree)
        toks = tsyn.lm_batch(0, 0, 2, 16, tcfg.vocab)["tokens"]
        ref = {"forward": np.asarray(jax.jit(lambda p, t: rtf.forward(p, rcfg, t)[0])(
            params, jnp.asarray(toks)), np.float32)}
        for name, q in (("bf16cache", False), ("4bitcache", True)):
            step = jax.jit(lambda p, c, t, n: rtf.decode_step(p, rcfg, c, t, n, quantized=q))
            cache = rtf.init_decode_cache(rcfg, 2, 16, quantized=q)
            outs = []
            for t in range(STEPS):
                lg, cache = step(params, cache, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
                outs.append(np.asarray(lg, np.float32))
            ref[name] = np.stack(outs)
    model = convert.from_reference_params(tcfg, tree, device="cpu")
    return tcfg, model, toks, ref, tree


def _port(arch_id: str, what: str) -> np.ndarray:
    tcfg, model, toks, _, _ = _setup(arch_id)
    if what == "forward":
        return ttf.forward(model, tcfg, torch.tensor(toks))[0].float().numpy()
    q = what == "4bitcache"
    cache = ttf.init_decode_cache(tcfg, 2, 16, quantized=q, device="cpu")
    outs = []
    for t in range(STEPS):
        lg, cache = ttf.decode_step(model, tcfg, cache, torch.tensor(toks[:, t:t + 1]), t,
                                    quantized=q)
        outs.append(lg.float().numpy())
    return np.stack(outs)


def _position_distances(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    g = got.astype(np.float64).reshape(-1, got.shape[-1])
    w = want.astype(np.float64).reshape(-1, want.shape[-1])
    return np.linalg.norm(g - w, axis=-1) / np.linalg.norm(w, axis=-1)


@pytest.mark.parametrize("what", ["forward", "bf16cache", "4bitcache"])
@pytest.mark.parametrize("arch_id", LM_ARCHS)
def test_bf16_model_matches_reference(arch_id, what):
    tcfg, _, _, ref, _ = _setup(arch_id)
    got = _port(arch_id, what)
    assert got.shape == ref[what].shape and np.isfinite(got).all()
    dist = _position_distances(got, ref[what])
    med, worst = float(np.median(dist)), float(dist.max())
    med_bound, worst_bound = MLA_MOE_BOUNDS if tcfg.mla else BOUNDS[what]
    assert med <= med_bound and worst <= worst_bound, (med, worst)


def _mismatch(got: torch.Tensor, want) -> float:
    return float((got.float().numpy() != np.asarray(want.astype(jnp.float32))).mean())


@pytest.mark.parametrize("arch_id", ["deepseek-v3-671b", "olmoe-1b-7b"])
def test_bf16_moe_experts_equal_reference(arch_id):
    """The routed experts' f32 einsum outputs stay f32 into silu(gate) * up and
    the combine: bf16 ``moe_ffn`` equals the reference's but for rare last-bit
    flips (measured 0; a bf16-rounded expert product differs in ~60%)."""
    rcfg = _bf16(RC.get(arch_id).make_smoke())
    tcfg, model, _, _, tree = _setup(arch_id)
    rm = dataclasses.replace(rcfg.moe, n_shared=0)
    tm = dataclasses.replace(tcfg.moe, n_shared=0)
    tp = model.blocks[-1][0].ffn
    rp = jax.tree.map(lambda a: jnp.asarray(a[0]), tree["blocks"][-1])["ffn"]
    for seed in (0, 1):
        x = np.random.RandomState(seed).standard_normal((3, 12, tcfg.d_model)).astype(np.float32)
        with _f32_einsums():
            r_y, _ = rmoe.moe_ffn(rp, jnp.asarray(x).astype(jnp.bfloat16), rm)
        t_y, _ = tmoe.moe_ffn(tp, torch.tensor(x).to(torch.bfloat16), tm)
        assert t_y.dtype == torch.bfloat16
        assert _mismatch(t_y, r_y) <= MISMATCH_BOUND


@pytest.mark.parametrize("d_in,d_out", [(64, 64), (64, 192), (256, 512)])
def test_bf16_dense_bias_rounds_once(d_in, d_out):
    """A bf16 ``dense`` with a bias rounds once, after the bias is added to the
    f32 product (measured 0 outputs differ; rounding the product first, 30%)."""
    rng = np.random.RandomState(d_in + d_out)
    w = (rng.standard_normal((d_in, d_out)) / np.sqrt(d_in)).astype(np.float32)
    b = (rng.standard_normal((d_out,)) * 0.5).astype(np.float32)
    x = rng.standard_normal((2, 16, d_in)).astype(np.float32)
    r_y = rlayers.dense({"w": jnp.asarray(w).astype(jnp.bfloat16),
                         "b": jnp.asarray(b).astype(jnp.bfloat16)},
                        jnp.asarray(x).astype(jnp.bfloat16))
    p = tlayers.Dense(d_in, d_out, bias=True, dtype=torch.bfloat16, device=torch.device("meta"))
    p.w = torch.nn.Parameter(torch.tensor(w).to(torch.bfloat16), requires_grad=False)
    p.b = torch.nn.Parameter(torch.tensor(b).to(torch.bfloat16), requires_grad=False)
    t_y = tlayers.dense(p, torch.tensor(x).to(torch.bfloat16))
    assert t_y.dtype == torch.bfloat16
    assert _mismatch(t_y, r_y) <= MISMATCH_BOUND


def _forward_routes(model, cfg, toks, replay=None):
    """(logits, every MoE layer's route output) of a forward; ``replay``
    feeds recorded routes back in place of the router's own."""
    route, seen = tmoe.route, []

    def recording(x, p, mcfg):
        seen.append(next(replay) if replay is not None else route(x, p, mcfg))
        return seen[-1]

    tmoe.route = recording
    try:
        logits = ttf.forward(model, cfg, toks)[0]
    finally:
        tmoe.route = route
    return logits.float(), seen


@pytest.mark.parametrize("arch_id", ["olmoe-1b-7b", "deepseek-v3-671b", "llama3.2-3b"])
def test_bf16_distance_from_f32_is_routing(arch_id):
    """A bf16 MoE model's forward is far from its f32 twin's where a token's
    top-k experts differ (the residual stream's bf16 rounding moves a near
    tie); with the f32 forward's routing replayed, its distance is a dense
    model's.  Measured at these sizes (4 layers, 2 x 256 tokens): olmoe 2.43
    with its own routing (8-11 of 512 tokens a layer take another expert
    set), 0.0598 replayed; deepseek 2.17 / 0.136 (its MLA adds its own
    bf16 error); llama 0.0578.  Bounds: replayed 0.1 (MLA 0.2)."""
    cfg = dataclasses.replace(TC.get(arch_id).make_smoke(), dtype="bfloat16", n_layers=4)
    if cfg.moe:          # no drops: the distance is the routing's and the experts'
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=float(cfg.moe.n_experts) / cfg.moe.top_k))
    model = ttf.Transformer(cfg, torch.Generator().manual_seed(0), device="cpu")
    f32_cfg = dataclasses.replace(cfg, dtype="float32")
    f32_model = ttf.Transformer(f32_cfg, device="meta")
    f32_model.load_state_dict({k: v.float() for k, v in model.state_dict().items()},
                              assign=True)
    toks = torch.tensor(tsyn.lm_batch(0, 2, 2, 256, cfg.vocab)["tokens"])
    want, routes = _forward_routes(f32_model, f32_cfg, toks)
    own, own_routes = _forward_routes(model, cfg, toks)
    replayed, _ = _forward_routes(model, cfg, toks, replay=iter(routes))
    n_moe = cfg.n_layers - cfg.moe.first_dense_layers if cfg.moe else 0
    assert len(routes) == len(own_routes) == n_moe
    flips = [int((a[0] != b[0]).any(-1).sum()) for a, b in zip(routes, own_routes)]
    assert (sum(flips) > 0) == bool(cfg.moe), flips
    distance = float((replayed - want).abs().max())
    assert distance <= (0.2 if cfg.mla else 0.1)
    assert distance <= float((own - want).abs().max())
