"""Decoder-only transformer family covering the registry's LM architectures
(counterpart of ``repro/models/transformer.py``).

One config dataclass spans dense GQA (llama3, qwen1.5 with QKV bias),
local+global alternating attention with logit softcaps (gemma2), MoE FFN
stacks (olmoe) and MLA attention + shared/routed experts + MTP (deepseek-v3).

``Transformer`` holds the parameters under the reference's keys.  Its
``blocks`` are the reference's consecutive homogeneous blocks (DeepSeek's
dense then MoE layers), each a ``ModuleList`` of per-layer modules where the
reference stacks ``[L, ...]`` arrays for ``lax.scan``: in PyTorch the layers
simply run one after another, so ``unroll`` changes nothing here.  ``remat``
is the reference's ``jax.checkpoint`` around each layer when gradients are
taken: ``torch.utils.checkpoint`` (non-reentrant) recomputes the layer in
the backward pass; ``remat_policy="dots"`` keeps the matmuls without batch
dimensions (``mm`` / ``addmm``, not ``bmm``) and recomputes the rest.  A
recomputed layer gives the bytes of its first pass.  The sharding fields
(``dp_axes``, ``act_shard``, ``attn_*_shard``, ``vocab_shard``) stay so
that every registry entry equals the reference's field by field; on one
device they change nothing.

The serving entry points are ``prefill`` and ``decode_step`` (no autograd
graph); ``forward`` is shared with training, whose loss is ``lm_loss``
(cross-entropy, chunked when ``loss_chunk`` > 0, + the MoE aux, + the MTP
head).  Gradients flow once the parameters ask for them
(``model.requires_grad_(True)``, as ``train.optimizer.make_train_step``
does); they are created without.  Decode caches keep the reference's stacked
layout (a list over blocks of ``[L, B, S, ...]`` tensors,
``kvcache.init_cache``); ``decode_step`` writes the new position into them
in place and returns them.  With ``quantized=True`` the cache is MonaVec's
4-bit cache (``kvcache``), whose rotations run the Hadamard kernel.
"""

from __future__ import annotations

import dataclasses
import functools
from types import SimpleNamespace
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from .kvcache import KVSpec, init_cache, quant_attention_decode, quantize_kv
from .layers import (Dense, SwiGLU, apply_rope, attention_scores_mask, dense, gqa_attention,
                     model_device, normal, pop_matmul_out, push_matmul_out, rms_norm,
                     rope_angles, softcap, swiglu, zeros)
from .mla import MLA, MLAConfig, _project_kv_latent, _project_q, mla_attend
from .moe import MoE, MoEConfig, moe_ffn


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    rope_theta: float = 10000.0
    qkv_bias: bool = False                 # qwen1.5
    attn_softcap: float = 0.0              # gemma2: 50
    final_softcap: float = 0.0             # gemma2: 30
    window: int = 0                        # sliding-window size for local layers
    window_pattern: str = "none"           # "none" | "alternate" (gemma2)
    post_norms: bool = False               # gemma2 post-attn/post-ffn norms
    embed_scale: bool = False              # gemma2 multiplies embeds by sqrt(D)
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    mtp: bool = False                      # deepseek multi-token prediction
    mtp_weight: float = 0.3
    dtype: str = "bfloat16"
    remat: bool = True                     # recompute each layer in the backward pass
    remat_policy: str = "full"             # "full" | "dots" (keep mm / addmm outputs)
    loss_chunk: int = 0                    # chunked CE (training)
    unroll: bool = False                   # python-unrolled stack (no effect here)
    dp_axes: Optional[Tuple[str, ...]] = None  # sharding fields: no effect on one device
    act_shard: Optional[str] = None
    bf16_matmul: bool = False              # matmul outputs stay bf16 (layers._acc)
    attn_q_chunks: int = 1                 # query-block chunking (memory)
    attn_kv_shard: Optional[str] = None
    attn_seq_shard: Optional[str] = None
    attn_seq_axis: str = "kv"
    vocab_shard: Optional[str] = None

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def block_layout(self) -> List[Tuple[str, int]]:
        """Consecutive homogeneous (ffn_kind, n_layers) blocks."""
        if self.moe and self.moe.first_dense_layers:
            return [("dense", self.moe.first_dense_layers),
                    ("moe", self.n_layers - self.moe.first_dense_layers)]
        return [("moe" if self.moe else "dense", self.n_layers)]

    def layer_windows(self) -> np.ndarray:
        """Per-layer sliding-window sizes (0 = full attention)."""
        w = np.zeros(self.n_layers, dtype=np.int32)
        if self.window_pattern == "alternate":
            w[0::2] = self.window                 # even layers local (gemma2)
        elif self.window_pattern == "all":
            w[:] = self.window
        return w

    def param_count(self) -> int:
        """Total parameter count, counted on ``meta`` tensors (nothing allocated)."""
        model = Transformer(self, device="meta")
        return sum(p.numel() for p in model.parameters())

    def active_param_count(self) -> int:
        """Params touched per token (MoE: routed top-k + shared only)."""
        total = self.param_count()
        if not self.moe:
            return total
        m = self.moe
        n_moe_layers = self.n_layers - m.first_dense_layers
        per_expert = 3 * self.d_model * m.d_ff_expert
        return total - n_moe_layers * (m.n_experts - m.top_k) * per_expert


# ---------------------------------------------------------------------------
# Parameters.
# ---------------------------------------------------------------------------

class Attn(nn.Module):
    """``ln`` and ``q`` / ``k`` / ``v`` / ``o`` (GQA) or ``mla``; ``post_ln``."""

    def __init__(self, cfg: TransformerConfig, *, device, generator):
        super().__init__()
        dtype = cfg.torch_dtype
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.ln = zeros((cfg.d_model,), dtype, device)
        if cfg.mla:
            self.mla = MLA(cfg.d_model, cfg.n_heads, cfg.mla, **kw)
        else:
            h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
            self.q = Dense(cfg.d_model, h * dh, bias=cfg.qkv_bias, **kw)
            self.k = Dense(cfg.d_model, kv * dh, bias=cfg.qkv_bias, **kw)
            self.v = Dense(cfg.d_model, kv * dh, bias=cfg.qkv_bias, **kw)
            self.o = Dense(h * dh, cfg.d_model, **kw)
        if cfg.post_norms:
            self.post_ln = zeros((cfg.d_model,), dtype, device)


class Layer(nn.Module):
    """One decoder layer: ``attn``, ``ffn_ln``, ``ffn`` (SwiGLU or MoE),
    ``post_ffn_ln``."""

    def __init__(self, cfg: TransformerConfig, kind: str, *, device, generator):
        super().__init__()
        dtype = cfg.torch_dtype
        self.attn = Attn(cfg, device=device, generator=generator)
        self.ffn_ln = zeros((cfg.d_model,), dtype, device)
        if kind == "moe":
            self.ffn = MoE(cfg.d_model, cfg.moe, dtype=dtype, device=device, generator=generator)
        else:
            self.ffn = SwiGLU(cfg.d_model, cfg.d_ff, dtype=dtype, device=device,
                              generator=generator)
        if cfg.post_norms:
            self.post_ffn_ln = zeros((cfg.d_model,), dtype, device)


class MTP(nn.Module):
    """DeepSeek's depth-1 multi-token-prediction head (``lm_loss``)."""

    def __init__(self, cfg: TransformerConfig, *, device, generator):
        super().__init__()
        dtype = cfg.torch_dtype
        self.proj = Dense(2 * cfg.d_model, cfg.d_model, dtype=dtype, device=device,
                          generator=generator)
        self.layer = Layer(cfg, "dense", device=device, generator=generator)
        self.ln = zeros((cfg.d_model,), dtype, device)


class Transformer(nn.Module):
    """The reference's ``init_params``: ``embed`` [V, D], ``final_norm``, ``blocks`` (one
    ``ModuleList`` of layers per ``block_layout`` entry), ``lm_head`` when
    embeddings are untied, ``mtp`` when configured.  Parameters are drawn
    from ``generator`` on ``device`` (``meta``: shapes only)."""

    def __init__(self, cfg: TransformerConfig, generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        device = model_device(device)
        self.cfg = cfg
        dtype = cfg.torch_dtype
        kw = dict(device=device, generator=generator)
        self.embed = normal((cfg.vocab, cfg.d_model), 1.0 / np.sqrt(cfg.d_model), dtype,
                            device, generator)
        self.final_norm = zeros((cfg.d_model,), dtype, device)
        self.blocks = nn.ModuleList(nn.ModuleList(Layer(cfg, kind, **kw) for _ in range(n))
                                    for kind, n in cfg.block_layout())
        if not cfg.tie_embeddings:
            self.lm_head = Dense(cfg.d_model, cfg.vocab, dtype=dtype, **kw)
        if cfg.mtp:
            self.mtp = MTP(cfg, **kw)

    def forward(self, tokens: torch.Tensor, *, collect_cache: bool = False,
                skip_head: bool = False):
        return forward(self, self.cfg, tokens, collect_cache=collect_cache, skip_head=skip_head)


# ---------------------------------------------------------------------------
# Blocks (shared by prefill and decode).
# ---------------------------------------------------------------------------

def _attn_full(lp: Attn, x, positions, window: int, cfg: TransformerConfig):
    """Full-sequence self-attention sublayer.  Returns (out, kv): kv is
    (k, v) [B,S,KV,dh] for GQA or the latent [B,S,r+dr] for MLA."""
    h = rms_norm(x, lp.ln, cfg.norm_eps)
    mask = attention_scores_mask(positions, positions, window)
    b, s, _ = h.shape
    if cfg.mla:
        sin, cos = rope_angles(positions, cfg.mla.qk_rope_dim, cfg.rope_theta)
        q_nope, q_rope = _project_q(lp.mla, h, cfg.n_heads, cfg.mla, sin, cos)
        latent = _project_kv_latent(lp.mla, h, cfg.mla, sin, cos)
        out = mla_attend(lp.mla, q_nope, q_rope, latent, mask, n_heads=cfg.n_heads,
                         mla=cfg.mla, attn_softcap=cfg.attn_softcap,
                         q_chunks=cfg.attn_q_chunks).to(x.dtype)
        kv = latent
    else:
        hh, kvh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        sin, cos = rope_angles(positions, dh, cfg.rope_theta)
        q = dense(lp.q, h).reshape(b, s, hh, dh)
        k = dense(lp.k, h).reshape(b, s, kvh, dh)
        v = dense(lp.v, h).reshape(b, s, kvh, dh)
        q, k = apply_rope(q, sin, cos), apply_rope(k, sin, cos)
        out = gqa_attention(q, k, v, mask, scale=dh ** -0.5, attn_softcap=cfg.attn_softcap,
                            q_chunks=cfg.attn_q_chunks)
        out = dense(lp.o, out.reshape(b, s, hh * dh))
        kv = (k, v)
    if cfg.post_norms:
        out = rms_norm(out, lp.post_ln, cfg.norm_eps)
    return out, kv


def _ffn_sublayer(lp: Layer, x, kind: str, cfg: TransformerConfig):
    h = rms_norm(x, lp.ffn_ln, cfg.norm_eps)
    if kind == "moe":
        y, aux = moe_ffn(lp.ffn, h, cfg.moe)
    else:
        y, aux = swiglu(lp.ffn, h), torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.post_norms:
        y = rms_norm(y, lp.post_ffn_ln, cfg.norm_eps)
    return y, aux


def _layer_full(lp: Layer, x, positions, window: int, kind: str, cfg: TransformerConfig):
    a, kv = _attn_full(lp.attn, x, positions, window, cfg)
    x = x + a
    f, aux = _ffn_sublayer(lp, x, kind, cfg)
    return x + f, aux, kv


def _embed(params: Transformer, cfg: TransformerConfig, tokens: torch.Tensor) -> torch.Tensor:
    x = params.embed[tokens.long()]
    if cfg.embed_scale:
        # sqrt(D) rounded to the embedding's dtype, as a host scalar (no copy
        # to the device); its product with x is exact before x's rounding.
        x = x * float(torch.tensor(np.sqrt(cfg.d_model)).to(x.dtype))
    return x


# ---------------------------------------------------------------------------
# Forward and prefill.
# ---------------------------------------------------------------------------

def forward(params: Transformer, cfg: TransformerConfig, tokens: torch.Tensor, *,
            collect_cache: bool = False, skip_head: bool = False):
    """tokens [B, S] -> (logits [B,S,V] f32 | None, h_final, aux, caches | None).
    Builds an autograd graph only where parameters ask for gradients."""
    mm_out = cfg.torch_dtype if cfg.bf16_matmul else None
    prev = push_matmul_out(mm_out)
    try:
        return _forward_inner(params, cfg, tokens, collect_cache=collect_cache,
                              skip_head=skip_head, mm_out=mm_out)
    finally:
        pop_matmul_out(prev)


def _dots_policy(ctx, op, *args, **kwargs):
    """``dots_with_no_batch_dims_saveable``: keep plain matmuls, recompute the rest."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _layer_remat(lp, x, positions, window, kind, cfg, mm_out):
    """``_layer_full`` under the matmul policy of the forward that called it:
    the recomputation in the backward pass runs outside that forward."""
    prev = push_matmul_out(mm_out)
    try:
        return _layer_full(lp, x, positions, window, kind, cfg)
    finally:
        pop_matmul_out(prev)


def _wants_grad(params: nn.Module) -> bool:
    return torch.is_grad_enabled() and any(p.requires_grad for p in params.parameters())


def _forward_inner(params, cfg: TransformerConfig, tokens, *, collect_cache, skip_head,
                   mm_out=None):
    b, s = tokens.shape
    x = _embed(params, cfg, tokens)
    positions = torch.arange(s, dtype=torch.int32, device=x.device)
    windows = cfg.layer_windows()
    layer = _layer_full
    if cfg.remat and _wants_grad(params):
        kw = {}
        if cfg.remat_policy == "dots":
            kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                                 _dots_policy)
        layer = lambda *a: checkpoint(_layer_remat, *a, mm_out, use_reentrant=False, **kw)  # noqa: E731

    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    caches = []
    offset = 0
    for (kind, n), block in zip(cfg.block_layout(), params.blocks):
        kv_list = []
        for i, lp in enumerate(block):
            x, aux_i, kv_i = layer(lp, x, positions, int(windows[offset + i]), kind, cfg)
            aux_total = aux_total + aux_i
            if collect_cache:
                kv_list.append(kv_i)
        offset += n
        if collect_cache:
            if cfg.mla:
                caches.append(torch.stack(kv_list))
            else:
                caches.append((torch.stack([k for k, _ in kv_list]),
                               torch.stack([v for _, v in kv_list])))

    h_final = rms_norm(x, params.final_norm, cfg.norm_eps)
    logits = None if skip_head else _lm_head(params, cfg, h_final)
    return logits, h_final, aux_total, (caches if collect_cache else None)


def _lm_head(params: Transformer, cfg: TransformerConfig, h: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        logits = torch.matmul(h.to(torch.float32), params.embed.to(torch.float32).T)
    else:
        logits = dense(params.lm_head, h).to(torch.float32)
    if cfg.final_softcap > 0:
        logits = softcap(logits, cfg.final_softcap)
    return logits


# ---------------------------------------------------------------------------
# Losses (training).
# ---------------------------------------------------------------------------

def _xent(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy, f32."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    ll = torch.take_along_dim(logp, targets[..., None].long(), dim=-1)[..., 0]
    return -torch.mean(ll)


def _chunk_xent(params: Transformer, cfg: TransformerConfig, h: torch.Tensor,
                targets: torch.Tensor) -> torch.Tensor:
    return _xent(_lm_head(params, cfg, h), targets)


def _head_alias(params: Transformer, cfg: TransformerConfig) -> SimpleNamespace:
    """The head's weights, each behind a view of its own.  The full chunks'
    gradients meet at the view and are summed there, last chunk first, before
    the remainder's joins them: the order in which the reference's scan
    accumulates its chunks' cotangents and then adds the tail's (in bf16 the
    order shows in ~40% of the head's gradient elements)."""
    if cfg.tie_embeddings:
        return SimpleNamespace(embed=params.embed.view_as(params.embed))
    head = params.lm_head
    return SimpleNamespace(lm_head=SimpleNamespace(w=head.w.view_as(head.w), b=head.b))


def _xent_from_hidden(params: Transformer, cfg: TransformerConfig, h: torch.Tensor,
                      targets: torch.Tensor) -> torch.Tensor:
    """CE from final hidden states.  With ``cfg.loss_chunk`` > 0 the [B,S,V]
    f32 logits are never materialised: each full chunk's logits are
    recomputed in the backward pass (a checkpoint a chunk), the remainder
    (MTP's S-2 tail) taken as it is; each chunk's mean times its length,
    summed in order, over S, as the reference's scan (whose gradient order
    ``_head_alias`` keeps)."""
    s = h.shape[1]
    chunk = cfg.loss_chunk
    if chunk <= 0 or s <= chunk:
        return _xent(_lm_head(params, cfg, h), targets)
    n_chunks = s // chunk
    main = n_chunks * chunk
    grad = torch.is_grad_enabled() and h.requires_grad
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    head = _head_alias(params, cfg)
    for i in range(n_chunks):
        hc, tc = h[:, i * chunk:(i + 1) * chunk], targets[:, i * chunk:(i + 1) * chunk]
        xent = (checkpoint(_chunk_xent, head, cfg, hc, tc, use_reentrant=False) if grad
                else _chunk_xent(head, cfg, hc, tc))
        total = total + xent * chunk
    if main < s:
        total = total + _xent(_lm_head(params, cfg, h[:, main:]), targets[:, main:]) * (s - main)
    return total / s


def lm_loss(params: Transformer, cfg: TransformerConfig, tokens: torch.Tensor) -> torch.Tensor:
    """Causal LM loss (+ MoE aux, + the MTP head for deepseek)."""
    tokens = tokens.long()
    use_chunked = cfg.loss_chunk > 0
    if use_chunked:
        _, h_final, aux, _ = forward(params, cfg, tokens, skip_head=True)
        loss = _xent_from_hidden(params, cfg, h_final[:, :-1], tokens[:, 1:]) + aux
    else:
        logits, h_final, aux, _ = forward(params, cfg, tokens)
        loss = _xent(logits[:, :-1], tokens[:, 1:]) + aux
    if cfg.mtp:
        # Predict token t+2 from (h_t, embed(token_{t+1})) through one extra
        # layer sharing embeddings and the LM head (DeepSeek-V3 MTP, depth 1).
        emb_next = params.embed[tokens[:, 1:-1]]
        h_in = torch.cat([h_final[:, :-2], emb_next], dim=-1)
        h = dense(params.mtp.proj, h_in)
        pos = torch.arange(h.shape[1], dtype=torch.int32, device=h.device)
        h, _, _ = _layer_full(params.mtp.layer, h, pos, 0, "dense", cfg)
        h = rms_norm(h, params.mtp.ln, cfg.norm_eps)
        if use_chunked:
            mtp_xent = _xent_from_hidden(params, cfg, h, tokens[:, 2:])
        else:
            mtp_xent = _xent(_lm_head(params, cfg, h), tokens[:, 2:])
        loss = loss + cfg.mtp_weight * mtp_xent
    return loss


def prefill(params: Transformer, cfg: TransformerConfig, tokens: torch.Tensor, *,
            last_only: bool = False):
    """Full forward that also returns the per-block caches (``k`` / ``v``
    [L,B,S,KV,dh] or ``latent`` [L,B,S,C]).  last_only=True returns only the
    final position's logits [B, V]."""
    with torch.no_grad():
        logits, h_final, _, caches = forward(params, cfg, tokens, collect_cache=True,
                                             skip_head=last_only)
        if last_only:
            logits = _lm_head(params, cfg, h_final[:, -1:])[:, 0]
    out = []
    for kv in caches:
        if cfg.mla:
            out.append({"latent": kv})
        else:
            k, v = kv
            out.append({"k": k, "v": v})
    return logits, out


# ---------------------------------------------------------------------------
# Decode (one token against a KV cache).
# ---------------------------------------------------------------------------

def kv_spec(cfg: TransformerConfig, batch: int, max_len: int,
            quantized: bool = False) -> KVSpec:
    if cfg.mla:
        # Latent cache: one "head" of cache_dim per token.
        return KVSpec(batch=batch, max_len=max_len, n_kv_heads=1, head_dim=cfg.mla.cache_dim,
                      quantized=quantized, dtype=cfg.torch_dtype)
    return KVSpec(batch=batch, max_len=max_len, n_kv_heads=cfg.n_kv_heads,
                  head_dim=cfg.head_dim, quantized=quantized, dtype=cfg.torch_dtype)


def init_decode_cache(cfg: TransformerConfig, batch: int, max_len: int, *,
                      quantized: bool = False, device="cuda"):
    device = model_device(device)
    spec = kv_spec(cfg, batch, max_len, quantized)
    if cfg.mla:
        return [{"latent": torch.zeros((n, batch, max_len, cfg.mla.cache_dim),
                                       dtype=cfg.torch_dtype, device=device)}
                for _, n in cfg.block_layout()]
    return [init_cache(n, spec, device) for _, n in cfg.block_layout()]


def _attn_decode(lp: Attn, x, cache_layer: dict, cur_len: int, window: int,
                 cfg: TransformerConfig, spec: KVSpec):
    """One-token attention; writes position ``cur_len`` of ``cache_layer``
    (views into the stacked cache) and returns the sublayer's output."""
    b = x.shape[0]
    dev = x.device
    h = rms_norm(x, lp.ln, cfg.norm_eps)
    pos = torch.full((1,), cur_len, dtype=torch.int32, device=dev)
    kpos = torch.arange(spec.max_len, dtype=torch.int32, device=dev)
    valid = kpos[None, :] <= cur_len                     # [1, S]
    in_w = (cur_len - kpos[None, :]) < (window if window > 0 else 2 ** 30)
    mask = valid & in_w

    if cfg.mla:
        sin, cos = rope_angles(pos, cfg.mla.qk_rope_dim, cfg.rope_theta)
        q_nope, q_rope = _project_q(lp.mla, h, cfg.n_heads, cfg.mla, sin, cos)
        new_lat = _project_kv_latent(lp.mla, h, cfg.mla, sin, cos)     # [B,1,C]
        lat = cache_layer["latent"]
        lat[:, cur_len] = new_lat[:, 0].to(lat.dtype)
        out = mla_attend(lp.mla, q_nope, q_rope, lat, mask, n_heads=cfg.n_heads, mla=cfg.mla,
                         attn_softcap=cfg.attn_softcap).to(x.dtype)
    else:
        hh, kvh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        sin, cos = rope_angles(pos, dh, cfg.rope_theta)
        q = apply_rope(dense(lp.q, h).reshape(b, 1, hh, dh), sin, cos)
        k = apply_rope(dense(lp.k, h).reshape(b, 1, kvh, dh), sin, cos)
        v = dense(lp.v, h).reshape(b, 1, kvh, dh)
        if spec.quantized:
            kc, ks = quantize_kv(k, spec)
            vc, vs = quantize_kv(v, spec)
            cache_layer["k_codes"][:, cur_len] = kc[:, 0]
            cache_layer["v_codes"][:, cur_len] = vc[:, 0]
            cache_layer["k_scale"][:, cur_len] = ks[:, 0]
            cache_layer["v_scale"][:, cur_len] = vs[:, 0]
            out = quant_attention_decode(
                q, cache_layer["k_codes"], cache_layer["v_codes"], cache_layer["k_scale"],
                cache_layer["v_scale"], mask, spec, scale=dh ** -0.5,
                attn_softcap=cfg.attn_softcap)
        else:
            kf, vf = cache_layer["k"], cache_layer["v"]
            kf[:, cur_len] = k[:, 0].to(kf.dtype)
            vf[:, cur_len] = v[:, 0].to(vf.dtype)
            out = gqa_attention(q, kf, vf, mask, scale=dh ** -0.5,
                                attn_softcap=cfg.attn_softcap)
        out = dense(lp.o, out.reshape(b, 1, hh * dh))
    if cfg.post_norms:
        out = rms_norm(out, lp.post_ln, cfg.norm_eps)
    return out


def decode_step(params: Transformer, cfg: TransformerConfig, cache, tokens: torch.Tensor,
                cur_len, *, quantized: bool = False):
    """tokens [B, 1] + cache at length cur_len -> (logits [B, V] f32, cache).
    The new position is written into ``cache`` in place."""
    cur_len = int(cur_len)
    b = tokens.shape[0]
    spec = kv_spec(cfg, b, _cache_len(cache), quantized)
    windows = cfg.layer_windows()
    prev = push_matmul_out(cfg.torch_dtype if cfg.bf16_matmul else None)
    try:
        with torch.no_grad():
            x = _embed(params, cfg, tokens)
            offset = 0
            for (kind, n), block, cb in zip(cfg.block_layout(), params.blocks, cache):
                for i, lp in enumerate(block):
                    layer_cache = {name: t[i] for name, t in cb.items()}
                    a = _attn_decode(lp.attn, x, layer_cache, cur_len,
                                     int(windows[offset + i]), cfg, spec)
                    y = x + a
                    f, _ = _ffn_sublayer(lp, y, kind, cfg)
                    x = y + f
                offset += n
            h = rms_norm(x, params.final_norm, cfg.norm_eps)
            logits = _lm_head(params, cfg, h)[:, 0]
    finally:
        pop_matmul_out(prev)
    return logits, cache


def _cache_len(cache) -> int:
    return next(iter(cache[0].values())).shape[2]           # [L, B, S, ...]
