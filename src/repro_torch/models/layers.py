"""Shared neural-net layers (counterpart of ``repro/models/layers.py``).

Parameters live in ``nn.Module``s whose attribute names are the reference's
dict keys (``Dense.w`` / ``Dense.b``, ``SwiGLU.gate`` / ``up`` / ``down``);
the layers themselves are plain functions over those modules and tensors, as
in the reference.  Every initialisation takes an explicit device and an
explicit ``torch.Generator``; on the ``meta`` device nothing is drawn (the
shape-only form that ``convert.from_reference_params`` fills and
``TransformerConfig.param_count`` counts).

Matmuls follow the reference's accumulation rule (``_acc``): an f32 result
unless ``push_matmul_out`` set the input's own dtype.  A bf16 ``dense``
without a bias is one bf16 matmul (f32 accumulation inside, one rounding of
its output, as the reference's f32 einsum cast back to bf16); with a bias the
operands go to f32 first and the sum is rounded once, after the bias, as
there.  Wherever else the reference keeps an f32 einsum output (attention
logits, probabilities times values, MoE experts, tied LM head) the operands
go to f32 first, so the products are exact.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device


def model_device(device) -> torch.device:
    """``resolve_device``, plus ``meta`` for shape-only modules."""
    dev = torch.device(device)
    return dev if dev.type == "meta" else resolve_device(dev)


def normal(shape: Sequence[int], scale: float, dtype: torch.dtype, device: torch.device,
           generator: Optional[torch.Generator]) -> nn.Parameter:
    """``(N(0, 1) * scale).astype(dtype)`` drawn from ``generator`` on ``device``
    (uninitialised on ``meta``)."""
    if device.type == "meta":
        t = torch.empty(tuple(shape), dtype=dtype, device=device)
    else:
        if generator is None:
            raise ValueError("initialising parameters needs an explicit torch.Generator")
        t = (torch.randn(tuple(shape), generator=generator, device=device,
                         dtype=torch.float32) * np.float32(scale)).to(dtype)
    return nn.Parameter(t, requires_grad=False)


def zeros(shape: Sequence[int], dtype: torch.dtype, device: torch.device) -> nn.Parameter:
    return nn.Parameter(torch.zeros(tuple(shape), dtype=dtype, device=device),
                        requires_grad=False)


def wsc(x: torch.Tensor, *spec) -> torch.Tensor:
    """The reference's ``with_sharding_constraint``: the identity on one device."""
    return x


# Matmul output dtype policy (the reference's ``_MATMUL_OUT``): None -> f32
# results; a dtype -> matmuls on inputs of that dtype keep it.
_MATMUL_OUT = [None]


def push_matmul_out(dtype):
    prev = _MATMUL_OUT[0]
    _MATMUL_OUT[0] = dtype
    return prev


def pop_matmul_out(prev):
    _MATMUL_OUT[0] = prev


def _acc(x_dtype: torch.dtype) -> torch.dtype:
    out = _MATMUL_OUT[0]
    if out is not None and x_dtype == out:
        return out
    return torch.float32


class Dense(nn.Module):
    """``dense_init``: ``w`` [d_in, d_out] ~ N(0, scale^2), optional zero ``b``."""

    def __init__(self, d_in: int, d_out: int, *, bias: bool = False,
                 dtype: torch.dtype = torch.float32, device=None, generator=None,
                 scale: Optional[float] = None):
        super().__init__()
        scale = scale if scale is not None else 1.0 / np.sqrt(d_in)
        self.w = normal((d_in, d_out), scale, dtype, device, generator)
        self.b = zeros((d_out,), dtype, device) if bias else None


def dense(p: Dense, x: torch.Tensor) -> torch.Tensor:
    if p.b is None:
        return torch.matmul(x, p.w)     # one rounding of the accumulation, as astype(x.dtype)
    acc = _acc(x.dtype)
    y = torch.matmul(x.to(acc), p.w.to(acc)) + p.b.to(acc)
    return y.to(x.dtype)


def mlp_init(dims: Tuple[int, ...], *, bias: bool = True, dtype=torch.float32, device=None,
             generator=None) -> nn.ModuleList:
    return nn.ModuleList(Dense(dims[i], dims[i + 1], bias=bias, dtype=dtype, device=device,
                               generator=generator) for i in range(len(dims) - 1))


def mlp(params: nn.ModuleList, x: torch.Tensor, *, act=F.relu, final_act=None) -> torch.Tensor:
    for i, p in enumerate(params):
        x = dense(p, x)
        if i < len(params) - 1:
            x = act(x)
        elif final_act is not None:
            x = final_act(x)
    return x


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``x / rms(x) * (1 + w)``, computed in f32 (Gemma's zero-centred scale)."""
    dt = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + np.float32(eps))) * (1.0 + w.to(torch.float32))).to(dt)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma-2 logit soft-capping: cap * tanh(x / cap)."""
    return cap * torch.tanh(x / cap)


# ---------------------------------------------------------------------------
# Rotary position embeddings.
# ---------------------------------------------------------------------------

def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions [...,] -> (sin, cos) of shape [..., head_dim/2], f32."""
    half = head_dim // 2
    exponent = torch.arange(half, dtype=torch.float32, device=positions.device) / half
    freq = 1.0 / (float(theta) ** exponent)      # no host-to-device copy (a decode step's sync)
    ang = positions.to(torch.float32)[..., None] * freq
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    """x [..., S, H, dh]; sin/cos [..., S, dh/2] (broadcast over heads)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    s, c = sin[..., None, :], cos[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# GQA attention core: explicit matmuls and an f32 softmax, as the reference.
# ---------------------------------------------------------------------------

def attention_scores_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, window: int) -> torch.Tensor:
    """Boolean [Sq, Sk] mask: causal, windowed when ``window`` > 0."""
    causal = q_pos[:, None] >= k_pos[None, :]
    w = int(window) if int(window) > 0 else 2 ** 30
    in_window = (q_pos[:, None] - k_pos[None, :]) < w
    return causal & in_window


def _gqa_core(q, k, v, mask, scale, attn_softcap):
    b, sq, h, dh = q.shape
    kv = k.shape[2]
    g = h // kv
    qg = q.reshape(b, sq, kv, g, dh).to(torch.float32)
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k.to(torch.float32))
    logits = logits * scale
    if attn_softcap > 0:
        logits = softcap(logits, attn_softcap)
    m = mask[None, None, None] if mask.dim() == 2 else mask[:, None, None]
    logits = logits.masked_fill(~m, -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs.to(v.dtype).to(torch.float32),
                       v.to(torch.float32))
    return out.reshape(b, sq, h, dh).to(q.dtype)


def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor, *,
                  scale: float, attn_softcap: float = 0.0, logits_spec=None,
                  q_chunks: int = 1) -> torch.Tensor:
    """Grouped-query attention; q [B, Sq, H, dh], k / v [B, Sk, KV, dh], mask
    [Sq, Sk] or [B, Sq, Sk] bool -> [B, Sq, H, dh].  Softmax in f32, masked
    logits -1e30.  ``q_chunks`` > 1 runs query blocks one after another (peak
    memory of the score tile over ``q_chunks``); ``logits_spec`` is the
    reference's sharding of the score tile, nothing on one device."""
    sq = q.shape[1]
    if q_chunks <= 1 or sq % q_chunks != 0 or sq == 1:
        return _gqa_core(q, k, v, mask, scale, attn_softcap)
    qc = sq // q_chunks
    return torch.cat([_gqa_core(q[:, i * qc:(i + 1) * qc], k, v,
                                mask[..., i * qc:(i + 1) * qc, :], scale, attn_softcap)
                      for i in range(q_chunks)], dim=1)


class SwiGLU(nn.Module):
    """``swiglu_init``: gate / up [d_model, d_ff], down [d_ff, d_model]."""

    def __init__(self, d_model: int, d_ff: int, *, dtype=torch.float32, device=None,
                 generator=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.gate = Dense(d_model, d_ff, **kw)
        self.up = Dense(d_model, d_ff, **kw)
        self.down = Dense(d_ff, d_model, **kw)


def swiglu(p: SwiGLU, x: torch.Tensor) -> torch.Tensor:
    """Gated FFN: silu(x W_g) * (x W_u) W_d (LLaMA/Gemma/Qwen style)."""
    gate = dense(p.gate, x)
    up = dense(p.up, x)
    return dense(p.down, F.silu(gate) * up)
