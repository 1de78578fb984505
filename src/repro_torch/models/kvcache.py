"""KV caches for decode, including the MonaVec-quantized variant (counterpart
of ``repro/models/kvcache.py``).

The quantized cache applies the paper's own pipeline to attention KV state: a
seeded Hadamard rotation conditions each head vector, a per-vector scale
normalises it to ~N(0,1) coordinates, and the frozen 4-bit Lloyd-Max table
quantizes.  The query stays full precision; only the cached side is 4-bit.

The rotation is ``kernels.hadamard.signed_fwht`` over rows of the head dim:
the butterfly kernel (``csrc/hadamard.cu``) for a CUDA tensor, the
reference's Kronecker product on the CPU.  A decode step rotates the new key,
the new value and the query, and unrotates the attended value once: four
launches per layer.  With z = H D k (unnormalised), <H D q, H D k> = d' <q, k>,
so logits are computed in rotated space and scaled by 1/d'; the value path
accumulates in rotated space and unrotates once per output token.  The
logits and value products over dequantized rows are matmuls, as the
reference's einsums are.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch

from ..core import lloydmax
from ..core.quantize import pack_4bit, unpack_4bit
from ..core.rhdh import next_pow2, rademacher_signs
from ..kernels import hadamard


@dataclasses.dataclass(frozen=True)
class KVSpec:
    batch: int
    max_len: int
    n_kv_heads: int
    head_dim: int
    quantized: bool = False
    dtype: torch.dtype = torch.bfloat16
    seed: int = 0x6B76            # "kv": rotation seed (deterministic)


def init_cache(n_layers: int, spec: KVSpec, device="cpu"):
    """Stacked-over-layers cache: ``k`` / ``v`` [L, B, S, KV, dh] in the
    spec's dtype, or the 4-bit ``k_codes`` / ``v_codes`` [L, B, S, KV, d'/2]
    u8 with ``k_scale`` / ``v_scale`` [L, B, S, KV] f32."""
    b, s, kv, dh = spec.batch, spec.max_len, spec.n_kv_heads, spec.head_dim
    if not spec.quantized:
        return {"k": torch.zeros((n_layers, b, s, kv, dh), dtype=spec.dtype, device=device),
                "v": torch.zeros((n_layers, b, s, kv, dh), dtype=spec.dtype, device=device)}
    dp = next_pow2(dh)
    return {
        "k_codes": torch.zeros((n_layers, b, s, kv, dp // 2), dtype=torch.uint8, device=device),
        "v_codes": torch.zeros((n_layers, b, s, kv, dp // 2), dtype=torch.uint8, device=device),
        "k_scale": torch.zeros((n_layers, b, s, kv), dtype=torch.float32, device=device),
        "v_scale": torch.zeros((n_layers, b, s, kv), dtype=torch.float32, device=device),
    }


@functools.lru_cache(maxsize=16)
def _ones(d_pad: int, device: torch.device) -> torch.Tensor:
    # The unrotation's sign vector (the kernel multiplies by it); read only.
    return torch.ones(d_pad, dtype=torch.float32, device=device)


def _rotate(x: torch.Tensor, spec: KVSpec) -> torch.Tensor:
    """Unnormalised seeded Hadamard rotation over the head dim:
    ``H (pad(x) * signs)`` in f32, [..., dh] -> [..., d']."""
    dp = next_pow2(spec.head_dim)
    signs = rademacher_signs(spec.seed, dp, x.device)
    return hadamard.signed_fwht(x.to(torch.float32), signs, dp)


def _unrotate(z: torch.Tensor, spec: KVSpec) -> torch.Tensor:
    """``H z * (1/d') * signs`` cut to the head dim.  H z is the kernel with an
    all-ones sign vector; 1/d' is a power of two and the signs are ±1, so the
    two multiplies after it round nothing."""
    dp = z.shape[-1]
    signs = rademacher_signs(spec.seed, dp, z.device)
    x = hadamard.signed_fwht(z, _ones(dp, z.device), dp) * np.float32(1.0 / dp) * signs
    return x[..., :spec.head_dim]


def quantize_kv(x: torch.Tensor, spec: KVSpec) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., dh] -> (codes [..., d'/2] u8, scale [...] f32): MonaVec 4-bit."""
    z = _rotate(x, spec)
    dp = z.shape[-1]
    scale = torch.linalg.vector_norm(z, dim=-1) / np.float32(np.sqrt(dp))
    zn = z / torch.clamp(scale[..., None], min=1e-12)
    codes = lloydmax.quantize(zn, 4)
    return pack_4bit(codes), scale


def dequantize_k_rotated(codes: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """codes -> rotated-space f32 rows (for logits; no unrotation needed)."""
    deq = lloydmax.dequantize(unpack_4bit(codes), 4)
    return deq * scale[..., None]


def quant_attention_decode(
    q: torch.Tensor,                # [B, 1, H, dh] f32/bf16 (full precision)
    k_codes: torch.Tensor,          # [B, S, KV, d'/2] u8
    v_codes: torch.Tensor,
    k_scale: torch.Tensor,          # [B, S, KV]
    v_scale: torch.Tensor,
    mask: torch.Tensor,             # [1, S] or [B, 1, S] bool
    spec: KVSpec,
    *,
    scale: float,
    attn_softcap: float = 0.0,
) -> torch.Tensor:
    """Asymmetric decode attention against the 4-bit cache -> [B, 1, H, dh]."""
    b, _, h, dh = q.shape
    kv = k_codes.shape[2]
    g = h // kv
    dp = next_pow2(dh)

    q_rot = _rotate(q, spec)                                    # [B,1,H,d']
    k_deq = dequantize_k_rotated(k_codes, k_scale)              # [B,S,KV,d']
    qg = q_rot.reshape(b, 1, kv, g, dp)
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k_deq)
    logits = logits * (scale / dp)                              # undo the d' factor
    if attn_softcap > 0:
        logits = attn_softcap * torch.tanh(logits / attn_softcap)
    # The reference's two mask forms, both to [B|1, 1, 1, 1, S].
    m = mask[:, None, None] if mask.dim() == 2 else mask[:, None, None, 0][..., None, :]
    if m.dim() == 4:
        m = m[:, :, :, None, :]
    logits = logits.masked_fill(~m, -1e30)
    probs = torch.softmax(logits, dim=-1)

    v_deq = dequantize_k_rotated(v_codes, v_scale)              # rotated values
    out_rot = torch.einsum("bkgst,btkd->bskgd", probs, v_deq)
    out = _unrotate(out_rot, spec)                              # one unrotation
    return out.reshape(b, 1, h, dh).to(q.dtype)
