"""Multi-head Latent Attention, DeepSeek-V2/V3 (counterpart of
``repro/models/mla.py``).

Queries and keys/values come through low-rank latents:
    q:  x -> W_dq [D, r_q] -> norm -> W_uq [r_q, H*(d_nope + d_rope)]
    kv: x -> W_dkv [D, r_kv + d_rope]; the r_kv latent is normed and expanded
        by W_uk (keys) / W_uv (values); the d_rope slice is one rope key
        shared across heads.

Attention runs in the absorbed form: W_uk folds into the query and W_uv
into the output, so scores and values are taken against the latent
[B, S, r_kv + d_rope] directly, which is also the decode cache.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from .layers import Dense, apply_rope, dense, rms_norm, rope_angles, softcap, zeros


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128

    @property
    def cache_dim(self) -> int:
        return self.kv_lora_rank + self.qk_rope_dim


class MLA(nn.Module):
    """``mla_init``'s parameters, named as its keys."""

    def __init__(self, d_model: int, n_heads: int, mla: MLAConfig, *, dtype=torch.float32,
                 device=None, generator=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        h = n_heads
        self.w_dq = Dense(d_model, mla.q_lora_rank, **kw)
        self.q_ln = zeros((mla.q_lora_rank,), dtype, device)
        self.w_uq = Dense(mla.q_lora_rank, h * (mla.qk_nope_dim + mla.qk_rope_dim), **kw)
        self.w_dkv = Dense(d_model, mla.kv_lora_rank + mla.qk_rope_dim, **kw)
        self.kv_ln = zeros((mla.kv_lora_rank,), dtype, device)
        self.w_uk = Dense(mla.kv_lora_rank, h * mla.qk_nope_dim, **kw)
        self.w_uv = Dense(mla.kv_lora_rank, h * mla.v_head_dim, **kw)
        self.w_o = Dense(h * mla.v_head_dim, d_model, **kw)


def _project_q(p: MLA, x, n_heads: int, mla: MLAConfig, sin, cos):
    """x [B,S,D] -> (q_nope [B,S,H,dn], q_rope [B,S,H,dr])."""
    b, s, _ = x.shape
    q_lat = rms_norm(dense(p.w_dq, x), p.q_ln)
    q = dense(p.w_uq, q_lat).reshape(b, s, n_heads, mla.qk_nope_dim + mla.qk_rope_dim)
    q_nope, q_rope = q[..., :mla.qk_nope_dim], q[..., mla.qk_nope_dim:]
    return q_nope, apply_rope(q_rope, sin, cos)


def _project_kv_latent(p: MLA, x, mla: MLAConfig, sin, cos):
    """x [B,S,D] -> latent cache rows [B,S,r_kv + d_rope] (normed + roped)."""
    lat = dense(p.w_dkv, x)
    c_kv = rms_norm(lat[..., :mla.kv_lora_rank], p.kv_ln)
    k_rope = lat[..., mla.kv_lora_rank:][:, :, None, :]          # [B,S,1,dr]
    k_rope = apply_rope(k_rope, sin, cos)[:, :, 0, :]
    return torch.cat([c_kv, k_rope], dim=-1)


def mla_attention(p: MLA, x: torch.Tensor, positions: torch.Tensor, mask: torch.Tensor, *,
                  n_heads: int, mla: MLAConfig, rope_theta: float,
                  attn_softcap: float = 0.0) -> torch.Tensor:
    """Full-sequence MLA; absorbed scoring against the latent."""
    sin, cos = rope_angles(positions, mla.qk_rope_dim, rope_theta)
    q_nope, q_rope = _project_q(p, x, n_heads, mla, sin, cos)
    cache = _project_kv_latent(p, x, mla, sin, cos)
    return mla_attend(p, q_nope, q_rope, cache, mask, n_heads=n_heads, mla=mla,
                      attn_softcap=attn_softcap).to(x.dtype)


def mla_attend(p: MLA, q_nope: torch.Tensor, q_rope: torch.Tensor, cache: torch.Tensor,
               mask: torch.Tensor, *, n_heads: int, mla: MLAConfig, attn_softcap: float = 0.0,
               logits_spec=None, q_chunks: int = 1) -> torch.Tensor:
    """Absorbed-matmul attention against the latent cache -> [B, Sq, D].
    ``q_chunks`` > 1 runs query blocks one after another; ``logits_spec`` is
    the reference's sharding, nothing on one device."""
    sq = q_nope.shape[1]
    if q_chunks > 1 and sq % q_chunks == 0 and sq > 1:
        qc = sq // q_chunks
        return torch.cat([_mla_attend_core(p, q_nope[:, i * qc:(i + 1) * qc],
                                           q_rope[:, i * qc:(i + 1) * qc], cache,
                                           mask[..., i * qc:(i + 1) * qc, :], n_heads=n_heads,
                                           mla=mla, attn_softcap=attn_softcap)
                          for i in range(q_chunks)], dim=1)
    return _mla_attend_core(p, q_nope, q_rope, cache, mask, n_heads=n_heads, mla=mla,
                            attn_softcap=attn_softcap)


def _mla_attend_core(p: MLA, q_nope, q_rope, cache, mask, *, n_heads, mla: MLAConfig,
                     attn_softcap=0.0) -> torch.Tensor:
    f32 = torch.float32
    r = mla.kv_lora_rank
    c_kv, k_rope = cache[..., :r], cache[..., r:]
    b, sq, h, dn = q_nope.shape

    # Absorb W_uk into the query: q_lat[b,s,h,r] = q_nope . W_uk_head^T
    w_uk = p.w_uk.w.reshape(r, h, dn)
    q_lat = torch.einsum("bshd,rhd->bshr", q_nope.to(f32), w_uk.to(f32))
    logits = torch.einsum("bshr,btr->bhst", q_lat, c_kv.to(f32))
    logits = logits + torch.einsum("bshd,btd->bhst", q_rope.to(f32), k_rope.to(f32))
    logits = logits * (1.0 / np.sqrt(mla.qk_nope_dim + mla.qk_rope_dim))
    if attn_softcap > 0:
        logits = softcap(logits, attn_softcap)
    m = mask[None, None] if mask.dim() == 2 else mask[:, None]
    logits = logits.masked_fill(~m, -1e30)
    probs = torch.softmax(logits, dim=-1)

    # Attend in latent space, then expand with W_uv (absorbed on the output).
    lat_out = torch.einsum("bhst,btr->bshr", probs.to(c_kv.dtype).to(f32), c_kv.to(f32))
    w_uv = p.w_uv.w.reshape(r, h, mla.v_head_dim)
    out = torch.einsum("bshr,rhd->bshd", lat_out.to(c_kv.dtype).to(f32), w_uv.to(f32))
    out = out.reshape(b, sq, h * mla.v_head_dim)
    return dense(p.w_o, out.to(c_kv.dtype))
