"""Mixture-of-Experts FFN, DeepSeek-V3 / OLMoE style (counterpart of
``repro/models/moe.py``).

Routing:
  * ``softmax`` (OLMoE): top-k over softmax probs, renormalised, with the
    Switch load-balance aux loss;
  * ``sigmoid`` (DeepSeek-V3 aux-loss-free): top-k over sigmoid scores plus a
    per-expert bias buffer; combine weights are the normalised unbiased scores.
The top-k is ``core.scoring.topk`` (a stable descending sort): among equal
scores the lower expert wins, as with ``lax.top_k``.

Dispatch keeps the reference's per-group capacity C = ceil(S k / E * cf):
each batch row ranks its (token, choice) slots by a stable sort of expert
ids, and the first C slots of each expert are kept.  Nothing is added with
float atomics, so a forward gives the same bytes every run on the card: the
[B, E, C, D] buffer is a gather (each kept slot is written once), and the
combine gathers each token's k slot outputs to [B, S, k, D] and adds them in
the order the reference's scatter-add does (ascending expert).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.scoring import topk
from .layers import Dense, SwiGLU, _acc, normal, swiglu, zeros


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0
    router: str = "softmax"          # "softmax" | "sigmoid" (aux-free)
    capacity_factor: float = 1.25
    first_dense_layers: int = 0      # leading dense-FFN layers (DeepSeek-V3: 3)
    router_aux_weight: float = 0.01  # load-balance aux loss (softmax router)
    dp_axes: Optional[Tuple[str, ...]] = None  # dispatch-buffer batch sharding (one device: unused)
    ep_axis: Optional[str] = None              # expert-parallel mesh axis (one device: unused)


class MoE(nn.Module):
    """``moe_init``'s parameters: an f32 router and bias, stacked experts
    ``w_gate`` / ``w_up`` [E, D, F] and ``w_down`` [E, F, D], and the shared
    SwiGLU expert when ``n_shared`` > 0."""

    def __init__(self, d_model: int, mcfg: MoEConfig, *, dtype=torch.float32, device=None,
                 generator=None):
        super().__init__()
        e, f = mcfg.n_experts, mcfg.d_ff_expert
        scale = 1.0 / np.sqrt(d_model)
        self.router = Dense(d_model, e, dtype=torch.float32, device=device, generator=generator)
        self.router_bias = zeros((e,), torch.float32, device)
        self.w_gate = normal((e, d_model, f), scale, dtype, device, generator)
        self.w_up = normal((e, d_model, f), scale, dtype, device, generator)
        self.w_down = normal((e, f, d_model), 1.0 / np.sqrt(f), dtype, device, generator)
        self.shared = (SwiGLU(d_model, mcfg.d_ff_expert * mcfg.n_shared, dtype=dtype,
                              device=device, generator=generator) if mcfg.n_shared else None)


def route(x: torch.Tensor, p: MoE,
          mcfg: MoEConfig) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x [T, D] -> (top_idx [T, k] i64, weights [T, k] f32, aux_loss scalar)."""
    logits = torch.matmul(x.to(torch.float32), p.router.w)
    if mcfg.router == "sigmoid":
        scores = torch.sigmoid(logits)
        sel_scores = scores + p.router_bias[None, :]           # bias only selects
        _, top_idx = topk(sel_scores, mcfg.top_k)
        picked = torch.gather(scores, 1, top_idx)
        weights = picked / torch.clamp(picked.sum(dim=1, keepdim=True), min=1e-9)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)   # aux-loss-free
    else:
        probs = torch.softmax(logits, dim=-1)
        _, top_idx = topk(probs, mcfg.top_k)
        picked = torch.gather(probs, 1, top_idx)
        weights = picked / torch.clamp(picked.sum(dim=1, keepdim=True), min=1e-9)
        # Switch-style load-balance loss: E * sum_e f_e * p_e.
        t, e = x.shape[0], mcfg.n_experts
        counts = F.one_hot(top_idx.reshape(-1), e).sum(dim=0).to(torch.float32)
        f_e = counts / np.float32(t * mcfg.top_k)
        p_e = probs.mean(dim=0)
        aux = mcfg.router_aux_weight * e * torch.sum(f_e * p_e)
    return top_idx, weights, aux


def dispatch_slots(top_idx: torch.Tensor, e: int, cap: int) -> dict:
    """Per-group slotting of top_idx [B, S*k]: a stable sort of expert ids per
    row (``sorted_e``, ``order``), each expert's first sorted position and
    count (``starts``, ``counts`` [B, E]), each sorted entry's rank in its
    expert (``slot``) and whether it fits the capacity (``keep``)."""
    b, n = top_idx.shape
    dev = top_idx.device
    sorted_e, order = torch.sort(top_idx, dim=1, stable=True)
    experts = torch.arange(e, device=dev).expand(b, e).contiguous()
    starts = torch.searchsorted(sorted_e, experts)
    counts = torch.searchsorted(sorted_e, experts, right=True) - starts
    slot = torch.arange(n, device=dev)[None, :] - torch.gather(starts, 1, sorted_e)
    return {"sorted_e": sorted_e, "order": order, "starts": starts, "counts": counts,
            "slot": slot, "keep": slot < cap}


def moe_ffn(p: MoE, x: torch.Tensor, mcfg: MoEConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, D] -> (y [B, S, D], aux_loss).  Group-wise dispatch: each batch
    row slots its own tokens at capacity C = ceil(S * top_k / E * cf)."""
    b, s, d = x.shape
    e, k = mcfg.n_experts, mcfg.top_k
    cap = max(1, int(np.ceil(s * k / e * mcfg.capacity_factor)))
    dev = x.device

    top_idx, weights, aux = route(x.reshape(b * s, d), p, mcfg)
    top_idx = top_idx.reshape(b, s * k)                            # [B, S*k]
    weights = weights.reshape(b, s * k)

    slots = dispatch_slots(top_idx, e, cap)
    sorted_e, order, starts, counts, slot, keep = (
        slots[n] for n in ("sorted_e", "order", "starts", "counts", "slot", "keep"))
    token_of = order // k                                          # [B, S*k]

    # --- Dispatch: buffer cell (e, c) is the expert's c-th slot, if kept. ---
    c_idx = torch.arange(cap, device=dev)
    src = (starts[:, :, None] + c_idx).clamp(max=s * k - 1)        # [B, E, C]
    filled = c_idx < counts[:, :, None]
    tok = torch.gather(token_of, 1, src.reshape(b, e * cap))       # [B, E*C]
    b_idx = torch.arange(b, device=dev)[:, None]
    xd = x[b_idx, tok].reshape(b, e, cap, d)
    xd = torch.where(filled[..., None], xd, torch.zeros((), dtype=x.dtype, device=dev))

    # --- Expert compute (batched matmuls; gated SwiGLU). ---
    # The reference's einsums have an ``acc`` (f32) output: the operands go
    # to ``acc`` first, so silu(gate) * up and the combine see unrounded
    # products, as there.
    acc = _acc(x.dtype)
    gate = torch.einsum("gecd,edf->gecf", xd.to(acc), p.w_gate.to(acc))
    up = torch.einsum("gecd,edf->gecf", xd.to(acc), p.w_up.to(acc))
    h = (F.silu(gate) * up).to(x.dtype)
    y = torch.einsum("gecf,efd->gecd", h.to(acc), p.w_down.to(acc))  # [B, E, C, D]

    # --- Combine: each slot's weighted output, then per token in slot order. ---
    w_sorted = torch.gather(weights, 1, order)
    vals = y[b_idx, sorted_e, slot.clamp(max=cap - 1)]             # [B, S*k, D]
    vals = vals * torch.where(keep, w_sorted, torch.zeros((), device=dev))[..., None]
    inv = torch.argsort(order, dim=1)                              # (token, choice) -> slot
    pos, _ = torch.sort(inv.reshape(b, s, k), dim=-1)              # ascending expert
    per_tok = vals[b_idx[:, :, None], pos]                         # [B, S, k, D]
    out = per_tok[:, :, 0].to(torch.float32)
    for j in range(1, k):
        out = out + per_tok[:, :, j]

    if mcfg.n_shared:
        out = out + swiglu(p.shared, x.reshape(b * s, d)).reshape(b, s, d).to(torch.float32)
    return out.to(x.dtype), aux
