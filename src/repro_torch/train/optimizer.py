"""AdamW with global-norm clipping, configurable moment dtype, and optional
int8 error-feedback gradient compression (counterpart of
``repro/train/optimizer.py``).

Not ``torch.optim.AdamW``: its formula differs (it divides ``sqrt(v)`` by
``sqrt(bc2)``, decays weights by a separate multiply, has no global-norm
clip and no bf16 moments).  This is the reference's update, in f32:

    g  = g * min(1, clip_norm / max(|g|_global, 1e-12))
    m  = b1 m + (1 - b1) g;   v = b2 v + (1 - b2) g g
    p -= lr * ((m / bc1) / (sqrt(v / bc2) + eps) + wd * p)

with ``bc = 1 - b ** step`` in f32, and the results cast back to the
parameter's and the moments' dtypes (round to nearest even).

The parameters are a flat ``{name: tensor}`` (``nn.Module.named_parameters``)
and the state ``{"m", "v", "step"[, "ef"]}`` holds one tensor a name under
each moment, so it converts to the reference's tree as the parameters do
(``models.convert.reference_tree``).  ``adamw_update`` updates parameters
and state in place, leaf by leaf and in slices of ``UPDATE_SLICE``
elements, so a step's f32 temporaries stay a slice's (the tied embedding of
llama3.2-3b is [128,256 x 3,072]: 1.58 GB for each f32 copy); every element
sees the same operations either way.  A parameter without a gradient (a
buffer-like leaf such as MoE's ``router_bias``, which only selects experts)
takes a zero gradient, as ``jax.value_and_grad`` gives it: its moments
decay and weight decay still applies.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional, Tuple, Union

import torch
from torch import nn

#: Elements a slice of one leaf's update (its f32 temporaries: ~8 x 256 MiB).
UPDATE_SLICE = 1 << 26


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: float = 1.0
    moment_dtype: str = "float32"     # "bfloat16" for the biggest configs
    compress_grads: bool = False      # int8 + error feedback (see compress_int8)

    @property
    def torch_moment_dtype(self) -> torch.dtype:
        return getattr(torch, self.moment_dtype)


Params = Union[nn.Module, Mapping[str, torch.Tensor]]


def named_params(params: Params) -> Dict[str, torch.Tensor]:
    """``{name: tensor}`` of a module's parameters, or the mapping itself."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def init_opt_state(params: Params, cfg: AdamWConfig) -> dict:
    """Zero moments in ``cfg.moment_dtype`` (and an f32 error buffer with
    compression) beside each parameter, and ``step`` 0 (int32)."""
    params = named_params(params)
    dt = cfg.torch_moment_dtype

    def zeros(d):
        return {k: torch.zeros(p.shape, dtype=d, device=p.device) for k, p in params.items()}

    dev = next(iter(params.values())).device if params else torch.device("cpu")
    state = {"m": zeros(dt), "v": zeros(dt),
             "step": torch.zeros((), dtype=torch.int32, device=dev)}
    if cfg.compress_grads:
        state["ef"] = zeros(torch.float32)
    return state


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum over leaves (in order) of each leaf's sum of squares, f32."""
    return torch.sqrt(sum(torch.sum(torch.square(t.to(torch.float32))) for t in tensors))


def compress_int8(g: torch.Tensor, ef: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Error-feedback int8 quantization of one gradient tensor: returns
    (dequantized int8 gradient, new error buffer).  ``torch.round`` rounds
    half to even, as ``jnp.round``."""
    gf = g.to(torch.float32) + ef
    scale = torch.clamp(torch.max(torch.abs(gf)), min=1e-12) / _f32(127.0, gf)
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    deq = q.to(torch.float32) * scale
    return deq, gf - deq


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    """``x`` as a 0-d f32 tensor on ``like``'s device: a divisor or base that
    is a tensor keeps true division and ``pow`` on the card (a Python scalar
    divisor becomes a multiply by its reciprocal there)."""
    return torch.full((), x, dtype=torch.float32, device=like.device)


def _slices(t: torch.Tensor):
    flat = t.view(-1)
    for i in range(0, flat.numel(), UPDATE_SLICE):
        yield flat[i:i + UPDATE_SLICE]


@torch.no_grad()
def adamw_update(grads: Mapping[str, Optional[torch.Tensor]], state: dict, params: Params,
                 cfg: AdamWConfig):
    """One AdamW step, in place.  Returns (params, state, grad_norm): the
    same parameter tensors and state dict, updated; a missing or ``None``
    gradient is a zero one."""
    params = named_params(params)
    step = state["step"] + 1
    g_of = {k: grads.get(k) if grads.get(k) is not None else torch.zeros_like(p)
            for k, p in params.items()}
    if cfg.compress_grads:
        for k in params:
            g_of[k], ef = compress_int8(g_of[k], state["ef"][k])
            state["ef"][k].copy_(ef)

    gnorm = global_norm(g_of.values())
    clip = torch.clamp(_f32(cfg.clip_norm, gnorm) / torch.clamp(gnorm, min=1e-12), max=1.0)

    b1, b2 = cfg.b1, cfg.b2
    step_f = step.to(torch.float32)
    bc1 = 1.0 - _f32(b1, step_f) ** step_f
    bc2 = 1.0 - _f32(b2, step_f) ** step_f
    mdt = cfg.torch_moment_dtype
    for k, p in params.items():
        m, v = state["m"][k], state["v"][k]
        for ps, gs, ms, vs in zip(_slices(p.data), _slices(g_of[k].contiguous()),
                                  _slices(m), _slices(v)):
            g32 = gs.to(torch.float32) * clip
            m32 = b1 * ms.to(torch.float32) + (1 - b1) * g32
            v32 = b2 * vs.to(torch.float32) + (1 - b2) * g32 * g32
            mhat = m32 / bc1
            vhat = v32 / bc2
            p32 = ps.to(torch.float32)
            delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p32
            ps.copy_((p32 - cfg.lr * delta).to(ps.dtype))
            ms.copy_(m32.to(mdt))
            vs.copy_(v32.to(mdt))
    state["step"] = step
    return params, state, gnorm


def make_train_step(loss_fn: Callable, cfg: AdamWConfig):
    """``loss_fn(model, batch) -> scalar``.  Returns ``step(model, state,
    batch) -> (model, state, {"loss", "grad_norm"})``: gradients of every
    parameter (turned on here), then ``adamw_update``; gradients are freed
    after the update."""

    def step(model: nn.Module, state: dict, batch):
        model.requires_grad_(True)
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        loss = loss_fn(model, batch)
        loss.backward()
        grads = {k: p.grad for k, p in params.items()}
        _, state, gnorm = adamw_update(grads, state, params, cfg)
        for p in params.values():
            p.grad = None
        return model, state, {"loss": loss.detach(), "grad_norm": gnorm}

    return step
