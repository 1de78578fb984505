"""Training loop with checkpoint/restart, failure injection, and straggler
accounting (counterpart of ``repro/train/loop.py``).

Fault tolerance is across steps:
  * checkpoint every ``ckpt_every`` steps (atomic, keep-k);
  * on (re)start, resume from the newest complete checkpoint: the counter
    based data pipeline (``batch_fn(step)``) replays the exact batch
    sequence, so the continuation is bit for bit the uninterrupted run's;
  * ``simulate_failure_at`` stops the loop mid-run (the crash -> restore ->
    bitwise-identical continuation check);
  * a step-time watchdog records stragglers (steps slower than
    ``straggler_factor`` x the running median, once 8 steps are in).

``init_params_fn()`` returns the model (an ``nn.Module`` on its device),
``loss_fn(model, batch)`` a scalar.  A checkpoint holds ``{"params",
"opt"}`` in the reference's tree layout (``models.convert.reference_tree``),
so either package's files restore here.  The loss of each step is read
back to the host (``float``), one sync a step, as in the reference.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, List, Optional

import numpy as np
import torch
from torch import nn

from ..models.convert import reference_tree, state_dict_of
from .checkpoint import CheckpointManager
from .optimizer import AdamWConfig, init_opt_state, make_train_step


class SimulatedFailure(RuntimeError):
    pass


@dataclasses.dataclass
class TrainResult:
    params: Any
    opt_state: Any
    losses: List[float]
    start_step: int
    end_step: int
    straggler_steps: List[int]


def _host_stack(tensors) -> torch.Tensor:
    """Stack a block's layers on the host (a checkpoint's leaves go there)."""
    return torch.stack([t.detach().cpu() for t in tensors])


def checkpoint_tree(model: nn.Module, opt_state: dict) -> dict:
    """``{"params", "opt"}`` in the reference's layout (blocks stacked on the host)."""
    opt = {k: reference_tree(v, _host_stack) if isinstance(v, dict) else v
           for k, v in opt_state.items()}
    params = reference_tree({k: p.detach() for k, p in model.named_parameters()}, _host_stack)
    return {"params": params, "opt": opt}


def load_checkpoint_tree(model: nn.Module, tree: dict) -> dict:
    """Copy ``tree["params"]`` into ``model`` and return the optimizer state
    of ``tree["opt"]`` on the model's device, keyed by parameter name."""
    dev = next(model.parameters()).device
    model.load_state_dict(state_dict_of(tree["params"]), strict=True)
    return {k: ({n: t.to(dev) for n, t in state_dict_of(v).items()} if isinstance(v, (dict, list))
                else v.to(dev))
            for k, v in tree["opt"].items()}


def train(
    *,
    loss_fn: Callable[[nn.Module, Any], torch.Tensor],
    init_params_fn: Callable[[], nn.Module],
    batch_fn: Callable[[int], Any],          # step -> batch (counter-based)
    n_steps: int,
    opt_cfg: AdamWConfig = AdamWConfig(),
    ckpt: Optional[CheckpointManager] = None,
    ckpt_every: int = 50,
    simulate_failure_at: Optional[int] = None,
    straggler_factor: float = 3.0,
) -> TrainResult:
    """Train ``n_steps`` from the newest checkpoint (or from
    ``init_params_fn()``), then save step ``n_steps`` (unless the last step
    just saved it: the same files)."""
    step_fn = make_train_step(loss_fn, opt_cfg)

    start_step = 0
    model = init_params_fn()
    opt_state = None
    if ckpt is not None and ckpt.latest_step() is not None:
        restored, manifest = ckpt.restore()
        opt_state = load_checkpoint_tree(model, restored)
        start_step = manifest["step"]
    if opt_state is None:
        opt_state = init_opt_state(model, opt_cfg)

    losses: List[float] = []
    stragglers: List[int] = []
    durations: List[float] = []
    for step in range(start_step, n_steps):
        if simulate_failure_at is not None and step == simulate_failure_at:
            raise SimulatedFailure(f"injected failure at step {step}")
        t0 = time.monotonic()
        batch = batch_fn(step)
        model, opt_state, metrics = step_fn(model, opt_state, batch)
        losses.append(float(metrics["loss"]))
        dt = time.monotonic() - t0
        durations.append(dt)
        if len(durations) >= 8 and dt > straggler_factor * float(np.median(durations)):
            stragglers.append(step)
        if ckpt is not None and (step + 1) % ckpt_every == 0:
            ckpt.save(step + 1, checkpoint_tree(model, opt_state))
    if ckpt is not None and n_steps > start_step and n_steps % ckpt_every:
        ckpt.save(n_steps, checkpoint_tree(model, opt_state))
    return TrainResult(params=model, opt_state=opt_state, losses=losses,
                       start_step=start_step, end_step=n_steps,
                       straggler_steps=stragglers)
