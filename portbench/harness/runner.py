"""One run of one cell: set-up and window by the cell's traffic kind
(``traffic/<kind>.py``), the cell's metrics by their readers, then the
comparison with the reference by the kind's hooks, and the result line.

A kind module has ``run(ctx)`` (set-up and window), ``rows_done`` and
``attempted``, ``outputs`` (what is judged, taken out of the program's
state) and ``compare(ctx, out, control)`` (the numbers compared), and for the
traced run ``busy_s``, ``device_ops`` and ``idle_gaps``.
"""

from __future__ import annotations

import time
from types import ModuleType
from typing import Callable, Optional, Tuple

import torch

from . import cells
from . import device as devmod
from .context import Context


def start(name: str, seed: int, seconds: float, trace: bool, *, device: str = "cuda",
          t0: Optional[float] = None, age0: float = 0.0, overrides: Optional[dict] = None,
          stage_timer: Optional[Callable] = None) -> Tuple[Context, ModuleType]:
    """Set-up and window of one run: (context, traffic kind)."""
    cell = cells.load(name, overrides)
    dev = torch.device(device)
    ctx = Context(cell=cell, seed=int(seed), seconds=float(seconds), trace=bool(trace),
                  device=dev, t0=time.perf_counter() if t0 is None else t0, age0=age0,
                  stage_timer=stage_timer)
    ctx.mark("imports")
    if dev.type == "cuda":
        from repro_torch.kernels import cuda_build
        torch.cuda.init()
        ctx.mark("cuda context")
        cuda_build.build(["nibble_dot", "hadamard", "binary_dot", "gather_dot"])
        ctx.mark("kernel libraries")
    kind = cells.kind(cell.traffic["kind"])
    kind.run(ctx)
    ctx.win["rows_done"] = kind.rows_done(ctx)
    return ctx, kind


def outputs(ctx: Context, kind: ModuleType) -> dict:
    """What the comparison judges; the program's state is then freed."""
    out = kind.outputs(ctx)
    ctx.cache.clear()
    if ctx.on_card:
        torch.cuda.empty_cache()
    return out


def run_cell(name: str, seed: int, seconds: float, trace: bool, **kw) -> dict:
    """The result object of one run (the last line's keys, ``checks`` last)."""
    ctx, kind = start(name, seed, seconds, trace, **kw)
    cell = ctx.cell
    peak = torch.cuda.max_memory_reserved() if ctx.on_card else 0
    names = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for metric in names:
        mod = cells.reader(metric)
        value = mod.read(ctx)
        if value is not None:
            metrics[metric] = {"value": float(value), "unit": mod.UNIT}
    dev_info = {"platform": "gpu" if ctx.on_card else "cpu",
                "kind": torch.cuda.get_device_name() if ctx.on_card else "cpu",
                "count": cell.chips, "memory_peak_bytes": int(peak)}
    breakdown = None
    if trace and ctx.on_card:
        dev_info["busy_s"] = kind.busy_s(ctx)
        dev_info["window_s"] = ctx.window_s
        dev_info["power_limit_w"] = devmod.power_limit_w()
        breakdown = {"device_ops": kind.device_ops(ctx), "idle_gaps": kind.idle_gaps(ctx)}
    attempted, failed = kind.attempted(ctx), ctx.win["failed"]
    nums = kind.compare(ctx, outputs(ctx, kind))
    checks = {k: {"value": v, "limit": cell.limits[k]} for k, v in nums.items()}
    correct = failed == 0 and attempted > 0 and all(
        c["value"] <= c["limit"] for c in checks.values())
    result = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
              "metrics": metrics, "device": dev_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    prev, parts = 0.0, {}
    for step, at in ctx.marks:
        parts[step], prev = at - prev, at
    result["setup_parts"] = parts
    result["checks"] = checks
    return result
