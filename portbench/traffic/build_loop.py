"""Traffic kind ``build_loop``: back-to-back ``MonaVec.build`` of the corpus,
already on the device, after ``warmup_builds`` builds.  A build counts once
its codes are on the device (synchronised), and each is compared there with
the window's first (``torch.equal``).
"""

from __future__ import annotations

import gc
import time

import torch

from portbench.harness import data, judge
from portbench.harness import device as devmod
from portbench.harness.context import Context


def run(ctx: Context) -> None:
    t = ctx.cell.traffic
    x = data.corpus(ctx.cell.config, ctx.seed, ctx.device)
    ctx.state["corpus"] = x
    ctx.mark("data")
    ctx.drop_cached()
    for _ in range(t["warmup_builds"]):
        ctx.build_index(x)
        ctx.sync()
    builds, first, last, differ = 0, None, None, 0
    # The set-up's objects out of the collector's way: a build makes some
    # tens of thousands of short-lived tensors, and the collections they
    # set off then scan only what the window allocates.
    gc.collect()
    gc.freeze()
    t_start = ctx.mark_window_start()
    while True:
        last = None     # the previous build goes first: two indexes live, not three
        last = ctx.build_index(x)
        ctx.sync()
        builds += 1
        if first is None:
            first = last
        else:   # every build of the window against the first, on the device
            a, b = first.backend.enc, last.backend.enc
            differ += not (torch.equal(a.packed, b.packed) and torch.equal(a.qnorms, b.qnorms))
        t_end = time.perf_counter()
        if t_end - t_start >= ctx.seconds:
            break
    ctx.window_s = t_end - t_start
    gc.unfreeze()
    ctx.win.update(builds=builds, failed=0, rebuilds_differ=differ)
    ctx.state.update(first=first, last=last)
    if ctx.trace and ctx.on_card:
        # One more build after the window, under torch.profiler: tracing
        # every launch slows the host ~30x, so a traced window would hold
        # one build and read the profiler's own overhead as idle time.
        with devmod.profiled(host=False) as prof:
            ctx.build_index(x)
        ctx.profile_acts = devmod.device_activity(prof)


def rows_done(ctx: Context) -> int:
    return ctx.win["builds"] * ctx.cell.config["rows"]


def attempted(ctx: Context) -> int:
    return ctx.win["builds"]


def outputs(ctx: Context) -> dict:
    return judge.build_outputs(ctx)


def compare(ctx: Context, out: dict, control: bool = False) -> dict:
    return judge.build_numbers(ctx, out, control=control)


def busy_s(ctx: Context) -> float:
    """The profiled build's device activity (its intervals' union), times
    the window's builds."""
    return devmod.busy_us(ctx.profile_acts) / 1e6 * ctx.win["builds"]


def device_ops(ctx: Context) -> list:
    return devmod.top_ops(ctx.profile_acts or [])


def idle_gaps(ctx: Context) -> list:
    """The profiled build's longest gaps, each named by the operation that
    ended it (the profiler lengthens them)."""
    return devmod.idle_gaps(ctx.profile_acts or [])
