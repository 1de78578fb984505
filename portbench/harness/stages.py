"""The inputs a per-layer reader times a stage on: the index's codes and a
bucket of the cell's own queries, rotated by the program, made once a run
after the window and shared by every reader (``ctx.cache``)."""

from __future__ import annotations

import torch

from .context import Context


def enc(ctx: Context):
    """The window's index's encoded corpus (the program's state)."""
    return ctx.state["index"].backend.enc


def bucket(ctx: Context) -> int:
    t = ctx.cell.traffic
    return ctx.port.plan.shape_bucket(t["clients"] * t["rows_per_request"])


def q_rot(ctx: Context) -> torch.Tensor:
    """[bucket, d'] the program's rotation of a round's worth of pool rows."""
    if "q_rot" not in ctx.cache:
        q = torch.from_numpy(ctx.state["pool"][:bucket(ctx)]).to(ctx.device)
        ctx.cache["q_rot"] = ctx.port.quantize.encode_query(q, enc(ctx))
    return ctx.cache["q_rot"]


def scores(ctx: Context) -> torch.Tensor:
    """[bucket, n] the program's adjusted full-scan scores of those rows."""
    if "scores" not in ctx.cache:
        e = enc(ctx)
        raw = ctx.port.bruteforce.scan_stage(q_rot(ctx), e.packed, bits=e.bits)
        ctx.cache["scores"] = ctx.port.scoring.adjust_scores(raw, e.qnorms, e.metric)
    return ctx.cache["scores"]


def prepared(ctx: Context) -> torch.Tensor:
    """[n, d] the program's prepared (unit) corpus rows, the rotation's input."""
    if "prepared" not in ctx.cache:
        cfg = ctx.cell.config
        ctx.cache["prepared"] = ctx.port.standardize.prepare(
            ctx.state["corpus"], cfg["metric"], None)
    return ctx.cache["prepared"]


def rotated(ctx: Context) -> torch.Tensor:
    """[n, d'] the program's rotation of the prepared corpus."""
    if "rotated" not in ctx.cache:
        ctx.cache["rotated"] = ctx.port.rhdh.rhdh_apply(
            prepared(ctx), ctx.cell.config["rotation_seed"], normalized=False)
    return ctx.cache["rotated"]
