"""Device ms of the encode after the rotation (``quantize.encode_rotated``:
Lloyd-Max codes, norms, packing) on the program's rotation of the cell's
whole corpus: CUDA events around back-to-back calls, after the window."""

from portbench.harness import stages

UNIT = "ms"


def read(ctx):
    cfg = ctx.cell.config
    rot = stages.rotated(ctx)
    q = ctx.port.quantize
    return ctx.stage_ms(lambda: q.encode_rotated(
        rot, dim=cfg["dim"], metric=cfg["metric"], seed=cfg["rotation_seed"],
        bits=cfg["bits"], std=None), reps=5)
