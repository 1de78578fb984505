"""Share (%) of its roofline that the rotation (``rhdh.rhdh_apply``, B2 on the
card) reaches on the cell's prepared corpus [n, d] into [n, d']:
``roofline/rotation.py``'s work at the published peaks over the stage's
device ms (CUDA events, after the window)."""

from portbench.harness import cells, stages

UNIT = "%"


def read(ctx):
    cfg = ctx.cell.config
    x = stages.prepared(ctx)
    rhdh = ctx.port.rhdh
    d_pad = rhdh.next_pow2(x.shape[1])
    ms = ctx.stage_ms(lambda: rhdh.rhdh_apply(x, cfg["rotation_seed"], normalized=False),
                      reps=5)
    ops, nbytes = cells.roofline("rotation").work(x.shape[0], x.shape[1], d_pad)
    return 100.0 * ctx.bound_ms(ops, nbytes) / ms
