"""Share (%) of its roofline that the full scan (``bruteforce.scan_stage``,
B1 on the card) reaches at the cell's [bucket, n, d']: the bound of
``roofline/scan.py``'s work at the published peaks over the stage's device
ms (CUDA events, after the window)."""

from portbench.harness import cells, stages

UNIT = "%"


def read(ctx):
    e = stages.enc(ctx)
    q = stages.q_rot(ctx)
    ms = ctx.stage_ms(lambda: ctx.port.bruteforce.scan_stage(q, e.packed, bits=e.bits))
    ops, nbytes = cells.roofline("scan").work(q.shape[0], e.n, e.dim_pad)
    return 100.0 * ctx.bound_ms(ops, nbytes) / ms
