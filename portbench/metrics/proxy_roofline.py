"""Share (%) of its roofline that the sign proxy stage
(``binary.coarse_scan_stage``, B6 on the card) reaches at the cell's
[bucket, n, d']: ``roofline/sign_proxy.py``'s bytes at the published peak
over the stage's device ms (CUDA events, after the window)."""

from portbench.harness import cells, stages

UNIT = "%"


def read(ctx):
    e = stages.enc(ctx)
    q = stages.q_rot(ctx)
    binary = ctx.port.binary
    ms = ctx.stage_ms(lambda: binary.coarse_scan_stage(q, e.ccodes, kind=e.coarse))
    ops, nbytes = cells.roofline("sign_proxy").work(q.shape[0], e.n, e.dim_pad)
    return 100.0 * ctx.bound_ms(ops, nbytes) / ms
