"""Device ms of the cascade's survivor top-m (``binary.survivor_topk_stage``,
m = rescore_mult x k) at the cell's [bucket, n] on the program's own sign
proxies of a round's worth of the cell's queries: CUDA events around
back-to-back calls, after the window."""

from portbench.harness import stages

UNIT = "ms"


def read(ctx):
    t = ctx.cell.traffic
    e = stages.enc(ctx)
    binary = ctx.port.binary
    proxy = binary.coarse_scan_stage(stages.q_rot(ctx), e.ccodes, kind=e.coarse)
    m = t["knobs"]["rescore_mult"] * t["k"]
    return ctx.stage_ms(lambda: binary.survivor_topk_stage(proxy, None, m=m))
