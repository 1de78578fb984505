"""Device ms of the stable top-k (``scoring.topk``) at the cell's [bucket, n]
on the program's own scores of a round's worth of the cell's queries: CUDA
events around back-to-back calls, after the window."""

from portbench.harness import stages

UNIT = "ms"


def read(ctx):
    scores = stages.scores(ctx)
    k = ctx.cell.traffic["k"]
    return ctx.stage_ms(lambda: ctx.port.scoring.topk(scores, k))
