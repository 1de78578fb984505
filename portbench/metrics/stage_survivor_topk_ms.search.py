"""Device ms a round in the cascade's ``survivor_topk`` stage (the top-m of
the sign proxies over the live rows): the program's
``device.survivor_topk`` spans, CUDA timing events inside the replayed
graph on the trace's anchor clock; mean over the traced window's rounds."""

from portbench.harness import spans

UNIT = "ms"


def read(ctx):
    return spans.per_round_ms(ctx, "device.survivor_topk")
