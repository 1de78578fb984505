"""Device ms a round in the plan's ``scan`` stage (B1 and its metric
adjustment): the program's ``device.scan`` spans, CUDA timing events that
the captured graph records at the stage's start and end on every replay,
read on the trace's anchor clock; mean over the traced window's rounds."""

from portbench.harness import spans

UNIT = "ms"


def read(ctx):
    return spans.per_round_ms(ctx, "device.scan")
