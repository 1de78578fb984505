"""Device ms a round in the plan's ``finalize`` stage (the live mask's fill,
the stable top-k and the -1 marking): the program's ``device.finalize``
spans, CUDA timing events inside the replayed graph on the trace's anchor
clock; mean over the traced window's rounds."""

from portbench.harness import spans

UNIT = "ms"


def read(ctx):
    return spans.per_round_ms(ctx, "device.finalize")
