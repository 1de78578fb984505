"""Host ms a round in the service layer's ``submit`` calls: the program's
``batcher.submit`` spans (one a request, from its ``submit`` call's start to
its return), summed over a round, mean over the traced window's rounds."""

from portbench.harness import spans

UNIT = "ms"


def read(ctx):
    return spans.per_round_ms(ctx, "batcher.submit")
