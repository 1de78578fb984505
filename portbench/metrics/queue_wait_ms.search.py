"""Host ms a request waits in the batcher's queue: the program's
``batcher.queue`` spans (a wait span a request, from its ``submit``
returning to the start of its chunk's ``batcher.execute``), mean over the
traced window's requests."""

from portbench.harness import spans

UNIT = "ms"


def read(ctx):
    return spans.per_request_ms(ctx, "batcher.queue")
