"""95th percentile, over every request completed in the window, of the time
from its ``submit`` to its ``Ticket.result()`` returning (host clock)."""

import numpy as np

UNIT = "ms"


def read(ctx):
    return 1e3 * float(np.percentile(ctx.win["latency_s"][ctx.win["ok"]], 95))
