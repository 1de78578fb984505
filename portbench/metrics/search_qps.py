"""Query rows answered in the window over the window's seconds (host clock)."""

UNIT = "queries/s"


def read(ctx):
    return ctx.win["rows_done"] / ctx.window_s
