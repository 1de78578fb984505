"""Rows indexed by the builds completed in the window over the window's
seconds (host clock; a build completes when its codes are on the device)."""

UNIT = "rows/s"


def read(ctx):
    return ctx.win["rows_done"] / ctx.window_s
