"""Seconds from the start of the process to the start of the window: start
and imports, the kernels' libraries, the stand-in data made on the device,
the build and the warm-up (host clock)."""

UNIT = "s"


def read(ctx):
    return ctx.setup_s
