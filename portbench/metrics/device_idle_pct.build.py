"""Share (%) of a build's wall time in which the card ran no operation:
1 - (the union of the device activity intervals of one build, traced by
torch.profiler after the window) / (the window's seconds a build, untraced)."""

from portbench.harness import device

UNIT = "%"


def read(ctx):
    if ctx.profile_acts is None:
        return None
    per_build_s = ctx.window_s / ctx.win["builds"]
    return 100.0 * (1.0 - device.busy_us(ctx.profile_acts) / 1e6 / per_build_s)
