"""Share (%) of the traced window's wall time in which the card ran no graph
replay: 1 - (device time of every replay, from CUDA events the harness
records immediately around each ``CUDAGraph.replay``) / window."""

UNIT = "%"


def read(ctx):
    if ctx.replays is None:
        return None
    return 100.0 * (1.0 - ctx.replays.device_s() / ctx.window_s)
