"""Device-idle ms a round while a span of the program was open: the
program's ``trace.device_idle_us`` histograms (each stretch of a round's
trace in which the device ran nothing, put down to the innermost host span
open then), every cause but ``caller`` (the harness), summed, mean over the
traced window's rounds."""

from portbench.harness import spans

UNIT = "ms"


def read(ctx):
    return spans.idle_in_program_ms(ctx)
