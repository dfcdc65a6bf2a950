"""Set-up time: from the process's start to the first timed step (loading
and building the kernels, making the data and weights on the card, the
program's set-up, the warm-up)."""

UNIT, SOURCE = "s", "host_clock"


def read(ctx):
    return ctx.setup_s
