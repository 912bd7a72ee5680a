"""Process start to the first timed request: imports, the card's start,
data generation, the kernels' build or load, the index build and the
warm-up of the cell's own shapes."""

KIND, UNIT, BETTER, SOURCE = "end_to_end", "s", "lower", "host_clock"


def read(ctx):
    return ctx.setup_s
