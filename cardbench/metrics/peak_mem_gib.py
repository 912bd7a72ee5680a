"""torch.cuda.max_memory_allocated() over the program's set-up and the
window, read before the check (the benchmark's own data is off the card
then), in GiB."""

KIND, UNIT, BETTER, SOURCE = "end_to_end", "GiB", "lower", "host_clock"


def read(ctx):
    return ctx.peak_bytes / 2.0 ** 30
