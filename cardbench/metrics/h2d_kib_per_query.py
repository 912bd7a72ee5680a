"""KiB copied from the host to the card a query: the program's counter
"h2d_bytes" (every copy to a CUDA device on the search paths) over the
queries its requests served (comet_tpu_torch.utils.profiling), over the
profiled stretch. None without a card: a copy to the CPU counts
nothing."""

KIND, UNIT, BETTER, SOURCE = "per_layer", "KiB", "lower", "program_counter"
LAYER, MOVES = "API to device", "qps"


def read(ctx):
    from comet_tpu_torch.utils import profiling

    per_query = getattr(profiling, "per_query", None)   # None in a program without the counter
    value = per_query("h2d_bytes") if ctx.trace and per_query else None
    return value / 1024.0 if value else None
