"""Host ms a call of the metadata filter's `filter_bitset`."""

KIND, UNIT, BETTER, SOURCE = "per_layer", "ms", "lower", "program_span"
LAYER, MOVES = "metadata filter", "qps"


def read(ctx):
    return ctx.span_mean_ms("layer.filter")
