"""Host ms a call of the fluent path's fusion, `Fusion.combine` (the
benchmark's span around the call)."""

KIND, UNIT, BETTER, SOURCE = "per_layer", "ms", "lower", "program_span"
LAYER, MOVES = "hybrid coordinator", "qps"


def read(ctx):
    return ctx.span_mean_ms("layer.fusion")
