"""Host ms a request of building the results: aggregation, the result
objects, limit, autocut and sort of every leg and of the fusion; the
program's own spans "layer.*.results" (comet_tpu_torch.utils.profiling)
summed over a request, over the profiled stretch."""

KIND, UNIT, BETTER, SOURCE = "per_layer", "ms", "lower", "program_span"
LAYER, MOVES = "API", "qps"


def read(ctx):
    from comet_tpu_torch.utils import profiling

    span_ms = getattr(profiling, "span_ms", None)   # None in a program without spans
    return span_ms("layer.*.results") if ctx.trace and span_ms else None
