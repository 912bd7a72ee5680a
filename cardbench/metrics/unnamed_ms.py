"""Host ms a request that no step of the program names: the time of a
request's outermost span (one call into the program) less the union of
its leaf spans (comet_tpu_torch.utils.profiling), over the profiled
stretch."""

KIND, UNIT, BETTER, SOURCE = "per_layer", "ms", "lower", "program_span"
LAYER, MOVES = "API", "qps"


def read(ctx):
    from comet_tpu_torch.utils import profiling

    unnamed_ms = getattr(profiling, "unnamed_ms", None)   # None in a program without spans
    return unnamed_ms() if ctx.trace and unnamed_ms else None
