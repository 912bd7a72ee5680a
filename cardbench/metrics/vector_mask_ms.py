"""Host ms a request of the vector leg's slot mask: validity and the
document filter's words, copied and expanded on the card, made into the
scan's additive mask; the program's own span "layer.vector.mask"
(comet_tpu_torch.utils.profiling) over the profiled stretch."""

KIND, UNIT, BETTER, SOURCE = "per_layer", "ms", "lower", "program_span"
LAYER, MOVES = "API to device", "qps"


def read(ctx):
    from comet_tpu_torch.utils import profiling

    span_ms = getattr(profiling, "span_ms", None)   # None in a program without spans
    return span_ms("layer.vector.mask") if ctx.trace and span_ms else None
