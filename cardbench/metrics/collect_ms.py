"""Host ms a request of the collects: the waits for the card and the copies
of its results to the host with the ids mapped, of the vector and the text
leg; the program's own spans "layer.vector.collect" and
"layer.text.collect" (comet_tpu_torch.utils.profiling) summed over a
request, over the profiled stretch."""

KIND, UNIT, BETTER, SOURCE = "per_layer", "ms", "lower", "program_span"
LAYER, MOVES = "API to device", "qps"


def read(ctx):
    from comet_tpu_torch.utils import profiling

    span_ms = getattr(profiling, "span_ms", None)   # None in a program without spans
    if not ctx.trace or span_ms is None:
        return None
    return span_ms(("layer.vector.collect", "layer.text.collect"))
