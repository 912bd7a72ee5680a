"""Host ms a request of the text leg's mask: BM25's allowed-document mask
over every slot (soft deletes and the filter) and its copy to the card,
the program's own span "layer.text.mask" (comet_tpu_torch.utils.profiling)
over the profiled stretch."""

KIND, UNIT, BETTER, SOURCE = "per_layer", "ms", "lower", "program_span"
LAYER, MOVES = "text index", "qps"


def read(ctx):
    from comet_tpu_torch.utils import profiling

    span_ms = getattr(profiling, "span_ms", None)   # None in a program without spans
    return span_ms("layer.text.mask") if ctx.trace and span_ms else None
