"""Wall ms a query of the text leg's search in the fluent path: the BM25
builder's `execute`, which tokenizes, scores on the card and ends in its
own collect."""

KIND, UNIT, BETTER, SOURCE = "per_layer", "ms", "lower", "program_span"
LAYER, MOVES = "text index", "qps"


def read(ctx):
    return ctx.span_mean_ms("builder.text")
