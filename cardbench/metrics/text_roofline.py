"""The text leg's scoring and select as a share of its roofline: the
least time of its work (work/text.py) over the device time of every
kernel launched inside its host span ("stage.text", around BM25's
`_score`)."""

KIND, UNIT, BETTER, SOURCE = "per_layer", "%", "higher", "device_trace"
LAYER, MOVES = "kernels", "qps"


def read(ctx):
    return ctx.roofline("text")
