"""The vector leg's scan and select as a share of its roofline: the least
time of its work (work/scan.py) at the H100's published peaks over the
device time of every kernel launched inside its host span
("stage.scan", around `_search_launch`)."""

KIND, UNIT, BETTER, SOURCE = "per_layer", "%", "higher", "device_trace"
LAYER, MOVES = "kernels", "qps"


def read(ctx):
    return ctx.roofline("scan")
