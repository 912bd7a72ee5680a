"""An IVF search as a share of its roofline: the least time of its work
(work/ivf_scan.py: the coarse product, the probed lists' rows, the
queries and the results, the same whatever route runs it) at the H100's
published peaks over the device time of every kernel, copy and set
launched inside its host span ("stage.ivf_scan", around `_search_launch`
and around `_launch_sparse`, which an overflow's rescans call)."""

KIND, UNIT, BETTER, SOURCE = "per_layer", "%", "higher", "device_trace"
LAYER, MOVES = "kernels", "qps"


def read(ctx):
    return ctx.roofline("ivf_scan")
