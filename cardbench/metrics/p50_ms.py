"""Median latency of all requests due in an open loop's window, each
timed from when it was due (a failed request counts as infinitely late).
Per-layer and unbound: on the port's host-bound one-query paths runs of
one code spread by more than any bound the benchmark may set."""

import numpy as np

KIND, UNIT, BETTER, SOURCE = "per_layer", "ms", "lower", "host_clock"
LAYER, MOVES = "API", "qps"


def read(ctx):
    lat = ctx.window.get("latency_s")
    return None if lat is None else float(np.percentile(lat, 50)) * 1e3
