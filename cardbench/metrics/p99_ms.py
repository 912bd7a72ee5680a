"""99th percentile latency of all requests due in an open loop's window
(not a median of chunks), each timed from when it was due. Per-layer and
unbound, as p50_ms."""

import numpy as np

KIND, UNIT, BETTER, SOURCE = "per_layer", "ms", "lower", "host_clock"
LAYER, MOVES = "API", "qps"


def read(ctx):
    lat = ctx.window.get("latency_s")
    return None if lat is None else float(np.percentile(lat, 99)) * 1e3
