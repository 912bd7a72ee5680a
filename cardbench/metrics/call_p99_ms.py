"""99th percentile of a closed loop's `search_batch` call time: the
closed-loop cells' tail, kept as a per-layer metric so that it does not
widen the bound of an end-to-end metric."""

import numpy as np

KIND, UNIT, BETTER, SOURCE = "per_layer", "ms", "lower", "host_clock"
LAYER, MOVES = "API", "qps"


def read(ctx):
    calls = ctx.window.get("call_s")
    return None if calls is None else float(np.percentile(calls, 99)) * 1e3
