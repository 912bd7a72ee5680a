"""Share of the time inside requests (the benchmark's "request" spans of
the profiled stretch: a call of a closed loop, one request of an open
loop) in which no kernel, copy or set ran on the card: the host's part
of serving a request. An open loop's waits between arrivals are left
out, so the share follows the host's work a request, not the offered
rate."""

KIND, UNIT, BETTER, SOURCE = "per_layer", "%", "lower", "device_trace"
LAYER, MOVES = "device", "qps"


def read(ctx):
    if not ctx.trace or ctx.trace["busy_s"] <= 0 or ctx.trace["request_s"] <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace["request_busy_s"] / ctx.trace["request_s"])
