"""Queries completed a second over all of the window: in a closed loop
all queries of all calls over the time they took; in an open loop the
requests completed inside the window over its length (below the offered
rate only when a backlog builds)."""

KIND, UNIT, BETTER, SOURCE = "end_to_end", "queries/s", "higher", "host_clock"


def read(ctx):
    w = ctx.window
    if ctx.loop == "closed":
        return (w["attempted"] - w["failed"]) / w["elapsed"]
    return w["completed"] / w["elapsed"]
