"""Kernel calls a query over the window, from the port's own launch
counters (the list of chip_smoke.py's `read_launches`), with the split
and few-query routes left out: they are counted inside their parent's
count already."""

KIND, UNIT, BETTER, SOURCE = "per_layer", "count", "lower", "program_counter"
LAYER, MOVES = "API to device", "qps"
PARTS = ("topk_cl_split", "fused_dist_select_fewq")


def read(ctx):
    if ctx.launches is None:
        return None
    total = sum(v for key, v in ctx.launches.items() if key not in PARTS)
    return total / ctx.window["attempted"] if total else None
