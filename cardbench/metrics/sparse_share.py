"""Share of the queries served that the IVF path sent down its sparse
route (K3): the program's counter "ivf_sparse_rows" (counted at every IVF
launch, 0 on the dense route; comet_tpu_torch/indexes/ivf.py) over the
queries its requests served, over the profiled stretch, in %. It says
which route the window ran. None where the program counts nothing of the
kind."""

KIND, UNIT, BETTER, SOURCE = "per_layer", "%", "higher", "program_counter"
LAYER, MOVES = "API to device", "qps"


def read(ctx):
    from comet_tpu_torch.utils import profiling

    per_query = getattr(profiling, "per_query", None)   # None in a program without counters
    if not ctx.trace or per_query is None:
        return None
    if not any(r.counters and "ivf_sparse_rows" in r.counters for r in profiling.spans()):
        return None
    share = per_query("ivf_sparse_rows")
    return None if share is None else 100.0 * share
