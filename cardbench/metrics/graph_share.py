"""Share of the queries served that a CUDA graph's replay of the IVF
sparse pipeline served: the program's counter "ivf_graph_rows" (counted at
every call of the pipeline's graph cache on the card, 0 for a call that
ran the pipeline eagerly; comet_tpu_torch/ops/ivf_sparse.py) over the
queries its requests served, over the profiled stretch, in %. It says how
often the graph engages. None where the program counts nothing of the
kind."""

KIND, UNIT, BETTER, SOURCE = "per_layer", "%", "higher", "program_counter"
LAYER, MOVES = "API to device", "qps"


def read(ctx):
    from comet_tpu_torch.utils import profiling

    per_query = getattr(profiling, "per_query", None)   # None in a program without counters
    if not ctx.trace or per_query is None:
        return None
    if not any(r.counters and "ivf_graph_rows" in r.counters for r in profiling.spans()):
        return None
    share = per_query("ivf_graph_rows")
    return None if share is None else 100.0 * share
