"""Host ms a request of the IVF path's overflow rescans: the program's own
spans "layer.ivf.rescan" (comet_tpu_torch/indexes/ivf.py: a rescan's
enqueue and its wait for the overflow counts) summed over a request, over
all requests of the profiled stretch, 0 for a request with none. None
where the program's IVF path counts nothing (no "ivf_sparse_rows"
counter), as in a program without these spans."""

KIND, UNIT, BETTER, SOURCE = "per_layer", "ms", "lower", "program_span"
LAYER, MOVES = "API to device", "qps"


def read(ctx):
    from comet_tpu_torch.utils import profiling

    requests = getattr(profiling, "requests", None)   # None in a program without spans
    if not ctx.trace or requests is None:
        return None
    reqs = list(requests().values())
    if not any(r.counters and "ivf_sparse_rows" in r.counters for recs in reqs for r in recs):
        return None
    ns = sum(r.end - r.start for recs in reqs for r in recs if r.name == "layer.ivf.rescan")
    return ns / len(reqs) / 1e6
