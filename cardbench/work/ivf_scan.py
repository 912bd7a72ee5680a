"""Least work of an IVF search, the same whatever route runs it: the
coarse product, 2 Q nlist d float32 operations with the centroids read
once (4 nlist d bytes); the fine scan, 2 d operations for each (query,
row) pair of the rows in the query's probed lists; the rows of the union
of the call's probed lists read once (4 d bytes each); the queries read
once (4 Q d bytes); Q k results written once (a 4-byte id and a 4-byte
score). The lists and each query's probes come from the handed-over
centroids in float64 (references/ivf_l2.py), not from the program."""

import torch

from harness import peaks
from harness.spec import load_module

ivf_l2 = load_module("references", "ivf_l2")


def least(q: int, nlist: int, d: int, k: int, pairs: int, union_rows: int):
    ops = 2.0 * q * nlist * d + 2.0 * d * pairs
    n_bytes = 4.0 * union_rows * d + 4.0 * nlist * d + 4.0 * q * d + 8.0 * q * k
    return ops, n_bytes


def seconds(cell, data, calls) -> float:
    """Least seconds of the traced calls, each (requests, lo, hi)."""
    cf, k = cell["config_spec"], cell["traffic_spec"]["k"]
    lst = ivf_l2.lists(cell, data)
    nlist, d = lst["centroids"].shape
    sizes = torch.bincount(lst["assign"], minlength=nlist).to(torch.float64)
    pool = data["pool"]
    memo = {}
    total = 0.0
    for reqs, lo, hi in calls:
        key = (id(reqs), lo, hi)
        if key not in memo:
            rows = torch.as_tensor(reqs.rows[lo:hi], device=pool.device)
            probed, _ = ivf_l2.probes(lst, pool[rows].to(torch.float64), cf["nprobe"])
            pairs = int((probed.to(torch.float64) @ sizes).sum())
            union_rows = int(sizes[probed.any(dim=0)].sum())
            memo[key] = peaks.least_seconds(*least(hi - lo, nlist, d, k, pairs, union_rows))
        total += memo[key]
    return total
