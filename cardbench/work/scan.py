"""Least work of the vector leg's scan and select: Q queries of width d
against the rows the filter allows (all n without a filter), 2 Q rows d
float32 operations; the allowed rows and the queries read once (4 bytes
an element), the filter's bits (n / 8 bytes) where there is a filter,
and Q k results (a 4-byte id and a 4-byte score) written once. For a
configuration with `n` rows of `dim` components, and with `categories`
where document i belongs to the (i mod len(categories))-th."""

import numpy as np

from harness import peaks


def least(q: int, rows: int, d: int, k: int, n: int, filtered: bool):
    ops = 2.0 * q * rows * d
    n_bytes = 4.0 * rows * d + 4.0 * q * d + (n / 8.0 if filtered else 0.0) + 8.0 * q * k
    return ops, n_bytes


def seconds(cell, data, calls) -> float:
    """Least seconds of the traced calls, each (requests, lo, hi): a call's
    queries that share a category share its rows, read once."""
    cf, k = cell["config_spec"], cell["traffic_spec"]["k"]
    n, d = cf["n"], cf["dim"]
    total = 0.0
    for reqs, lo, hi in calls:
        if reqs.cats is None:
            total += peaks.least_seconds(*least(hi - lo, n, d, k, n, False))
            continue
        ops = n_bytes = 0.0
        cats, counts = np.unique(reqs.cats[lo:hi], return_counts=True)
        for c, q in zip(cats, counts):
            rows = len(range(int(c), n, len(cf["categories"])))
            o, b = least(int(q), rows, d, k, n, True)
            ops, n_bytes = ops + o, n_bytes + b
        total += peaks.least_seconds(ops, n_bytes)
    return total
