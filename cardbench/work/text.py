"""Least work of the text leg's scoring and select: every distinct
posting of the call's query terms read once (a 4-byte document and a
4-byte term frequency), the length of every touched document read once
(4 bytes), the filter's bits (n / 8 bytes) where there is a filter, and
Q k results written once (8 bytes each). Its few operations a posting
are not counted: the bytes bound it. For a configuration whose
documents are the rows of `data["tokens"]` (word indices below `vocab`)
with a single space between words, each space a term of its own, as
comet's tokenizer keeps them."""

import numpy as np

from harness import peaks


def least(postings: int, touched: int, q: int, k: int, n: int, filtered: bool = True):
    return 0.0, 8.0 * postings + 4.0 * touched + (n / 8.0 if filtered else 0.0) + 8.0 * q * k


def seconds(cell, data, calls) -> float:
    """Least seconds of the traced calls, each (requests, lo, hi)."""
    import torch

    cf, k = cell["config_spec"], cell["traffic_spec"]["k"]
    n, tokens = cf["n"], data["tokens"]
    srt = torch.sort(tokens, dim=1).values
    first = torch.ones_like(srt, dtype=torch.bool)
    first[:, 1:] = srt[:, 1:] != srt[:, :-1]
    df = torch.bincount(srt[first].long(), minlength=cf["vocab"])
    total = 0.0
    for reqs, lo, hi in calls:
        words = torch.as_tensor(np.unique(np.concatenate(reqs.words[lo:hi])), device=tokens.device)
        spaces = any(len(w) > 1 for w in reqs.words[lo:hi])   # every document has spaces
        postings = int(df[words].sum()) + (n if spaces else 0)
        touched = n if spaces else int(torch.isin(tokens, words).any(1).sum())
        total += peaks.least_seconds(*least(postings, touched, hi - lo, k, n,
                                            reqs.cats is not None))
    return total
