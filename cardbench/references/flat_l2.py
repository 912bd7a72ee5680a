"""Plain reference of exact L2 k-NN search, in PyTorch float64.

Squared distances of integer vectors are exact integers (below 2^25),
held exactly in float64, so the k nearest by (squared distance, id) are
decidable; a score is the correctly rounded float32 square root. Ids are
slot + 1. Nothing of the program is imported or read.

`precision="control"` is the control of the comparison: the squared
distances carried in TF32 (10 mantissa bits), the precision below the
configuration's float32 with TF32 off. (A TF32 matrix product alone is
exact on these inputs: 0..255 fit TF32's mantissa and the tensor cores
accumulate in float32; it is the distances kept at that precision that
a TF32 path would lose.)"""

import numpy as np
import torch

BLOCK = 64          # queries a block
SLOT_BITS = 21      # key = squared distance * 2^21 + slot, exact in float64


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to nearest even at TF32's 10 mantissa bits."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0x0FFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


def sqrt_f32(d2: np.ndarray) -> np.ndarray:
    return np.sqrt(np.asarray(d2, dtype=np.float64)).astype(np.float32)


def knn(corpus: torch.Tensor, queries: torch.Tensor, k: int, allowed=None,
        precision: str = "exact"):
    """The k nearest rows of `corpus` to each query: (ids [Q, k] int64,
    squared distances [Q, k] float64), by (squared distance, id); a row
    with fewer than k allowed documents ends in ids 0 and +inf.
    `allowed(q0, q1)` gives a [q1 - q0, n] bool mask, or None for all."""
    n = corpus.shape[0]
    if n >= 1 << SLOT_BITS:
        raise ValueError("the reference's keys hold at most 2^21 rows")
    x = corpus.to(torch.float64)
    xn = (x * x).sum(1)
    slots = torch.arange(n, device=x.device, dtype=torch.float64)
    out_ids, out_d2 = [], []
    for q0 in range(0, queries.shape[0], BLOCK):
        q = queries[q0:q0 + BLOCK].to(torch.float64)
        d2 = (q * q).sum(1, keepdim=True) + xn[None, :] - 2.0 * (q @ x.T)
        if precision == "control":
            d2 = tf32_round(d2).to(torch.float64)
        key = d2 * float(1 << SLOT_BITS) + slots[None, :]
        if allowed is not None:
            key = key.masked_fill(~allowed(q0, q0 + q.shape[0]), float("inf"))
        kk = min(k, n)
        top, pos = torch.topk(key, kk, dim=1, largest=False, sorted=True)
        hit = torch.isfinite(top)
        ids = torch.where(hit, pos + 1, torch.zeros_like(pos))
        dd = torch.where(hit, d2.gather(1, pos), torch.full_like(top, float("inf")))
        out_ids.append(ids.cpu().numpy())
        out_d2.append(dd.cpu().numpy())
    ids, d2 = np.concatenate(out_ids), np.concatenate(out_d2)
    if kk < k:
        ids = np.pad(ids, ((0, 0), (0, k - kk)))
        d2 = np.pad(d2, ((0, 0), (0, k - kk)), constant_values=np.inf)
    return ids, d2


def rows(ids: np.ndarray, d2: np.ndarray, order: str):
    """Result rows as the entry returns them: "distance" keeps the
    (squared distance, id) order of a batch row; "score" sorts a fluent
    list by (float32 score, id). Empty places are dropped."""
    out = []
    for i_row, d_row in zip(ids, d2):
        keep = i_row > 0
        i_row, s_row = i_row[keep], sqrt_f32(d_row[keep])
        if order == "score":
            o = np.lexsort((i_row, s_row))
            i_row, s_row = i_row[o], s_row[o]
        out.append((i_row.astype(np.int64), s_row.astype(np.float64)))
    return out


def expected(cell, data, reqs, picks, cats, precision="exact"):
    """(ids, scores, decided) of each request in `picks`, in the order the
    cell's entry returns them: a batch row by (squared distance, id), a
    fluent list by (score, id). Every order is decided."""
    dev = data["corpus"].device
    order = "distance" if cell["traffic_spec"]["entry"] == "search_batch" else "score"
    queries = data["pool"][torch.as_tensor(reqs.rows[picks], device=dev)]
    ids, d2 = knn(data["corpus"], queries, cell["traffic_spec"]["k"], None, precision)
    return [(i, s, True) for i, s in rows(ids, d2, order)]
