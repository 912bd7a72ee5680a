"""Masked top-k over corpus tiles, in plain PyTorch.

Counterpart of comet_tpu/ops/topk.py. These are the plain versions of the
search pipeline (ops/fused_scan.py) and the merge step the later slices
share. Results are ordered by ascending score, ties broken by ascending
slot index; empty slots carry (+inf, IDX_SENTINEL). `torch.topk` promises
no order for ties, so every selection here is a stable sort.
"""

from __future__ import annotations

import torch

from comet_tpu_torch.ops.distance import pairwise_scores_from_norms
from comet_tpu_torch.types import DistanceKind

IDX_SENTINEL = 2**31 - 1
INF = float("inf")


def _canonical_zero(s: torch.Tensor) -> torch.Tensor:
    # -0.0 == +0.0 in the ordering; a radix sort on the card tells them apart
    return torch.where(s == 0, torch.zeros_like(s), s)


def lexsort_topk(s: torch.Tensor, i: torch.Tensor, k: int):
    """The k best (score, index) pairs of each row, lexicographically: two
    stable sorts, by index then by score. Every plain select of the package
    (here and the plain version of K1 in ops/sortnet.py) is built on it."""
    s = _canonical_zero(s)
    by_idx = torch.sort(i, dim=1, stable=True).indices
    s, i = s.gather(1, by_idx), i.gather(1, by_idx)
    by_score = torch.sort(s, dim=1, stable=True).indices[:, :k]
    return s.gather(1, by_score), i.gather(1, by_score)


def merge_topk(scores_a, idx_a, scores_b, idx_b, k: int):
    """Merge two [Q, ka]/[Q, kb] top-k sets into the best [Q, k]: lower
    score first, ties toward the lower index."""
    return lexsort_topk(
        torch.cat([scores_a, scores_b], dim=1), torch.cat([idx_a, idx_b], dim=1), k
    )


def topk_lower(scores: torch.Tensor, k: int):
    """Top-k *smallest* scores per row with lowest-index tie-break.
    Returns (scores [Q, k], int32 positions [Q, k])."""
    s = _canonical_zero(scores)
    order = torch.sort(s, dim=1, stable=True).indices[:, :k]
    return s.gather(1, order), order.to(torch.int32)


def _masked(queries, corpus, sqnorms, valid, threshold, kind):
    dist = pairwise_scores_from_norms(queries, corpus, sqnorms, kind)
    keep = valid[None, :] & (dist <= threshold)
    return torch.where(keep, dist, torch.full_like(dist, INF))


def scan_topk(queries, corpus, corpus_sqnorms, valid, threshold: float,
              k: int, kind: DistanceKind, tile: int):
    """Exact masked k-NN of `queries` [Q, d] against `corpus` [N, d], tile
    by tile with a running top-k (N % tile == 0, k <= tile). Rows with
    `valid` False or distance > threshold are excluded (+inf disables the
    threshold). Returns (scores [Q, k] float32, slots [Q, k] int32)."""
    q_n, n = queries.shape[0], corpus.shape[0]
    if n % tile:
        raise ValueError(f"corpus rows {n} not a multiple of tile {tile}")
    best_s = torch.full((q_n, k), INF, dtype=torch.float32, device=queries.device)
    best_i = torch.full((q_n, k), IDX_SENTINEL, dtype=torch.int32, device=queries.device)
    for base in range(0, n, tile):
        sl = slice(base, base + tile)
        dist = _masked(queries, corpus[sl], corpus_sqnorms[sl], valid[sl],
                       threshold, kind)
        s, i = topk_lower(dist, min(k, tile))
        gi = torch.where(torch.isinf(s), IDX_SENTINEL, i + base).to(torch.int32)
        best_s, best_i = merge_topk(best_s, best_i, s, gi, k)
    return best_s, best_i


def block_select_from_dist(dist: torch.Tensor, k: int, block: int, base: int):
    """Exact top-k of a masked distance tile via contiguous block selection
    (see `block_topk`). Returns ([Q, k] scores, [Q, k] int32 slots)."""
    q_n, st = dist.shape
    n_groups = st // block
    dist3 = dist.view(q_n, n_groups, block)
    kb = min(k, n_groups)
    _, sel = topk_lower(dist3.amin(dim=2), kb)
    gathered = torch.gather(
        dist3, 1, sel.long()[:, :, None].expand(q_n, kb, block)
    ).reshape(q_n, kb * block)
    offs = torch.arange(block, dtype=torch.int32, device=dist.device)
    gidx = (sel[:, :, None] * block + offs).reshape(q_n, kb * block)
    kk = min(k, kb * block)
    s_out, i_out = lexsort_topk(gathered, gidx, kk)
    i_out = torch.where(torch.isinf(s_out), IDX_SENTINEL, i_out + base).to(torch.int32)
    if kk < k:
        pad = k - kk
        s_out = torch.cat([s_out, s_out.new_full((q_n, pad), INF)], dim=1)
        i_out = torch.cat([i_out, i_out.new_full((q_n, pad), IDX_SENTINEL)], dim=1)
    return s_out, i_out


def block_topk(queries, corpus, corpus_sqnorms, valid, threshold: float,
               k: int, kind: DistanceKind, block: int = 128,
               super_tile: int = 1 << 20):
    """Exact masked k-NN via two-level block selection.

    Exactness (incl. tie order): every element with score <= tau* (the
    k-th best key) lives in a group whose min <= tau*, and at most k groups
    hold such elements; with CONTIGUOUS groups, ordering groups by
    (min, group id) is consistent with ordering elements by (score, index),
    so the kept groups contain the true top-k in (score, index) order.
    """
    q_n, n = queries.shape[0], corpus.shape[0]
    st = min(super_tile, n)
    if n % st:
        raise ValueError(f"corpus rows {n} not a multiple of super tile {st}")
    best_s = torch.full((q_n, k), INF, dtype=torch.float32, device=queries.device)
    best_i = torch.full((q_n, k), IDX_SENTINEL, dtype=torch.int32, device=queries.device)
    for base in range(0, n, st):
        sl = slice(base, base + st)
        dist = _masked(queries, corpus[sl], corpus_sqnorms[sl], valid[sl],
                       threshold, kind)
        s, i = block_select_from_dist(dist, k, block, base)
        best_s, best_i = merge_topk(best_s, best_i, s, i, k)
    return best_s, best_i
