"""The graph beam of HNSW: a lockstep E = 1 best-first search over the
layer-0 adjacency, and the device sync of an insertion round.

Counterpart of comet_tpu/ops/graph.py (`beam_search_layer0`,
`scatter_graph_update`). The reference computes these in XLA, outside any
Pallas kernel, so they are plain PyTorch here on either device, not the
plain version of a kernel. Insertion (indexes/hnsw.py) takes the beam for
its candidate pool, and search takes it when the routing table would pass
BLOCKED_TABLE_BYTES_MAX.

A batch of queries runs best-first search together: each iteration expands
every query's best unexpanded candidate, scores its adjacency row, and
merges it into the ef-row beam by a sort. Visited sets are packed 32-bit
words per query ([Q, cap / 32], int32 holding the unsigned bits), marked by
scatter-add, a safe OR because only fresh bits are added and an adjacency
row is duplicate-free. Filters, thresholds and soft deletes gate result
admission only; filtered nodes still route.

Ties: the reference sorts with XLA's `lax.sort`, whose CPU sort keeps equal
keys in their input order (checked with one and two sort keys); every sort
here is stable, so equal distances keep the reference's order: the beam
before the new candidates, candidates in adjacency order.

The loop needs no per-iteration sync: a query that is inactive expands
nothing, so its candidates are all (+inf, SENT), the stable merge leaves
its beam, visited bits and result set as they were, and it stays inactive.
The flags are read every ALIVE_EVERY iterations, with the reference's
results (tests/test_torch_graph.py).
"""

from __future__ import annotations

import torch

from comet_tpu_torch.ops.distance import sqrt_f32
from comet_tpu_torch.ops.topk import IDX_SENTINEL, merge_topk
from comet_tpu_torch.types import DistanceKind

INF = float("inf")
ALIVE_EVERY = 8      # iterations between reads of the active flags


def _bits(slots: torch.Tensor) -> torch.Tensor:
    """int32 words with bit slot % 32 set (the unsigned bit 31 as the sign)."""
    b = torch.ones_like(slots, dtype=torch.int64) << (slots & 31).to(torch.int64)
    return torch.where(b >= 2**31, b - 2**32, b).to(torch.int32)


def _neighbor_dists(queries, qn, vectors, sqnorms, neigh, kind):
    """Distances from each query to its own neighbour row: [Q, W], in the
    index's metric space."""
    nc = neigh.clamp_min(0).long()
    ip = torch.einsum("qd,qwd->qw", queries, vectors[nc])
    if kind == DistanceKind.COSINE:
        return 1.0 - torch.clamp(ip, -1.0, 1.0)
    dist = torch.clamp_min(qn + sqnorms[nc] - 2.0 * ip, 0.0)
    if kind == DistanceKind.L2:
        dist = sqrt_f32(dist)
    return dist


def _sort_rows(keys, *rest, num_keys: int):
    """Stable sort of each row by `keys` (then by rest[0] when num_keys is
    2), carrying the other tensors along."""
    order = torch.arange(keys.shape[1], device=keys.device).expand_as(keys)
    if num_keys == 2:
        order = torch.sort(rest[0], dim=1, stable=True).indices
    order = order.gather(1, torch.sort(keys.gather(1, order), dim=1, stable=True).indices)
    return (keys.gather(1, order),) + tuple(t.gather(1, order) for t in rest)


def beam_search_layer0(
    queries: torch.Tensor,      # [Q, d] preprocessed float32
    entry_slots: torch.Tensor,  # [Q] int32 entry points (layer-0 slots)
    adj: torch.Tensor,          # [cap, W] int32 neighbour rows, -1 padded
    vectors: torch.Tensor,      # [cap, d] float32
    sqnorms: torch.Tensor,      # [cap] float32
    allowed: torch.Tensor,      # [cap] bool: result admission
    threshold: float,           # +inf disables
    ef: int,
    k: int,
    kind: DistanceKind,
    max_iters: int,
    expand: int = 1,
    fused_results: bool = True,
    seed_d: torch.Tensor | None = None,   # [Q, n_seed] metric-space distances
    seed_s: torch.Tensor | None = None,   # [Q, n_seed] int32 slots, (inf, SENT) padded
    stop: int | None = None,
):
    """Lockstep ef-beam search (reference beam_search_layer0). Returns
    (res_d [Q, k], res_s [Q, k]) ascending with the (score, slot)
    tie-break, empty = (+inf, IDX_SENTINEL).

    `expand` expands that many best unexpanded candidates an iteration.
    `fused_results` merges every admitted scored node into a result set of
    k rows each iteration (needed when filters, thresholds or deletes make
    admission differ from beam membership); otherwise the results are the
    best k of the final beam, admission applied once. Seeds (rows sorted by
    (dist, slot), duplicate-free, metric-space distances) start the beam,
    with the entry where a row is empty. `stop` narrows the termination
    window to beam row stop - 1 (default ef - 1)."""
    q_n = queries.shape[0]
    cap = adj.shape[0]
    dev = queries.device
    sent = IDX_SENTINEL
    thr = float(threshold)
    qn = (queries * queries).sum(dim=1, keepdim=True)
    entry_slots = entry_slots.to(torch.int32)
    e_d = _neighbor_dists(queries, qn, vectors, sqnorms, entry_slots[:, None], kind)[:, 0]
    n_words = cap // 32
    visited = torch.zeros((q_n, n_words), dtype=torch.int32, device=dev)

    if seed_s is not None:
        sw = seed_s.shape[1]
        seed_d, seed_s = seed_d.to(torch.float32), seed_s.to(torch.int32)
        if sw > ef:     # sorted ascending: the slice keeps the best seeds
            seed_d, seed_s = seed_d[:, :ef], seed_s[:, :ef]
        elif sw < ef:
            seed_d = torch.cat([seed_d, seed_d.new_full((q_n, ef - sw), INF)], dim=1)
            seed_s = torch.cat([seed_s, seed_s.new_full((q_n, ef - sw), sent)], dim=1)
        seeded_rows = seed_s[:, 0] != sent
        cand_d, cand_s = seed_d.clone(), seed_s.clone()
        cand_d[:, 0] = torch.where(seeded_rows, seed_d[:, 0], e_d)
        cand_s[:, 0] = torch.where(seeded_rows, seed_s[:, 0], entry_slots)
        live = cand_s != sent
        sc = torch.where(live, cand_s, 0)
        visited.scatter_add_(1, (sc >> 5).long(),
                             torch.where(live, _bits(sc), torch.zeros_like(sc)))
        ok0 = live & allowed[sc.long()] & (cand_d <= thr)
        sd0, ss0 = _sort_rows(torch.where(ok0, cand_d, torch.full_like(cand_d, INF)),
                              torch.where(ok0, cand_s, torch.full_like(cand_s, sent)),
                              num_keys=2)
        res_d, res_s = sd0[:, :k], ss0[:, :k]
    else:
        cand_d = torch.full((q_n, ef), INF, dtype=torch.float32, device=dev)
        cand_s = torch.full((q_n, ef), sent, dtype=torch.int32, device=dev)
        cand_d[:, 0], cand_s[:, 0] = e_d, entry_slots
        visited.scatter_add_(1, (entry_slots >> 5).long()[:, None], _bits(entry_slots)[:, None])
        res_d = torch.full((q_n, k), INF, dtype=torch.float32, device=dev)
        res_s = torch.full((q_n, k), sent, dtype=torch.int32, device=dev)
        ok0 = allowed[entry_slots.long()] & (e_d <= thr)
        res_d[:, 0] = torch.where(ok0, e_d, torch.full_like(e_d, INF))
        res_s[:, 0] = torch.where(ok0, entry_slots, torch.full_like(entry_slots, sent))
    expanded = torch.zeros((q_n, ef), dtype=torch.bool, device=dev)
    stop_col = ef - 1 if stop is None else min(max(int(stop), 1), ef) - 1

    for it in range(int(max_iters)):
        unexp_d = torch.where(expanded | (cand_s == sent), torch.full_like(cand_d, INF), cand_d)
        worst = cand_d[:, stop_col]
        # the first minima, as argmin and lax.top_k take them
        if expand == 1:
            best_pos = unexp_d.argmin(dim=1, keepdim=True)
        else:
            best_pos = torch.sort(unexp_d, dim=1, stable=True).indices[:, :expand]
        best_d = unexp_d.gather(1, best_pos)
        active = (best_d[:, 0] < INF) & (best_d[:, 0] <= worst)
        do_expand = active[:, None] & (best_d < INF)
        expanded = expanded.scatter(1, best_pos, expanded.gather(1, best_pos) | do_expand)
        nodes = torch.where(do_expand, cand_s.gather(1, best_pos), 0)
        neigh = torch.where(do_expand[:, :, None], adj[nodes.long()], -1).reshape(q_n, -1)
        nc = neigh.clamp_min(0)
        words = visited.gather(1, (nc >> 5).long())
        bits = _bits(nc)
        seen = (words & bits) != 0
        if expand > 1:
            # copies of a slot within the row: all but the first are seen
            sort_idx = torch.sort(neigh, dim=1, stable=True).indices
            sorted_n = neigh.gather(1, sort_idx)
            rep = torch.zeros_like(seen)
            rep[:, 1:] = sorted_n[:, 1:] == sorted_n[:, :-1]
            seen = seen | torch.zeros_like(rep).scatter(1, sort_idx, rep)
        fresh = (neigh >= 0) & ~seen
        visited.scatter_add_(1, (nc >> 5).long(), torch.where(fresh, bits, torch.zeros_like(bits)))

        nd = _neighbor_dists(queries, qn, vectors, sqnorms, neigh, kind)
        nd = torch.where(fresh, nd, torch.full_like(nd, INF))
        ns = torch.where(fresh, neigh, torch.full_like(neigh, sent))

        # merge into the beam, carrying the expanded flags through the sort
        md = torch.cat([cand_d, nd], dim=1)
        ms = torch.cat([cand_s, ns], dim=1)
        me = torch.cat([expanded, torch.zeros_like(fresh)], dim=1)
        if fused_results:
            sd, ss, se = _sort_rows(md, ms, me, num_keys=2)
        else:
            sd, ss, se = _sort_rows(md, ms, me, num_keys=1)
        cand_d, cand_s, expanded = sd[:, :ef], ss[:, :ef], se[:, :ef]

        if fused_results:
            adm = fresh & allowed[nc.long()] & (nd <= thr)
            rd = torch.where(adm, nd, torch.full_like(nd, INF))
            rs = torch.where(rd < INF, neigh, torch.full_like(neigh, sent))
            res_d, res_s = merge_topk(res_d, res_s, rd, rs, k)
        if (it + 1) % ALIVE_EVERY == 0 and not bool(active.any()):
            break

    if fused_results:
        return res_d, res_s
    live = cand_s != sent
    ok = live & allowed[torch.where(live, cand_s, 0).long()] & (cand_d <= thr)
    sd, ss = _sort_rows(torch.where(ok, cand_d, torch.full_like(cand_d, INF)),
                        torch.where(ok, cand_s, torch.full_like(cand_s, sent)), num_keys=2)
    return sd[:, :k], ss[:, :k]


def scatter_graph_update(vectors, sqnorms, adj, vec_rows, vec_values, adj_rows, adj_values):
    """The device sync of an insertion round, in place: new vectors and
    their squared norms, and the touched adjacency rows. Returns (vectors,
    sqnorms, adj)."""
    vectors[vec_rows] = vec_values
    sqnorms[vec_rows] = (vec_values * vec_values).sum(dim=1)
    adj[adj_rows] = adj_values
    return vectors, sqnorms, adj
