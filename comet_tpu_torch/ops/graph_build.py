"""Bulk HNSW graph construction: staged exact-kNN rounds.

Counterpart of comet_tpu/ops/graph_build.py. A layer's nodes are taken in
doubling stages (64, 64, 128, ...): each stage's nodes take their forward
edges from an exact kNN against the prefix [0, stage end) of the layer, so
early nodes keep the long-range edges that make the graph navigable (the
reference's insert loop with efConstruction = infinity). Forward edges are
selected from the kNN pool by the HNSW paper's neighbour heuristic (admit a
candidate if it is closer to the node than to every neighbour admitted
before it, then backfill the nearest), and the reverse edges of a whole
layer are appended in one pass that re-selects overflowing rows with the
same heuristic.

Stage kNN: every stage runs through `flat_topk_pipeline` (ops/fused_scan.py,
kernels K2 and K1 on a CUDA device, their plain versions on the CPU) over
the whole capacity-padded corpus with the mask `where(rank < hi, sqnorm,
inf)`: rows that are not among the first `hi` members of the layer are
out. (The reference runs the stages of at most 2048 prefix rows as a host
matmul; on integer data the distances and their order are the same.)
Distances are kernel-domain (squared L2, or cosine distance) and
comparison-only; ties follow (distance asc, slot asc). Pairwise candidate
distances take bf16-rounded vectors with float32 accumulation, as the
reference's bf16 matmul does. The adjacency stays on the index's device
for the whole layer.

The reference's TPU workarounds (one canonical shape for every stage,
pooled host buffers, a narrow upload format) are left out: they change no
result.
"""

from __future__ import annotations

import numpy as np
import torch

from comet_tpu_torch.ops.distance import bf16_round
from comet_tpu_torch.ops.fused_scan import GROUP, flat_topk_pipeline
from comet_tpu_torch.ops.topk import IDX_SENTINEL, dist_key_bits
from comet_tpu_torch.types import DistanceKind

# The first stage is small so that the early nodes keep long-range edges.
FIRST_STAGE = 64
QUERY_CHUNK = 32768   # stage queries per flat-pipeline call
FIN_CHUNK = 16384     # rows per re-selection chunk of the reverse pass
RANK_NONE = 2**31 - 1
SENT = IDX_SENTINEL


def _finalize_math(corpus, cand_s, cand_d, own, select: int, out_width: int, cosine: bool):
    """Self-strip, slot dedup (keeping the smaller distance), (dist, slot)
    order, pairwise bf16 distances, greedy relative-neighbourhood
    admission, admitted first with the nearest non-admitted as backfill.
    cand_s [B, C] int32 (SENT empty), cand_d [B, C] float32, own [B] int32
    (-2: no self). Returns (slots [B, out_width], dists [B, out_width]):
    the best `select`, SENT / +inf padded."""
    b, c = cand_s.shape
    dev = cand_s.device
    inf = torch.full_like(cand_d, float("inf"))
    invalid = (cand_s == SENT) | (cand_s == own[:, None])
    d0 = torch.where(invalid, inf, cand_d)
    s0 = torch.where(invalid, torch.full_like(cand_s, SENT), cand_s)
    # dedup: (slot, dist) order puts a slot's copies together, smaller first
    k1 = torch.sort((s0.to(torch.int64) << 32) | dist_key_bits(d0), dim=1).values
    s1 = (k1 >> 32).to(torch.int32)
    d1 = (k1 & 0xFFFFFFFF).to(torch.int32).view(torch.float32)
    dup = torch.zeros_like(s1, dtype=torch.bool)
    dup[:, 1:] = (s1[:, 1:] == s1[:, :-1]) & (s1[:, 1:] != SENT)
    d1 = torch.where(dup, inf, d1)
    s1 = torch.where(dup, torch.full_like(s1, SENT), s1)
    # canonical (dist asc, slot asc) candidate order
    k2 = torch.sort((dist_key_bits(d1) << 32) | s1.to(torch.int64), dim=1).values
    d2 = (k2 >> 32).to(torch.int32).view(torch.float32)
    s2 = (k2 & 0xFFFFFFFF).to(torch.int32)

    cv = bf16_round(corpus[s2.clamp(0, corpus.shape[0] - 1).long()])   # [B, C, d]
    ip = _bmm_f32(cv)
    if cosine:
        pair_d = 1.0 - torch.clamp(ip, -1.0, 1.0)
    else:
        sq = (cv * cv).sum(dim=2)
        pair_d = torch.clamp_min(sq[:, :, None] + sq[:, None, :] - 2.0 * ip, 0.0)
    valid = (s2 != SENT) & torch.isfinite(d2)
    mind = torch.full((b, c), float("inf"), dtype=torch.float32, device=dev)
    cols = []
    for j in range(c):
        admit = (d2[:, j] < mind[:, j]) & valid[:, j]
        mind = torch.where(admit[:, None], torch.minimum(mind, pair_d[:, :, j]), mind)
        cols.append(admit)
    admitted = torch.stack(cols, dim=1)
    # admitted first (in distance order), then the nearest non-admitted
    order = torch.sort((~admitted).to(torch.int8), dim=1, stable=True).indices
    s3, d3 = s2.gather(1, order), d2.gather(1, order)
    width = max(select, out_width)
    if c < width:
        s3 = torch.cat([s3, s3.new_full((b, width - c), SENT)], dim=1)
        d3 = torch.cat([d3, d3.new_full((b, width - c), float("inf"))], dim=1)
    s3, d3 = s3[:, :select], d3[:, :select]
    if select < out_width:
        s3 = torch.cat([s3, s3.new_full((b, out_width - select), SENT)], dim=1)
        d3 = torch.cat([d3, d3.new_full((b, out_width - select), float("inf"))], dim=1)
    return s3, d3


def _bmm_f32(cv: torch.Tensor) -> torch.Tensor:
    """cv @ cv^T per batch row, in full float32 (never TF32 on the card)."""
    if cv.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("torch.backends.cuda.matmul.allow_tf32 is on: the pairwise "
                           "distances need full-float32 products")
    return torch.bmm(cv, cv.transpose(1, 2))


class BulkGraphBuilder:
    """Builds every layer of one HNSW graph over a capacity-padded corpus.

    `device_vectors` [cap, d] float32 (rows >= n are padding) and
    `device_sqnorms` [cap] are the rows and their squared norms on the
    build's device (the index's device mirror)."""

    def __init__(self, n: int, kind: DistanceKind, device_vectors: torch.Tensor,
                 device_sqnorms: torch.Tensor):
        self.n = n
        self.cosine = kind == DistanceKind.COSINE
        self.corpus = device_vectors
        self.sqnorms = device_sqnorms
        if device_vectors.shape[0] % GROUP:
            raise ValueError(f"the device corpus rows ({device_vectors.shape[0]}) must be a "
                             f"multiple of {GROUP}")

    def build_layer(self, members: np.ndarray | None, m_forward: int, width: int,
                    first_stage: int = FIRST_STAGE) -> np.ndarray:
        """Staged construction of one layer over `members` (global slots,
        ascending; None = all rows [0, n)). Returns adj [n, width] int32,
        -1 padded, global slots; only member rows are populated."""
        n = self.n
        dev = self.corpus.device
        order = (np.arange(n, dtype=np.int32) if members is None
                 else np.asarray(members, dtype=np.int32))
        nloc = len(order)
        if nloc <= 1:
            return np.full((n, width), -1, np.int32)
        order_dev = torch.from_numpy(order).to(dev)
        rank_dev = torch.full((self.corpus.shape[0],), RANK_NONE, dtype=torch.int32, device=dev)
        rank_dev[order_dev.long()] = torch.arange(nloc, dtype=torch.int32, device=dev)
        adj_s = torch.full((n, width), SENT, dtype=torch.int32, device=dev)
        adj_d = torch.full((n, width), float("inf"), dtype=torch.float32, device=dev)
        pool = 2 * m_forward
        out_w = max(width, 2 * m_forward)
        select = min(m_forward, width)
        lo, hi = 0, min(first_stage, nloc)
        while lo < nloc:
            self._stage(adj_s, adj_d, order_dev, rank_dev, lo, hi, min(pool + 1, hi), select,
                        width, out_w)
            lo, hi = hi, min(2 * hi, nloc)
        out = self._append(adj_s, adj_d, order_dev, width)
        return out.cpu().numpy()

    def _stage(self, adj_s, adj_d, order_dev, rank_dev, lo, hi, k, select, width, out_w):
        """One stage's kNN through the flat pipeline, QUERY_CHUNK queries at
        a time, then the finalize and the scatter of the stage's rows."""
        base = torch.zeros_like(self.sqnorms) if self.cosine else self.sqnorms
        mask = torch.where(rank_dev < hi, base, torch.full_like(base, float("inf")))
        for q0 in range(lo, hi, QUERY_CHUNK):
            rows = order_dev[q0:min(q0 + QUERY_CHUNK, hi)]
            dh, sh = flat_topk_pipeline(self.corpus[rows.long()], self.corpus, mask,
                                        float("inf"), k, cosine=self.cosine, sqrt_out=False)
            fs, fd = _finalize_math(self.corpus, sh, dh, rows, select, out_w, self.cosine)
            adj_s[rows.long()] = fs[:, :width]
            adj_d[rows.long()] = fd[:, :width]

    def _append(self, adj_s, adj_d, order_dev, width: int) -> torch.Tensor:
        """The layer's reverse edges: every forward edge (src -> dst) sorted
        by (dst, dist, src), the first 2 width per destination appended to
        its row, and every member row re-selected (FIN_CHUNK rows at a
        time) with the heuristic. Returns [n, width] int32, -1 padded."""
        n = self.n
        dev = adj_s.device
        ol = order_dev.long()
        fwd_s = adj_s[ol]                                   # [L, w]
        fwd_d = adj_d[ol]
        w = fwd_s.shape[1]
        dst = fwd_s.reshape(-1).to(torch.int64)
        src = order_dev[:, None].expand(-1, w).reshape(-1).to(torch.int64)
        dd = fwd_d.reshape(-1)
        # (dst, dist, src) order: a sort by (dist, src), then a stable one by dst
        o1 = torch.sort((dist_key_bits(dd) << 32) | src, dim=0).indices
        dst, dd, src = dst[o1], dd[o1], src[o1]
        o2 = torch.sort(dst, dim=0, stable=True).indices
        dst, dd, src = dst[o2], dd[o2], src[o2]
        e = dst.shape[0]
        iota = torch.arange(e, dtype=torch.int64, device=dev)
        is_start = torch.ones(e, dtype=torch.bool, device=dev)
        is_start[1:] = dst[1:] != dst[:-1]
        run_start = torch.cummax(torch.where(is_start, iota, torch.zeros_like(iota)), dim=0).values
        rank = iota - run_start
        cap2 = 2 * width   # the heuristic can admit beyond the nearest `width`
        keep = (dst != SENT) & (rank < cap2)
        app_s = torch.full((n, cap2), SENT, dtype=torch.int32, device=dev)
        app_d = torch.full((n, cap2), float("inf"), dtype=torch.float32, device=dev)
        app_s[dst[keep], rank[keep]] = src[keep].to(torch.int32)
        app_d[dst[keep], rank[keep]] = dd[keep]
        out = torch.full((n, width), -1, dtype=torch.int32, device=dev)
        no_self = torch.full((FIN_CHUNK,), -2, dtype=torch.int32, device=dev)
        for r0 in range(0, ol.shape[0], FIN_CHUNK):
            rows = ol[r0:r0 + FIN_CHUNK]
            cs = torch.cat([adj_s[rows], app_s[rows]], dim=1)
            cd = torch.cat([adj_d[rows], app_d[rows]], dim=1)
            ss, _ = _finalize_math(self.corpus, cs, cd, no_self[:rows.shape[0]], width, width,
                                   self.cosine)
            out[rows] = torch.where(ss == SENT, torch.full_like(ss, -1), ss)
        return out
