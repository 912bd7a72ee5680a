"""Exact flat scan: fused distances + group select (kernel K2), and the
pipeline around it.

Counterpart of comet_tpu/ops/pallas_scan.py (flat mode, float32 corpus).

`fused_dist_select` returns the masked, thresholded distance matrix and the
exact top-kb 128-row groups of every query, ranked by (group minimum,
group id). On a CUDA tensor the distances and group minima come from the
kernel of `csrc/fused_scan.cu` (see the note there), counted in `LAUNCHES`,
and the group choice from K1 (ops/sortnet.py). On a CPU tensor both stages
run their plain PyTorch versions; the device alone decides.

`flat_topk_pipeline` is plain torch around the two kernels: for each chunk
of TQ queries it runs `fused_dist_select`, gathers the member distances of
the kb kept groups and selects the exact top-k of those candidates with K1.
Exactness is the block-select bound of ops/topk.block_topk: with
contiguous groups, ordering groups by (min, id) is consistent with ordering
rows by (score, slot), so keeping min(k, n_groups) groups keeps the top-k.

The mask vector carries the validity of each row: for L2 it holds the
squared norms with +inf on invalid rows, for cosine 0 with +inf on invalid
rows. The threshold applies to the kernel's distance: the squared distance
for L2.
"""

from __future__ import annotations

import numpy as np
import torch

from comet_tpu_torch.ops import _build
from comet_tpu_torch.ops.distance import pairwise_scores_from_norms, sqrt_f32
from comet_tpu_torch.ops.sortnet import topk_rows, use_plain
from comet_tpu_torch.ops.topk import IDX_SENTINEL
from comet_tpu_torch.types import DistanceKind

GROUP = 128   # rows per selection group
TQ = 256      # queries per pipeline chunk: bounds dist at TQ * N floats

# Kernel launches made by `_fused_scan_cuda`.
LAUNCHES = 0


def _fused_dist_select_plain(queries, corpus, mask_vec, thr: float, cosine: bool):
    """Plain PyTorch distances and group minima, in the kernel's order of
    operations. Returns (dist [Q, N], gmin [Q, N // GROUP])."""
    if cosine:
        dist = pairwise_scores_from_norms(
            queries, corpus, mask_vec, DistanceKind.COSINE
        ) + mask_vec[None, :]
    else:
        # the mask vector takes the place of the squared norms
        dist = pairwise_scores_from_norms(
            queries, corpus, mask_vec, DistanceKind.L2_SQUARED
        )
    dist = torch.where(dist <= thr, dist, torch.full_like(dist, float("inf")))
    gmin = dist.view(dist.shape[0], -1, GROUP).amin(dim=2)
    return dist, gmin


def _fused_scan_cuda(queries, corpus, mask_vec, thr: float, cosine: bool):
    """Launch K2. Returns (dist [Q, N], gmin [Q, N // GROUP])."""
    global LAUNCHES
    lib = _build.library()
    q_n, d = queries.shape
    n = corpus.shape[0]
    dev = queries.device
    qn = (queries * queries).sum(dim=1)
    dist = torch.empty((q_n, n), dtype=torch.float32, device=dev)
    gmin = torch.empty((q_n, n // GROUP), dtype=torch.float32, device=dev)
    code = lib.comet_fused_scan(
        queries.data_ptr(), qn.data_ptr(), corpus.data_ptr(),
        mask_vec.data_ptr(), thr, q_n, n, d, int(cosine),
        dist.data_ptr(), gmin.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    LAUNCHES += 1
    _build.check(code, "fused_scan")
    return dist, gmin


def fused_dist_select(
    queries: torch.Tensor,    # [Q, d] float32
    corpus: torch.Tensor,     # [N, d] float32, N % GROUP == 0
    mask_vec: torch.Tensor,   # [N] float32 additive mask (+inf = invalid)
    threshold: float,         # +inf disables
    kb: int,                  # groups to keep per query
    cosine: bool = False,
):
    """Returns (dist [Q, N] float32 with +inf on masked or over-threshold
    entries, gsel [Q, kb] int32: the top-kb group ids of each query in
    (group minimum, group id) order)."""
    if queries.ndim != 2 or corpus.ndim != 2 or queries.shape[1] != corpus.shape[1]:
        raise ValueError(f"shape mismatch: queries {tuple(queries.shape)}, corpus {tuple(corpus.shape)}")
    n = corpus.shape[0]
    if n == 0 or n % GROUP:
        raise ValueError(f"corpus rows ({n}) must be a positive multiple of {GROUP}")
    if mask_vec.shape != (n,):
        raise ValueError(f"mask_vec must be [{n}], got {tuple(mask_vec.shape)}")
    for name, t in (("queries", queries), ("corpus", corpus), ("mask_vec", mask_vec)):
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if t.device != queries.device:
            raise ValueError(f"{name} is on {t.device}, queries on {queries.device}")
    if not 1 <= kb <= n // GROUP:
        raise ValueError(f"kb={kb} outside [1, {n // GROUP}]")
    thr = float(np.float32(threshold))
    if use_plain(queries):
        dist, gmin = _fused_dist_select_plain(queries, corpus, mask_vec, thr, cosine)
    else:
        dist, gmin = _fused_scan_cuda(
            queries.contiguous(), corpus.contiguous(), mask_vec.contiguous(),
            thr, cosine,
        )
    _, gsel = topk_rows(gmin, None, kb)
    return dist, gsel[:, :kb]


def _chunk_topk(qc, corpus, mask_vec, thr, k, kb, cosine, sqrt_out):
    """One chunk of queries: distances + group select -> gather -> exact
    top-k of the kept groups' rows. Returns ([T, k] scores, [T, k] slots)."""
    t = qc.shape[0]
    n_groups = corpus.shape[0] // GROUP
    dist, gsel = fused_dist_select(qc, corpus, mask_vec, thr, kb, cosine)
    cand = torch.gather(
        dist.view(t, n_groups, GROUP), 1,
        gsel.long()[:, :, None].expand(t, kb, GROUP),
    ).reshape(t, kb * GROUP)
    offs = torch.arange(GROUP, dtype=torch.int32, device=qc.device)
    cidx = (gsel[:, :, None] * GROUP + offs).reshape(t, kb * GROUP)
    fv, fi = topk_rows(cand, cidx, k)
    fv, fi = fv[:, :k], fi[:, :k]
    fi = torch.where(torch.isinf(fv), torch.full_like(fi, IDX_SENTINEL), fi)
    if sqrt_out:
        fv = sqrt_f32(fv)
    return fv, fi


def flat_topk_pipeline(
    queries: torch.Tensor,    # [Q, d] float32
    corpus: torch.Tensor,     # [N, d] float32
    mask_vec: torch.Tensor,   # [N] float32 additive mask
    threshold: float,         # on the SQUARED distance for L2; +inf disables
    k: int,
    cosine: bool = False,
    sqrt_out: bool = False,
):
    """Exact masked k-NN of every query. Returns (scores [Q, k] float32,
    slots [Q, k] int32); empty slots carry (+inf, IDX_SENTINEL)."""
    n_groups = corpus.shape[0] // GROUP
    if not 1 <= k <= n_groups * GROUP:
        raise ValueError(f"k={k} outside [1, {n_groups * GROUP}]")
    kb = min(max(1 << max(k - 1, 1).bit_length(), 8), n_groups)
    outs = [
        _chunk_topk(queries[q0:q0 + TQ], corpus, mask_vec, threshold, k, kb,
                    cosine, sqrt_out)
        for q0 in range(0, queries.shape[0], TQ)
    ]
    if not outs:
        return (torch.empty((0, k), dtype=torch.float32, device=queries.device),
                torch.empty((0, k), dtype=torch.int32, device=queries.device))
    return torch.cat([s for s, _ in outs]), torch.cat([i for _, i in outs])
