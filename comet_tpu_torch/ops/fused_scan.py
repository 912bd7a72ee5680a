"""Exact flat scan: fused distances + group select (kernel K2), and the
pipelines around it.

Counterpart of comet_tpu/ops/pallas_scan.py (float32 corpus): the flat
mode and the nprobe (IVF) mode of `fused_dist_select`, `flat_topk_pipeline`
and `ivf_topk_pipeline`.

`fused_dist_select` returns the masked, thresholded distance matrix and the
exact top-kb 128-row groups of every query, ranked by (group minimum,
group id). On a CUDA tensor the distances and group minima come from the
kernel of `csrc/fused_scan.cu` (see the note there), counted in `LAUNCHES`
(flat mode) or `NPROBE_LAUNCHES` (nprobe mode), and the group choice from
K1 (ops/sortnet.py). On a CPU tensor both stages run their plain PyTorch
versions; the device alone decides.

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

In nprobe mode (`assign` and `probes` given) a row whose cluster
`assign[n]` is not among the query's probed clusters is +inf for that
query; rows with assign -1 never match. The kernel tests one bit of a
per-query bitmask of the probed clusters (`_probe_words`), the plain
version looks the cluster up in a [Q, nlist + 1] membership table.
`ivf_topk_pipeline` is the dense IVF search: an exact top-nprobe coarse
choice of clusters per query (K1, ties to the lower centroid id), then the
flat pipeline in nprobe mode.
"""

from __future__ import annotations

import numpy as np
import torch

from comet_tpu_torch.ops import _build
from comet_tpu_torch.ops.distance import f32_matmul, pairwise_scores_from_norms, sqrt_f32
from comet_tpu_torch.ops.sortnet import topk_rows, use_plain
from comet_tpu_torch.ops.topk import IDX_SENTINEL
from comet_tpu_torch.types import DistanceKind

GROUP = 128   # rows per selection group
TQ = 256      # queries per pipeline chunk: bounds dist at TQ * N floats

# Kernel launches made by `_fused_scan_cuda`: flat mode, nprobe mode.
LAUNCHES = 0
NPROBE_LAUNCHES = 0


def _probe_words(probes: torch.Tensor, nlist: int) -> torch.Tensor:
    """[Q, ceil(nlist / 32)] int32 bitmask of each query's probed clusters:
    bit c % 32 of word c // 32 is set when the query probes cluster c."""
    q_n = probes.shape[0]
    n_words = (nlist + 31) // 32
    bits = torch.zeros((q_n, n_words * 32), dtype=torch.bool, device=probes.device)
    bits.scatter_(1, probes.long(), True)
    shifts = torch.arange(32, dtype=torch.int64, device=probes.device)
    words = (bits.view(q_n, n_words, 32).to(torch.int64) << shifts).sum(dim=2)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def _probe_member(probes: torch.Tensor, assign: torch.Tensor, nlist: int) -> torch.Tensor:
    """[Q, N] bool: row n's cluster is among query q's probes (assign -1
    never is)."""
    table = torch.zeros((probes.shape[0], nlist + 1), dtype=torch.bool, device=probes.device)
    table.scatter_(1, probes.long(), True)
    col = torch.where(assign >= 0, assign, torch.full_like(assign, nlist)).long()
    return table[:, col]


def _fused_dist_select_plain(queries, corpus, mask_vec, thr: float, cosine: bool,
                             assign=None, probes=None, nlist: int = 0):
    """Plain PyTorch distances and group minima, in the kernel's order of
    operations; nprobe mode when `assign` is given. Returns
    (dist [Q, N], gmin [Q, N // GROUP])."""
    if cosine:
        dist = pairwise_scores_from_norms(
            queries, corpus, mask_vec, DistanceKind.COSINE
        ) + mask_vec[None, :]
    else:
        # the mask vector takes the place of the squared norms
        dist = pairwise_scores_from_norms(
            queries, corpus, mask_vec, DistanceKind.L2_SQUARED
        )
    inf = torch.full_like(dist, float("inf"))
    dist = torch.where(dist <= thr, dist, inf)
    if assign is not None:
        dist = torch.where(_probe_member(probes, assign, nlist), dist, inf)
    gmin = dist.view(dist.shape[0], -1, GROUP).amin(dim=2)
    return dist, gmin


def _fused_scan_cuda(queries, corpus, mask_vec, thr: float, cosine: bool,
                     assign=None, probes=None, nlist: int = 0):
    """Launch K2 (nprobe mode when `assign` is given). Returns
    (dist [Q, N], gmin [Q, N // GROUP])."""
    global LAUNCHES, NPROBE_LAUNCHES
    lib = _build.library()
    q_n, d = queries.shape
    n = corpus.shape[0]
    dev = queries.device
    qn = (queries * queries).sum(dim=1)
    words, n_words = None, 0
    if assign is not None:
        words = _probe_words(probes, nlist)
        n_words = words.shape[1]
    dist = torch.empty((q_n, n), dtype=torch.float32, device=dev)
    gmin = torch.empty((q_n, n // GROUP), dtype=torch.float32, device=dev)
    code = lib.comet_fused_scan(
        queries.data_ptr(), qn.data_ptr(), corpus.data_ptr(),
        mask_vec.data_ptr(), thr, q_n, n, d, int(cosine),
        assign.data_ptr() if assign is not None else None,
        words.data_ptr() if words is not None else None, n_words,
        dist.data_ptr(), gmin.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if assign is None:
        LAUNCHES += 1
    else:
        NPROBE_LAUNCHES += 1
    _build.check(code, "fused_scan")
    return dist, gmin


def fused_dist_select(
    queries: torch.Tensor,    # [Q, d] float32
    corpus: torch.Tensor,     # [N, d] float32, N % GROUP == 0
    mask_vec: torch.Tensor,   # [N] float32 additive mask (+inf = invalid)
    threshold: float,         # +inf disables
    kb: int,                  # groups to keep per query
    cosine: bool = False,
    assign: torch.Tensor | None = None,   # [N] int32 cluster per row (nprobe mode)
    probes: torch.Tensor | None = None,   # [Q, P] int32 probed clusters
    nlist: int = 0,                       # clusters: ids lie in [0, nlist)
):
    """Returns (dist [Q, N] float32 with +inf on masked, over-threshold or
    (nprobe mode) unprobed entries, gsel [Q, kb] int32: the top-kb group
    ids of each query in (group minimum, group id) order)."""
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
    if (assign is None) != (probes is None):
        raise ValueError("nprobe mode needs both assign and probes")
    if assign is not None:
        if assign.shape != (n,) or assign.dtype != torch.int32:
            raise ValueError(f"assign must be int32 [{n}], got {assign.dtype} {tuple(assign.shape)}")
        if probes.ndim != 2 or probes.shape[0] != queries.shape[0] or probes.dtype != torch.int32:
            raise ValueError(f"probes must be int32 [{queries.shape[0]}, P], got "
                             f"{probes.dtype} {tuple(probes.shape)}")
        if nlist < 1:
            raise ValueError(f"nprobe mode needs nlist >= 1, got {nlist}")
        for name, t in (("assign", assign), ("probes", probes)):
            if t.device != queries.device:
                raise ValueError(f"{name} is on {t.device}, queries on {queries.device}")
    thr = float(np.float32(threshold))
    if use_plain(queries):
        dist, gmin = _fused_dist_select_plain(queries, corpus, mask_vec, thr, cosine,
                                              assign, probes, nlist)
    else:
        dist, gmin = _fused_scan_cuda(
            queries.contiguous(), corpus.contiguous(), mask_vec.contiguous(),
            thr, cosine,
            assign.contiguous() if assign is not None else None,
            probes.contiguous() if probes is not None else None, nlist,
        )
    _, gsel = topk_rows(gmin, None, kb)
    return dist, gsel[:, :kb]


def _chunk_topk(qc, corpus, mask_vec, thr, k, kb, cosine, sqrt_out,
                assign=None, probes=None, nlist=0):
    """One chunk of queries: distances + group select -> gather -> exact
    top-k of the kept groups' rows. Returns ([T, k] scores, [T, k] slots)."""
    t = qc.shape[0]
    n_groups = corpus.shape[0] // GROUP
    dist, gsel = fused_dist_select(qc, corpus, mask_vec, thr, kb, cosine,
                                   assign, probes, nlist)
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
    return _pipeline(queries, corpus, mask_vec, threshold, k, cosine, sqrt_out)


def _pipeline(queries, corpus, mask_vec, threshold, k, cosine, sqrt_out,
              assign=None, probes=None, nlist=0):
    n_groups = corpus.shape[0] // GROUP
    if not 1 <= k <= n_groups * GROUP:
        raise ValueError(f"k={k} outside [1, {n_groups * GROUP}]")
    kb = min(max(1 << max(k - 1, 1).bit_length(), 8), n_groups)
    outs = [
        _chunk_topk(queries[q0:q0 + TQ], corpus, mask_vec, threshold, k, kb,
                    cosine, sqrt_out, assign,
                    probes[q0:q0 + TQ] if probes is not None else None, nlist)
        for q0 in range(0, queries.shape[0], TQ)
    ]
    if not outs:
        return (torch.empty((0, k), dtype=torch.float32, device=queries.device),
                torch.empty((0, k), dtype=torch.int32, device=queries.device))
    return torch.cat([s for s, _ in outs]), torch.cat([i for _, i in outs])


def probe_pad(nprobe: int) -> int:
    """The coarse stage's probe width: nprobe padded to a power of two of
    at least 8 (pallas_scan.py:393, ivf_sparse.py:382)."""
    return max(1 << max(nprobe - 1, 1).bit_length(), 8)


def coarse_probes(queries, centroids, nprobe: int, coarse_cosine: bool, width: int):
    """[Q, width] int32 probed cluster ids: the exact top-nprobe centroids
    of each query by `cn - 2 cq` (L2; the query norm is dropped, as it
    does not change a query's order) or `-cq` (cosine), ties to the lower
    centroid id, padded to `width` by repeating probe 0."""
    cq = f32_matmul(queries, centroids)                     # [Q, nlist]
    if coarse_cosine:
        cd = -cq
    else:
        cn = (centroids * centroids).sum(dim=1)
        cd = cn[None, :] - 2.0 * cq
    probes = topk_rows(cd, None, nprobe)[1][:, :nprobe]
    if width > nprobe:
        probes = torch.cat([probes, probes[:, :1].expand(-1, width - nprobe)], dim=1)
    return probes.contiguous()


def ivf_topk_pipeline(
    queries: torch.Tensor,    # [Q, d] float32
    corpus: torch.Tensor,     # [N, d] float32, N % GROUP == 0
    mask_vec: torch.Tensor,   # [N] float32 additive mask
    threshold: float,         # on the SQUARED distance for L2; +inf disables
    centroids: torch.Tensor,  # [nlist, d] float32
    assign: torch.Tensor,     # [N] int32 cluster per row, -1 for none
    k: int,
    nprobe: int,
    coarse_cosine: bool = False,
    cosine: bool = False,
    sqrt_out: bool = False,
):
    """IVF search as a dense masked scan (pallas_scan.ivf_topk_pipeline):
    the coarse stage picks each query's nprobe clusters, then the flat
    pipeline scans the corpus in nprobe mode. Returns (scores [Q, k]
    float32, slots [Q, k] int32); empty slots carry (+inf, IDX_SENTINEL)."""
    nlist = centroids.shape[0]
    width = probe_pad(nprobe)
    if nlist >= 8:
        width = min(width, nlist)
    probes = coarse_probes(queries, centroids, nprobe, coarse_cosine, width)
    return _pipeline(queries, corpus, mask_vec, threshold, k, cosine, sqrt_out,
                     assign, probes, nlist)
