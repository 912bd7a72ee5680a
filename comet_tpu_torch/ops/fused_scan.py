"""Exact flat scan: fused distances + group select (kernel K2), and the
pipelines around it.

Counterpart of comet_tpu/ops/pallas_scan.py: the flat mode (float32 or
bfloat16 corpus) and the nprobe (IVF) mode of `fused_dist_select`,
`flat_topk_pipeline` and `ivf_topk_pipeline`.

`fused_dist_select` returns the masked, thresholded distance matrix and the
exact top-kb 128-row groups of every query, ranked by (group minimum,
group id). On a CUDA tensor the distances and group minima come from the
kernel of `csrc/fused_scan.cu` (see the note there), counted in `LAUNCHES`
(flat mode), `NPROBE_LAUNCHES` (nprobe mode), `BF16_LAUNCHES`,
`F16_LAUNCHES` or `INT8_LAUNCHES` (the flat mode's bf16, float16 and int8
corpus operands), and the group choice from
K1 (ops/sortnet.py). The kernel has two routes: the 128-query tile, and
for at most `FEWQ_MAX` queries (a store's one-query search, a hybrid
`execute`) the few-query tile, which streams the corpus once and gives
the same bits; its launches count under the mode's counter and also in
`FEWQ_LAUNCHES`. On a CPU tensor both stages run their plain PyTorch
versions; the device alone decides.

`flat_topk_pipeline` is plain torch around the two kernels: for each chunk
of TQ queries it runs `fused_dist_select`, gathers the member distances of
the kb kept groups and selects the exact top-k of those candidates with K1.
Exactness is the block-select bound of ops/topk.block_topk: with
contiguous groups, ordering groups by (min, id) is consistent with ordering
rows by (score, slot), so keeping min(k, n_groups) groups keeps the top-k.

With a bfloat16 corpus (flat `storage="bfloat16"`, pallas_scan.py:82-93)
the queries are rounded to bf16 for the product, which accumulates the
exact bf16 products in float32 from 0 in ascending depth (`bf16_dot`, the
kernel's FMA chain); `qn` stays the norm of the float32 queries
(pallas_scan.py:187) and the mask the float32 squared norms.

A float16 or int8 corpus (flat `storage="float16"|"int8"`) is the scan
the reference runs in XLA (`block_topk` through
`pairwise_scores_from_norms`, comet_tpu/ops/distance.py:60-96): float16
rounds the queries to float16 (`f16_dot`); int8 rounds them to bf16,
widens the rows exactly, and multiplies the float32 sum by the corpus's
abs-max `scale` before the epilogue, whose mask holds the squared norms of
the dequantised rows. Where the reference takes the square root inside
its scan and thresholds the root, these pipelines select on the squared
distance with the threshold squared and take `sqrt_f32` at the end, as
the flat float32 and bf16 scans do.

`kb_cap` (0 = off) keeps fewer selection groups than the exactness bound,
for callers that want an approximate shortlist (the nrefine candidates
of IVFPQ, pallas_scan.py:309-313): the best kb_cap rows stay exact, and
ranks past it come from the kept groups.

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
from comet_tpu_torch.ops.distance import (
    bf16_dot,
    f16_dot,
    f32_matmul,
    pairwise_scores_from_norms,
    sqrt_f32,
)
from comet_tpu_torch.ops.sortnet import topk_rows, use_plain
from comet_tpu_torch.ops.topk import IDX_SENTINEL
from comet_tpu_torch.types import DistanceKind

GROUP = 128   # rows per selection group
TQ = 256      # queries per pipeline chunk: bounds dist at TQ * N floats

# Kernel launches made by `_fused_scan_cuda`: flat mode, nprobe mode, the
# flat mode's bf16, float16 and int8 corpus operands.
LAUNCHES = 0
NPROBE_LAUNCHES = 0
BF16_LAUNCHES = 0
F16_LAUNCHES = 0
INT8_LAUNCHES = 0
# ... of which the few-query route's (any mode)
FEWQ_LAUNCHES = 0

# Queries at or below which the scan takes the few-query tile (all it
# takes, csrc/fused_scan.cu FEWQ_Q_MAX). On an H100 it beat the 128-query
# tile at every Q of 1-32 over 524,288 rows in every operand and mode
# (chip_smoke.py --kernels-only, PERF.md §6).
FEWQ_MAX = 32

# The kernel's operand codes (csrc/fused_scan.cu) by corpus dtype, and the
# dtype the queries are rounded to for the product.
OPERANDS = {torch.float32: (0, torch.float32), torch.bfloat16: (1, torch.bfloat16),
            torch.float16: (2, torch.float16), torch.int8: (3, torch.bfloat16)}


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
                             assign=None, probes=None, nlist: int = 0, scale=None):
    """Plain PyTorch distances and group minima, in the kernel's order of
    operations; nprobe mode when `assign` is given, the bf16, float16 or
    int8 operand for a corpus of that dtype (int8 with its `scale`).
    Returns (dist [Q, N], gmin [Q, N // GROUP])."""
    if corpus.dtype != torch.float32:
        qr = queries.to(OPERANDS[corpus.dtype][1])[:, None, :]
        if corpus.dtype == torch.float16:
            ip = f16_dot(qr, corpus[None, :, :])
        else:
            ip = bf16_dot(qr, corpus[None, :, :])
        if corpus.dtype == torch.int8:
            ip = ip * torch.tensor(scale, dtype=torch.float32, device=ip.device)
        if cosine:
            dist = (1.0 - torch.clamp(ip, -1.0, 1.0)) + mask_vec[None, :]
        else:
            qn = (queries * queries).sum(dim=1, keepdim=True)
            dist = torch.clamp_min((qn + mask_vec[None, :]) - 2.0 * ip, 0.0)
    elif cosine:
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
                     assign=None, probes=None, nlist: int = 0, scale=None):
    """Launch K2 (nprobe mode when `assign` is given, the bf16, float16 or
    int8 operand for a corpus of that dtype, int8 with its `scale`; the
    few-query tile for at most FEWQ_MAX queries).
    Returns (dist [Q, N], gmin [Q, N // GROUP])."""
    global LAUNCHES, NPROBE_LAUNCHES, BF16_LAUNCHES, F16_LAUNCHES, INT8_LAUNCHES, FEWQ_LAUNCHES
    lib = _build.library()
    q_n, d = queries.shape
    n = corpus.shape[0]
    dev = queries.device
    qn = (queries * queries).sum(dim=1)
    operand, q_dtype = OPERANDS[corpus.dtype]
    q = queries.to(q_dtype).contiguous()
    words, n_words = None, 0
    if assign is not None:
        words = _probe_words(probes, nlist)
        n_words = words.shape[1]
    dist = torch.empty((q_n, n), dtype=torch.float32, device=dev)
    gmin = torch.empty((q_n, n // GROUP), dtype=torch.float32, device=dev)
    fewq = q_n <= FEWQ_MAX
    code = lib.comet_fused_scan(
        q.data_ptr(), qn.data_ptr(), corpus.data_ptr(),
        mask_vec.data_ptr(), thr, q_n, n, d, int(cosine), operand,
        float(scale) if scale is not None else 1.0,
        assign.data_ptr() if assign is not None else None,
        words.data_ptr() if words is not None else None, n_words,
        dist.data_ptr(), gmin.data_ptr(), int(fewq),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    with _build.COUNT_LOCK:
        FEWQ_LAUNCHES += int(fewq)
        if corpus.dtype == torch.bfloat16:
            BF16_LAUNCHES += 1
        elif corpus.dtype == torch.float16:
            F16_LAUNCHES += 1
        elif corpus.dtype == torch.int8:
            INT8_LAUNCHES += 1
        elif assign is None:
            LAUNCHES += 1
        else:
            NPROBE_LAUNCHES += 1
    _build.check(code, "fused_scan")
    return dist, gmin


def fused_dist_select(
    queries: torch.Tensor,    # [Q, d] float32
    corpus: torch.Tensor,     # [N, d] float32, bfloat16, float16 or int8, N % GROUP == 0
    mask_vec: torch.Tensor,   # [N] float32 additive mask (+inf = invalid)
    threshold: float,         # +inf disables
    kb: int,                  # groups to keep per query
    cosine: bool = False,
    assign: torch.Tensor | None = None,   # [N] int32 cluster per row (nprobe mode)
    probes: torch.Tensor | None = None,   # [Q, P] int32 probed clusters
    nlist: int = 0,                       # clusters: ids lie in [0, nlist)
    scale: float | None = None,           # an int8 corpus's abs-max scale
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
        if t.dtype != torch.float32 and not (name == "corpus" and t.dtype in OPERANDS):
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if t.device != queries.device:
            raise ValueError(f"{name} is on {t.device}, queries on {queries.device}")
    if not 1 <= kb <= n // GROUP:
        raise ValueError(f"kb={kb} outside [1, {n // GROUP}]")
    if (assign is None) != (probes is None):
        raise ValueError("nprobe mode needs both assign and probes")
    if assign is not None and corpus.dtype != torch.float32:
        raise ValueError("nprobe mode needs a float32 corpus")
    if (scale is None) != (corpus.dtype != torch.int8):
        raise ValueError("an int8 corpus needs its scale, and only an int8 corpus takes one")
    if scale is not None:
        scale = float(np.float32(scale))
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
                                              assign, probes, nlist, scale)
    else:
        dist, gmin = _fused_scan_cuda(
            queries.contiguous(), corpus.contiguous(), mask_vec.contiguous(),
            thr, cosine,
            assign.contiguous() if assign is not None else None,
            probes.contiguous() if probes is not None else None, nlist, scale,
        )
    _, gsel = topk_rows(gmin, None, kb)
    return dist, gsel[:, :kb]


def _chunk_topk(qc, corpus, mask_vec, thr, k, kb, cosine, sqrt_out,
                assign=None, probes=None, nlist=0, scale=None):
    """One chunk of queries: distances + group select -> gather -> exact
    top-k of the kept groups' rows. Returns ([T, k] scores, [T, k] slots)."""
    t = qc.shape[0]
    n_groups = corpus.shape[0] // GROUP
    dist, gsel = fused_dist_select(qc, corpus, mask_vec, thr, kb, cosine,
                                   assign, probes, nlist, scale)
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
    corpus: torch.Tensor,     # [N, d] float32, bfloat16, float16 or int8
    mask_vec: torch.Tensor,   # [N] float32 additive mask
    threshold: float,         # on the SQUARED distance for L2; +inf disables
    k: int,
    cosine: bool = False,
    sqrt_out: bool = False,
    kb_cap: int = 0,
    scale: float | None = None,
):
    """Exact masked k-NN of every query (approximate past rank kb_cap when
    kb_cap > 0; an int8 corpus takes its `scale`). Returns (scores [Q, k]
    float32, slots [Q, k] int32); empty slots carry (+inf, IDX_SENTINEL)."""
    return _pipeline(queries, corpus, mask_vec, threshold, k, cosine, sqrt_out,
                     kb_cap=kb_cap, scale=scale)


def _pipeline(queries, corpus, mask_vec, threshold, k, cosine, sqrt_out,
              assign=None, probes=None, nlist=0, kb_cap=0, scale=None):
    n_groups = corpus.shape[0] // GROUP
    if not 1 <= k <= n_groups * GROUP:
        raise ValueError(f"k={k} outside [1, {n_groups * GROUP}]")
    kb = min(max(1 << max(k - 1, 1).bit_length(), 8), n_groups)
    if kb_cap:
        kb = min(kb, max(1 << max(kb_cap - 1, 1).bit_length(), 8))
    outs = [
        _chunk_topk(queries[q0:q0 + TQ], corpus, mask_vec, threshold, k, kb,
                    cosine, sqrt_out, assign,
                    probes[q0:q0 + TQ] if probes is not None else None, nlist, scale)
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
    kb_cap: int = 0,
):
    """IVF search as a dense masked scan (pallas_scan.ivf_topk_pipeline):
    the coarse stage picks each query's nprobe clusters, then the flat
    pipeline scans the corpus in nprobe mode (`kb_cap` as in
    `flat_topk_pipeline`). Returns (scores [Q, k] float32, slots [Q, k]
    int32); empty slots carry (+inf, IDX_SENTINEL)."""
    nlist = centroids.shape[0]
    width = probe_pad(nprobe)
    if nlist >= 8:
        width = min(width, nlist)
    probes = coarse_probes(queries, centroids, nprobe, coarse_cosine, width)
    return _pipeline(queries, corpus, mask_vec, threshold, k, cosine, sqrt_out,
                     assign, probes, nlist, kb_cap)
