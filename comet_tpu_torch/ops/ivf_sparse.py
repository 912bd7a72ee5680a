"""Block-sparse IVF scan (kernel K3) and the pipeline around it.

Counterpart of comet_tpu/ops/ivf_sparse.py, float32 distances. Compute
tracks nprobe:

  1. The corpus is laid out CLUSTER-MAJOR (`build_cluster_major`): each
     inverted list occupies a contiguous run of 256-row chunks; padding rows
     carry +inf in the additive mask.
  2. Queries are sorted by the spatial key of their nearest centroid
     (`cluster_order_key`) and cut into groups of QG = 128, so the queries
     of a group probe overlapping clusters.
  3. `_group_chunk_lists` gives every group its deduplicated list of S
     chunks, ordered by best probe rank; steps past the group's need are
     dead (cluster id -1).
  4. `_sparse_scan` computes, per (group, step), the [128 queries x 256
     rows] distance tile of the listed chunk with the reference's epilogue,
     +inf for every query that does not probe the chunk's cluster, and the
     minima of the tile's two 128-row selection groups. On a CUDA tensor
     the kernel of `csrc/ivf_sparse.cu` does it (see the note there),
     counted in `LAUNCHES`; on a CPU tensor `_sparse_scan_plain`. K1 then
     picks each query's top-kb groups by (minimum, scan position), which is
     the set and order the reference kernel's running selection keeps.
  5. The kept groups' distances are gathered and reduced to the top-k by
     K1; local row -> cluster-major row -> slot; a (score, slot) sort
     within the k_pow2 candidates; the inverse query permutation.

Exactness and divergences are the reference's: distances are float32, the
top-k SET is exact within the scanned chunks, score ties at the k-th
boundary break by scan order and not slot order, and a group's walk is
budgeted at S steps and UC distinct clusters; the returned per-group
overflow counts every chunk dropped, and indexes/ivf.py rescans with a
larger S until it is zero.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from comet_tpu_torch.ops import _build
from comet_tpu_torch.ops.distance import f32_matmul, sqrt_f32
from comet_tpu_torch.ops.fused_scan import coarse_probes, probe_pad
from comet_tpu_torch.ops.kmeans import kmeans
from comet_tpu_torch.ops.sortnet import k_pow2, topk_rows, use_plain
from comet_tpu_torch.ops.topk import IDX_SENTINEL
from comet_tpu_torch.types import DistanceKind

CHUNK = 256      # corpus rows per chunk (two 128-row selection groups)
SEL_GROUP = 128  # rows per selection group
QG = 128         # queries per kernel group
BIG = 2**30
DEFAULT_MEM_GB = 8.0   # see `_mem_envelope_bytes`

# Kernel launches made by `_sparse_scan_cuda`.
LAUNCHES = 0


# -- layout (host) ---------------------------------------------------------------


def build_cluster_major(assign: np.ndarray, nlist: int, chunk: int = CHUNK) -> dict:
    """Cluster-major row layout from per-slot assignments (host, numpy).

    Each cluster's slots occupy a contiguous run of `chunk`-row blocks,
    padded with -1. Returns dict with:
      perm        [NR] int32  — slot per physical row (-1 = padding)
      chunk_start [nlist + 1] int32 — cluster c owns chunks [s_c, s_{c+1})
      nchunks     [nlist] int32
      max_chunks  int — max chunks of any single cluster
    """
    assign = np.asarray(assign)
    order = np.argsort(assign, kind="stable")
    sorted_assign = assign[order]
    pos0 = np.searchsorted(sorted_assign, 0)  # skip unassigned (-1)
    slots = order[pos0:].astype(np.int32)
    lists = sorted_assign[pos0:]
    counts = (
        np.bincount(lists, minlength=nlist)
        if len(lists)
        else np.zeros(nlist, dtype=np.int64)
    )
    nchunks = -(-counts // chunk)  # ceil
    chunk_start = np.zeros(nlist + 1, dtype=np.int32)
    chunk_start[1:] = np.cumsum(nchunks)
    nr = max(int(chunk_start[-1]), 1) * chunk
    perm = np.full(nr, -1, dtype=np.int32)
    if len(slots):
        starts = np.zeros(nlist, dtype=np.int64)
        np.cumsum(counts[:-1], out=starts[1:])
        within = np.arange(len(slots)) - starts[lists]
        rows = chunk_start[lists].astype(np.int64) * chunk + within
        perm[rows] = slots
    return {
        "perm": perm,
        "chunk_start": chunk_start,
        "nchunks": nchunks.astype(np.int32),
        "max_chunks": max(int(nchunks.max()) if nlist else 1, 1),
    }


def cluster_order_key(centroids: np.ndarray, *, device="cuda") -> np.ndarray:
    """Spatial ordering key per cluster: nearby centroids -> nearby keys.

    k-means the centroids into ~nlist/64 super-clusters (on `device`) and
    key by the super-cluster. Query batches sorted by this key put
    spatially close queries into the same 128-query group, which keeps each
    group's probed-chunk union small."""
    nlist = len(centroids)
    nsuper = max(min(nlist // 64, 64), 1)
    if nsuper <= 1:
        return np.arange(nlist, dtype=np.int32)
    cents = torch.as_tensor(np.asarray(centroids, dtype=np.float32), device=device)
    _, sup_assign = kmeans(cents, nsuper, DistanceKind.L2_SQUARED, 10)
    return sup_assign.cpu().numpy().astype(np.int32)


def default_budgets(
    nprobe: int, nlist: int, nchunks_total: int, max_chunks: int
) -> tuple[int, int, int]:
    """(S, UC, MC) budgets for a batch: S covers ~4x a single query's probed
    chunks (group members share most probes when sorted by coarse cell),
    capped at the whole table."""
    avg_chunks = max(nchunks_total / max(nlist, 1), 1.0)
    npad = probe_pad(nprobe)
    want = int(npad * avg_chunks * 4)
    S = 1 << max(int(want - 1).bit_length(), 5)
    S = min(S, 1 << max(int(nchunks_total - 1).bit_length(), 5))
    UC = min(S, nlist)
    return S, UC, max_chunks


# -- per-batch chunk lists (device) -------------------------------------------------


def _group_chunk_lists(probes, chunk_start, nchunks, S: int, UC: int, MC: int, nlist: int):
    """Per-group deduplicated chunk walk lists, ordered by best probe rank.

    probes [Q, P] int32 (query-sorted, Q % QG == 0), chunk_start
    [nlist + 1] and nchunks [nlist] int32, all on one device. Returns
    (chunk_ids [G, S] int32, cluster_ids [G, S] int32 (-1 dead),
    n_real [G] int32, overflow [G] int32)."""
    q_n, p = probes.shape
    if p * nlist >= BIG:
        raise ValueError(f"probe width {p} x nlist {nlist} too large")
    g_n = q_n // QG
    dev = probes.device
    pg = probes.reshape(g_n, QG * p).long()
    ranks = torch.arange(QG * p, device=dev) % p
    # min probe rank per distinct cluster: sort by (cluster, rank)
    ks = torch.sort(pg * p + ranks, dim=1).values
    c_s, r_s = ks // p, ks % p
    first = torch.cat(
        [torch.ones((g_n, 1), dtype=torch.bool, device=dev), c_s[:, 1:] != c_s[:, :-1]], dim=1
    )
    big = torch.full_like(ks, BIG)
    sel_key = torch.sort(torch.where(first, r_s * nlist + c_s, big), dim=1).values[:, :UC]
    valid_c = sel_key < BIG                              # ordered by (rank, cluster)
    c_u = torch.where(valid_c, sel_key % nlist, torch.zeros_like(sel_key))
    cs64, nc64 = chunk_start.long(), nchunks.long()
    # expand clusters to chunks: exclusive cumsum of the chunk counts
    base = cs64[c_u]                                     # [G, UC]
    nch = torch.where(valid_c, nc64[c_u], torch.zeros_like(c_u))
    off = torch.cumsum(nch, dim=1) - nch
    i = torch.arange(MC, device=dev)[None, None, :]
    pos = off[:, :, None] + i                            # [G, UC, MC]
    ok = valid_c[:, :, None] & (i < nch[:, :, None]) & (pos < S)
    # torch's scatter has no "drop" mode: dropped entries land in a spare
    # column S, which is cut off
    pos_safe = torch.where(ok, pos, torch.full_like(pos, S)).reshape(g_n, -1)
    chunk_val = (base[:, :, None] + i).reshape(g_n, -1)
    clus_val = c_u[:, :, None].expand(-1, -1, MC).reshape(g_n, -1)
    spare = torch.full((g_n, S + 1), -1, dtype=torch.int64, device=dev)
    chunk_ids = spare.clone().scatter_(1, pos_safe, chunk_val)[:, :S]
    cluster_ids = spare.scatter_(1, pos_safe, clus_val)[:, :S]
    # chunks wanted across ALL distinct probed clusters, before the UC and S
    # cuts, so overflow counts every dropped chunk
    total_wanted = torch.where(first, nc64[c_s.clamp(0, nlist - 1)], torch.zeros_like(c_s)).sum(dim=1)
    n_kept = (off + nch)[:, -1]
    # dead steps repeat a real chunk under an all-inf result; a group that
    # probed only empty clusters has every step dead: clamp
    chunk_ids = torch.where(cluster_ids < 0, chunk_ids[:, :1].clamp_min(0), chunk_ids)
    n_real = torch.clamp_max(n_kept, S)
    overflow = total_wanted - n_real
    i32 = torch.int32
    return chunk_ids.to(i32), cluster_ids.to(i32), n_real.to(i32), overflow.to(i32)


# -- the sparse scan: K3 and its plain version ----------------------------------------


def _sparse_scan_plain(qsorted, corpus, mask_vec, probes, chunk_ids, cluster_ids,
                       thr: float, cosine: bool):
    """Plain PyTorch version of K3, in the kernel's order of operations.

    qsorted [G * QG, d], corpus [NR, d] cluster-major, mask_vec [NR],
    probes [G * QG, P], chunk_ids / cluster_ids [G, S]. Returns
    (dist [G, QG, S * CHUNK], gmin [G, QG, 2 S]) float32; gmin position
    2 s + h is the minimum of rows h * 128 ... of step s."""
    g_n, s_n = chunk_ids.shape
    d = qsorted.shape[1]
    dev = qsorted.device
    rows = (chunk_ids.long()[:, :, None] * CHUNK
            + torch.arange(CHUNK, device=dev)).reshape(g_n, s_n * CHUNK)
    q = qsorted.view(g_n, QG, d)
    ip = torch.stack([f32_matmul(q[g], corpus[rows[g]]) for g in range(g_n)])
    m = mask_vec[rows][:, None, :]                       # [G, 1, S * CHUNK]
    if cosine:
        dist = (1.0 - torch.clamp(ip, -1.0, 1.0)) + m
    else:
        qn = (q * q).sum(dim=2, keepdim=True)
        dist = torch.clamp_min((qn + m) - 2.0 * ip, 0.0)
    inf = torch.full_like(dist, float("inf"))
    dist = torch.where(dist <= thr, dist, inf)
    pr = probes.view(g_n, QG, -1)
    member = (pr[:, :, :, None] == cluster_ids[:, None, None, :]).any(dim=2)  # [G, QG, S]
    dist = torch.where(member.repeat_interleave(CHUNK, dim=2), dist, inf)
    gmin = dist.view(g_n, QG, 2 * s_n, SEL_GROUP).amin(dim=3)
    return dist, gmin


def _sparse_scan_cuda(qsorted, corpus, mask_vec, probes, chunk_ids, cluster_ids,
                      thr: float, cosine: bool):
    """Launch K3. Returns (dist [G, QG, S * CHUNK], gmin [G, QG, 2 S])."""
    global LAUNCHES
    lib = _build.library()
    g_n, s_n = chunk_ids.shape
    d = qsorted.shape[1]
    dev = qsorted.device
    qn = (qsorted * qsorted).sum(dim=1)
    dist = torch.empty((g_n, QG, s_n * CHUNK), dtype=torch.float32, device=dev)
    gmin = torch.empty((g_n, QG, 2 * s_n), dtype=torch.float32, device=dev)
    code = lib.comet_sparse_scan(
        qsorted.data_ptr(), qn.data_ptr(), corpus.data_ptr(), mask_vec.data_ptr(),
        probes.data_ptr(), probes.shape[1], chunk_ids.data_ptr(),
        cluster_ids.data_ptr(), thr, g_n, s_n, d, int(cosine),
        dist.data_ptr(), gmin.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    LAUNCHES += 1
    _build.check(code, "sparse_scan")
    return dist, gmin


def _sparse_scan(qsorted, corpus, mask_vec, probes, chunk_ids, cluster_ids,
                 threshold: float, kb: int, cosine: bool = False):
    """Distances of the listed chunks and each query's top-kb selection
    groups. Returns (dist [G, QG, S * CHUNK] float32, gsel [G, QG, kb]
    int32: group positions 2 s + h in (group minimum, position) order)."""
    g_n, s_n = chunk_ids.shape
    if qsorted.ndim != 2 or qsorted.shape[0] != g_n * QG:
        raise ValueError(f"qsorted must be [{g_n * QG}, d], got {tuple(qsorted.shape)}")
    d = qsorted.shape[1]
    if corpus.ndim != 2 or corpus.shape[1] != d or corpus.shape[0] % CHUNK:
        raise ValueError(f"corpus must be [NR, {d}] with NR % {CHUNK} == 0, got {tuple(corpus.shape)}")
    if mask_vec.shape != (corpus.shape[0],):
        raise ValueError(f"mask_vec must be [{corpus.shape[0]}], got {tuple(mask_vec.shape)}")
    if probes.ndim != 2 or probes.shape[0] != qsorted.shape[0]:
        raise ValueError(f"probes must be [{qsorted.shape[0]}, P], got {tuple(probes.shape)}")
    if cluster_ids.shape != chunk_ids.shape:
        raise ValueError("chunk_ids and cluster_ids differ in shape")
    for name, t, dt in (("qsorted", qsorted, torch.float32), ("corpus", corpus, torch.float32),
                        ("mask_vec", mask_vec, torch.float32), ("probes", probes, torch.int32),
                        ("chunk_ids", chunk_ids, torch.int32),
                        ("cluster_ids", cluster_ids, torch.int32)):
        if t.dtype != dt:
            raise ValueError(f"{name} must be {dt}, got {t.dtype}")
        if t.device != qsorted.device:
            raise ValueError(f"{name} is on {t.device}, qsorted on {qsorted.device}")
    if not 1 <= kb <= 2 * s_n:
        raise ValueError(f"kb={kb} outside [1, {2 * s_n}]")
    thr = float(np.float32(threshold))
    args = [t.contiguous() for t in (qsorted, corpus, mask_vec, probes, chunk_ids, cluster_ids)]
    if use_plain(qsorted):
        dist, gmin = _sparse_scan_plain(*args, thr, cosine)
    else:
        dist, gmin = _sparse_scan_cuda(*args, thr, cosine)
    gsel = topk_rows(gmin.view(g_n * QG, 2 * s_n), None, kb)[1][:, :kb]
    return dist, gsel.reshape(g_n, QG, kb)


# -- the pipeline -------------------------------------------------------------------


def scan_plan(q, centroids, order_key, chunk_start, nchunks, k, nprobe,
              S, UC, MC, nlist, coarse_cosine):
    """The scan's inputs for one slice of queries (a multiple of QG):
    coarse probes, the stable query sort by the order key of each query's
    nearest centroid, and the groups' chunk lists. kb is a power of two
    >= k (block-select bound) and S grows so that at least kb selection
    groups exist (the extra steps are dead). Returns a dict of qperm,
    qsorted, probes (sorted), chunk_ids, cluster_ids, overflow, kb, S."""
    kb = k_pow2(k)
    S = max(S, -(-kb * SEL_GROUP // CHUNK))
    probes = coarse_probes(q, centroids, nprobe, coarse_cosine, probe_pad(nprobe))
    p0 = probes[:, 0].long()
    qperm = torch.argsort(order_key.long()[p0] * nlist + p0, stable=True)
    probes_s = probes[qperm]
    chunk_ids, cluster_ids, _, overflow = _group_chunk_lists(
        probes_s, chunk_start, nchunks, S, UC, MC, nlist)
    return dict(qperm=qperm, qsorted=q[qperm], probes=probes_s, chunk_ids=chunk_ids,
                cluster_ids=cluster_ids, overflow=overflow, kb=kb, S=S)


def _pipeline(q, corpus, mask_vec, row_slot, thr, centroids, order_key,
              chunk_start, nchunks, k, nprobe, S, UC, MC, nlist,
              coarse_cosine, cosine, sqrt_out):
    """One slice of queries (a multiple of QG). Returns (scores [Q, k],
    slots [Q, k] int32, overflow [G] int32)."""
    q_n = q.shape[0]
    dev = q.device
    plan = scan_plan(q, centroids, order_key, chunk_start, nchunks, k, nprobe,
                     S, UC, MC, nlist, coarse_cosine)
    qperm, chunk_ids, kb, S = plan["qperm"], plan["chunk_ids"], plan["kb"], plan["S"]
    dist, gsel = _sparse_scan(plan["qsorted"], corpus, mask_vec, plan["probes"], chunk_ids,
                              plan["cluster_ids"], thr, kb, cosine)

    # candidate stage, every group at once (the flat pipeline's structure)
    d3 = dist.view(q_n, 2 * S, SEL_GROUP)
    gs = gsel.view(q_n, kb)
    cand = torch.gather(d3, 1, gs.long()[:, :, None].expand(q_n, kb, SEL_GROUP))
    offs = torch.arange(SEL_GROUP, dtype=torch.int32, device=dev)
    cidx = (gs[:, :, None] * SEL_GROUP + offs).reshape(q_n, kb * SEL_GROUP)
    fv, fi = topk_rows(cand.reshape(q_n, kb * SEL_GROUP), cidx, k)   # [Q, k_pow2]
    # local index -> cluster-major row -> slot
    sent = fi == IDX_SENTINEL
    step = torch.clamp_max(fi // CHUNK, S - 1).long()
    chunks = chunk_ids.repeat_interleave(QG, dim=0)                    # [Q, S]
    grow = torch.gather(chunks, 1, step).long() * CHUNK + (fi % CHUNK)
    slot = row_slot[torch.where(sent, torch.zeros_like(grow), grow)]
    drop = sent | torch.isinf(fv)
    slot = torch.where(drop, torch.full_like(slot, IDX_SENTINEL), slot)
    fv = torch.where(drop, torch.full_like(fv, float("inf")), fv)
    # deterministic (score, slot) order within the k_pow2 candidates
    fv, slot = topk_rows(fv, slot, fv.shape[1])
    fv, slot = fv[:, :k], slot[:, :k]
    if sqrt_out:
        fv = sqrt_f32(fv)
    inv = torch.empty_like(qperm)
    inv[qperm] = torch.arange(q_n, device=dev)
    return fv[inv], slot[inv], plan["overflow"]


def _mem_envelope_bytes() -> int:
    """Budget for one launch's [G, QG, S * CHUNK] float32 distance tensor
    (COMET_SPARSE_MEM_GB; default DEFAULT_MEM_GB = 8 GiB, a tenth of an
    80 GB H100). A 2048-query batch is 16 x 128 x S x 256 x 4 bytes: 2 GiB
    at S = 1024 (nprobe 32's default budget at 1M rows, nlist 1024), 8 GiB
    at S = 4096, so it runs as one slice; larger batches or budgets run in
    query-group slices, one after another, each freed before the next."""
    try:
        gb = float(os.environ.get("COMET_SPARSE_MEM_GB", str(DEFAULT_MEM_GB)))
    except ValueError:
        gb = DEFAULT_MEM_GB
    return int(gb * (1 << 30))


def ivf_sparse_pipeline(
    queries: torch.Tensor,      # [Q, d] float32, preprocessed
    corpus: torch.Tensor,       # [NR, d] float32 cluster-major rows
    mask_vec: torch.Tensor,     # [NR] float32 additive mask (+inf invalid / padding)
    row_slot: torch.Tensor,     # [NR] int32 slot per row (-1 padding)
    threshold: float,           # on the SQUARED distance for L2; +inf disables
    centroids: torch.Tensor,    # [nlist, d] float32
    order_key: torch.Tensor,    # [nlist] int32 spatial key per cluster
    chunk_start: torch.Tensor,  # [nlist + 1] int32
    nchunks: torch.Tensor,      # [nlist] int32
    k: int,
    nprobe: int,
    S: int, UC: int, MC: int, nlist: int,
    coarse_cosine: bool = False,
    cosine: bool = False,
    sqrt_out: bool = False,
):
    """Block-sparse IVF search of every query. Pads the batch with zero
    queries to a multiple of QG and, when the scan's distance tensor would
    exceed the envelope (`_mem_envelope_bytes`), runs it in QG-multiple
    slices (queries are sorted within a slice). Returns (scores [Q, k]
    float32, slots [Q, k] int32, overflow [G] int32, one count per group
    of QG padded queries); empty slots carry (+inf, IDX_SENTINEL)."""
    q_n = queries.shape[0]
    q_pad = -(-max(q_n, 1) // QG) * QG
    if q_pad > q_n:
        queries = torch.cat([queries, queries.new_zeros((q_pad - q_n, queries.shape[1]))])
    g_n = q_pad // QG
    per_group = QG * S * CHUNK * 4
    max_g = max(_mem_envelope_bytes() // max(per_group, 1), 1)
    args = (corpus, mask_vec, row_slot, threshold, centroids, order_key,
            chunk_start, nchunks, k, nprobe, S, UC, MC, nlist,
            coarse_cosine, cosine, sqrt_out)
    outs = [_pipeline(queries[g0 * QG:min(g0 + max_g, g_n) * QG], *args)
            for g0 in range(0, g_n, max_g)]
    return (torch.cat([o[0] for o in outs])[:q_n],
            torch.cat([o[1] for o in outs])[:q_n],
            torch.cat([o[2] for o in outs]))
