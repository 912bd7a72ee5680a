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
     chunks, ordered by best probe rank (the scan order); steps past the
     group's need are dead (cluster id -1).
  4. K3 (`_compact_scan`) computes, for each query that probes a listed
     chunk's cluster, the chunk's 256 distances with the reference's
     epilogue, and writes them to a row of the query's own at places in
     scan order (`_compact_places`), W = nprobe x MC x 256 wide, +inf where
     nothing was scanned, with the chunk of each place. A row's position
     order is the order of the reference kernel's [G, QG, S x 256] tile
     restricted to the query's own chunks, and every chunk of the tile
     that the row lacks is +inf there. So:
     - the exact top-k (kb_cap == 0: IVF's search, IVFPQ without nrefine,
       HNSW's seed scan with seed_kb < 0): K1 selects each row's top k
       directly, ties to the lower position: the candidates, in the same
       tie order, that the reference's group select keeps;
     - a shortlist (kb_cap > 0: HNSW's default seed scan, IVFPQ's nrefine
       shortlist): the row is at least kb / 2 chunks wide, K3 also writes
       each 128-place selection group's minimum (and the row is not
       filled: a group whose minimum is +inf is masked once gathered), K1
       picks each query's top-kb groups by (minimum, position), which are
       the tile's groups in its order, and their distances are gathered
       and reduced to the top-k by K1.
     On a CUDA tensor the kernel of `csrc/ivf_sparse.cu` runs (see the note
     there: what bounds it), counted in `LAUNCHES`; on a CPU tensor
     `_compact_scan_plain`, built on `_sparse_scan_plain`, the plain version
     of the reference kernel's tile.
  5. Position -> chunk -> cluster-major row -> slot; a (score, slot) sort
     within the k_pow2 candidates; the inverse query permutation.

Exactness and divergences are the reference's: distances are float32, the
top-k SET is exact within the scanned chunks, score ties at the k-th
boundary break by scan order and not slot order, and a group's walk is
budgeted at S steps and UC distinct clusters; the returned per-group
overflow counts every chunk dropped, and indexes/ivf.py rescans with a
larger S until it is zero.

The bf16 mode (`bf16_domain=True`, HNSW's seed scan) scores bf16 queries
against a bf16 cluster-major corpus with float32 accumulation, float32
query norms from the float32 queries and the caller's mask (the float32
value of the bf16 squared norm). Its inner product is `bf16_dot`
(ops/distance.py), the one the beam's in-loop scoring uses, so a seed's
distance is bit-equal to the distance the beam finds for the same (query,
slot); its kernel launches count in `BF16_LAUNCHES`. `kb_cap` keeps fewer
selection groups than the exactness bound (the seed scan's approximate
top-k): the best kb_cap rows stay exact.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from comet_tpu_torch.ops import _build
from comet_tpu_torch.ops.distance import bf16_dot, f32_matmul, sqrt_f32
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

# K3's launches: float32 mode, bf16 mode.
LAUNCHES = 0
BF16_LAUNCHES = 0


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


# -- the reference kernel's tile, in plain PyTorch ---------------------------------------


def _sparse_scan_plain(qsorted, corpus, mask_vec, probes, chunk_ids, cluster_ids,
                       thr: float, cosine: bool, qn=None):
    """Plain PyTorch version of the reference kernel
    (comet_tpu/ops/ivf_sparse.py:_sparse_kernel), in K3's order of
    operations: every listed step's distances for every query of its group.

    qsorted [G * QG, d] float32, corpus [NR, d] cluster-major (float32, or
    bfloat16 for the bf16 mode, where the queries are rounded to bf16 and
    the product is `bf16_dot`), mask_vec [NR], probes [G * QG, P],
    chunk_ids / cluster_ids [G, S], qn [G * QG] the queries' squared norms
    (computed from qsorted when None). Returns (dist [G, QG, S * CHUNK],
    gmin [G, QG, 2 S]) float32; gmin position 2 s + h is the minimum of rows
    h * 128 ... of step s."""
    g_n, s_n = chunk_ids.shape
    d = qsorted.shape[1]
    dev = qsorted.device
    if qn is None:
        qn = (qsorted * qsorted).sum(dim=1)
    rows = (chunk_ids.long()[:, :, None] * CHUNK
            + torch.arange(CHUNK, device=dev)).reshape(g_n, s_n * CHUNK)
    q = qsorted.view(g_n, QG, d)
    if corpus.dtype == torch.bfloat16:
        qb = q.to(torch.bfloat16)
        ip = torch.stack([bf16_dot(qb[g][:, None, :], corpus[rows[g]][None, :, :])
                          for g in range(g_n)])
    else:
        ip = torch.stack([f32_matmul(q[g], corpus[rows[g]]) for g in range(g_n)])
    m = mask_vec[rows][:, None, :]                       # [G, 1, S * CHUNK]
    if cosine:
        dist = (1.0 - torch.clamp(ip, -1.0, 1.0)) + m
    else:
        dist = torch.clamp_min((qn.view(g_n, QG, 1) + m) - 2.0 * ip, 0.0)
    inf = torch.full_like(dist, float("inf"))
    dist = torch.where(dist <= thr, dist, inf)
    pr = probes.view(g_n, QG, -1)
    member = (pr[:, :, :, None] == cluster_ids[:, None, None, :]).any(dim=2)  # [G, QG, S]
    dist = torch.where(member.repeat_interleave(CHUNK, dim=2), dist, inf)
    gmin = dist.view(g_n, QG, 2 * s_n, SEL_GROUP).amin(dim=3)
    return dist, gmin


def _check_scan(qsorted, corpus, mask_vec, probes, chunk_ids, cluster_ids, chunk_start,
                nchunks, bf16_domain: bool, qn):
    """Raises ValueError unless the scan's inputs have the shapes, dtypes
    and device K3 takes."""
    g_n = chunk_ids.shape[0]
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
    if chunk_start.shape != (len(nchunks) + 1,):
        raise ValueError(f"chunk_start must be [{len(nchunks) + 1}], "
                         f"got {tuple(chunk_start.shape)}")
    if qn is not None and qn.shape != (qsorted.shape[0],):
        raise ValueError(f"qn must be [{qsorted.shape[0]}], got {tuple(qn.shape)}")
    corpus_dt = torch.bfloat16 if bf16_domain else torch.float32
    checks = [("qsorted", qsorted, torch.float32), ("corpus", corpus, corpus_dt),
              ("mask_vec", mask_vec, torch.float32), ("probes", probes, torch.int32),
              ("chunk_ids", chunk_ids, torch.int32), ("cluster_ids", cluster_ids, torch.int32),
              ("chunk_start", chunk_start, torch.int32), ("nchunks", nchunks, torch.int32)]
    if qn is not None:
        checks.append(("qn", qn, torch.float32))
    for name, t, dt in checks:
        if t.dtype != dt:
            raise ValueError(f"{name} must be {dt}, got {t.dtype}")
        if t.device != qsorted.device:
            raise ValueError(f"{name} is on {t.device}, qsorted on {qsorted.device}")


# -- K3: each query's distances in a row of its own -----------------------------------


def select_groups(k: int, kb_cap: int = 0) -> int:
    """Selection groups each query keeps: k_pow2(k), the block-select bound,
    or at most k_pow2(kb_cap) when kb_cap > 0."""
    kb = k_pow2(k)
    return min(kb, k_pow2(kb_cap)) if kb_cap else kb


def compact_width(nprobe: int, MC: int, k: int = 0, kb_cap: int = 0) -> int:
    """Chunk places of a compact row: every chunk a query can probe, at most
    MC in each of its nprobe clusters, and for a shortlist (kb_cap > 0) at
    least its `select_groups(k, kb_cap)` groups of 128 places (two a
    chunk)."""
    kb = select_groups(k, kb_cap) if kb_cap else 0
    return max(nprobe * MC, -(-kb * SEL_GROUP // CHUNK), 1)


def _walk_starts(cluster_ids, nlist: int):
    """[G, nlist + 1] int32: the step at which each cluster's chunks start
    in its group's walk, BIG where the walk does not reach it (a dead step,
    -1, lands in the spare column nlist). Chunk i of cluster c is step
    starts[g, c] + i, so it is scanned for group g where that step is
    below S."""
    g_n, s_n = cluster_ids.shape
    dev = cluster_ids.device
    starts = torch.full((g_n, nlist + 1), BIG, dtype=torch.int32, device=dev)
    steps = torch.arange(s_n, dtype=torch.int32, device=dev).expand(g_n, s_n)
    return starts.scatter_reduce_(1, cluster_ids.long() % (nlist + 1), steps, "amin")


def _compact_places(probes, starts, nchunks, MC: int):
    """[Q, n] int32: the place, in its query's compact row, of the first
    chunk of each of the query's n probes (the coarse stage's first n
    columns: distinct clusters), from the walk's `_walk_starts`. A query's
    places follow its group's scan order (the order of the clusters in the
    group's walk, then the chunk within the cluster), so a row's position
    order is the reference tile's position order restricted to the query's
    own chunks: a probe's place is the sum of min(chunk count, MC) over the
    query's probes that the walk takes earlier. K3 works each place out
    itself; this is its plain version."""
    pl = probes.long()
    key = starts.repeat_interleave(QG, dim=0).gather(1, pl)
    _, order = torch.sort(key, dim=1, stable=True)
    nch = nchunks.clamp_max(MC)[pl.gather(1, order)].long()
    places = torch.empty_like(nch).scatter_(1, order, nch.cumsum(dim=1) - nch)
    return places.to(torch.int32)


def _compact_scan_plain(qsorted, corpus, mask_vec, probes, chunk_ids, cluster_ids, chunk_start,
                        nchunks, n_places: int, MC: int, wc: int, thr: float, cosine: bool,
                        qn=None, minima: bool = False):
    """Plain PyTorch version of K3: the reference's tile
    (`_sparse_scan_plain`), each member (query, step) tile moved to its
    place; a query's member test reads its first n_places probes. Returns
    (cand [G * QG, wc * CHUNK] float32, +inf where nothing was scanned,
    chunk_tab [G * QG, wc] int32, the chunk of each place, 0 where none,
    gmin as `_compact_scan`'s)."""
    # a dead step (cluster id -1) has no member: the tile of each walk's
    # live steps alone, in walk order, holds every member tile
    live = cluster_ids >= 0
    steps = torch.sort((~live).to(torch.int8), dim=1, stable=True).indices
    steps = steps[:, :max(int(live.sum(dim=1).max()), 1)]
    chunk_ids, cluster_ids = chunk_ids.gather(1, steps), cluster_ids.gather(1, steps)
    dist, _ = _sparse_scan_plain(qsorted, corpus, mask_vec, probes, chunk_ids, cluster_ids,
                                 thr, cosine, qn)
    g_n, s_n = chunk_ids.shape
    q_n = g_n * QG
    dev = qsorted.device
    places = _compact_places(probes[:, :n_places], _walk_starts(cluster_ids, len(nchunks)),
                             nchunks, MC)
    hit = probes.view(g_n, QG, -1, 1) == cluster_ids.view(g_n, 1, 1, s_n)   # [G, QG, P, S]
    first = hit.to(torch.int8).argmax(dim=2)            # each query's first probe of the cluster
    within = chunk_ids.long() - chunk_start.long()[cluster_ids.long().clamp_min(0)]   # [G, S]
    place = (places.view(g_n, QG, n_places).long().gather(2, first.clamp_max(n_places - 1))
             + within[:, None, :])
    keep = hit.any(dim=2) & (first < n_places) & (place < wc)
    g, r, st = keep.nonzero(as_tuple=True)
    row, at = g * QG + r, place[keep]
    cand = torch.full((q_n, wc, CHUNK), float("inf"), dtype=torch.float32, device=dev)
    cand[row, at] = dist.view(g_n, QG, s_n, CHUNK)[g, r, st]
    chunk_tab = torch.zeros((q_n, wc), dtype=torch.int32, device=dev)
    chunk_tab[row, at] = chunk_ids[g, st]
    gmin = cand.view(q_n, 2 * wc, SEL_GROUP).amin(dim=2) if minima else None
    return cand.view(q_n, wc * CHUNK), chunk_tab, gmin


def _compact_scan_cuda(qsorted, corpus, mask_vec, probes, chunk_ids, cluster_ids, chunk_start,
                       nchunks, n_places: int, MC: int, wc: int, thr: float, cosine: bool,
                       qn=None, minima: bool = False):
    """Launch K3 (the bf16 mode for a bfloat16 corpus): `_compact_scan`'s
    outputs (csrc/ivf_sparse.cu)."""
    global LAUNCHES, BF16_LAUNCHES
    lib = _build.library()
    g_n, s_n = chunk_ids.shape
    d = qsorted.shape[1]
    dev = qsorted.device
    nlist = len(nchunks)
    if qn is None:
        qn = (qsorted * qsorted).sum(dim=1)
    bf16 = corpus.dtype == torch.bfloat16
    q = qsorted.to(torch.bfloat16).contiguous() if bf16 else qsorted
    qn = qn.contiguous()
    starts = _walk_starts(cluster_ids, nlist)
    rows, f32 = (g_n * QG, wc * CHUNK), torch.float32
    cand = (torch.empty(rows, dtype=f32, device=dev) if minima
            else torch.full(rows, float("inf"), dtype=f32, device=dev))
    gmin = torch.full((g_n * QG, 2 * wc), float("inf"), dtype=f32, device=dev) if minima else None
    chunk_tab = torch.zeros((g_n * QG, wc), dtype=torch.int32, device=dev)
    code = lib.comet_sparse_scan_compact(
        q.data_ptr(), qn.data_ptr(), corpus.data_ptr(), mask_vec.data_ptr(),
        probes.data_ptr(), probes.shape[1], n_places, starts.data_ptr(), chunk_start.data_ptr(),
        nchunks.data_ptr(), nlist, MC, thr, g_n, s_n, corpus.shape[0] // CHUNK, d,
        int(cosine), int(bf16), wc, cand.data_ptr(), chunk_tab.data_ptr(),
        None if gmin is None else gmin.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    with _build.COUNT_LOCK:
        if bf16:
            BF16_LAUNCHES += 1
        else:
            LAUNCHES += 1
    _build.check(code, "sparse_scan_compact")
    return cand, chunk_tab, gmin


def _compact_scan(qsorted, corpus, mask_vec, probes, chunk_ids, cluster_ids, chunk_start,
                  nchunks, n_places: int, MC: int, wc: int, threshold: float,
                  cosine: bool = False, bf16_domain: bool = False, qn=None,
                  minima: bool = False):
    """K3: each probing query's distances at its own places
    (`_compact_places`), from the inputs of `_sparse_scan_plain` (the corpus
    float32, or bfloat16 with `bf16_domain`; `qn` float32 [G * QG] the
    queries' squared norms, else computed from qsorted), the layout's
    chunk_start [nlist + 1] and nchunks [nlist] (int32), the probes a row
    has places for (n_places: the coarse stage's nprobe), MC and the row's
    places wc. Returns (cand [G * QG, wc * CHUNK] float32, chunk_tab
    [G * QG, wc] int32, gmin): a candidate at position i of its row lies in
    row chunk_tab[q, i // CHUNK] * CHUNK + i % CHUNK of the cluster-major
    corpus. With `minima`, gmin [G * QG, 2 wc] float32 holds each 128-place
    group's minimum and cand only the groups whose minimum is finite (the
    card leaves the rest unwritten); else gmin is None and cand is +inf
    wherever nothing was scanned."""
    _check_scan(qsorted, corpus, mask_vec, probes, chunk_ids, cluster_ids, chunk_start, nchunks,
                bf16_domain, qn)
    if not 1 <= n_places <= probes.shape[1] or MC < 1 or wc < 1:
        raise ValueError(f"n_places={n_places} (of {probes.shape[1]}), MC={MC}, wc={wc}")
    thr = float(np.float32(threshold))
    args = [t.contiguous() for t in (qsorted, corpus, mask_vec, probes, chunk_ids, cluster_ids,
                                     chunk_start, nchunks)]
    fn = _compact_scan_plain if use_plain(qsorted) else _compact_scan_cuda
    return fn(*args, n_places, MC, wc, thr, cosine, qn, minima)


# -- the pipeline -------------------------------------------------------------------


def scan_plan(q, centroids, order_key, chunk_start, nchunks, k, nprobe,
              S, UC, MC, nlist, coarse_cosine, kb_cap: int = 0):
    """The scan's inputs for one slice of queries (a multiple of QG):
    coarse probes, the stable query sort by the order key of each query's
    nearest centroid, and the groups' chunk lists. kb is `select_groups`,
    and S grows so that at least kb selection groups exist (the extra steps
    are dead), as the reference's does. Returns a dict of qperm, qsorted,
    probes (sorted), chunk_ids, cluster_ids, overflow, kb, S."""
    kb = select_groups(k, kb_cap)
    S = max(S, -(-kb * SEL_GROUP // CHUNK))
    probes = coarse_probes(q, centroids, nprobe, coarse_cosine, probe_pad(nprobe))
    p0 = probes[:, 0].long()
    qperm = torch.argsort(order_key.long()[p0] * nlist + p0, stable=True)
    probes_s = probes[qperm]
    chunk_ids, cluster_ids, _, overflow = _group_chunk_lists(
        probes_s, chunk_start, nchunks, S, UC, MC, nlist)
    return dict(qperm=qperm, qsorted=q[qperm], probes=probes_s, chunk_ids=chunk_ids,
                cluster_ids=cluster_ids, overflow=overflow, kb=kb, S=S)


def _pipeline(q, qn, corpus, mask_vec, row_slot, thr, centroids, order_key,
              chunk_start, nchunks, k, nprobe, S, UC, MC, nlist,
              coarse_cosine, cosine, sqrt_out, bf16_domain, kb_cap):
    """One slice of queries (a multiple of QG). Returns (scores [Q, k],
    slots [Q, k] int32, overflow [G] int32)."""
    q_n = q.shape[0]
    dev = q.device
    plan = scan_plan(q, centroids, order_key, chunk_start, nchunks, k, nprobe,
                     S, UC, MC, nlist, coarse_cosine, kb_cap)
    qperm, kb = plan["qperm"], plan["kb"]
    qn_s = qn[qperm] if qn is not None else None
    cand, chunks, gmin = _compact_scan(
        plan["qsorted"], corpus, mask_vec, plan["probes"], plan["chunk_ids"], plan["cluster_ids"],
        chunk_start, nchunks, nprobe, MC, compact_width(nprobe, MC, k, kb_cap), thr, cosine,
        bf16_domain, qn_s, minima=bool(kb_cap))
    if kb_cap:
        # the shortlist: each query's top-kb selection groups by (minimum,
        # position), the reference tile's groups in its order (module
        # note), their distances gathered (a group with no finite minimum
        # holds nothing scanned: +inf), then the candidate select
        gv, gs = topk_rows(gmin, None, kb)
        gv, gs = gv[:, :kb], gs[:, :kb]
        cand = torch.gather(cand.view(q_n, -1, SEL_GROUP), 1,
                            gs.long()[:, :, None].expand(q_n, kb, SEL_GROUP))
        cand = cand.masked_fill(torch.isinf(gv)[:, :, None], float("inf"))
        offs = torch.arange(SEL_GROUP, dtype=torch.int32, device=dev)
        cidx = (gs[:, :, None] * SEL_GROUP + offs).reshape(q_n, kb * SEL_GROUP)
        fv, fi = topk_rows(cand.reshape(q_n, kb * SEL_GROUP), cidx, k)   # [Q, k_pow2]
    else:
        # the exact top-k: one select of each query's own row
        fv, fi = topk_rows(cand, None, k)                                  # [Q, k_pow2]
    # position -> chunk -> cluster-major row -> slot
    sent = fi == IDX_SENTINEL
    step = torch.clamp_max(fi // CHUNK, chunks.shape[1] - 1).long()
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
    """Budget for one launch's scan output (COMET_SPARSE_MEM_GB; default
    DEFAULT_MEM_GB = 8 GiB, a tenth of an 80 GB H100). K3's rows are QG x
    W x 4 bytes a group, W = `compact_width` x CHUNK: 147 MB for 2048 queries
    at nprobe 10 and lists of at most 7 chunks. A batch past the envelope
    runs in query-group slices, one after another, each freed before the
    next."""
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
    bf16_domain: bool = False,  # bf16 corpus, bf16-domain distances (HNSW seeds)
    kb_cap: int = 0,            # > 0: keep at most k_pow2(kb_cap) selection groups
    qn: torch.Tensor | None = None,  # [Q] float32 query squared norms (bf16 mode)
):
    """Block-sparse IVF search of every query: the exact top-k when kb_cap
    is 0, a shortlist of selection groups otherwise (module note). Pads the
    batch with zero queries to a multiple of QG and, when K3's rows would
    exceed the envelope (`_mem_envelope_bytes`), runs it in QG-multiple
    slices (queries are sorted within a slice). Returns (scores [Q, k]
    float32, slots [Q, k] int32, overflow [G] int32, one count per group
    of QG padded queries); empty slots carry (+inf, IDX_SENTINEL).

    With `bf16_domain` the corpus is bfloat16 and the mask the float32
    value of each row's bf16 squared norm; `qn`, when given, is used for
    the query norms, so that the caller's beam search and this scan read
    the same values."""
    q_n = queries.shape[0]
    q_pad = -(-max(q_n, 1) // QG) * QG
    if q_pad > q_n:
        queries = torch.cat([queries, queries.new_zeros((q_pad - q_n, queries.shape[1]))])
        if qn is not None:
            qn = torch.cat([qn, qn.new_zeros(q_pad - q_n)])
    g_n = q_pad // QG
    per_group = QG * compact_width(nprobe, MC, k, kb_cap) * CHUNK * 4
    max_g = max(_mem_envelope_bytes() // max(per_group, 1), 1)
    args = (corpus, mask_vec, row_slot, threshold, centroids, order_key,
            chunk_start, nchunks, k, nprobe, S, UC, MC, nlist,
            coarse_cosine, cosine, sqrt_out, bf16_domain, kb_cap)
    outs = []
    for g0 in range(0, g_n, max_g):
        rows = slice(g0 * QG, min(g0 + max_g, g_n) * QG)
        outs.append(_pipeline(queries[rows], qn[rows] if qn is not None else None, *args))
    return (torch.cat([o[0] for o in outs])[:q_n],
            torch.cat([o[1] for o in outs])[:q_n],
            torch.cat([o[2] for o in outs]))
