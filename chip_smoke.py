"""Smoke run of comet_tpu_torch on one NVIDIA card.

    python3 chip_smoke.py [--seed N] [--profile] [--kernels-only]

1. Prints the card (name and power limit, as nvidia-smi gives them), the
   torch and CUDA versions, where nvcc is, and builds the CUDA kernels from
   the sources in this checkout.
2. Holds each kernel against its plain PyTorch version on the card at the
   main paths' shapes and times it: K1 (top-k select, csrc/topk.cu) and
   K2 (fused distance scan, csrc/fused_scan.cu) first. K1 is timed at the
   flat path's two selects on the flat path's own inputs (the group minima
   of 256 queries, [256, 8192] with k = 128, and the candidates of their
   kept groups, [256, 16384] with k = 100) and at the HNSW finalize's
   [2048, 256], k = 128 (rows cut from those candidates), with its device
   time a call (`queued_device_ms`), beside
   `torch.topk(dim=1, largest=False)`, its yardstick, and in the
   reference's column layout. K1's split route on BM25-like rows
   from the seed ([256, 2^20] rare-term and 5 %-scored chunks at k = 10
   and 100; one query's row over 45,428 and 286,372 documents at k = 10)
   beside torch.topk, the bytes bound and its device time a select;
   K2's few-query route at Q = 1-32 over the corpus's first 65,536 and
   524,288 rows, bit-equal to the plain version and to the 128-query tile,
   each route timed with its device time, the plain version's device time
   at one query, and the other operands and modes at Q = 1-32 over 524,288
   rows beside the 128-query tile. Then K3 (block-sparse scan,
   csrc/ivf_sparse.cu) on an IVF index built as in section 5 (nlist 1024
   trained on the first 100,000 rows) and the batch's own chunk lists: float32 at
   nprobe 10 and its default step budget (S = 512), at the step budget the
   IVF path learns on this batch, and the bf16 mode at the seed scan's
   nprobe (16), each with its member pairs; then whole pipelines: the
   exact search against a shortlist at the exact bound, and HNSW's
   default seed scan (kb_cap 32) and IVFPQ's nrefine shortlist (kb_cap
   128) held to the reference tile's shortlist, each with its device time
   a call; K4 (beam merge, csrc/beam_merge.cu) split and fused and K5
   (csrc/fused_expand.cu) at Q = 2048, ef = ew = kr = 256, E = 8, W = 32
   on a running search's beam state made from the seed, K5 over a packed table of the corpus with a
   random adjacency, beside the split pair (packed scoring + K4 split);
   the in-loop scoring kernel (csrc/gather_score.cu) on the same nodes over
   the packed and the blocked table (nd, ns and adm held to the plain
   version, split and fused mode). Times are CUDA-event medians of 5, the
   host's launch included; the device time a launch of K5, the split
   pair's two kernels and the scoring kernel in both layouts comes from
   torch.profiler. `--kernels-only` stops here: a copy of this script
   placed at the root of another checkout times that checkout's kernels
   the same way. Then
   K1 (widths 1 to 65539, k 1 to 8192, ties, signed zeros, +inf and
   repeated keys, both layouts) and its split route (ops/edge_cases
   K1_SPLIT_CASES: [1-256, 16385-2^20], ~10^6 +-0.0 zeros past fewer than
   k smaller values, runs across tile edges, +inf rows, permuted and
   repeated indices, kp = 8192), all modes of K2 (Q 1-300, d 1-144,
   N 128-4096, with and without a threshold; the few-query route at Q
   2-32, N up to 65,536, also against the 128-query tile), K3's two modes (0-128
   probing queries a step, dead steps, S = 1, a zero-padded group, d
   3-128, L2 and cosine, with and without a threshold) and K4 split and
   fused (ties, copies, SENT and +inf rows, ew 7-300, beams and result
   sets out of slot order), the scoring kernel (both layouts, both modes)
   and K5 (stop = ef and ef / 4, also against the split pair) at W 1-32,
   d 3-128, expand 1-23, Q 1-2048, ndig 2-3, packed rows off 16-byte
   boundaries, -1 nodes and empty entries, and the BM25 scorer (empty
   queries, a term without postings or covering every document, repeated
   terms, every document deleted or filtered out, k above the matches,
   the padding edge, ragged chunks, k = 1 and 1024; its tiling: partial
   tiles, runs across tiles and in the last one, one query over 70,000
   and 330,000 documents, ragged query groups, shared and moved terms,
   several windows of term positions, untouched allowed documents) are
   held to their plain versions at edge shapes (ops/edge_cases.py).
3. Drives the flat path through the public API at the users' size: a
   FlatIndex of 1,048,576 x 128 SIFT-range integer vectors (L2), searched
   with 2048 queries at k = 100. On integer data every float32 distance is
   exact, so ids and scores must be array-equal to the plain pipeline
   (ops/topk.block_topk) on the card and, for 64 queries, to a float64 brute
   force on the host. Then a search with a doc-ID filter and a threshold,
   and a cosine index at the same size. The kernel launches of the L2
   searches are counted and reported. `--profile` adds a torch.profiler
   breakdown of two steady batches.
4. Flat bf16 storage: K2's bf16 operand held bit-equal to its plain version
   on 256 queries x 1M x 128 and timed, then FlatIndex(storage="bfloat16")
   without and with `rerank` at the same size: ids and scores array-equal
   to the float32 path (the data are exact in bf16), queries/s, launches.
5. The IVF path at the reference's operating point: an IVFIndex over the
   same corpus (nlist 1024 trained on the first 100,000 rows). Holds K2's nprobe mode (256 queries x
   1M rows, the index's probes at nprobe 10) against its plain version,
   then searches 2048 queries at k = 100
   for nprobe 1, 5, 10, 20 and 32 on the default (sparse) route: scores
   array-equal and ids equal, but for ties at the k-th score, to the plain
   probed-lists pipeline on the card, recall@100 against the flat path's
   exact ids, queries/s. Then one dense-route search, one nprobe = nlist
   search (equal to the flat path), a filtered + thresholded search and a
   cosine index, with the launches of every kernel counted. `--profile`
   adds a torch.profiler breakdown of two steady nprobe-10 batches.
6. The HNSW path: an HNSWIndex (M = 16, ef_search = 200) bulk-built over
   HNSW_N rows of the same corpus (the stage kNN runs K2 and K1), searched
   with 2048 queries at k = 100, seeded (K3's bf16 mode, csrc/ivf_sparse.cu)
   and classic over the blocked table: every iteration runs the in-loop
   scoring kernel (csrc/gather_score.cu) and K4, the merge step
   (csrc/beam_merge.cu). Then the packed table (held equal to the blocked
   pair on a row range), the same searches with COMET_HNSW_PACKED=1 (the
   scoring kernel's packed mode) and COMET_HNSW_FUSE=1 (K5,
   csrc/fused_expand.cu), each array-equal to the blocked search; a
   filtered + thresholded search (K4's fused mode). K5 is held bit-equal to
   its plain version and to the split pair on a real iteration and timed
   beside the pair; the packed scoring also on 152-byte rows.
7. HNSW insertion: N_INSERT held-out rows of the same generator added to
   the 1M graph in rounds of 512 (the first grows the capacity to 2^21 and
   rebuilds the device state; the others update it in place), timed: the
   first half over the blocked table, the second over the packed one (the
   index holds one table), each held equal to a fresh build after its
   half; fused, seeded and classic searches of the grown index with
   recall@100 against its exact ids; one `add`; searches after removing 1% of the ids; a cosine index
   of 2^16 rows. Every HNSW search's ids and scores must be array-equal to
   the plain beam (the same index with every wrapper on its plain version,
   on the card). K4 (both modes), K3's bf16 mode and the scoring kernel
   (nd, ns and the admission flags adm, split mode and the fused mode of
   the filtered search) are held bit-equal to their plain versions on the
   inputs of a real iteration, and timed (the seed scan also whole, held
   to the reference tile's shortlist, with its device time a call); a
   Gaussian index shows seed and in-loop distances bit-equal; one
   iteration's blocked-table row gather is timed.
   `--profile` adds breakdowns of one insertion round and of two steady
   seeded and two classic batches of the grown index.

8. Flat float16 and int8 storage: K2's float16 and int8 operands (the
   scans the reference runs in XLA, comet_tpu/ops/topk.py:155) held
   bit-equal to their plain versions on 256 queries x 1M x 128 (the int8
   rows quantised with the abs-max scale the index fits) and timed, the
   float16 product alone timed as torch.mm into float32 beside them; then
   FlatIndex(storage="float16" | "int8") without and with `rerank`, each
   equal to its plain pipeline on the card (256 queries): float16 ids and
   scores equal to the float32 path (the data are exact in float16), int8
   with its recall@100 against the float32 ids; queries/s, launches.
9. PQ and IVFPQ at the reference's operating points (bench.py:293-361):
   trained on the first 100,000 rows, m = 16, nbits = 8, the 1M corpus
   added. PQ on its dense route (K2, K1) and on ADC (K1's selects) with
   `pq.DECODED_BYTES_MAX` patched to 0; IVFPQ nlist 1024 with the
   originals on the sparse route (K3, K1) at nprobe 1-32 and with nrefine
   256 at nprobe 10 (the device re-rank), the dense route (K2's nprobe
   mode) at nprobe 10 with and without nrefine, the LUT walk past the byte
   cap, and an OPQ index at k = 10, nprobe 10, nrefine 64. Each search is
   held to the same search with every wrapper on its plain version on the
   card: array-equal on ADC and the walk; where K2 or K3 sums the trained
   model's non-integer reconstructions, whose plain product (cuBLAS) adds
   in another order, scores allclose(1e-5, 1e-4) with ids equal but at
   near ties, and array-equal on an integer twin (the same codes with the
   codebooks and centroids rounded, an OPQ rotation replaced by a signed
   permutation), where every distance is exact. With recall@100 (recall@10
   for OPQ) against the flat path's exact ids, train, add and search
   times, queries/s and each route's launches.
   `--profile` adds a breakdown of one IVFPQ nprobe-10 batch.
10. BM25 at the reference benchmark's scale (bench.py:419-462): 2^20
   documents of 60 words drawn Zipf(1.3) over a 50,000-word letter-only
   vocabulary from the seed, ingested by `BM25SearchIndex.add_batch` with
   the default segmentation (every UAX#29 segment a term, so every
   multi-word query also scores the whitespace term of every document),
   docs/s; the postings built on the card. The scorer
   (csrc/bm25_score.cu) on a 256-query chunk of 1-, 2- and 10-term
   queries: its dense rows bit-equal to the plain version, timed beside
   it, beside `index_put_(accumulate=True)` of the same contributions
   (2-term), beside its bound and the bytes its tiled design moves
   (`bm25_design_bytes`); K1 on those [256, 2^20] rows at k = 10
   and 100 (its split route) beside `torch.topk`. Then `search_batch` of 2048 queries of
   the bench's mid-frequency terms (ranks 100-5000), 1-, 2- and 10-term,
   at k = 10 and 100: queries/s, launches; each batch's first 256 rows
   array-equal to the plain scorer on the card, 8 queries of each
   against a float64 host oracle (ids equal but at ties within 1e-6,
   scores allclose(1e-5)). `--profile` adds two 2-term batches.
11. Hybrid search (bench.py:465-530's shape at the full corpus): a
   FlatIndex of the 1M corpus, the BM25 index of section 10 (ids
   1..2^20, the vectors' ids) and a RoaringMetadataIndex filled by
   `add_columns` (cat in a-d by i mod 4, num = i mod 1000), searched by
   `HybridSearchIndex.search_batch` with 2048 vector + 2-term text
   queries under eq("cat", "a"), reciprocal-rank and weighted fusion,
   k = 10: queries/s, launches, and the host time of each of its four
   steps called one by one (metadata filter, vector launch, BM25, collect
   and fusion; equal to search_batch); 64 reciprocal-rank and 16 weighted
   queries equal to the fluent execute() one by one, the vector leg equal
   to the plain pipeline (ops/topk.block_topk) under the candidate mask,
   the text leg to the plain scorer. `--profile` adds two batches.
12. The persistent hybrid store (comet_tpu_torch.storage) with the
   reference's knobs (100 MiB memtables, 200 MiB flush threshold,
   compaction of 5 segments every 300 s, WAL on, fsync off) over card
   factories (FlatIndex float32, BM25SearchIndex, RoaringMetadataIndex):
   2^19 documents, row i of the corpus with document i of section 10's
   texts and section 11's metadata, ingested by add_batch in batches of
   16,384 (docs/s, rotations, background flushes); flush(); 4,096 flushed
   documents removed, then maybe_compact(); 256 vector-only, 256 2-term
   text and 256 hybrid searches (cat = a, reciprocal rank) at k = 10
   through new_search()...execute() over every memtable and segment (p50,
   p99, queries/s); 16,384 more documents left in the WAL by a simulated
   crash, the reopen (WAL replay) and its first search (segments loaded
   onto the card) timed; close(). After the searches, the BM25 scorer,
   K1 on its row (the split route) and K2's float32 flat mode (the
   few-query route) are timed alone at one query over the smallest and
   the largest segment, beside their bounds, their plain versions and the
   one PyTorch call of the same function (`index_put_(accumulate=True)`
   for the scorer, `torch.topk` for K1; K2 has none), with their device
   time a call from one profiler window over the three in turns. The
   store's searches must launch both new routes (sections 10, 11 and 13
   K1's split route, through their BM25 legs).
   Vector-only results equal one FlatIndex on the card over the live rows
   before and after compaction and after the reopen (ids but at ties at
   the k-th score); 16 text and 16 hybrid searches equal their
   recomputation on every wrapper's plain version; no removed id comes
   back; after the crash every acknowledged document is live and found by
   has_document. `--profile` adds a window of 64 hybrid store searches.
13. Sharding (comet_tpu_torch.parallel) over meshes of S shards, all on
   the one card: one process drives the shards in turn, so this measures
   the per-shard launches and K1's merge, not an interconnect. Flat at
   S = 1, 2, 4 and 8 over the 1M corpus (2048 queries, k = 100): ids and
   scores array-equal to section 3's FlatIndex, with allowed = ids % 3 !=
   0 equal to the plain pipeline under that mask, and K1 at the merge's
   shape ([S 100, 2048] candidates x queries with their slots) held to
   its plain version and timed beside `torch.topk`. At S = 4: IVF (nlist
   1024 with its trained centroids rounded to integers, so both probe
   rules rank alike; nprobe 10) equal to the single-device dense route;
   PQ and IVFPQ (m = 16, nbits 8, nlist 1024, nprobe 10) held to the
   single-device dense routes at section 9's bar (the integer twin
   equal); one k-means step from the IVF's trained centroids equal to a
   plain single-device step (centroids allclose(1e-5)); HNSW (M = 16,
   ef 200, a 1M bulk build) equal to the single-device graph beam
   (`indexes.hnsw.BLOCKED_TABLE_BYTES_MAX` patched to 0); the seeded
   HNSW searcher from the index's seed centroids equal at S = 1 and 4;
   recall@100 against the flat ids. Section 11 runs its hybrid batches
   once more over a sharded flat searcher (S = 4), equal to
   `HybridSearchIndex.search_batch`. Queries/s and the K1 / K2 / scorer
   launches of every search; `--profile` adds two sharded flat batches
   at S = 4.

Any mismatch raises, so the run exits non-zero. The last line is
{"ok": true, "device": {...}}; the line before it names the kernels with
their launches, errors, times and bounds (`topk_cl_split` and
`fused_dist_select_fewq` are K1's split and K2's few-query routes, whose
launches the `topk_cl` and `fused_dist_select*` mode entries include),
and the line before that the card.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

N = 1 << 20        # corpus rows
N_INSERT = 8192    # held-out rows inserted into the HNSW graph
DIM = 128
K = 100
BATCH = 2048       # queries per search_batch call
ROUNDS = 4         # steady-state search rounds
NLIST = 1024       # IVF lists (bench.py's IVF operating point)
N_TRAIN = 100_000  # IVF training rows
NPROBES = (1, 5, 10, 20, 32)
HNSW_N = N         # HNSW corpus rows (the flat phase's exact ids are its ground truth)
HNSW_COSINE_N = 1 << 16
EF_SEARCH = 200

# NVIDIA's published peaks of one H100 SXM (at its 700 W limit, dense):
# float32 outside the tensor cores, bf16 on the tensor cores, and device
# memory bandwidth.
PEAK_FP32 = 67e12
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12


def bound(n_bytes, n_ops, peak=PEAK_FP32, more_ops_ms=0.0):
    """The least time the card could take: (ms, "bytes" or "operations").
    n_ops operations at `peak`, plus `more_ops_ms` of operations of another
    type."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES * 1e3, n_ops / peak * 1e3 + more_ops_ms
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sift_like(rng, n_corpus, n_queries, dim, n_extra=0):
    """SIFT-range clustered data: a Gaussian mixture with low intrinsic
    dimension (bench.py's generator), rounded and clipped to 0..255.
    Returns the corpus, the queries and n_extra held-out rows (drawn last,
    so the corpus and the queries do not depend on n_extra)."""
    centers = rng.uniform(0, 256, size=(1024, dim)).astype(np.float32)
    proj = rng.normal(scale=1.0, size=(16, dim)).astype(np.float32)

    def sample(count):
        which = rng.integers(0, len(centers), size=count)
        z = rng.normal(scale=12.0, size=(count, 16)).astype(np.float32)
        v = centers[which] + z @ proj
        return np.clip(np.rint(v), 0, 255).astype(np.float32)

    return sample(n_corpus), sample(n_queries), sample(n_extra)


def sparse_signs(rng, n, dim):
    """Vectors with dim/2 entries of +-1 and the rest 0: their norm is a
    power of two, so normalised entries and every cosine are exact."""
    support = rng.permuted(
        np.tile(np.repeat(np.array([1, 0], np.int8), dim // 2), (n, 1)), axis=1
    )
    signs = rng.integers(0, 2, size=(n, dim), dtype=np.int8) * 2 - 1
    return (support * signs).astype(np.float32)


def plain_search(queries, corpus, valid, thr, kind, chunk=256, k=K):
    """The plain pipeline, ops/topk.block_topk, over chunks of queries (a
    chunk's [chunk, N] distances fit the card). For L2_SQUARED the scores
    come back as their square roots, as FlatIndex returns L2 scores."""
    from comet_tpu_torch import DistanceKind
    from comet_tpu_torch.ops import topk
    from comet_tpu_torch.ops.distance import sqrt_f32

    sqn = (corpus * corpus).sum(dim=1)
    outs = [
        topk.block_topk(queries[q0:q0 + chunk], corpus, sqn, valid, thr, k, kind)
        for q0 in range(0, queries.shape[0], chunk)
    ]
    scores = torch.cat([s for s, _ in outs])
    if kind == DistanceKind.L2_SQUARED:
        scores = sqrt_f32(scores)
    return scores.cpu().numpy(), torch.cat([i for _, i in outs]).cpu().numpy()


def host_topk(queries, corpus, k, allowed=None, thr2=np.inf):
    """Float64 brute-force L2 top-k on the host, ties to the lower slot.
    Returns (slots [Q, k], squared distances [Q, k])."""
    x = corpus.astype(np.float64)
    xn = (x * x).sum(axis=1)
    out_s, out_d = [], []
    for q in queries.astype(np.float64):
        d2 = (q @ q) + xn - 2.0 * (x @ q)
        if allowed is not None:
            d2 = np.where(allowed, d2, np.inf)
        d2 = np.where(d2 <= thr2, d2, np.inf)
        kth = np.partition(d2, k - 1)[k - 1]
        cand = np.flatnonzero(d2 <= kth)
        order = cand[np.lexsort((cand, d2[cand]))][:k]
        out_s.append(order)
        out_d.append(d2[order])
    return np.array(out_s), np.array(out_d)


def plain_probes(queries, centroids, nprobe, cosine=False):
    """The plain pipeline's probes: the exact top-nprobe centroids of each
    query by (cn - 2 cq, or -cq for cosine; centroid id), plain select."""
    from comet_tpu_torch.ops import sortnet
    from comet_tpu_torch.ops.distance import f32_matmul

    cq = f32_matmul(queries, centroids)
    cd = -cq if cosine else (centroids * centroids).sum(dim=1)[None, :] - 2.0 * cq
    return sortnet._topk_rows_plain(cd, None, nprobe)[1][:, :nprobe]


def plain_ivf_search(queries, corpus, valid, assign, centroids, nprobe, thr, kind,
                     chunk=256):
    """The plain pipeline of IVF search: rows of unprobed clusters masked,
    then ops/topk's exact block select. L2_SQUARED scores come back as
    their square roots, as IVFIndex returns L2 scores."""
    from comet_tpu_torch import DistanceKind
    from comet_tpu_torch.ops import fused_scan, topk
    from comet_tpu_torch.ops.distance import sqrt_f32

    cosine = kind == DistanceKind.COSINE
    probes = plain_probes(queries, centroids, nprobe, cosine)
    sqn = (corpus * corpus).sum(dim=1)
    outs = []
    for q0 in range(0, queries.shape[0], chunk):
        dist = topk._masked(queries[q0:q0 + chunk], corpus, sqn, valid, thr, kind)
        member = fused_scan._probe_member(probes[q0:q0 + chunk], assign, centroids.shape[0])
        dist = torch.where(member, dist, torch.full_like(dist, float("inf")))
        outs.append(topk.block_select_from_dist(dist, K, 128, 0))
    scores = torch.cat([s for s, _ in outs])
    if kind == DistanceKind.L2_SQUARED:
        scores = sqrt_f32(scores)
    return scores.cpu().numpy(), torch.cat([i for _, i in outs]).cpu().numpy()


def reset_launches():
    """Every kernel's launch count to 0."""
    from comet_tpu_torch.ops import beam_kernel, bm25, fused_scan, ivf_sparse, sortnet

    bm25.LAUNCHES = 0
    sortnet.LAUNCHES = fused_scan.LAUNCHES = fused_scan.NPROBE_LAUNCHES = 0
    sortnet.SPLIT_LAUNCHES = fused_scan.FEWQ_LAUNCHES = 0
    fused_scan.BF16_LAUNCHES = fused_scan.F16_LAUNCHES = fused_scan.INT8_LAUNCHES = 0
    ivf_sparse.LAUNCHES = ivf_sparse.BF16_LAUNCHES = 0
    beam_kernel.LAUNCHES = beam_kernel.FUSED_LAUNCHES = beam_kernel.SCORE_LAUNCHES = 0
    beam_kernel.PACKED_SCORE_LAUNCHES = beam_kernel.FUSE_LAUNCHES = 0


def read_launches():
    from comet_tpu_torch.ops import beam_kernel, bm25, fused_scan, ivf_sparse, sortnet

    # the split and few-query routes' counts are parts of topk_cl's and of
    # the fused_dist_select modes' (a checkout without them reads 0)
    return {"bm25_score": bm25.LAUNCHES,
            "topk_cl": sortnet.LAUNCHES, "fused_dist_select": fused_scan.LAUNCHES,
            "topk_cl_split": getattr(sortnet, "SPLIT_LAUNCHES", 0),
            "fused_dist_select_fewq": getattr(fused_scan, "FEWQ_LAUNCHES", 0),
            "fused_dist_select_nprobe": fused_scan.NPROBE_LAUNCHES,
            "fused_dist_select_bf16": fused_scan.BF16_LAUNCHES,
            "fused_dist_select_f16": fused_scan.F16_LAUNCHES,
            "fused_dist_select_int8": fused_scan.INT8_LAUNCHES,
            "sparse_scan": ivf_sparse.LAUNCHES, "sparse_scan_bf16": ivf_sparse.BF16_LAUNCHES,
            "beam_merge": beam_kernel.LAUNCHES, "beam_merge_fused": beam_kernel.FUSED_LAUNCHES,
            "gather_score": beam_kernel.SCORE_LAUNCHES,
            "gather_score_packed": beam_kernel.PACKED_SCORE_LAUNCHES,
            "fused_expand": beam_kernel.FUSE_LAUNCHES}


def ids_of(slots, base=1):
    """Plain-pipeline slots -> the ids the index was given (slot + base)."""
    from comet_tpu_torch.ops import topk

    return np.where(slots == topk.IDX_SENTINEL, 0xFFFFFFFF, slots.astype(np.int64) + base)


def check_probed(name, got_ids, got_scores, want_ids, want_scores, ties_ok):
    """Scores array-equal; ids array-equal, or, with `ties_ok` (the sparse
    route breaks ties at the k-th score in scan order), equal wherever the
    score is below the row's k-th. Returns the tied positions that differ."""
    if not np.array_equal(got_scores, want_scores):
        raise AssertionError(f"{name}: scores differ from the plain probed pipeline")
    if not ties_ok:
        if not np.array_equal(got_ids, want_ids):
            raise AssertionError(f"{name}: ids differ from the plain probed pipeline")
        return 0
    below = want_scores < want_scores[:, -1:]
    if not np.array_equal(got_ids[below], want_ids[below]):
        raise AssertionError(f"{name}: ids below the k-th score differ from the plain pipeline")
    if not np.array_equal((got_ids != 0xFFFFFFFF).sum(1), (want_ids != 0xFFFFFFFF).sum(1)):
        raise AssertionError(f"{name}: result counts differ from the plain pipeline")
    return int((got_ids != want_ids).sum())


def recall_at_k(got_ids, true_ids):
    return float(np.mean([len(np.intersect1d(g, t)) / len(t) for g, t in zip(got_ids, true_ids)]))


def tied_ids_hold(got_ids, got_scores, want_ids, queries, corpus):
    """Where the sparse route returned another id than the plain pipeline
    (a tie at the k-th score), that id's true L2 distance is the score."""
    r, c = np.nonzero(got_ids != want_ids)
    diff = queries[r].astype(np.float64) - corpus[got_ids[r, c].astype(np.int64) - 1]
    true = np.sqrt((diff * diff).sum(axis=1)).astype(np.float32)
    return bool(np.array_equal(true, got_scores[r, c]))


def kernel_rows(prof):
    """(device us, count, name) of each device event of a torch.profiler
    trace (kernels, copies): the device's own rows only, not the CPU ops
    that launched them, whose device time would count each kernel twice."""
    from torch.autograd import DeviceType

    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0)
        if e.device_type == DeviceType.CUDA and dev_us > 0:
            rows.append((dev_us, e.count, e.key))
    return rows


def profile_window(fn, label=""):
    """torch.profiler over `fn`: prints the kernels by device time and the
    device's busy and idle share of the window's wall time, and the
    launches the package's wrappers counted in the window (a trace that
    lost events shows fewer rows of a kernel than launches)."""
    from torch.profiler import ProfilerActivity, profile

    before = read_launches()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = kernel_rows(prof)
    busy = sum(r[0] for r in rows)
    print(f"profile{f' ({label})' if label else ''}: {busy / 1e3:.3f} ms of device activity in "
          f"{wall_us / 1e3:.3f} ms of wall time, idle share {1 - busy / wall_us:.3f}")
    for dev_us, count, key in sorted(rows, reverse=True)[:12]:
        print(f"  {100 * dev_us / busy:6.2f} %  {count:5d} x {dev_us / count:10.3f} us  {key[:90]}")
    after = read_launches()
    print("  launches counted by the wrappers in the window: " + ", ".join(
        f"{key} {after[key] - before[key]}" for key in after if after[key] != before[key]))


def build_ivf(corpus, tag):
    """An IVF index of sections 2 and 5 (each builds its own): nlist NLIST
    trained on the first N_TRAIN rows, then the whole corpus added."""
    from comet_tpu_torch import DistanceKind, IVFIndex

    ivf = IVFIndex(DIM, NLIST, DistanceKind.L2, device="cuda")
    t0 = time.perf_counter()
    ivf.train(corpus[:N_TRAIN])
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    t0 = time.perf_counter()
    ivf.add_batch(corpus, ids=np.arange(1, N + 1, dtype=np.uint32))
    torch.cuda.synchronize()
    print(f"IVF nlist={NLIST}: train on {N_TRAIN} rows {t_train:.3f} s, add_batch {N} x {DIM} "
          f"{time.perf_counter() - t0:.3f} s {tag}")
    return ivf


def k3_section(corpus, queries, dev, tag, time_ms):
    """K3 on an IVF index's cluster-major layout (`build_ivf`, an index of
    its own; the mixture's lists are uneven) and the batch's own chunk
    lists (section 2): float32 at nprobe 10 at its default step budget and
    at the step budget the IVF path learns on this batch, and the bf16 mode
    at the seed scan's nprobe (nlist / 64) over a bf16 copy of the layout
    (mask: the float32 value of each row's bf16 squared norm), each with
    its rows and chunk table held array-equal to the plain version and
    timed with its launch (the wrapper's fills included), on the card
    alone and the kernel alone. Then whole pipelines: at the learned
    budget, the exact search (kb_cap = 0) against a shortlist at the exact
    bound (kb_cap = K), outputs array-equal; and the two shortlists of the
    port, HNSW's default seed scan (bf16, nprobe nlist / 64, k 128, kb_cap
    32) and IVFPQ's nrefine shortlist (nprobe 10, k 256, kb_cap 128), each
    held to the selection from the reference's dense tile
    (`edge_cases.plain_shortlist`); each pipeline timed with its launch, on
    the card alone, and its kernels' device time (torch.profiler). Returns
    the kernels line's entry `sparse_scan`: float32 at nprobe 10 and the
    step budget the IVF path learned (the default budget where it learned
    none), the shape of the IVF path's launches."""
    from comet_tpu_torch.ops import edge_cases
    from comet_tpu_torch.ops import ivf_sparse as sp
    from comet_tpu_torch.ops.distance import bf16_round

    inf = float("inf")
    ivf = build_ivf(corpus, tag)
    t0 = time.perf_counter()
    st = ivf._device_sparse()
    torch.cuda.synchronize()
    print(f"IVF cluster-major layout: {st['nch_total']} chunks of {sp.CHUNK} rows, built in "
          f"{time.perf_counter() - t0:.3f} s")
    q_all = torch.from_numpy(queries).to(dev)
    g_n = BATCH // sp.QG
    bf16_layout = (st["corpus"].to(torch.bfloat16), bf16_round(st["mask_vec"]))

    def plan_of(nprobe, S):
        S0, _, MC = sp.default_budgets(nprobe, NLIST, st["nch_total"], st["max_chunks"])
        S = S or S0
        plan = sp.scan_plan(q_all, ivf._dev_centroids, ivf._order_key, st["chunk_start"],
                            st["nchunks"], 128, nprobe, S, min(S, NLIST), MC, NLIST, False)
        live = plan["cluster_ids"] >= 0
        member = (plan["probes"][:, :nprobe].view(g_n, sp.QG, -1, 1)
                  == plan["cluster_ids"].view(g_n, 1, 1, plan["S"])).any(dim=2)  # [G, QG, S]
        chunks_read = int(torch.unique(plan["chunk_ids"][live]).numel())
        return plan, MC, live, member, chunks_read

    def run(label, nprobe, S=0, bf16=False):
        plan, MC, live, member, chunks_read = plan_of(nprobe, S)
        S = plan["S"]
        wc = sp.compact_width(nprobe, MC)
        corpus, mask = bf16_layout if bf16 else (st["corpus"], st["mask_vec"])
        qn = (plan["qsorted"] * plan["qsorted"]).sum(dim=1)
        args = (plan["qsorted"], corpus, mask, plan["probes"], plan["chunk_ids"],
                plan["cluster_ids"], st["chunk_start"], st["nchunks"], nprobe, MC, wc, inf, False,
                qn)
        cand, tab = sp._compact_scan_cuda(*args)[:2]
        pcand, ptab = sp._compact_scan_plain(*args)[:2]
        torch.cuda.synchronize()
        if not (torch.equal(cand, pcand) and torch.equal(tab, ptab)):
            raise AssertionError(f"K3, {label}, differs from its plain version")
        n_fin = int(torch.isfinite(pcand).sum())
        del cand, tab, pcand, ptab
        torch.cuda.empty_cache()
        ms = time_ms(lambda: sp._compact_scan_cuda(*args))
        call_us = queued_device_ms(lambda: sp._compact_scan_cuda(*args)) * 1e3
        kernel_us = device_us(lambda: sp._compact_scan_cuda(*args), ["compact_scan_kernel"])[0]
        pms = time_ms(lambda: sp._compact_scan_plain(*args))
        pairs = int(member.sum())
        esize = 2 if bf16 else 4
        # queries and their norms, probes, the walk's start table, the
        # layout's chunk starts and counts, each chunk a walk reaches and
        # its mask read once; the rows and the chunk table written once
        n_bytes = (esize * BATCH * DIM + 4 * (BATCH + BATCH * plan["probes"].shape[1]
                                              + g_n * (NLIST + 1) + 2 * NLIST + 1
                                              + BATCH * wc * (sp.CHUNK + 1))
                   + chunks_read * sp.CHUNK * (esize * DIM + 4))
        b = bound(n_bytes, 2 * DIM * pairs * sp.CHUNK)
        print(f"K3, {label}, {BATCH} queries, S={S}, MC={MC}, row {wc} chunks "
              f"({int(live.sum())} of {g_n * S} steps live, {chunks_read} chunks, {pairs} member "
              f"(query, chunk) pairs, {pairs / BATCH:.1f} a query): rows and chunk table equal to "
              f"plain ({n_fin} finite entries); {ms:.3f} ms with its launch and fills, device "
              f"{call_us:.1f} us a call, kernel alone {kernel_us:.1f} us; plain {pms:.3f} ms; "
              f"bound {b[0]:.3f} ms ({b[1]}) {tag}")
        return dict(err=0.0, ms=ms, plain_ms=pms, library_ms=None, bound=b), S, MC

    def pipe(nprobe, S, MC, k, bf16=False):
        corpus, mask = bf16_layout if bf16 else (st["corpus"], st["mask_vec"])
        return (q_all, corpus, mask, st["row_slot"], inf, ivf._dev_centroids, ivf._order_key,
                st["chunk_start"], st["nchunks"], k, nprobe, S, min(S, NLIST), MC, NLIST)

    def timed(label, args, kb_cap, want=None, against=""):
        def call():
            return sp.ivf_sparse_pipeline(*args, sqrt_out=True, bf16_domain=bf16, kb_cap=kb_cap)

        bf16 = args[1].dtype == torch.bfloat16
        got = call()
        torch.cuda.synchronize()
        if want is not None and not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"the IVF pipeline, {label}, differs from {against}")
        ms, dev_ms = time_ms(call), queued_device_ms(call, reps=10)
        # every kernel of a call on the profiler's clock, one K3 launch a call
        kern_us = calls_device_us([call], [([""], "scan_kernel")])[0]
        mode = ", bf16 mode" if bf16 else ""
        held = f": equal to {against}" if against else ""
        print(f"IVF pipeline, {label} (nprobe {args[10]}, k={args[9]}, kb_cap {kb_cap}, S="
              f"{args[11]}{mode}){held}; {ms:.3f} ms with launch, device {dev_ms:.3f} ms a "
              f"call, its kernels {kern_us / 1e3:.3f} ms a call {tag}")
        return got

    entry, S0, _ = run("float32, nprobe 10", 10)
    # the IVF path's first batch learns its step budget, the one budget the
    # index then holds, where a group's probes overflowed the default
    ivf.search_batch(queries, k=K, nprobes=10)
    learned = list(ivf._sparse_S_hint.values())
    if len(learned) != (ivf.stats()["sparse_overflow_batches"] > 0):
        raise AssertionError(f"the IVF path holds step budgets {learned} after "
                             f"{ivf.stats()['sparse_overflow_batches']} overflowed batches")
    if learned:
        entry, S, MC = run("float32, nprobe 10, the step budget the IVF path learned", 10,
                           S=learned[0])
    else:
        S, MC = S0, sp.default_budgets(10, NLIST, st["nch_total"], st["max_chunks"])[2]
        print("the IVF path learned no step budget on this batch (no overflow)")
    run(f"bf16 mode, nprobe {NLIST // 64}", NLIST // 64, bf16=True)

    exact = timed("the exact search", pipe(10, S, MC, K), 0)
    timed("a shortlist at the exact bound", pipe(10, S, MC, K), K, exact, "the exact search")
    for label, nprobe, k, kb_cap, bf16 in (("HNSW's default seed scan", NLIST // 64, 128, 32, True),
                                           ("IVFPQ's nrefine shortlist", 10, 256, 128, False)):
        S_d, _, MC = sp.default_budgets(nprobe, NLIST, st["nch_total"], st["max_chunks"])
        args = pipe(nprobe, S_d, MC, k, bf16)
        want = edge_cases.plain_shortlist(*args, kb_cap)
        timed(label, args, kb_cap, want, "the reference tile's shortlist")
        del want
    del q_all, st, ivf, bf16_layout, exact
    torch.cuda.empty_cache()
    return {"sparse_scan": entry}


def merge_compares(ef, ew):
    """Compares of a merge sort of ew candidates and one merge with the
    sorted ef-row beam: the operations a merge step needs."""
    return ew * max(ew - 1, 1).bit_length() + ef + ew


def beam_section(x_dev, queries, seed, dev, tag, time_ms):
    """K4 (split and fused) and K5 at the HNSW path's shapes on a running
    search's state made from the seed (section 2; `edge_cases.k4_case`):
    Q = BATCH, ef = ew = kr = 256 (ef_search 200 padded), expand 8; K5 over
    a packed routing table of the corpus with a random W = 32 adjacency.
    Each held array-equal to its plain version and timed."""
    from comet_tpu_torch.ops import beam_kernel as bk
    from comet_tpu_torch.ops.edge_cases import equal, k4_case

    ef = ew = kr = 256
    expand, w = 8, 32
    state = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
             for a in k4_case(BATCH, ef, ew, kr, seed, mid_search=True)]
    for fused in (False, True):
        args = state[:5] + (state[5:] if fused else [None, None, None])
        rest = (ef, ew, expand, fused, kr if fused else 0, ef)
        got = bk._merge_cuda(*args, *rest)
        want = bk._merge_plain(*args, *rest)
        torch.cuda.synchronize()
        equal(f"K4 ({'fused' if fused else 'split'}) against its plain version on the running "
              f"search's state", got, want)
        ms = time_ms(lambda: bk._merge_cuda(*args, *rest))
        pms = time_ms(lambda: bk._merge_plain(*args, *rest))
        print(f"K4 beam merge ({'fused' if fused else 'split'}) Q={BATCH} ef={ef} ew={ew} "
              f"expand={expand}{f' kr={kr}' if fused else ''}, a running search's state: "
              f"equal to plain; kernel {ms:.4f} ms, plain {pms:.3f} ms {tag}")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    adj = torch.randint(-1, N, (N, w), generator=gen, device=dev, dtype=torch.int32)
    sqn = (x_dev * x_dev).sum(dim=1)
    packed = bk.build_packed_table(adj, x_dev, sqn)
    nodes = torch.randint(-1, N, (BATCH, expand), generator=gen, device=dev, dtype=torch.int32)
    q = torch.from_numpy(queries).to(dev)
    qb, qn = q.to(torch.bfloat16), bk.row_sqnorms(q)
    bd, bs, be = state[:3]
    k5 = (nodes, packed, qb, qn, bd, bs, be, ef, expand, ef)
    inf = float("inf")

    def split():
        nd, ns, _ = bk._gather_score_cuda(qb, qn, packed, None, nodes, None, inf, False)
        return bk._merge_cuda(bd, bs, be, nd, ns, None, None, None, ef, expand * w, expand,
                              False, 0, ef)[:4]

    got = bk._fused_expand_cuda(*k5)
    want = bk._fused_expand_plain(*k5)
    pair = split()
    torch.cuda.synchronize()
    if not all(torch.equal(g, wv) and torch.equal(g, sv) for g, wv, sv in zip(got, want, pair)):
        raise AssertionError("K5 differs from its plain version or the split pair on the running "
                             "search's state")
    ms = time_ms(lambda: bk._fused_expand_cuda(*k5))
    sms = time_ms(split)
    pms = time_ms(lambda: bk._fused_expand_plain(*k5))
    print(f"K5 fused expand Q={BATCH} ef={ef} E={expand} W={w} d={DIM}, a running search's "
          f"state over a packed table of {N} rows: equal to plain and to the split pair; kernel "
          f"{ms:.4f} ms, split pair (packed scoring + K4) {sms:.4f} ms, plain {pms:.3f} ms {tag}")
    # the scoring kernel on the same nodes, both layouts: split mode timed,
    # fused mode (a random allowed mask, a threshold at the median) checked
    allowed = torch.rand(N, generator=gen, device=dev) < 0.7
    live = int((nodes >= 0).sum())
    dev_us = {"K5": device_us(lambda: bk._fused_expand_cuda(*k5), ("fused_expand",)),
              "split pair (packed scoring + K4 split)": device_us(
                  split, ("gather_score", "beam_merge"))}
    for layout in ("packed", "blocked"):
        if layout == "blocked":
            del packed, k5
            torch.cuda.empty_cache()
            table, aux = bk.build_blocked_tables(adj, x_dev, sqn)
        else:
            table, aux = packed, None
        sa = (qb, qn, table, aux, nodes, allowed, inf, False)
        hold_scoring(sa, f"{layout} table, the running search's nodes")
        nd = bk._gather_score_plain(*sa)[0]
        n_adm = hold_scoring(sa[:6] + (float(nd[torch.isfinite(nd)].median()), True),
                              f"{layout} table, fused mode, the running search's nodes")
        ms = time_ms(lambda: bk._gather_score_cuda(*sa))
        pms = time_ms(lambda: bk._gather_score_plain(*sa))
        dev_us[f"{layout} scoring"] = device_us(lambda: bk._gather_score_cuda(*sa),
                                                ("gather_score",))
        row_bytes = (table.shape[1] if aux is None else w * DIM + aux.shape[1]) * 2
        n_bytes = (live * row_bytes + nodes.numel() * 4 + qb.numel() * 2 + qn.numel() * 4
                   + nodes.numel() * w * 8)
        b = bound(n_bytes, 2 * DIM * live * w, PEAK_BF16)
        print(f"in-loop scoring, {layout} table, Q={BATCH} E={expand} W={w}, the same nodes "
              f"({live} expanded, rows of {row_bytes} bytes): nd, ns and adm equal to plain "
              f"(fused mode: {n_adm} admitted); kernel {ms:.4f} ms, plain {pms:.3f} ms; bound "
              f"{b[0]:.4f} ms ({b[1]}; {n_bytes / 1e6:.1f} MB) {tag}")
        del table, aux, sa, nd
    print("device time a launch (torch.profiler, mean over a 0.5 s window): " + ", ".join(
        f"{k} {' + '.join(f'{u:.1f}' for u in v)} us" for k, v in dev_us.items()) + f" {tag}")
    del adj, state, q, qb, qn, nodes, allowed
    torch.cuda.empty_cache()


def profiled_rows(fns, seconds=0.5):
    """`kernel_rows` of one torch.profiler window of at least `seconds`
    over calls of `fns` in turns, after a warm-up: long enough that the
    trace keeps launches past the ~130 ms it can lose at its start."""
    from torch.profiler import ProfilerActivity, profile

    for fn in fns:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            for fn in fns:
                fn()
            torch.cuda.synchronize()
    return kernel_rows(prof)


def device_us(fn, keys):
    """Mean device time a launch, in us, of each kernel whose name holds
    one of `keys` (in that order), over the calls of `fn` in one
    `profiled_rows` window: the kernel alone, without the host's launch.
    A trace that kept no launch of one raises."""
    rows = profiled_rows([fn])
    out = []
    for key in keys:
        tot = sum(us for us, _, name in rows if key in name)
        cnt = sum(count for _, count, name in rows if key in name)
        if cnt == 0:
            raise AssertionError(f"the profiler kept no launch of {key}")
        out.append(tot / cnt)
    return out


def calls_device_us(fns, anchors):
    """Mean device time of one call of each of `fns`, run in turns in one
    `profiled_rows` window: for fn i, the device time of every kernel
    whose name holds one of anchors[i][0] over the count of anchors[i][1],
    the kernel it launches once a call. None where the trace kept no
    launch of it."""
    rows = profiled_rows(fns)
    out = []
    for names, once in anchors:
        tot = sum(us for us, _, key in rows if any(n in key for n in names))
        cnt = sum(count for _, count, key in rows if once in key)
        out.append(tot / cnt if cnt else None)
    return out


K1_SPLIT_NAMES = (("split_pass", "split_count", "split_write", "Memset"), "split_write")
# (rows, width, scored share, ks) of k1_split_section: BM25's chunk rows
# and one query's row over the store's smallest and largest segment
K1_SPLIT_SHAPES = ((256, 1 << 20, 0.0, (10, 100)), (256, 1 << 20, 0.05, (10, 100)),
                   (1, 45_428, 0.0, (10,)), (1, 286_372, 0.0, (10,)), (1, 286_372, 0.05, (10,)))
K2_FEWQ_NS = (65_536, 524_288)      # corpus rows of k2_fewq_section
K2_FEWQ_QS = (1, 2, 4, 8, 16, 32)   # its query counts
K2_FEWQ_NLIST, K2_FEWQ_NPROBE = 1024, 10   # its nprobe mode's clusters


def bm25_like_rows(gen, rows, width, matched, dev):
    """[rows, width] negated BM25 scores from `gen`: a `matched` share of
    the documents scores -(1..21), the rest are +0.0 or -0.0."""
    u = torch.rand((rows, width), generator=gen, device=dev)
    score = -(1.0 + 20.0 * torch.rand((rows, width), generator=gen, device=dev))
    zero = torch.where(u < matched / 2 + 0.5, torch.zeros((), device=dev),
                       -torch.zeros((), device=dev))
    return torch.where(u < matched, score, zero)


def k1_split_section(seed, dev, tag, time_ms):
    """K1's split route at the shapes that reach it: BM25's [256,
    2^20] chunk rows (a rare-term chunk, whose boundary lies in ~10^6
    zeros, and a common-term one, 5 % of the documents scored) at k = 10
    and 100, and one query's row over the store's smallest and largest
    segment (45,428 and 286,372 documents) at k = 10: held to the plain
    version, timed beside torch.topk and the bytes bound, with the device
    time a select. A checkout without the route times its own K1 at the
    same shapes. Returns the report entry of the [256, 2^20] rare-term
    chunk at k = 10."""
    from comet_tpu_torch.ops import sortnet

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    out = {}
    for rows, width, matched, ks in K1_SPLIT_SHAPES:
        vals = bm25_like_rows(gen, rows, width, matched, dev)
        if matched == 0.0:
            # fewer than k scored documents: the boundary falls in the zeros
            vals[:, :3] = -5.0
        for k in ks:
            gv, gi = sortnet.topk_rows(vals, None, k)
            pv, pi = sortnet._topk_rows_plain(vals, None, k)
            torch.cuda.synchronize()
            if not (torch.equal(gi, pi) and torch.equal(gv, pv)):
                raise AssertionError(f"K1 differs from its plain version at [{rows}, {width}], "
                                     f"k={k}")
            ms = time_ms(lambda: sortnet.topk_rows(vals, None, k), reps=11)
            pms = time_ms(lambda: sortnet._topk_rows_plain(vals, None, k), reps=1)
            lms = time_ms(lambda: torch.topk(vals, k, dim=1, largest=False), reps=11)
            b = bound(4 * rows * width + 8 * rows * sortnet.k_pow2(k), 0)
            us = calls_device_us([lambda: sortnet.topk_rows(vals, None, k)],
                                 [K1_SPLIT_NAMES if hasattr(sortnet, "SPLIT_LAUNCHES")
                                  else (("topk",), "topk")])[0]
            what = "rare-term" if matched == 0.0 else f"{matched:.0%} scored"
            print(f"K1 split route [{rows}, {width}] k={k}, idx=None, {what}: equal to plain; "
                  f"kernel {ms:.4f} ms (device {'not measured' if us is None else f'{us:.1f} us'}"
                  f"), plain {pms:.3f} ms, torch.topk(dim=1, largest=False) {lms:.4f} ms; bound "
                  f"{b[0] * 1e3:.2f} us ({b[1]}) {tag}")
            if (rows, width, matched, k) == K1_SPLIT_SHAPES[0][:3] + (10,):
                out["topk_cl_split"] = dict(err=0.0, ms=ms, plain_ms=pms, library_ms=lms, bound=b)
        del vals
    torch.cuda.empty_cache()
    return out


def queued_device_ms(fn, reps=20):
    """Device time of one call of `fn`, in ms: `reps` calls queued behind a
    sleep kernel on the stream, so the card runs them back to back, timed
    by CUDA events around them (every kernel of a call, host launch apart)."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def k2_fewq_section(x_dev, queries, dev, tag, time_ms):
    """K2's few-query route: Q = 1, 2, 4, 8, 16 and 32 queries over the
    first 65,536 and 524,288 rows of the corpus (float32, L2), dist and
    group minima bit-equal to the plain version and to the 128-query tile,
    each route timed with its launch (CUDA events) and on the card alone
    (`queued_device_ms`: the whole call, qn included), beside the bytes
    bound; at one query over 524,288 rows also each route's kernel alone
    (torch.profiler) and the plain version both ways. Then the other
    operands and modes at the same Qs over 524,288 rows (bf16, float16,
    int8 with its scale, nprobe at nprobe 10 of 1024 clusters, float32
    cosine): both routes bit-equal to each other and timed the same two
    ways. A checkout without the route times its tile twice. Returns the
    report entry at one query over 524,288 rows."""
    from comet_tpu_torch.ops import fused_scan

    has = hasattr(fused_scan, "FEWQ_MAX")
    saved = getattr(fused_scan, "FEWQ_MAX", 0)
    inf = float("inf")
    dev_s = lambda us: "not measured" if us is None else f"{us:.1f} us"  # noqa: E731
    anchor = [(("fewq_scan", "fused_scan_kernel"), "scan_kernel")]

    def routes(what, scan, plain=None, kernel_us=False):
        """(few-query, tile), each (ms, device us a call, dist, gmin, the
        kernel's device us or None), both routes held to each other and,
        given `plain`, to the plain version."""
        times = {}
        try:
            for route, limit in (("few-query", 32), ("128-query tile", 0)):
                if has:
                    fused_scan.FEWQ_MAX = limit
                dist, gmin = scan()
                if plain is not None:
                    pdist, pgmin = plain()
                    torch.cuda.synchronize()
                    if not (torch.equal(dist, pdist) and torch.equal(gmin, pgmin)):
                        raise AssertionError(f"K2 {route} at {what} differs from its plain "
                                             f"version")
                    del pdist, pgmin
                times[route] = (time_ms(scan, reps=11), queued_device_ms(scan) * 1e3, dist, gmin,
                                calls_device_us([scan], anchor)[0] if kernel_us else None)
        finally:
            if has:
                fused_scan.FEWQ_MAX = saved
        fq, tl = times["few-query"], times["128-query tile"]
        if not (torch.equal(fq[2], tl[2]) and torch.equal(fq[3], tl[3])):
            raise AssertionError(f"K2 at {what}: the routes differ")
        return fq, tl

    out = {}
    for n in K2_FEWQ_NS:
        xs = x_dev[:n]
        mask = (xs * xs).sum(dim=1)
        for q_n in K2_FEWQ_QS:
            qs = torch.from_numpy(queries[:q_n]).to(dev)

            def scan():
                return fused_scan._fused_scan_cuda(qs, xs, mask, inf, False)

            def plain():
                return fused_scan._fused_dist_select_plain(qs, xs, mask, inf, False)
            main = (q_n, n) == (1, K2_FEWQ_NS[-1])
            fq, tl = routes(f"Q={q_n}, N={n}", scan, plain, kernel_us=main)
            b = bound(4 * (q_n * DIM + n * DIM + n + q_n * n + q_n * (n // 128)),
                      2 * q_n * n * DIM)
            print(f"K2 Q={q_n} N={n} d={DIM} float32 L2: both routes equal to plain and to each "
                  f"other; few-query {fq[0]:.4f} ms (device {fq[1]:.1f} us a call), 128-query "
                  f"tile {tl[0]:.4f} ms (device {tl[1]:.1f} us a call); bound {b[0] * 1e3:.2f} us "
                  f"({b[1]}) {tag}")
            if main:
                pms = time_ms(plain, reps=11)
                out["fused_dist_select_fewq"] = dict(err=0.0, ms=fq[0], plain_ms=pms,
                                                     library_ms=None, bound=b)
                print(f"K2 at Q=1 N={n}: kernel alone (torch.profiler) few-query "
                      f"{dev_s(fq[4])}, 128-query tile {dev_s(tl[4])}; plain version "
                      f"{pms:.4f} ms (device {queued_device_ms(plain) * 1e3:.1f} us a call) {tag}")
            del fq, tl
    # the other operands and modes over the largest N
    n = K2_FEWQ_NS[-1]
    xs = x_dev[:n]
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    assign = torch.randint(0, K2_FEWQ_NLIST, (n,), generator=gen, device=dev,
                           dtype=torch.int32)
    x8 = (xs - 128.0).clamp(-127.0, 127.0).to(torch.int8)
    modes = (
        ("bf16 L2", xs.to(torch.bfloat16), (xs * xs).sum(dim=1), {}, False),
        ("float16 L2", xs.to(torch.float16), (xs * xs).sum(dim=1), {}, False),
        ("int8 L2", x8, (x8.float() * x8.float()).sum(dim=1), {"scale": 1.0}, False),
        ("nprobe L2", xs, (xs * xs).sum(dim=1), {"assign": assign, "nlist": K2_FEWQ_NLIST},
         False),
        ("float32 cosine", torch.nn.functional.normalize(xs, dim=1), torch.zeros(n, device=dev),
         {}, True),
    )
    for name, corpus, mask, kw, cosine in modes:
        for q_n in K2_FEWQ_QS:
            qs = torch.from_numpy(queries[:q_n]).to(dev)
            if cosine:
                qs = torch.nn.functional.normalize(qs, dim=1)
            kw_q = dict(kw)
            if "assign" in kw:
                kw_q["probes"] = torch.randint(0, K2_FEWQ_NLIST, (q_n, K2_FEWQ_NPROBE),
                                               generator=gen, device=dev, dtype=torch.int32)

            def scan():
                return fused_scan._fused_scan_cuda(qs, corpus, mask, inf, cosine, **kw_q)
            fq, tl = routes(f"{name}, Q={q_n}, N={n}", scan)
            print(f"K2 {name} Q={q_n} N={n} d={DIM}: the routes equal; few-query {fq[0]:.4f} ms "
                  f"(device {fq[1]:.1f} us a call), 128-query tile {tl[0]:.4f} ms (device "
                  f"{tl[1]:.1f} us a call) {tag}")
            del fq, tl
        del corpus, mask
    torch.cuda.empty_cache()
    return out


def ivf_phase(corpus, queries, c_corpus, c_queries, flat_ids, flat_scores, dev, tag,
              time_ms, profile):
    """Section 5 of the module docstring, on a fresh index from `build_ivf`.
    Returns {"report": per-kernel numbers of K2's nprobe mode, "launches":
    the IVF path's counts}."""
    from comet_tpu_torch import Bitset, DistanceKind, IVFIndex
    from comet_tpu_torch.indexes.base import _additive_mask
    from comet_tpu_torch.ops import fused_scan, sortnet
    from comet_tpu_torch.ops import ivf_sparse as sp
    from comet_tpu_torch.ops.distance import preprocess

    inf = float("inf")
    ids = np.arange(1, N + 1, dtype=np.uint32)
    report = {}
    ivf = build_ivf(corpus, tag)
    vecs, sqnorms, valid = ivf._store.device_state()
    assign = ivf._device_dense()
    cents = ivf._dev_centroids
    sizes = torch.bincount(assign[assign >= 0].long(), minlength=NLIST)
    t0 = time.perf_counter()
    st = ivf._device_sparse()
    torch.cuda.synchronize()
    print(f"list sizes: min {int(sizes.min())}, median {int(sizes.median())}, "
          f"max {int(sizes.max())}; cluster-major layout {st['nch_total']} chunks of "
          f"{sp.CHUNK} rows, built in {time.perf_counter() - t0:.3f} s")

    # K2, nprobe mode: 256 queries x 1M rows with the index's probes at nprobe 10
    q256 = torch.from_numpy(queries[:256]).to(dev)
    width = min(fused_scan.probe_pad(10), NLIST)
    probes = fused_scan.coarse_probes(q256, cents, 10, False, width)
    mask = _additive_mask(valid, sqnorms, False)
    kw = dict(assign=assign, probes=probes, nlist=NLIST)
    dist, gsel = fused_scan.fused_dist_select(q256, vecs, mask, inf, 128, False, **kw)
    pdist, pgmin = fused_scan._fused_dist_select_plain(q256, vecs, mask, inf, False, **kw)
    pgsel = sortnet._topk_rows_plain(pgmin, None, 128)[1]
    torch.cuda.synchronize()
    if not (torch.equal(dist, pdist) and torch.equal(gsel, pgsel)):
        raise AssertionError("K2 nprobe mode differs from its plain version")
    fin = torch.isfinite(pdist)
    err = (dist[fin] - pdist[fin]).abs().max().item()
    n_fin = int(fin.sum())
    ms = time_ms(lambda: fused_scan._fused_scan_cuda(q256, vecs, mask, inf, False, **kw))
    pms = time_ms(lambda: fused_scan._fused_dist_select_plain(q256, vecs, mask, inf, False, **kw))
    table = torch.zeros((256, NLIST), dtype=torch.bool, device=dev)
    table.scatter_(1, probes.long(), True)
    pairs = float((table.float() @ sizes.float()).sum())      # (query, probed row) pairs
    rows_read = float(sizes[table.any(dim=0)].sum())          # rows of any probed list
    n_bytes = 4 * (256 * DIM + rows_read * DIM + 2 * N + 256 * width + 256 * N + 256 * (N // 128))
    report["fused_dist_select_nprobe"] = dict(err=err, ms=ms, plain_ms=pms, library_ms=None,
                                              bound=bound(n_bytes, 2 * DIM * pairs))
    print(f"K2 nprobe mode 256 x {N} x {DIM}, nprobe 10 (width {width}): dist and group "
          f"choice equal to plain ({n_fin} finite entries); kernel {ms:.3f} ms, plain "
          f"{pms:.3f} ms; bound {report['fused_dist_select_nprobe']['bound'][0]:.3f} ms "
          f"({report['fused_dist_select_nprobe']['bound'][1]}) {tag}")
    del dist, pdist, pgmin, gsel, pgsel, fin, table, mask, q256, probes

    qs_all = torch.from_numpy(queries).to(dev)

    # the IVF path through the public API, every launch counted
    allowed = (ids % 3) != 0
    reset_launches()
    runs = {}
    for nprobe in NPROBES:
        ov0 = ivf.stats()["sparse_overflow_batches"]
        t0 = time.perf_counter()
        got = ivf.search_batch(queries, k=K, nprobes=nprobe)
        first = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(ROUNDS):
            again = ivf.search_batch(queries, k=K, nprobes=nprobe)
        steady = time.perf_counter() - t0
        if not (np.array_equal(again[0], got[0]) and np.array_equal(again[1], got[1])):
            raise AssertionError(f"repeated IVF searches differ at nprobe {nprobe}")
        runs[nprobe] = (got, first, ROUNDS * BATCH / steady,
                        ivf.stats()["sparse_overflow_batches"] - ov0)
    route = os.environ.get("COMET_IVF_SPARSE")
    os.environ["COMET_IVF_SPARSE"] = "0"
    t0 = time.perf_counter()
    dense = ivf.search_batch(queries, k=K, nprobes=10)
    t_dense = time.perf_counter() - t0
    if route is None:
        del os.environ["COMET_IVF_SPARSE"]
    else:
        os.environ["COMET_IVF_SPARSE"] = route
    full = ivf.search_batch(queries, k=K, nprobes=NLIST)
    thr = float(np.median(runs[10][0][1][:, 9]))
    filt = ivf.search_batch(queries, k=K, nprobes=10, threshold=thr,
                            document_ids=Bitset.from_array(ids[allowed]))
    if profile:
        profile_window(lambda: [ivf.search_batch(queries, k=K, nprobes=10) for _ in range(2)])
    l2_launches = read_launches()

    # ... checked against the plain probed-lists pipeline on the card
    recalls = []
    for nprobe in NPROBES:
        (g_ids, g_scores), first, qps, ov = runs[nprobe]
        ps, pi = plain_ivf_search(qs_all, vecs, valid, assign, cents, nprobe, inf,
                                  DistanceKind.L2_SQUARED)
        want = ids_of(pi)
        ties = check_probed(f"nprobe {nprobe}", g_ids, g_scores, want, ps, ties_ok=True)
        if ties and not tied_ids_hold(g_ids, g_scores, want, queries, corpus):
            raise AssertionError(f"nprobe {nprobe}: an id at a tie has another distance")
        recalls.append(recall_at_k(g_ids, flat_ids))
        print(f"IVF nprobe {nprobe:2d} k={K}: scores equal to the plain probed pipeline, ids "
              f"equal but {ties} tied at the k-th score; recall@{K} {recalls[-1]:.4f}; "
              f"{qps:.1f} queries/s steady, first batch {first:.3f} s; overflow batches "
              f"{ov} {tag}")
        if nprobe == 10:
            check_probed("dense route nprobe 10", dense[0], dense[1], want, ps, ties_ok=False)
            print(f"IVF dense route (COMET_IVF_SPARSE=0) nprobe 10: ids and scores equal to "
                  f"the plain probed pipeline; {BATCH / t_dense:.1f} queries/s (one batch) {tag}")
    if any(b < a - 1e-12 for a, b in zip(recalls, recalls[1:])):
        raise AssertionError(f"recall falls as nprobe grows: {recalls}")
    if not (np.array_equal(full[0], flat_ids) and np.array_equal(full[1], flat_scores)):
        raise AssertionError("nprobe = nlist differs from the flat path")
    print(f"IVF nprobe = nlist: ids and scores equal to the flat path")
    thr2 = float(np.float32(thr) * np.float32(thr))
    allowed_dev = torch.from_numpy(allowed).to(dev)
    ps, pi = plain_ivf_search(qs_all, vecs, allowed_dev, assign, cents, 10, thr2,
                              DistanceKind.L2_SQUARED)
    ties = check_probed("filtered + threshold", filt[0], filt[1], ids_of(pi), ps, ties_ok=True)
    hits = filt[0][filt[0] != 0xFFFFFFFF]
    if not 0 < len(hits) < filt[0].size or (hits % 3 == 0).any():
        raise AssertionError("the IVF filter or threshold had no effect")
    print(f"IVF nprobe 10 with doc-ID filter and threshold {thr:.3f}: {len(hits)} hits, equal "
          f"to the plain probed pipeline ({ties} tied ids differ)")
    del ivf, vecs, sqnorms, valid, assign, st, qs_all, allowed_dev
    torch.cuda.empty_cache()

    # a cosine IVF index, on data whose cosines are exact
    c_ivf = IVFIndex(DIM, NLIST, DistanceKind.COSINE, device="cuda")
    c_ivf.train(c_corpus[:N_TRAIN])
    c_ivf.add_batch(c_corpus, ids=ids)
    reset_launches()
    c_ids, c_scores = c_ivf.search_batch(c_queries, k=K, nprobes=10)
    c_launches = read_launches()
    launches = {key: l2_launches[key] + c_launches[key] for key in l2_launches}
    if c_launches["topk_cl"] <= 0 or c_launches["sparse_scan"] + c_launches["fused_dist_select_nprobe"] <= 0:
        raise AssertionError(f"the cosine IVF search did not run its kernels: {c_launches}")
    qc = torch.from_numpy(preprocess(c_queries, DistanceKind.COSINE)).to(dev)
    c_vecs, _, c_valid = c_ivf._store.device_state()
    ps, pi = plain_ivf_search(qc, c_vecs, c_valid, c_ivf._device_dense(), c_ivf._dev_centroids,
                              10, inf, DistanceKind.COSINE)
    ties = check_probed("cosine nprobe 10", c_ids, c_scores, ids_of(pi), ps, ties_ok=True)
    print(f"IVF cosine nprobe 10: scores equal to the plain probed pipeline ({ties} tied ids "
          f"differ)")
    print(f"kernel launches of the IVF path ({len(NPROBES) * (1 + ROUNDS) + 4} L2 and 1 "
          f"cosine search_batch calls{', profile included' if profile else ''}): {launches}")
    for key in ("topk_cl", "fused_dist_select_nprobe", "sparse_scan"):
        if launches[key] <= 0:
            raise AssertionError(f"a kernel of the IVF path never launched: {launches}")
    del c_ivf, c_vecs, c_valid, qc
    torch.cuda.empty_cache()
    return {"report": report, "launches": launches}


def flat_bf16_phase(corpus, queries, flat_ids, flat_scores, dev, tag, time_ms):
    """Section 4 of the module docstring. Returns {"report": K2's bf16
    operand, "launches": the bf16 flat path's counts}."""
    from comet_tpu_torch import DistanceKind, FlatIndex
    from comet_tpu_torch.ops import fused_scan, sortnet

    inf = float("inf")
    x_dev = torch.from_numpy(corpus).to(dev)
    xb = x_dev.to(torch.bfloat16)
    mask = (x_dev * x_dev).sum(dim=1)
    del x_dev
    q256 = torch.from_numpy(queries[:256]).to(dev)
    dist, gsel = fused_scan.fused_dist_select(q256, xb, mask, inf, 128)
    pdist, pgmin = fused_scan._fused_dist_select_plain(q256, xb, mask, inf, False)
    pgsel = sortnet._topk_rows_plain(pgmin, None, 128)[1]
    torch.cuda.synchronize()
    if not (torch.equal(dist, pdist) and torch.equal(gsel, pgsel)):
        raise AssertionError("K2's bf16 operand differs from its plain version")
    del dist, pdist, pgmin, gsel, pgsel
    ms = time_ms(lambda: fused_scan._fused_scan_cuda(q256, xb, mask, inf, False))
    pms = time_ms(lambda: fused_scan._fused_dist_select_plain(q256, xb, mask, inf, False))
    # queries (float32), the bf16 corpus and the mask read once; dist and
    # the group minima written
    n_bytes = 4 * 256 * DIM + 2 * N * DIM + 4 * N + 4 * 256 * N + 4 * 256 * (N // 128)
    report = {"fused_dist_select_bf16": dict(err=0.0, ms=ms, plain_ms=pms, library_ms=None,
                                             bound=bound(n_bytes, 2 * 256 * N * DIM, PEAK_BF16))}
    b = report["fused_dist_select_bf16"]["bound"]
    print(f"K2 bf16 operand 256 x {N} x {DIM} kb=128 L2: dist and group choice equal to plain; "
          f"kernel {ms:.3f} ms, plain {pms:.3f} ms; bound {b[0]:.3f} ms ({b[1]}; operations at "
          f"the bf16 tensor-core peak) {tag}")
    del xb, mask, q256
    torch.cuda.empty_cache()

    ids = np.arange(1, N + 1, dtype=np.uint32)
    reset_launches()
    for rerank in (False, True):
        index = FlatIndex(DIM, DistanceKind.L2, storage="bfloat16", rerank=rerank, device="cuda")
        index.add_batch(corpus, ids=ids)
        t0 = time.perf_counter()
        got = index.search_batch(queries, k=K)
        first = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(ROUNDS):
            again = index.search_batch(queries, k=K)
        qps = ROUNDS * BATCH / (time.perf_counter() - t0)
        for g in (got, again):
            if not (np.array_equal(g[0], flat_ids) and np.array_equal(g[1], flat_scores)):
                raise AssertionError(f"flat bf16 (rerank={rerank}) differs from the float32 path")
        print(f"FlatIndex(storage='bfloat16', rerank={rerank}) {N} x {DIM} k={K}: ids and "
              f"scores equal to the float32 flat path; {qps:.1f} queries/s steady, first batch "
              f"{first:.3f} s (bf16 copy included) {tag}")
        report[f"qps_rerank_{rerank}"] = qps
        del index
        torch.cuda.empty_cache()
    launches = read_launches()
    print(f"kernel launches of the bf16 flat path ({2 * (1 + ROUNDS)} search_batch calls): "
          f"{launches}")
    if min(launches["fused_dist_select_bf16"], launches["topk_cl"]) <= 0:
        raise AssertionError(f"a kernel of the bf16 flat path never launched: {launches}")
    return {"report": report, "launches": launches}


def flat_lossy_phase(corpus, queries, flat_ids, flat_scores, dev, tag, time_ms):
    """Section 8 of the module docstring. Returns {"report": K2's float16
    and int8 operands, "launches": the float16 / int8 flat path's counts}."""
    from comet_tpu_torch import DistanceKind, FlatIndex
    from comet_tpu_torch.ops import fused_scan, sortnet

    inf = float("inf")
    x_dev = torch.from_numpy(corpus).to(dev)
    q256 = torch.from_numpy(queries[:256]).to(dev)
    # the scale the untrained int8 index fits to this corpus
    scale = float(np.float32(max(float(np.abs(corpus).max()), 1e-30) / 127.0))
    s_t = torch.tensor(scale, dtype=torch.float32, device=dev)
    x8 = torch.clamp(torch.round(x_dev / s_t), -127, 127).to(torch.int8)
    deq = x8.to(torch.float32) * s_t
    operands = (("f16", x_dev.to(torch.float16), (x_dev * x_dev).sum(dim=1), None, 2),
                ("int8", x8, (deq * deq).sum(dim=1), scale, 1))
    del x_dev, deq
    report = {}
    for name, xs, mask, sc, width in operands:
        dist, gsel = fused_scan.fused_dist_select(q256, xs, mask, inf, 128, scale=sc)
        pdist, pgmin = fused_scan._fused_dist_select_plain(q256, xs, mask, inf, False,
                                                           scale=sc)
        pgsel = sortnet._topk_rows_plain(pgmin, None, 128)[1]
        torch.cuda.synchronize()
        if not (torch.equal(dist, pdist) and torch.equal(gsel, pgsel)):
            raise AssertionError(f"K2's {name} operand differs from its plain version")
        del dist, pdist, pgmin, gsel, pgsel
        ms = time_ms(lambda: fused_scan._fused_scan_cuda(q256, xs, mask, inf, False, scale=sc))
        pms = time_ms(lambda: fused_scan._fused_dist_select_plain(q256, xs, mask, inf, False,
                                                                  scale=sc), reps=1)
        # queries (float16 or bf16), the corpus and the mask read once; dist
        # and the group minima written; the products at the 16-bit
        # tensor-core peak (int8 rows widen exactly to bf16)
        n_bytes = (2 * 256 * DIM + width * N * DIM + 4 * N + 4 * 256 * N
                   + 4 * 256 * (N // 128))
        key = f"fused_dist_select_{name}"
        report[key] = dict(err=0.0, ms=ms, plain_ms=pms, library_ms=None,
                           bound=bound(n_bytes, 2 * 256 * N * DIM, PEAK_BF16))
        b = report[key]["bound"]
        extra = ""
        if name == "f16":
            qh = q256.to(torch.float16)
            mm_ms = time_ms(lambda: torch.mm(qh, xs.T, out_dtype=torch.float32))
            report[key]["mm_ms"] = mm_ms
            extra = f"; the product alone, torch.mm(out_dtype=torch.float32), {mm_ms:.3f} ms"
        print(f"K2 {name} operand 256 x {N} x {DIM} kb=128 L2: dist and group choice equal to "
              f"plain; kernel {ms:.3f} ms, plain {pms:.3f} ms; bound {b[0]:.3f} ms ({b[1]})"
              f"{extra} {tag}")
    del operands, xs, mask, x8, q256
    torch.cuda.empty_cache()

    ids = np.arange(1, N + 1, dtype=np.uint32)
    reset_launches()
    for storage in ("float16", "int8"):
        for rerank in (False, True):
            index = FlatIndex(DIM, DistanceKind.L2, storage=storage, rerank=rerank,
                              device="cuda")
            index.add_batch(corpus, ids=ids)
            t0 = time.perf_counter()
            got = index.search_batch(queries, k=K)
            first = time.perf_counter() - t0
            t0 = time.perf_counter()
            for _ in range(ROUNDS):
                again = index.search_batch(queries, k=K)
            qps = ROUNDS * BATCH / (time.perf_counter() - t0)
            if not (np.array_equal(again[0], got[0]) and np.array_equal(again[1], got[1])):
                raise AssertionError(f"repeated flat {storage} searches differ")
            with uncounted(), plain_versions():
                plain = index.search_batch(queries[:256], k=K)
            if not (np.array_equal(plain[0], got[0][:256])
                    and np.array_equal(plain[1], got[1][:256])):
                raise AssertionError(f"flat {storage} (rerank={rerank}) differs from the plain "
                                     f"pipeline")
            name = f"FlatIndex(storage={storage!r}, rerank={rerank}) {N} x {DIM} k={K}"
            if storage == "float16":
                if not (np.array_equal(got[0], flat_ids) and np.array_equal(got[1], flat_scores)):
                    raise AssertionError(f"{name} differs from the float32 flat path")
                held = "ids and scores equal to the float32 flat path"
            else:
                held = f"recall@{K} against the float32 ids {recall_at_k(got[0], flat_ids):.4f}"
            print(f"{name}: equal to the plain pipeline (256 queries); {held}; {qps:.1f} "
                  f"queries/s steady, first batch {first:.3f} s (the lossy copy included) {tag}")
            report[f"qps_{storage}_rerank_{rerank}"] = qps
            del index
            torch.cuda.empty_cache()
    launches = read_launches()
    print(f"kernel launches of the float16 / int8 flat path ({4 * (1 + ROUNDS)} search_batch "
          f"calls): {launches}")
    if min(launches["fused_dist_select_f16"], launches["fused_dist_select_int8"],
           launches["topk_cl"]) <= 0:
        raise AssertionError(f"a kernel of the float16 / int8 flat path never launched: "
                             f"{launches}")
    return {"report": report, "launches": launches}


PQ_M, PQ_NBITS = 16, 8           # bench.py's PQ / IVFPQ operating point


def close_to_plain(name, ids, scores, p_ids, p_scores):
    """A float32 scan of non-integer rows against its plain version, whose
    product (cuBLAS) sums in another order than the kernels' FMA chain:
    scores allclose(1e-5, 1e-4), and every id whose plain score lies below
    the row's k-th by more than that tolerance present in the kernel's
    row. Returns the positions whose ids differ (near ties)."""
    np.testing.assert_allclose(scores, p_scores, rtol=1e-5, atol=1e-4,
                               err_msg=f"{name}: scores differ from the plain route")
    kth = p_scores[:, -1:]
    safe = p_scores < kth - (1e-4 + 1e-5 * np.abs(kth))
    for r in np.flatnonzero(safe.any(axis=1)):
        if not np.isin(p_ids[r][safe[r]], ids[r]).all():
            raise AssertionError(f"{name}: an id below the k-th score is missing (row {r})")
    return int((ids != p_ids).sum())


def snapped_twin(index):
    """The index's state with its codebooks and centroids rounded to
    integers and an OPQ rotation replaced by a signed permutation: on this
    integer corpus every distance of every route is then exact, so each
    route must be bit-equal to its plain version."""
    from comet_tpu_torch import IVFPQIndex, PQIndex

    st = index._store
    rot = None
    if index._rot is not None:
        g = np.random.default_rng(1)
        rot = (np.eye(DIM, dtype=np.float32)[g.permutation(DIM)]
               * g.choice([-1.0, 1.0], DIM)).astype(np.float32)
    books = np.rint(index._codebooks)
    if isinstance(index, PQIndex):
        return PQIndex.load_reference_state(st.ids, index._codes, st.valid, st.n, books, rot,
                                            device="cuda")
    return IVFPQIndex.load_reference_state(
        st.ids, index._codes, index._assign, st.valid, st.n, np.rint(index._centroids), books,
        rot, st.vectors if index._store_originals else None, device="cuda")


def pq_search_checked(index, name, queries, flat_ids, tag, rounds=ROUNDS, recall_k=K,
                      twin=None, **kw):
    """search_batch through the kernels (a first batch, then `rounds` steady
    ones), with recall against the flat path's exact ids and queries/s,
    then the same batch with every wrapper on its plain version on the
    card: array-equal, or, with a `twin` (a route whose float32 product
    sums the trained model's non-integer rows), `close_to_plain` there and
    array-equal on the twin's integer state. Returns (ids, scores,
    launches)."""
    reset_launches()
    t0 = time.perf_counter()
    ids, scores = index.search_batch(queries, k=recall_k, **kw)
    first = time.perf_counter() - t0
    qps = None
    if rounds:
        t0 = time.perf_counter()
        for _ in range(rounds):
            again = index.search_batch(queries, k=recall_k, **kw)
        qps = rounds * len(queries) / (time.perf_counter() - t0)
        if not (np.array_equal(again[0], ids) and np.array_equal(again[1], scores)):
            raise AssertionError(f"{name}: repeated searches differ")
    launches = read_launches()
    if ids.shape != (len(queries), recall_k) or not np.isfinite(scores).all():
        raise AssertionError(f"{name}: bad result shape {ids.shape} or non-finite scores")
    with uncounted():
        with plain_versions():
            p_ids, p_scores = index.search_batch(queries, k=recall_k, **kw)
        if twin is None:
            if not (np.array_equal(ids, p_ids) and np.array_equal(scores, p_scores)):
                raise AssertionError(f"{name}: ids or scores differ from the plain route")
            held = "ids and scores equal to the plain route"
        else:
            near = close_to_plain(name, ids, scores, p_ids, p_scores)
            t_ids, t_scores = twin.search_batch(queries, k=recall_k, **kw)
            with plain_versions():
                tp_ids, tp_scores = twin.search_batch(queries, k=recall_k, **kw)
            if not (np.array_equal(t_ids, tp_ids) and np.array_equal(t_scores, tp_scores)):
                raise AssertionError(f"{name}: the integer twin differs from its plain route")
            held = (f"allclose(1e-5, 1e-4) to the plain route ({near} ids at near ties "
                    f"differ), the integer twin equal to its plain route")
    rec = recall_at_k(ids, flat_ids[:len(queries), :recall_k])
    used = {k: v for k, v in launches.items() if v}
    print(f"{name}: {held}; recall@{recall_k} {rec:.4f}; "
          + (f"{qps:.1f} queries/s steady, " if qps else "")
          + f"first batch {first:.3f} s; launches {used} {tag}")
    return ids, scores, launches


def pq_phase(corpus, queries, flat_ids, tag, profile):
    """Section 9 of the module docstring. Returns {"launches": the PQ and
    IVFPQ paths' counts (the routes past the byte cap included)}."""
    from comet_tpu_torch import DistanceKind, IVFPQIndex, PQIndex
    from comet_tpu_torch.indexes import pq

    ids = np.arange(1, N + 1, dtype=np.uint32)
    total = {}

    def add(launches):
        for key, v in launches.items():
            total[key] = total.get(key, 0) + v

    def built(index, what):
        t0 = time.perf_counter()
        index.train(corpus[:N_TRAIN])
        torch.cuda.synchronize()
        t_train = time.perf_counter() - t0
        t0 = time.perf_counter()
        index.add_batch(corpus, ids=ids)
        torch.cuda.synchronize()
        print(f"{what}: train on {N_TRAIN} rows {t_train:.3f} s, add_batch {N} x {DIM} "
              f"{time.perf_counter() - t0:.3f} s {tag}")
        return index

    # PQ: the dense route, then ADC past the byte cap
    pqi = built(PQIndex(DIM, DistanceKind.L2, m=PQ_M, nbits=PQ_NBITS, device="cuda"),
                f"PQIndex m={PQ_M} nbits={PQ_NBITS}")
    twin = snapped_twin(pqi)
    dense_ids, _, launches = pq_search_checked(pqi, "PQ dense route k=100", queries,
                                               flat_ids, tag, twin=twin)
    add(launches)
    saved = pq.DECODED_BYTES_MAX
    pq.DECODED_BYTES_MAX = 0
    try:
        adc_ids, _, launches = pq_search_checked(pqi, "PQ ADC route (byte cap 0) k=100",
                                                 queries, flat_ids, tag, rounds=1)
    finally:
        pq.DECODED_BYTES_MAX = saved
    add(launches)
    del twin
    print(f"PQ: the ADC route's ids differ from the dense route's at "
          f"{int((adc_ids != dense_ids).sum())} of {adc_ids.size} places (near ties of "
          f"the two float32 sums)")
    del pqi
    torch.cuda.empty_cache()

    # IVFPQ nlist 1024 with the originals: the sparse route at each nprobe
    ivf = built(IVFPQIndex(DIM, DistanceKind.L2, nlist=NLIST, m=PQ_M, nbits=PQ_NBITS,
                           store_originals=True, device="cuda"),
                f"IVFPQIndex nlist={NLIST} m={PQ_M} nbits={PQ_NBITS} store_originals")
    twin = snapped_twin(ivf)
    for nprobe in NPROBES:
        _, _, launches = pq_search_checked(ivf, f"IVFPQ sparse route nprobe {nprobe:2d} k=100",
                                           queries, flat_ids, tag, twin=twin, nprobes=nprobe)
        add(launches)
    _, _, launches = pq_search_checked(ivf, "IVFPQ sparse route nprobe 10 nrefine 256 k=100",
                                       queries, flat_ids, tag, twin=twin, nprobes=10,
                                       nrefine=256)
    add(launches)
    with env_set(COMET_IVFPQ_SPARSE="0"):
        _, _, launches = pq_search_checked(ivf, "IVFPQ dense route nprobe 10 k=100", queries,
                                           flat_ids, tag, rounds=1, twin=twin, nprobes=10)
        add(launches)
        _, _, launches = pq_search_checked(ivf, "IVFPQ dense route nprobe 10 nrefine 256 "
                                           "k=100", queries, flat_ids, tag, rounds=1,
                                           twin=twin, nprobes=10, nrefine=256)
        add(launches)
    del twin
    saved = pq.DECODED_BYTES_MAX
    pq.DECODED_BYTES_MAX = 0
    try:
        _, _, launches = pq_search_checked(ivf, "IVFPQ LUT walk (byte cap 0) nprobe 10 k=100",
                                           queries, flat_ids, tag, rounds=1, nprobes=10)
        add(launches)
    finally:
        pq.DECODED_BYTES_MAX = saved
    if profile:
        profile_window(lambda: ivf.search_batch(queries, k=K, nprobes=10),
                       "IVFPQ sparse nprobe 10")
    del ivf
    torch.cuda.empty_cache()

    # OPQ: recall@10 at nprobe 10 with nrefine
    opq = built(IVFPQIndex(DIM, DistanceKind.L2, nlist=NLIST, m=PQ_M, nbits=PQ_NBITS,
                           store_originals=True, opq=True, device="cuda"),
                f"IVFPQIndex opq nlist={NLIST} m={PQ_M} nbits={PQ_NBITS}")
    _, _, launches = pq_search_checked(opq, "IVFPQ OPQ sparse route nprobe 10 nrefine 64 k=10",
                                       queries, flat_ids, tag, recall_k=10,
                                       twin=snapped_twin(opq), nprobes=10, nrefine=64)
    add(launches)
    del opq
    torch.cuda.empty_cache()
    print(f"kernel launches of the PQ / IVFPQ paths: {total}")
    for key in ("topk_cl", "fused_dist_select", "fused_dist_select_nprobe", "sparse_scan"):
        if total.get(key, 0) <= 0:
            raise AssertionError(f"a kernel of the PQ / IVFPQ paths never launched: {total}")
    return {"launches": total}


class plain_versions:
    """Inside, every wrapper of the package takes its plain version, also
    for CUDA tensors: searches run the plain beam on the same card tensors.
    Plain versions count no launches."""

    def __enter__(self):
        from comet_tpu_torch.ops import beam_kernel, bm25, fused_scan, ivf_sparse, sortnet

        self.mods = (sortnet, fused_scan, ivf_sparse, beam_kernel, bm25)
        self.saved = [m.use_plain for m in self.mods]
        for m in self.mods:
            m.use_plain = lambda t: True
        return self

    def __exit__(self, *exc):
        for m, f in zip(self.mods, self.saved):
            m.use_plain = f


class capture:
    """Inside, `module.name` is wrapped: the arguments of its call number
    `which` (0-based) are kept in `.args` / `.kwargs`."""

    def __init__(self, module, name, which):
        self.module, self.name, self.which = module, name, which
        self.args = self.kwargs = None

    def __enter__(self):
        self.real = getattr(self.module, self.name)
        calls = [0]

        def wrapped(*args, **kwargs):
            if calls[0] == self.which:
                self.args, self.kwargs = args, kwargs
            calls[0] += 1
            return self.real(*args, **kwargs)

        setattr(self.module, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)


def hnsw_search_checked(index, name, queries, rounds=0, **kw):
    """search_batch through the kernels (a first batch, then `rounds`
    steady ones), then the same batch on the plain beam; ids and scores must
    be array-equal. Returns (ids, scores, first seconds, queries/s or None)."""
    st0 = index.stats()
    t0 = time.perf_counter()
    ids, scores = index.search_batch(queries, k=K, ef_search=EF_SEARCH, **kw)
    first = time.perf_counter() - t0
    st1 = index.stats()
    index.first_seed_health = (st1["seed_overflow_chunks"] - st0["seed_overflow_chunks"],
                               st1["seed_starved_queries"] - st0["seed_starved_queries"])
    qps = None
    if rounds:
        t0 = time.perf_counter()
        for _ in range(rounds):
            again = index.search_batch(queries, k=K, ef_search=EF_SEARCH, **kw)
        qps = rounds * len(queries) / (time.perf_counter() - t0)
        if not (np.array_equal(again[0], ids) and np.array_equal(again[1], scores)):
            raise AssertionError(f"HNSW {name}: repeated searches differ")
    with plain_versions():
        p_ids, p_scores = index.search_batch(queries, k=K, ef_search=EF_SEARCH, **kw)
    if not (np.array_equal(ids, p_ids) and np.array_equal(scores, p_scores)):
        raise AssertionError(f"HNSW {name}: ids or scores differ from the plain beam")
    if ids.shape != (len(queries), K):
        raise AssertionError(f"HNSW {name}: result shape {ids.shape}")
    return ids, scores, first, qps


class uncounted:
    """Inside, kernel launches do not count: launches made to hold a kernel
    against its plain version are not the main path's."""

    def __enter__(self):
        self.saved = read_launches()
        return self

    def __exit__(self, *exc):
        from comet_tpu_torch.ops import beam_kernel, bm25, fused_scan, ivf_sparse, sortnet

        s = self.saved
        bm25.LAUNCHES = s["bm25_score"]
        sortnet.LAUNCHES = s["topk_cl"]
        sortnet.SPLIT_LAUNCHES = s["topk_cl_split"]
        fused_scan.LAUNCHES = s["fused_dist_select"]
        fused_scan.FEWQ_LAUNCHES = s["fused_dist_select_fewq"]
        fused_scan.NPROBE_LAUNCHES = s["fused_dist_select_nprobe"]
        fused_scan.BF16_LAUNCHES = s["fused_dist_select_bf16"]
        fused_scan.F16_LAUNCHES = s["fused_dist_select_f16"]
        fused_scan.INT8_LAUNCHES = s["fused_dist_select_int8"]
        ivf_sparse.LAUNCHES, ivf_sparse.BF16_LAUNCHES = s["sparse_scan"], s["sparse_scan_bf16"]
        beam_kernel.LAUNCHES = s["beam_merge"]
        beam_kernel.FUSED_LAUNCHES = s["beam_merge_fused"]
        beam_kernel.SCORE_LAUNCHES = s["gather_score"]
        beam_kernel.PACKED_SCORE_LAUNCHES = s["gather_score_packed"]
        beam_kernel.FUSE_LAUNCHES = s["fused_expand"]


class env_set:
    """Inside, the environment variables given are set (None: unset)."""

    def __init__(self, **values):
        self.values = values

    def __enter__(self):
        self.saved = {k: os.environ.get(k) for k in self.values}
        for k, v in self.values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        return self

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def hold_scoring(args, what):
    """The scoring kernel's three outputs (nd, ns, and adm, or None unless
    fused) held to its plain version on `args`. Returns the admitted count."""
    from comet_tpu_torch.ops import beam_kernel as bk
    from comet_tpu_torch.ops.edge_cases import equal

    got = bk._gather_score_cuda(*args)
    want = bk._gather_score_plain(*args)
    torch.cuda.synchronize()
    equal(f"the scoring kernel against its plain version ({what})", got, want,
          ("nd", "ns", "adm"))
    return None if got[2] is None else int(got[2].sum())


def check_k4_scoring_k3(cap_merge, cap_fused, cap_score, cap_fscore, cap_seed, report, tag,
                        time_ms):
    """K4 (split and fused), the blocked scoring kernel (split and fused
    mode) and K3's bf16 mode against their plain versions on the captured
    inputs of real iterations, timed."""
    from comet_tpu_torch.ops import beam_kernel as bk
    from comet_tpu_torch.ops import edge_cases
    from comet_tpu_torch.ops import ivf_sparse as sp
    from comet_tpu_torch.ops.distance import sqrt_f32
    from comet_tpu_torch.ops.edge_cases import equal

    for key, cap in (("beam_merge", cap_merge), ("beam_merge_fused", cap_fused)):
        a, kw = cap.args, cap.kwargs
        fused = kw["fused"]
        if not fused and a[5:] and any(t is not None for t in a[5:]):
            raise AssertionError("the split step was given a result set")
        args = list(a[:5]) + ([a[5], a[6], a[7]] if fused else [None, None, None])
        args = [t.contiguous() if t is not None else None for t in args]
        ef, ew, expand, kr = kw["ef"], kw["ew"], kw["expand"], kw["kr"]
        stop = kw["stop"] or ef
        rest = (ef, ew, expand, fused, kr, stop)
        got = bk._merge_cuda(*args, *rest)
        want = bk._merge_plain(*args, *rest)
        torch.cuda.synchronize()
        equal(f"K4 ({key}) against its plain version", got, want)
        q_n = args[0].shape[0]
        ms = time_ms(lambda: bk._merge_cuda(*args, *rest))
        pms = time_ms(lambda: bk._merge_plain(*args, *rest))
        n_bytes = q_n * (ef * 12 + ew * 8 + ef * 12 + bk.MISC_ROWS * 4)
        n_cmp = q_n * merge_compares(ef, ew)
        if fused:
            n_bytes += q_n * (kr * 8 + ew * 4 + kr * 8)
            n_cmp += q_n * (kr + ew)            # the admitted run merged with the result set
        report[key] = dict(err=0.0, ms=ms, plain_ms=pms, library_ms=None,
                           bound=bound(n_bytes, n_cmp))
        print(f"K4 beam merge ({'fused' if fused else 'split'}) Q={q_n} ef={ef} ew={ew} "
              f"expand={expand} stop={stop}{f' kr={kr}' if fused else ''}, inputs of iteration "
              f"3: equal to plain; kernel {ms:.3f} ms, plain {pms:.3f} ms; bound "
              f"{report[key]['bound'][0]:.4f} ms ({report[key]['bound'][1]}; {n_bytes / 1e6:.1f} "
              f"MB, {n_cmp / 1e6:.1f} M compares) {tag}")

    a = cap_score.args
    qb, qn, nbr_vecs, aux, nodes, allowed_dev, thr_k, fused = a
    hold_scoring(a, "blocked table, a seeded search's iteration 3")
    fa = cap_fscore.args
    if not fa[7] or fa[3] is None:
        raise AssertionError("the filtered search did not score the blocked table in fused mode")
    n_adm = hold_scoring(fa, "blocked table, fused mode, a filtered search's iteration 3")
    print(f"in-loop scoring, fused mode (filter + threshold {fa[6]:.3f}), iteration 3: nd, ns "
          f"and adm equal to plain; {n_adm} of {fa[4].numel() * nbr_vecs.shape[1]} candidates "
          f"admitted {tag}")
    ms = time_ms(lambda: bk._gather_score_cuda(*a))
    pms = time_ms(lambda: bk._gather_score_plain(*a))
    live = int((nodes >= 0).sum())
    w = nbr_vecs.shape[1]
    n_bytes = (live * (w * DIM * 2 + aux.shape[1] * 2) + nodes.numel() * 4 + qb.numel() * 2
               + qn.numel() * 4 + nodes.shape[0] * nodes.shape[1] * w * 8)
    report["gather_score"] = dict(err=0.0, ms=ms, plain_ms=pms, library_ms=None,
                                  bound=bound(n_bytes, 2 * DIM * live * w))
    print(f"in-loop scoring Q={nodes.shape[0]} E={nodes.shape[1]} W={w} ({live} nodes "
          f"expanded), iteration 3: nd, ns and adm equal to plain; kernel {ms:.3f} ms, plain "
          f"{pms:.3f} ms; "
          f"bound {report['gather_score']['bound'][0]:.4f} ms "
          f"({report['gather_score']['bound'][1]}) {tag}")

    # the seed scan: its pipeline call replayed, held to the reference
    # tile's shortlist, and K3's bf16 mode on its inputs
    a, kw = cap_seed.args, cap_seed.kwargs
    kb_cap, qn = kw["kb_cap"], kw["qn"]
    if not kw["bf16_domain"] or a[1].dtype != torch.bfloat16 or not kb_cap:
        raise AssertionError("the seed scan did not take K3's bf16 mode with a shortlist")
    lay = a + tuple(kw[n] for n in ("k", "nprobe", "S", "UC", "MC", "nlist"))
    q, corpus_b, mask, thr_s = a[0], a[1], a[2], float(a[4])
    k, nprobe, MC, nlist = kw["k"], kw["nprobe"], kw["MC"], kw["nlist"]
    got = sp.ivf_sparse_pipeline(*a, **kw)
    want = edge_cases.plain_shortlist(*lay, kb_cap, qn=qn)
    torch.cuda.synchronize()
    if not (torch.equal(sqrt_f32(got[0]), want[0]) and torch.equal(got[1], want[1])
            and torch.equal(got[2], want[2])):
        raise AssertionError("the seed scan differs from the reference tile's shortlist")
    del got, want
    call_ms = queued_device_ms(lambda: sp.ivf_sparse_pipeline(*a, **kw), reps=10)
    plan = sp.scan_plan(q, *a[5:9], k, nprobe, kw["S"], kw["UC"], MC, nlist, False, kb_cap)
    wc = sp.compact_width(nprobe, MC, k, kb_cap)
    scan = (plan["qsorted"], corpus_b, mask, plan["probes"], plan["chunk_ids"],
            plan["cluster_ids"], a[7], a[8], nprobe, MC, wc, thr_s, False, qn[plan["qperm"]])
    # the pipeline's mode: the group minima written, the row not filled
    filled = sp._compact_scan_cuda(*scan)
    got = sp._compact_scan_cuda(*scan, minima=True)
    pcand, ptab, pgmin = sp._compact_scan_plain(*scan, minima=True)
    torch.cuda.synchronize()
    if not (torch.equal(filled[0], pcand) and torch.equal(filled[1], ptab)
            and torch.equal(got[2], pgmin)):
        raise AssertionError("K3's bf16 mode differs from its plain version")
    edge_cases.check_k3_minima(filled, got, "bf16 mode, the seed scan's inputs")
    n_fin = int(torch.isfinite(pcand).sum())
    del filled, got, pcand, ptab, pgmin
    ms = time_ms(lambda: sp._compact_scan_cuda(*scan, minima=True))
    kernel_us = device_us(lambda: sp._compact_scan_cuda(*scan, minima=True),
                          ["compact_scan_kernel"])[0]
    pms = time_ms(lambda: sp._compact_scan_plain(*scan, minima=True))
    chunk_ids, cluster_ids, probes = plan["chunk_ids"], plan["cluster_ids"], plan["probes"]
    g_n, s_n = chunk_ids.shape
    live = cluster_ids >= 0
    member = (probes[:, :nprobe].view(g_n, sp.QG, -1, 1)
              == cluster_ids.view(g_n, 1, 1, s_n)).any(dim=2)
    pairs = float(member.sum()) * sp.CHUNK
    chunks_read = int(torch.unique(chunk_ids[live]).numel())
    q_n = q.shape[0]
    # queries and their norms, probes, the walk's start table, the layout's
    # chunk starts and counts, each chunk a walk reaches and its mask read
    # once; the member pairs' distances, the chunk table and the group
    # minima written once
    n_bytes = (q_n * DIM * 2 + 4 * (q_n + q_n * probes.shape[1] + g_n * (nlist + 1)
                                    + 2 * nlist + 1 + pairs + 3 * q_n * wc)
               + chunks_read * sp.CHUNK * (2 * DIM + 4))
    report["sparse_scan_bf16"] = dict(err=0.0, ms=ms, plain_ms=pms, library_ms=None,
                                      bound=bound(n_bytes, 2 * DIM * pairs))
    print(f"HNSW seed scan of {q_n} queries (nprobe {nprobe}, k={k}, kb_cap {kb_cap}, S={s_n}, "
          f"{int(live.sum())} of {g_n * s_n} steps live, {chunks_read} chunks, row {wc} chunks): "
          f"equal to the reference tile's shortlist, device {call_ms:.3f} ms a call; K3's bf16 "
          f"mode on its inputs equal to plain ({n_fin} finite entries), and its group minima; "
          f"with the minima (the pipeline's mode) kernel {ms:.3f} ms with its launch and fills, "
          f"{kernel_us:.1f} us alone, plain {pms:.3f} ms; bound "
          f"{report['sparse_scan_bf16']['bound'][0]:.3f} ms "
          f"({report['sparse_scan_bf16']['bound'][1]}) {tag}")


def time_gather(index, n, dev, tag, time_ms):
    """One iteration's blocked-table row gather: 8 rows a query of a
    2048-query batch, at random among the graph's n nodes."""
    nbr_vecs, aux = index._routing_tables()
    rng = np.random.default_rng(1)
    rows = torch.from_numpy(rng.integers(0, n, size=BATCH * 8)).to(dev)
    ms = time_ms(lambda: (nbr_vecs[rows], aux[rows]))
    row_bytes = nbr_vecs.shape[1] * DIM * 2 + aux.shape[1] * 2
    gbps = len(rows) * row_bytes / (ms * 1e-3) / 1e9
    print(f"blocked-table gather, one iteration: {len(rows)} rows of {row_bytes} bytes "
          f"(W x d bf16 + the aux row, table of {nbr_vecs.shape[0]} rows) in {ms:.4f} ms: "
          f"{len(rows) / (ms * 1e-3):.4g} rows/s, {gbps:.1f} GB/s = "
          f"{gbps / (PEAK_BYTES / 1e9):.3f} of 3.35 TB/s {tag}")


def packed_fused_phase(index, queries, blocked, report, dev, tag, time_ms):
    """Part of section 6 of the module docstring, on the 1M graph: the
    packed table against the blocked pair, the packed and fused searches
    against the blocked ones and the plain beam, K5 and the packed scoring
    against their plain versions. `blocked` maps "seeded" / "classic" to
    the blocked search's (ids, scores)."""
    from comet_tpu_torch.ops import beam_kernel as bk

    nbr_vecs, aux = index._routing_tables()
    t0 = time.perf_counter()
    with env_set(COMET_HNSW_PACKED="1"):
        packed, none = index._routing_tables()
    torch.cuda.synchronize()
    t_pack = time.perf_counter() - t0
    cap, w, d = nbr_vecs.shape
    rows = slice(cap // 2, cap // 2 + (1 << 16))
    if not (none is None and torch.equal(packed[rows, : w * d].view(-1, w, d), nbr_vecs[rows])
            and torch.equal(packed[rows, w * d:], aux[rows])):
        raise AssertionError("the packed table differs from the blocked pair")
    print(f"packed table {tuple(packed.shape)} bf16 ({packed.numel() * 2 / 2**30:.2f} GiB, rows "
          f"of {packed.shape[1] * 2} bytes) built in {t_pack:.3f} s; rows {rows.start}.."
          f"{rows.stop - 1} equal to the blocked pair {tag}")
    for switch in ("COMET_HNSW_PACKED", "COMET_HNSW_FUSE"):
        for mode, seed in (("seeded", None), ("classic", "0")):
            with env_set(**{switch: "1", "COMET_HNSW_SEED": seed}), \
                    capture(bk, "fused_expand_merge", 2) as cap_k5, \
                    capture(bk, "gather_score", 2) as cap_score:
                got = hnsw_search_checked(index, f"{mode} {switch}=1", queries, rounds=ROUNDS)
            want = blocked[mode]
            if not (np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])):
                raise AssertionError(f"{mode} search with {switch}=1 differs from the blocked one")
            print(f"HNSW {mode} {switch}=1: ids and scores equal to the blocked split search and "
                  f"to the plain beam; {got[3]:.1f} queries/s steady, first batch {got[2]:.3f} s "
                  f"{tag}")
            if (switch, mode) == ("COMET_HNSW_FUSE", "seeded"):
                k5_args = cap_k5
            if (switch, mode) == ("COMET_HNSW_PACKED", "seeded"):
                score_args = cap_score
    with uncounted():
        check_k5_packed_scoring(k5_args, score_args, report, dev, tag, time_ms)


def check_k5_packed_scoring(cap_k5, cap_score, report, dev, tag, time_ms):
    """K5 and the packed scoring mode against their plain versions on a
    real iteration's inputs (and K5 against the split pair's kernels), then
    the packed scoring at an unaligned shape; timed beside the split pair."""
    from comet_tpu_torch.ops import beam_kernel as bk

    a, kw = cap_k5.args, cap_k5.kwargs
    nodes, packed, qb, qn, bd, bs, be = [t.contiguous() for t in a]
    ef, expand, stop = kw["ef"], kw["expand"], kw["stop"] or kw["ef"]
    q_n, d = qb.shape
    w = bk._table_width(packed, d)
    got = bk._fused_expand_cuda(nodes, packed, qb, qn, bd, bs, be, ef, expand, stop)
    want = bk._fused_expand_plain(nodes, packed, qb, qn, bd, bs, be, ef, expand, stop)

    def split():
        nd, ns, _ = bk._gather_score_cuda(qb, qn, packed, None, nodes, None, float("inf"), False)
        return bk._merge_cuda(bd, bs, be, nd, ns, None, None, None, ef, expand * w, expand,
                              False, 0, stop)[:4]

    pair = split()
    torch.cuda.synchronize()
    for g, wv, sv in zip(got, want, pair):
        if not (torch.equal(g, wv) and torch.equal(g, sv)):
            raise AssertionError("K5 differs from its plain version or the split pair")
    ms = time_ms(lambda: bk._fused_expand_cuda(nodes, packed, qb, qn, bd, bs, be, ef, expand,
                                               stop))
    pms = time_ms(lambda: bk._fused_expand_plain(nodes, packed, qb, qn, bd, bs, be, ef, expand,
                                                 stop))
    sms = time_ms(split)
    live = int((nodes >= 0).sum())
    row_len = packed.shape[1]
    n_bytes = (live * row_len * 2 + nodes.numel() * 4 + qb.numel() * 2 + qn.numel() * 4
               + q_n * ef * 12 * 2 + q_n * bk.MISC_ROWS * 4)
    n_cmp = q_n * merge_compares(ef, expand * w)
    report["fused_expand"] = dict(
        err=0.0, ms=ms, plain_ms=pms, library_ms=None,
        bound=bound(n_bytes, 2 * d * live * w, PEAK_BF16, n_cmp / PEAK_FP32 * 1e3))
    print(f"K5 fused expand Q={q_n} ef={ef} E={expand} W={w} d={d} stop={stop} ({live} nodes "
          f"expanded, rows of {row_len * 2} bytes), a seeded search's iteration 3: equal to "
          f"plain and to the split pair; kernel {ms:.3f} ms, split pair (packed scoring + K4) "
          f"{sms:.3f} ms, plain {pms:.3f} ms; bound {report['fused_expand']['bound'][0]:.4f} ms "
          f"({report['fused_expand']['bound'][1]}; {n_bytes / 1e6:.1f} MB) {tag}")

    a = cap_score.args
    if a[3] is not None:
        raise AssertionError("the packed search scored a blocked table")
    hold_scoring(a, "packed table, a seeded search's iteration 3")
    # the same nodes in fused mode: the search's allowed mask, a threshold
    # at the median finite distance
    nd = bk._gather_score_plain(*a)[0]
    fa = a[:6] + (float(nd[torch.isfinite(nd)].median()), True)
    n_adm = hold_scoring(fa, "packed table, fused mode on a seeded search's iteration 3")
    ms = time_ms(lambda: bk._gather_score_cuda(*a))
    pms = time_ms(lambda: bk._gather_score_plain(*a))
    qb, qn, packed, nodes = a[0], a[1], a[2], a[4]
    live = int((nodes >= 0).sum())
    n_bytes = (live * packed.shape[1] * 2 + nodes.numel() * 4 + qb.numel() * 2 + qn.numel() * 4
               + nodes.numel() * w * 8)
    report["gather_score_packed"] = dict(err=0.0, ms=ms, plain_ms=pms, library_ms=None,
                                         bound=bound(n_bytes, 2 * d * live * w, PEAK_BF16))
    # an unaligned shape: W = 4, d = 16 rows of 152 bytes
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(4096, 16)).astype(np.float32)).to(dev)
    adj = torch.from_numpy(rng.integers(-1, 4096, size=(4096, 4)).astype(np.int32)).to(dev)
    small = bk.build_packed_table(adj, x, (x * x).sum(dim=1))
    qs = torch.from_numpy(rng.normal(size=(512, 16)).astype(np.float32)).to(dev)
    ua = (qs.to(torch.bfloat16), (qs * qs).sum(dim=1), small, None,
          torch.from_numpy(rng.integers(-1, 4096, size=(512, 8)).astype(np.int32)).to(dev),
          None, float("inf"), False)
    hold_scoring(ua, "packed table of 152-byte rows")
    print(f"packed scoring Q={nodes.shape[0]} E={nodes.shape[1]} W={w} ({live} nodes expanded), "
          f"iteration 3 of a seeded search: nd, ns and adm equal to plain (fused mode: {n_adm} "
          f"admitted), and on 152-byte rows (W=4, d=16, {small.shape[0]} rows); kernel "
          f"{ms:.3f} ms, plain {pms:.3f} ms; bound "
          f"{report['gather_score_packed']['bound'][0]:.4f} ms "
          f"({report['gather_score_packed']['bound'][1]}) {tag}")


def table_equals_fresh_build(index, dev):
    """The device adjacency against the host graph, and the resident routing
    table, updated in place, against a fresh build of its layout. Returns
    the layout's name."""
    from comet_tpu_torch.ops import beam_kernel as bk

    vecs, sqn, _ = index._store.device_state()
    adj = torch.from_numpy(index._adj0).to(dev)
    if not torch.equal(index._dev_adj, adj):
        raise AssertionError("the device adjacency differs from the host graph")
    packed, (tab, aux) = index._table
    if packed:
        same = aux is None and torch.equal(tab, bk.build_packed_table(adj, vecs, sqn))
    else:
        fresh = bk.build_blocked_tables(adj, vecs, sqn)
        same = torch.equal(tab, fresh[0]) and torch.equal(aux, fresh[1])
        del fresh
    del adj, tab, aux
    torch.cuda.empty_cache()
    name = "packed" if packed else "blocked"
    if not same:
        raise AssertionError(f"the {name} table updated in place differs from a fresh build")
    return name


def insertion_phase(index, queries, extra, dev, tag, time_ms, profile):
    """Part of section 7 of the module docstring: `extra` held-out rows
    added to the 1M graph in BUILD_SUB_BATCH rounds, the first half over the
    blocked table and the second over the packed one (COMET_HNSW_PACKED=1;
    the index holds one table), each table after its half against a fresh
    build; fused / seeded / classic searches on the grown index against the
    plain beam with recall@K against its exact ids, and one `add`."""
    from comet_tpu_torch import VectorNode
    from comet_tpu_torch.indexes import hnsw as hnsw_mod
    from comet_tpu_torch.ops import beam_kernel as bk
    from comet_tpu_torch.ops import fused_scan

    n0, cap0 = index._store.n, index._store.capacity
    sub = hnsw_mod.BUILD_SUB_BATCH
    half = len(extra) // 2
    times = {"blocked": [], "packed": []}
    for lo in range(0, len(extra), sub):
        layout = "packed" if lo >= half else "blocked"
        with env_set(COMET_HNSW_PACKED="1" if layout == "packed" else None):
            if lo == half:
                checked = table_equals_fresh_build(index, dev)
                t0 = time.perf_counter()
                index._routing_tables()        # the switch replaces the blocked table
                torch.cuda.synchronize()
                t_switch = time.perf_counter() - t0
            rows = extra[lo: lo + sub]
            row_ids = np.arange(n0 + 1 + lo, n0 + 1 + lo + len(rows))
            t0 = time.perf_counter()
            if profile and lo == sub:      # the second round: in place
                profile_window(lambda: index.add_batch(rows, ids=row_ids))
            else:
                index.add_batch(rows, ids=row_ids)
            torch.cuda.synchronize()
            times[layout].append(time.perf_counter() - t0)
            if index._table is None or ("packed" if index._table[0] else "blocked") != layout:
                raise AssertionError(f"the {layout} table is not the one resident")
    with env_set(COMET_HNSW_PACKED="1"):
        checked = [checked, table_equals_fresh_build(index, dev)]
    cap = index._store.capacity
    first = times["blocked"][0]
    blocked, packed = times["blocked"][1:], times["packed"]
    total = first + sum(blocked) + sum(packed)
    print(f"HNSW insertion of {len(extra)} held-out rows into the {n0}-row graph (efC "
          f"{index.config.ef_construction}, {len(extra) // sub} rounds of {sub}, one routing "
          f"table resident): {len(extra) / total:.1f} vectors/s over all rounds; the first round "
          f"{first:.3f} s (capacity {cap0} -> {cap}, device mirror and the blocked table rebuilt "
          f"at ndig {bk._aux_digits(cap)}); blocked rounds 2-{len(blocked) + 1} "
          f"{len(blocked) * sub / sum(blocked):.1f} vectors/s in place (median round "
          f"{statistics.median(blocked):.3f} s); the packed table built in {t_switch:.3f} s; "
          f"packed rounds {len(blocked) + 2}-{len(extra) // sub} "
          f"{len(packed) * sub / sum(packed):.1f} vectors/s in place (median round "
          f"{statistics.median(packed):.3f} s) {tag}")
    print(f"the {' and '.join(checked)} tables updated in place equal fresh builds on the "
          f"adjacency after their rounds ({index._store.n} rows, capacity {cap})")
    vecs, sqn, valid = index._store.device_state()
    q = torch.from_numpy(queries).to(dev)
    mask = torch.where(valid, sqn, torch.full_like(sqn, float("inf")))
    with uncounted():              # the exact ids are a check, not the main path
        true_ids = fused_scan.flat_topk_pipeline(q, vecs, mask, float("inf"), K)[1]
        true_ids = true_ids.cpu().numpy() + 1
    del q, mask
    torch.cuda.empty_cache()
    new_hits = int((true_ids > n0).sum())
    # fused first, on the packed table the last rounds kept; then the
    # blocked table is rebuilt (in the seeded search's first batch)
    for name, envs in (("fused", {"COMET_HNSW_FUSE": "1"}), ("seeded", {}),
                       ("classic", {"COMET_HNSW_SEED": "0"})):
        with env_set(**envs):
            ids_, _, first, qps = hnsw_search_checked(index, f"grown {name}", queries,
                                                      rounds=ROUNDS)
        rec = recall_at_k(ids_, true_ids)
        print(f"HNSW grown index {name}: equal to the plain beam; recall@{K} {rec:.4f} against "
              f"the exact ids of the {index._store.n}-row corpus ({new_hits} of its top-{K} "
              f"entries are inserted rows, {int((ids_ > n0).sum())} returned); {qps:.1f} "
              f"queries/s steady, first batch {first:.3f} s {tag}")
        if rec < 0.80:
            raise AssertionError(f"grown-index recall@{K} {rec:.4f} < 0.80")
    v = extra[0] + 1.0
    t0 = time.perf_counter()
    index.add(VectorNode(n0 + len(extra) + 1, v))
    torch.cuda.synchronize()
    t_one = time.perf_counter() - t0
    got = index.search_batch(v[None, :], k=1)
    if got[0][0, 0] != n0 + len(extra) + 1:
        raise AssertionError("the node added by add() is not its own nearest neighbour")
    print(f"HNSW add() of one node: {t_one * 1e3:.1f} ms (one insertion round, in place); the "
          f"node is its own nearest neighbour {tag}")


def hnsw_phase(corpus, queries, extra, c_corpus, c_queries, flat_ids, dev, tag, time_ms,
               profile):
    """Sections 6 and 7 of the module docstring. Returns {"report": per-kernel
    numbers of K3's bf16 mode, K4, the scoring kernel (both layouts) and
    K5, "launches": the HNSW path's counts}."""
    from comet_tpu_torch import Bitset, DistanceKind, HNSWIndex
    from comet_tpu_torch.ops import beam_kernel as bk
    from comet_tpu_torch.ops import ivf_sparse as sp
    from comet_tpu_torch.ops.distance import bf16_dot

    n = HNSW_N
    ids = np.arange(1, n + 1, dtype=np.uint32)
    report = {}
    envs = env_set(COMET_HNSW_SEED=None, COMET_HNSW_PACKED=None, COMET_HNSW_FUSE=None)
    envs.__enter__()

    # -- the main path, every launch counted -------------------------------
    reset_launches()
    t0 = time.perf_counter()
    index = HNSWIndex(DIM, DistanceKind.L2, device="cuda")
    index.add_batch(corpus[:n], ids=ids)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    build_launches = read_launches()
    print(f"HNSW bulk build {n} x {DIM}, M=16: {t_build:.3f} s, {n / t_build:.1f} vectors/s, "
          f"top level {index._max_level}; K2 launches {build_launches['fused_dist_select']}, "
          f"K1 {build_launches['topk_cl']} {tag}")
    with capture(bk, "beam_merge_step", 2) as cap_merge, \
            capture(bk, "gather_score", 2) as cap_score, \
            capture(sp, "ivf_sparse_pipeline", 0) as cap_seed:
        s_ids, s_scores, s_first, s_qps = hnsw_search_checked(index, "seeded", queries,
                                                              rounds=ROUNDS)
    ov, starved = index.first_seed_health
    s_recall = recall_at_k(s_ids, flat_ids) if n == N else None
    print(f"HNSW seeded k={K} ef={EF_SEARCH}: ids and scores equal to the plain beam; recall@{K} "
          f"{s_recall if s_recall is None else f'{s_recall:.4f}'}; {s_qps:.1f} queries/s steady, "
          f"first batch {s_first:.3f} s (seed tables included); the first batch's seed scan "
          f"dropped {ov} chunks and left {starved} of {BATCH} queries probe-starved {tag}")
    with env_set(COMET_HNSW_SEED="0"):
        c_ids, c_scores, c_first, c_qps = hnsw_search_checked(index, "classic", queries,
                                                              rounds=ROUNDS)
    c_recall = recall_at_k(c_ids, flat_ids) if n == N else None
    print(f"HNSW classic (COMET_HNSW_SEED=0) k={K} ef={EF_SEARCH}: equal to the plain beam; "
          f"recall@{K} {c_recall if c_recall is None else f'{c_recall:.4f}'}; {c_qps:.1f} "
          f"queries/s steady, first batch {c_first:.3f} s {tag}")
    if c_recall is not None and c_recall < 0.80:
        raise AssertionError(f"classic HNSW recall@{K} {c_recall:.4f} < 0.80")

    # -- the packed table and K5 -------------------------------------------------
    packed_fused_phase(index, queries, {"seeded": (s_ids, s_scores), "classic": (c_ids, c_scores)},
                       report, dev, tag, time_ms)

    allowed = (ids % 3) != 0
    thr = float(np.median(s_scores[:, 9]))
    with capture(bk, "beam_merge_step", 2) as cap_fused, \
            capture(bk, "gather_score", 2) as cap_fscore:
        f_ids, _, _, _ = hnsw_search_checked(index, "filtered + threshold", queries,
                                             threshold=thr,
                                             document_ids=Bitset.from_array(ids[allowed]))
    hits = f_ids[f_ids != 0xFFFFFFFF]
    if not 0 < len(hits) < f_ids.size or (hits % 3 == 0).any():
        raise AssertionError("the HNSW filter or threshold had no effect")
    print(f"HNSW with doc-ID filter and threshold {thr:.3f}: {len(hits)} hits, equal to the "
          f"plain beam")
    with uncounted():
        check_k4_scoring_k3(cap_merge, cap_fused, cap_score, cap_fscore, cap_seed, report, tag,
                            time_ms)
    del cap_merge, cap_fused, cap_score, cap_fscore, cap_seed
    torch.cuda.empty_cache()

    # -- incremental insertion ---------------------------------------------------------
    insertion_phase(index, queries, extra, dev, tag, time_ms, profile)

    removed = ids[::100]
    for i in removed.tolist():
        index.remove(i)
    r_ids, _, r_first, _ = hnsw_search_checked(index, "after remove", queries)
    if np.isin(r_ids, removed).any():
        raise AssertionError("a removed id came back")
    print(f"HNSW after removing {len(removed)} ids of the grown index: equal to the plain beam, "
          f"no removed id returned; first batch {r_first:.3f} s (seed mask refresh included)")
    if profile:
        profile_window(lambda: [index.search_batch(queries, k=K, ef_search=EF_SEARCH)
                                for _ in range(2)], "HNSW seeded")
        with env_set(COMET_HNSW_SEED="0"):
            profile_window(lambda: [index.search_batch(queries, k=K, ef_search=EF_SEARCH)
                                    for _ in range(2)], "HNSW classic")
    time_gather(index, n, dev, tag, time_ms)
    del index
    torch.cuda.empty_cache()
    c_index = HNSWIndex(DIM, DistanceKind.COSINE, device="cuda")
    c_index.add_batch(c_corpus[:HNSW_COSINE_N], ids=ids[:HNSW_COSINE_N])
    cos_ids, _, _, _ = hnsw_search_checked(c_index, "cosine", c_queries)
    if (cos_ids == 0xFFFFFFFF).any():
        raise AssertionError("the cosine HNSW search left results empty")
    print(f"HNSW cosine {HNSW_COSINE_N} x {DIM}: equal to the plain beam")
    launches = read_launches()
    print(f"kernel launches of the HNSW path (2 bulk builds, the insertion rounds and one add, "
          f"every search_batch call above{', profile included' if profile else ''}): {launches}")
    for key in ("topk_cl", "fused_dist_select", "sparse_scan_bf16", "beam_merge",
                "beam_merge_fused", "gather_score", "gather_score_packed", "fused_expand"):
        if launches[key] <= 0:
            raise AssertionError(f"a kernel of the HNSW path never launched: {launches}")
    del c_index
    torch.cuda.empty_cache()

    # -- seed and in-loop distances on Gaussian data ----------------------------------
    g_rng = np.random.default_rng(7)
    gx = g_rng.normal(size=(8192, DIM)).astype(np.float32)
    gq = torch.from_numpy(g_rng.normal(size=(BATCH // 8, DIM)).astype(np.float32)).to(dev)
    g_index = HNSWIndex(DIM, DistanceKind.L2, device="cuda")
    g_index.add_batch(gx, ids=np.arange(1, len(gx) + 1))
    gqn = bk.row_sqnorms(gq)
    sd, ss = g_index._seed_scan(gq, gqn, 128)
    nbr_vecs, aux = g_index._routing_tables()
    adj = g_index._adj0[: len(gx)]
    w = adj.shape[1]
    flat = adj.ravel()
    valid_pos = np.flatnonzero(flat >= 0)
    where = np.full(len(gx), -1, np.int64)               # one (node, column) per slot
    where[flat[valid_pos]] = valid_pos
    seeds = ss[:, :8].cpu().numpy()
    pos = where[np.where(seeds >= 0, np.minimum(seeds, len(gx) - 1), 0)]
    ok = (seeds != 2**31 - 1) & (pos >= 0)
    nodes = torch.from_numpy(np.where(ok, pos // w, -1).astype(np.int32)).to(dev)
    cols = np.where(ok, pos % w, 0)
    nd, ns, _ = bk.gather_score(gq.to(torch.bfloat16), gqn, nbr_vecs, aux, nodes,
                                torch.ones(len(gx), dtype=torch.bool, device=dev),
                                float("inf"), False)
    e_idx = torch.from_numpy(np.arange(8)[None, :] * w + cols).to(dev)
    loop_d = nd.gather(1, e_idx)
    loop_s = ns.gather(1, e_idx)
    okt = torch.from_numpy(ok).to(dev)
    vecs, sqnorms, _ = g_index._store.device_state()
    s_long = torch.where(okt, ss[:, :8], torch.zeros_like(ss[:, :8])).long()
    e_d = torch.clamp_min((gqn[:, None] + sqnorms[s_long].to(torch.bfloat16).float())
                          - 2.0 * bf16_dot(gq.to(torch.bfloat16)[:, None, :],
                                           vecs[s_long].to(torch.bfloat16)), 0.0)
    torch.cuda.synchronize()
    n_pairs = int(okt.sum())
    if not (n_pairs > 0 and torch.equal(loop_s[okt], ss[:, :8][okt])
            and torch.equal(loop_d[okt], sd[:, :8][okt]) and torch.equal(e_d[okt], sd[:, :8][okt])):
        raise AssertionError("seed and in-loop distances differ on Gaussian data")
    print(f"Gaussian 8192 x {DIM}: {n_pairs} (query, slot) pairs, seed distances (K3 bf16) "
          f"bit-equal to in-loop distances (scoring kernel) and to the entry-start bf16 dot")
    del g_index, nbr_vecs, aux
    torch.cuda.empty_cache()
    envs.__exit__()
    return {"report": report, "launches": launches}


BM25_N = N         # documents of the BM25 and hybrid phases, one a corpus row
BM25_WORDS = 60    # words a document (bench.py:419-462)
BM25_VOCAB = 50_000
BM25_TERMS = (1, 2, 10)
BM25_KS = (10, 100)
BM25_CHUNK = 256   # queries a scorer chunk holds at 2^20 documents
HYBRID_K = 10


def bm25_corpus(seed):
    """bench.py:419-452's text corpus at BM25_N documents: BM25_WORDS words
    a document, drawn Zipf(1.3) over a BM25_VOCAB-word letter-only
    vocabulary, and the query terms, the vocabulary's ranks 100-5000."""
    rng = np.random.default_rng((seed, 25))
    vocab = ["".join(chr(97 + (i // 26 ** j) % 26) for j in range(4)) + "x"
             for i in range(BM25_VOCAB)]
    texts = [" ".join([vocab[t] for t in row])
             for row in (rng.zipf(1.3, size=(BM25_N, BM25_WORDS)) % BM25_VOCAB).tolist()]
    return texts, [vocab[100 + (i * 37) % 4900] for i in range(4000)]


def bm25_queries(qterms, n_terms, count=None):
    """`count` (BATCH) queries of `n_terms` terms each (bench.py:453-460)."""
    return [" ".join(qterms[(i * n_terms + j) % len(qterms)] for j in range(n_terms))
            for i in range(count or BATCH)]


def bm25_oracle(index, host, query, k):
    """Float64 BM25 on the host over the index's postings (the formula of
    bm25_index_search.go:299-327 in double): the ids of the k best by
    (score desc, id asc) and every slot's score (slot s holds id s + 1
    here)."""
    import math

    from comet_tpu_torch.ops.bm25 import B, K1

    slot_docs, ps, pt, dl, df, start = host
    n = float(index._num_docs)
    avgdl = index._total_tokens / n
    s = np.zeros(len(slot_docs))
    for t in index._tokenize(query):
        tid = index._vocab.get(t)
        if tid is None or df[tid] == 0:
            continue
        run = slice(start[tid], start[tid] + df[tid])
        sl, tf = ps[run], pt[run].astype(np.float64)
        idf = math.log((n - df[tid] + 0.5) / (df[tid] + 0.5) + 1.0)
        s[sl] += idf * (tf * (K1 + 1.0)) / (tf + K1 * (1.0 - B + B * (dl[sl] / avgdl)))
    hit = np.flatnonzero(s > 0)
    return slot_docs[hit[np.lexsort((hit, -s[hit]))][:k]], s


def bm25_chunk_inputs(index, queries, dev):
    """The scorer's arguments for `queries` (one chunk), as `search_batch`
    builds them, every document allowed."""
    slot_docs, post_slot, post_tf, doc_len, df, term_start = index._postings()
    t_start, t_len, t_idf, q_off = index._query_terms(queries, df, term_start)
    return dict(post_slot=post_slot, post_tf=post_tf,
                t_start=torch.from_numpy(t_start).to(dev), t_len=torch.from_numpy(t_len).to(dev),
                t_idf=torch.from_numpy(t_idf).to(dev), q_off=q_off, doc_len=doc_len,
                allowed=torch.ones(len(slot_docs), dtype=torch.bool, device=dev),
                avgdl=float(np.float32(index._total_tokens / index._num_docs)))


def bm25_design_bytes(a, rows, n):
    """The bytes the scorer's design (csrc/bm25_score.cu) moves for `rows`
    queries over n documents with the inputs `a` (`bm25_chunk_inputs`):
    the rows written once; a block's tile of lengths and allowed bytes (5
    bytes a document), its queries' bounds (8 bytes a query) and term
    entries (start, length, idf: 16 bytes); each group's distinct
    (position, term) sub-runs once (8 bytes a posting); 4 bytes a probe of
    the two searches a distinct entry and tile, at most floor(log2(w)) + 1
    for a search window of w postings ([x - (n - len), x] for slot x).
    Returns (bytes, tile, group)."""
    from comet_tpu_torch.ops import bm25

    tile, group = bm25.tile_shape(rows, n, torch.cuda.get_device_properties(0)
                                  .multi_processor_count)
    tiles, groups = -(-n // tile), -(-rows // group)
    q_off = np.asarray(a["q_off"], np.int64)
    t_start, t_len = a["t_start"].cpu().numpy(), a["t_len"].cpu().numpy().astype(np.int64)
    t_idf = a["t_idf"].cpu().numpy().view(np.uint32)
    lens = []
    for g in range(groups):
        bounds = q_off[g * group:min(rows, (g + 1) * group) + 1]
        first, cnt = bounds[:-1], np.diff(bounds)
        for j in range(int(cnt.max(initial=0))):
            keys = {(t_start[t], t_len[t], t_idf[t]) for t in (first[cnt > j] + j).tolist()
                    if t_len[t] > 0}
            lens.extend(key[1] for key in keys)
    length = np.asarray(lens, np.int64)[:, None]
    edges = np.minimum(np.arange(tiles + 1, dtype=np.int64) * tile, n)
    probes = 0
    for x in (edges[:-1][None, :], edges[1:][None, :]):
        top = np.minimum(length, x)
        w = top - np.minimum(top, np.maximum(0, x - (n - length)))
        probes += int(np.where(w > 0, np.floor(np.log2(np.maximum(w, 1))) + 1, 0).sum())
    entries = int(q_off[rows] - q_off[0])
    total = (4 * rows * n + 5 * n * groups + (16 * entries + 8 * rows) * tiles
             + 8 * int(length.sum()) + 4 * probes)
    return total, tile, group


def bm25_library(a, n_rows, dev):
    """The one PyTorch call that makes the scorer's sums of the chunk `a`
    (`bm25_chunk_inputs`, n_rows queries), in another order:
    `index_put_(accumulate=True)` of every contribution into zero rows.
    Returns the call; its rows are the scores, where the scorer's are
    their negation."""
    from comet_tpu_torch.ops import bm25

    n = a["doc_len"].shape[0]
    lens = a["t_len"].long()
    postings = int(lens.sum())
    counts = torch.from_numpy(np.diff(a["q_off"])).to(dev)
    rows = torch.repeat_interleave(torch.repeat_interleave(
        torch.arange(n_rows, device=dev), counts), lens)
    first = torch.repeat_interleave(torch.cumsum(lens, 0) - lens, lens)
    pidx = (torch.repeat_interleave(a["t_start"], lens)
            + torch.arange(postings, device=dev) - first)
    slots = a["post_slot"][pidx].long()
    c = bm25.contribution(a["post_tf"][pidx], a["doc_len"][slots],
                          torch.repeat_interleave(a["t_idf"], lens),
                          torch.tensor(a["avgdl"], dtype=torch.float32, device=dev))

    def lib():
        return torch.zeros((n_rows, n), device=dev).index_put_((rows, slots), c,
                                                                  accumulate=True)
    return lib


def bm25_section(index, queries, n_terms, dev, tag, time_ms, library=False):
    """The scorer on one 256-query chunk of `queries`: its dense rows held
    bit-equal to the plain rows and timed beside them (and, with
    `library`, beside the one PyTorch call that makes the same sums in
    another order: `index_put_(accumulate=True)` of every contribution);
    then K1 on those rows at k = 10 and 100. Returns the report entries."""
    from comet_tpu_torch.ops import bm25, sortnet

    a = bm25_chunk_inputs(index, queries[:BM25_CHUNK], dev)
    q_off = a["q_off"]
    q_off_dev = torch.from_numpy(q_off.astype(np.int32)).to(dev)
    args = {key: v for key, v in a.items() if key != "q_off"}
    dense = bm25._bm25_dense_cuda(**args, q_off_dev=q_off_dev)
    plain = bm25._bm25_dense_plain(**args, q_off=q_off)
    torch.cuda.synchronize()
    if not torch.equal(dense.view(torch.int32), plain.view(torch.int32)):
        raise AssertionError(f"the BM25 scorer differs from its plain version ({n_terms}-term)")
    del plain
    ms = time_ms(lambda: bm25._bm25_dense_cuda(**args, q_off_dev=q_off_dev))
    pms = time_ms(lambda: bm25._bm25_dense_plain(**args, q_off=q_off), reps=1)
    n = a["doc_len"].shape[0]
    lens = a["t_len"].long()
    postings = int(lens.sum())
    # the least traffic: each input once (the distinct terms' postings, the
    # lengths and the mask), each output once (the rows); its arithmetic,
    # 9 float32 operations a posting
    runs = {(int(s), int(c)) for s, c in zip(a["t_start"].tolist(), a["t_len"].tolist())}
    distinct = sum(c for _, c in runs)
    b = bound(8 * distinct + 5 * n + 4 * BM25_CHUNK * n, 9 * postings)
    design, tile, group = bm25_design_bytes(a, BM25_CHUNK, n)
    lms, lib_err = None, None
    if library:
        lib = bm25_library(a, BM25_CHUNK, dev)
        lib_err = float((torch.where(a["allowed"], -lib(), 0.0) - dense).abs().max())
        lms = time_ms(lib)
        del lib
    print(f"BM25 scorer, 256 {n_terms}-term queries over {n} documents ({postings} postings): "
          f"dense rows bit-equal to the plain version; kernel {ms:.3f} ms, plain {pms:.3f} ms"
          + (f", index_put_(accumulate=True) {lms:.3f} ms (max abs difference {lib_err:.3g}, "
             f"its sums in another order)" if library else "")
          + f"; bound {b[0]:.4f} ms ({b[1]}), this design's traffic (tiles of {tile} "
          f"documents, {group} queries a block) {design / 1e9:.3f} GB = "
          f"{design / PEAK_BYTES * 1e3:.3f} ms {tag}")
    out = {"bm25_score": dict(err=0.0, ms=ms, plain_ms=pms, library_ms=lms, bound=b)}
    for k in BM25_KS:
        gv, gi = sortnet.topk_rows(dense, None, k)
        pv, pi = sortnet._topk_rows_plain(dense, None, k)
        torch.cuda.synchronize()
        if not (torch.equal(gi, pi) and torch.equal(gv, pv)):
            raise AssertionError(f"K1 differs from its plain version on the BM25 rows (k={k})")
        k1 = time_ms(lambda: sortnet.topk_rows(dense, None, k))
        pk1 = time_ms(lambda: sortnet._topk_rows_plain(dense, None, k), reps=1)
        lk1 = time_ms(lambda: torch.topk(dense, k, dim=1, largest=False))
        kb = bound(4 * BM25_CHUNK * n + 8 * BM25_CHUNK * sortnet.k_pow2(k), 0)
        us = calls_device_us([lambda: sortnet.topk_rows(dense, None, k)], [K1_SPLIT_NAMES])[0]
        print(f"K1 topk_rows on those rows {[BM25_CHUNK, n]} k={k}, idx=None (split route): "
              f"equal to plain; kernel {k1:.4f} ms (device "
              f"{'not measured' if us is None else f'{us:.1f} us'}), plain {pk1:.3f} ms, "
              f"torch.topk(dim=1, largest=False) {lk1:.4f} ms; bound {kb[0]:.4f} ms ({kb[1]}) "
              f"{tag}")
        out[f"topk_bm25_k{k}"] = dict(err=0.0, ms=k1, plain_ms=pk1, library_ms=lk1, bound=kb)
    del dense
    torch.cuda.empty_cache()
    return out


def bm25_phase(seed, dev, tag, time_ms, profile):
    """Section 10 of the module docstring. Returns {"report": the scorer's
    numbers, "launches": the BM25 path's counts, "index", "texts",
    "qterms"}."""
    from comet_tpu_torch import BM25SearchIndex
    from comet_tpu_torch.ops import bm25

    t0 = time.perf_counter()
    texts, qterms = bm25_corpus(seed)
    print(f"BM25 corpus: {BM25_N} documents x {BM25_WORDS} words, Zipf(1.3) over "
          f"{BM25_VOCAB} words ({time.perf_counter() - t0:.1f} s on the host)")
    index = BM25SearchIndex(device="cuda")
    t0 = time.perf_counter()
    index.add_batch(range(1, BM25_N + 1), texts)
    t_ingest = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = index._postings()
    torch.cuda.synchronize()
    t_post = time.perf_counter() - t0
    n_post = host[1].shape[0]
    print(f"BM25 ingest (default segmentation, every segment a term): {t_ingest:.1f} s = "
          f"{BM25_N / t_ingest:.1f} docs/s on the host; {n_post} postings of "
          f"{int(np.count_nonzero(host[4]))} terms built on the card in {t_post:.3f} s {tag}")
    report = {}
    for n_terms in BM25_TERMS:   # the kernels line takes the 2-term chunk, the hybrid shape
        sec = bm25_section(index, bm25_queries(qterms, n_terms), n_terms, dev, tag, time_ms,
                           library=n_terms == 2)
        if n_terms == 2:
            report = sec

    reset_launches()
    results = {}
    for n_terms in BM25_TERMS:
        queries = bm25_queries(qterms, n_terms)
        for k in BM25_KS:
            t0 = time.perf_counter()
            got = index.search_batch(queries, k=k)
            first = time.perf_counter() - t0
            t0 = time.perf_counter()
            again = index.search_batch(queries, k=k)
            qps = BATCH / (time.perf_counter() - t0)
            if not (np.array_equal(again[0], got[0]) and np.array_equal(again[1], got[1])):
                raise AssertionError(f"repeated BM25 searches differ ({n_terms}-term, k={k})")
            results[n_terms, k] = got
            report[f"qps_{n_terms}term_k{k}"] = qps
            print(f"BM25 search_batch {BATCH} {n_terms}-term queries k={k}: {qps:.1f} "
                  f"queries/s steady, first batch {first:.3f} s {tag}")
    launches = read_launches()
    print(f"kernel launches of the {2 * len(BM25_TERMS) * len(BM25_KS)} BM25 search_batch "
          f"calls: {launches}")
    if min(launches["bm25_score"], launches["topk_cl"]) <= 0:
        raise AssertionError(f"a kernel of the BM25 path never launched: {launches}")
    if profile:
        q2 = bm25_queries(qterms, 2)
        profile_window(lambda: [index.search_batch(q2, k=10) for _ in range(2)],
                       "BM25 2-term, k = 10")

    t0 = time.perf_counter()
    h = (host[0], host[1].cpu().numpy(), host[2].cpu().numpy(), host[3].cpu().numpy().astype(
        np.float64), host[4], host[5])
    n_ties = 0
    for (n_terms, k), (ids, scores) in results.items():
        queries = bm25_queries(qterms, n_terms)
        with uncounted(), plain_versions():
            p_ids, p_scores = index.search_batch(queries[:BM25_CHUNK], k=k)
        if not (np.array_equal(p_ids, ids[:BM25_CHUNK])
                and np.array_equal(p_scores, scores[:BM25_CHUNK])):
            raise AssertionError(f"BM25 {n_terms}-term k={k} differs from the plain scorer")
        for qi in range(0, BATCH, BATCH // 8):
            want, s = bm25_oracle(index, h, queries[qi], k)
            got = ids[qi][ids[qi] != 0xFFFFFFFF].astype(np.int64)
            if len(got) != len(want):
                raise AssertionError(f"BM25 {n_terms}-term query {qi}: {len(got)} hits, "
                                     f"the oracle {len(want)}")
            np.testing.assert_allclose(scores[qi][:len(got)], s[got - 1], rtol=1e-5)
            diff = got != want
            if (np.abs(s[got[diff] - 1] - s[want[diff] - 1])
                    > 1e-6 * np.abs(s[want[diff] - 1])).any():
                raise AssertionError(f"BM25 {n_terms}-term query {qi}: ids differ from the "
                                     f"float64 oracle beyond ties")
            n_ties += int(diff.sum())
    print(f"BM25 results: ids and scores array-equal to the plain scorer on the card "
          f"({BM25_CHUNK} queries of each batch), ids equal to a float64 host oracle on 8 "
          f"queries of each ({n_ties} positions at ties within 1e-6 differ), scores "
          f"allclose(1e-5) ({time.perf_counter() - t0:.1f} s) {tag}")
    del h
    return {"report": report, "launches": launches, "index": index, "texts": texts,
            "qterms": qterms}


def hybrid_phase(corpus, queries, text_index, qterms, dev, tag, time_ms, profile):
    """Section 11 of the module docstring. Returns {"launches": the hybrid
    path's counts}."""
    from comet_tpu_torch import (DistanceKind, FlatIndex, FusionKind, RoaringMetadataIndex,
                                 eq, fuse_batch_rows, new_fusion, new_hybrid_search_index)

    ids = np.arange(1, N + 1, dtype=np.uint32)
    flat = FlatIndex(DIM, DistanceKind.L2, device="cuda")
    flat.add_batch(corpus, ids=ids)
    meta = RoaringMetadataIndex()
    t0 = time.perf_counter()
    meta.add_columns(ids, {"cat": np.array(list("abcd"))[np.arange(N) % 4],
                           "num": np.arange(N) % 1000})
    print(f"metadata add_columns {N} docs (cat in a-d, num = i mod 1000): "
          f"{time.perf_counter() - t0:.3f} s on the host")
    hybrid = new_hybrid_search_index(flat, text_index, meta)
    texts = bm25_queries(qterms, 2)
    filt = [eq("cat", "a")]
    kinds = (FusionKind.RECIPROCAL_RANK, FusionKind.WEIGHTED_SUM)
    reset_launches()
    batches = {}
    for kind in kinds:
        t0 = time.perf_counter()
        batches[kind] = hybrid.search_batch(queries, texts, k=HYBRID_K, metadata_filters=filt,
                                            fusion_kind=kind)
        first = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(ROUNDS):
            again = hybrid.search_batch(queries, texts, k=HYBRID_K, metadata_filters=filt,
                                        fusion_kind=kind)
        qps = ROUNDS * BATCH / (time.perf_counter() - t0)
        if again != batches[kind]:
            raise AssertionError(f"repeated hybrid searches differ ({kind.value})")
        print(f"hybrid search_batch {BATCH} queries (vector + 2-term text), filter cat = a, "
              f"{kind.value}, k={HYBRID_K}: {qps:.1f} queries/s steady, first batch "
              f"{first:.3f} s {tag}")
    launches = read_launches()
    print(f"kernel launches of the {2 * (1 + ROUNDS)} hybrid search_batch calls: {launches}")
    if min(launches["bm25_score"], launches["topk_cl"], launches["fused_dist_select"]) <= 0:
        raise AssertionError(f"a kernel of the hybrid path never launched: {launches}")

    with uncounted():
        # the four steps of search_batch, called one by one in its order
        rrf = new_fusion(FusionKind.RECIPROCAL_RANK)
        steps = []
        for _ in range(3):
            t = [time.perf_counter()]
            cand = meta.filter_bitset(filt)
            t.append(time.perf_counter())
            handle = flat._search_launch(queries, flat._make_batch_builder(
                HYBRID_K, 0.0, cand, None, None, None, -1, 1, True))
            t.append(time.perf_counter())
            t_ids, t_sc = text_index.search_batch(texts, k=HYBRID_K, document_ids=cand)
            t.append(time.perf_counter())
            v_ids, v_sc = flat._search_collect(handle)
            v_ids, v_sc = v_ids[:, :HYBRID_K], v_sc[:, :HYBRID_K]
            fused = fuse_batch_rows(v_ids, v_sc, t_ids, t_sc, cand, rrf, BATCH, HYBRID_K)
            t.append(time.perf_counter())
            steps.append(np.diff(t) * 1e3)
        if fused != batches[FusionKind.RECIPROCAL_RANK]:
            raise AssertionError("the hybrid steps called one by one differ from search_batch")
        m = np.median(steps, axis=0)
        print(f"hybrid steps, host ms (median of 3, reciprocal rank): metadata filter "
              f"{m[0]:.3f}, vector launch {m[1]:.3f}, BM25 on the card {m[2]:.3f} (it waits "
              f"for the vector leg queued before it on the stream), collect and fusion "
              f"{m[3]:.3f} {tag}")

        t0 = time.perf_counter()
        for kind, count in zip(kinds, (64, 16)):
            for qi in range(count):
                one = (hybrid.new_search().with_vector(queries[qi]).with_text(texts[qi])
                       .with_metadata(*filt).with_fusion_kind(kind).with_k(HYBRID_K).execute())
                if [(r.id, r.score) for r in one] != [(r.id, r.score)
                                                      for r in batches[kind][qi]]:
                    raise AssertionError(f"hybrid query {qi} ({kind.value}): execute() "
                                         f"differs from search_batch")
        allowed = torch.from_numpy(np.arange(N) % 4 == 0).to(dev)
        x_dev = torch.from_numpy(corpus).to(dev)
        ps, pi = plain_search(torch.from_numpy(queries).to(dev), x_dev, allowed, float("inf"),
                              DistanceKind.L2_SQUARED, k=HYBRID_K)
        if not (np.array_equal(v_ids, ids_of(pi)) and np.array_equal(v_sc, ps)):
            raise AssertionError("the hybrid vector leg differs from the plain pipeline "
                                 "under the candidate mask")
        with plain_versions():
            p_ids, p_sc = text_index.search_batch(texts[:BM25_CHUNK], k=HYBRID_K,
                                                  document_ids=cand)
        if not (np.array_equal(p_ids, t_ids[:BM25_CHUNK])
                and np.array_equal(p_sc, t_sc[:BM25_CHUNK])):
            raise AssertionError("the hybrid text leg differs from the plain scorer")
        if (v_ids % 4 != 1).any() or (t_ids[t_ids != 0xFFFFFFFF] % 4 != 1).any():
            raise AssertionError("a hybrid leg returned a document outside the filter")
        print(f"hybrid: 64 reciprocal-rank and 16 weighted queries equal to execute() one by "
              f"one; the vector leg equal to the plain pipeline (ops/topk.block_topk) under the "
              f"candidate mask ({BATCH} queries), the text leg to the plain scorer "
              f"({BM25_CHUNK} queries) ({time.perf_counter() - t0:.1f} s)")
        del x_dev, allowed
    if profile:
        profile_window(lambda: [hybrid.search_batch(queries, texts, k=HYBRID_K,
                                                    metadata_filters=filt,
                                                    fusion_kind=FusionKind.RECIPROCAL_RANK)
                                for _ in range(2)], "hybrid, reciprocal rank")
    del hybrid, flat
    torch.cuda.empty_cache()

    # section 13's hybrid: the same batches over a sharded flat searcher
    from comet_tpu_torch.parallel import (ShardedFlatSearcher, ShardedHybridSearcher,
                                          make_corpus_mesh)

    vec = ShardedFlatSearcher(make_corpus_mesh([dev] * SHARD_S), corpus)
    sharded = ShardedHybridSearcher(vec, ids, text_index=text_index, metadata_index=meta)
    rrf = FusionKind.RECIPROCAL_RANK
    reset_launches()
    t0 = time.perf_counter()
    got = sharded.search_batch(queries, texts, k=HYBRID_K, metadata_filters=filt,
                               fusion_kind=rrf)
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(ROUNDS):
        again = sharded.search_batch(queries, texts, k=HYBRID_K, metadata_filters=filt,
                                     fusion_kind=rrf)
    qps = ROUNDS * BATCH / (time.perf_counter() - t0)
    sharded_launches = read_launches()
    if got != batches[rrf] or again != got:
        raise AssertionError("the sharded hybrid differs from HybridSearchIndex.search_batch")
    used = {key: v for key, v in sharded_launches.items() if v}
    if min(sharded_launches["bm25_score"], sharded_launches["topk_cl"],
           sharded_launches["fused_dist_select"]) <= 0:
        raise AssertionError(f"a kernel of the sharded hybrid never launched: {used}")
    print(f"sharded hybrid S={SHARD_S} (section 13) search_batch {BATCH} queries, filter cat = a, "
          f"{rrf.value}, k={HYBRID_K}: equal to HybridSearchIndex.search_batch; {qps:.1f} "
          f"queries/s steady, first batch {first:.3f} s; launches of {1 + ROUNDS} batches "
          f"{used} {tag}")
    del sharded, vec
    torch.cuda.empty_cache()
    return {"launches": launches, "sharded_launches": sharded_launches}


STORE_N = 1 << 19      # documents of the persistent store: the first rows of the corpus
STORE_BATCH = 16384    # documents an add_batch call
STORE_REMOVE = 4096    # flushed documents removed before the compaction
STORE_QUERIES = 256    # store searches of each kind
STORE_CHECK = 16       # text and hybrid searches recomputed on the plain versions
STORE_WAL_N = 16384    # documents added after the flush and left in the WAL by the crash
STORE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_store")


def store_vector_check(store, ref_flat, queries, what):
    """Vector-only store searches (every memtable and segment, k = 10)
    against one FlatIndex on the card over the same live rows: scores
    array-equal, ids equal but at ties at the k-th score. Returns the
    seconds of each search and the ids returned."""
    secs, got_i, got_s = [], [], []
    for q in queries:
        t0 = time.perf_counter()
        res = store.new_search().with_vector(q).with_k(HYBRID_K).execute()
        secs.append(time.perf_counter() - t0)
        got_i.append([r.id for r in res])
        got_s.append([r.score for r in res])
    with uncounted():
        want_i, want_s = ref_flat.search_batch(queries, k=HYBRID_K)
    got_i = np.array(got_i, dtype=np.int64)
    got_s = np.array(got_s, dtype=np.float64).astype(np.float32)
    check_probed(f"store vector-only searches ({what})", got_i, got_s, want_i.astype(np.int64),
                 want_s, ties_ok=True)
    return secs, got_i


def store_text_checks(store, texts, vectors, filt, kind):
    """Text-only and hybrid store searches: their results, and the first
    STORE_CHECK of each recomputed with every wrapper on its plain version
    (the plain BM25 scorer and top-k in every source's text leg, the plain
    scan in its vector leg), merged by the store's merge_results: equal."""
    runs = {"text": lambda i, b: b.with_text(texts[i]),
            "hybrid": lambda i, b: (b.with_vector(vectors[i]).with_text(texts[i])
                                    .with_metadata(*filt).with_fusion_kind(kind))}
    out = {}
    for name, make in runs.items():
        secs, res = [], []
        for i in range(len(texts)):
            t0 = time.perf_counter()
            res.append([(r.id, r.score) for r in make(i, store.new_search()).with_k(HYBRID_K)
                        .execute()])
            secs.append(time.perf_counter() - t0)
        with uncounted(), plain_versions():
            for i in range(STORE_CHECK):
                want = [(r.id, r.score)
                        for r in make(i, store.new_search()).with_k(HYBRID_K).execute()]
                if want != res[i]:
                    raise AssertionError(f"store {name} search {i} differs from its plain "
                                         f"recomputation")
        out[name] = (secs, res)
    return out


def serial_deflate(store, tag):
    """The level-9 deflate rate of one core on this host, on a 2 MiB
    sample of each stream kind of the store's first segment, and the
    seconds the streams the store has written so far would take on one
    core, as the reference's serial gzip.open writes them."""
    import gzip
    import zlib

    paths = store.segments.list()[0].paths
    total = 0.0
    rates = []
    for kind, n in store.write_stats["bytes"].items():
        with gzip.open(paths[kind], "rb") as f:
            sample = f.read(2 << 20)
        t0 = time.perf_counter()
        zlib.compress(sample, 9)
        rate = len(sample) / (time.perf_counter() - t0)
        rates.append(f"{kind} {rate / 1e6:.2f} MB/s")
        total += n / rate
    print(f"serial level-9 deflate on one core of this host (2 MiB samples): {', '.join(rates)}; "
          f"the {sum(store.write_stats['bytes'].values())} bytes written so far would take "
          f"{total:.1f} s on one core, the pool took {store.write_stats['deflate_s']:.1f} s {tag}")


def latency(secs):
    ms = np.array(secs) * 1e3
    return (f"p50 {np.percentile(ms, 50):.3f} ms, p99 {np.percentile(ms, 99):.3f} ms, "
            f"{len(secs) / sum(secs):.1f} queries/s")


def store_kernels_alone(store, text, vector, dev, tag, time_ms):
    """The store's one-query kernel shapes, each timed alone over the
    smallest and the largest segment: the BM25 scorer on `text`, K1 on its
    negated row (k = HYBRID_K; the split route) and K2's float32 flat mode
    on `vector` (the few-query route), each held to its plain version
    (uncounted), beside its bytes bound (as section 10 counts the
    scorer's and K1's). CUDA-event ms include the host's launch; the
    device time a call is torch.profiler's, over the three run in turns in
    one window (`calls_device_us`)."""
    from comet_tpu_torch.ops import bm25, fused_scan, sortnet

    segs = sorted(store.segments.list(), key=lambda seg: seg.get_index().count())
    inf = float("inf")
    with uncounted():
        for which, seg in (("smallest", segs[0]), ("largest", segs[-1])):
            hybrid = seg.get_index()
            a = bm25_chunk_inputs(hybrid.text_index(), [text], dev)
            q_off = a["q_off"]
            q_off_dev = torch.from_numpy(q_off.astype(np.int32)).to(dev)
            args = {key: v for key, v in a.items() if key != "q_off"}
            n = a["doc_len"].shape[0]

            def score():
                return bm25._bm25_dense_cuda(**args, q_off_dev=q_off_dev)
            dense = score()
            plain = bm25._bm25_dense_plain(**args, q_off=q_off)
            if not torch.equal(dense.view(torch.int32), plain.view(torch.int32)):
                raise AssertionError(f"the BM25 scorer differs from its plain version over the "
                                     f"{which} segment")
            runs = {(int(s), int(c)) for s, c in zip(a["t_start"].tolist(), a["t_len"].tolist())}
            postings = int(a["t_len"].long().sum())
            rows = {"BM25 scorer": (score, (("bm25_score",), "bm25_score"), bound(
                8 * sum(c for _, c in runs) + 5 * n + 4 * n, 9 * postings),
                lambda: bm25._bm25_dense_plain(**args, q_off=q_off), bm25_library(a, 1, dev))}
            gv, gi = sortnet.topk_rows(dense, None, HYBRID_K)
            pv, pi = sortnet._topk_rows_plain(dense, None, HYBRID_K)
            if not (torch.equal(gi, pi) and torch.equal(gv, pv)):
                raise AssertionError(f"K1 differs from its plain version over the {which} segment")
            rows["K1 topk_rows"] = (lambda: sortnet.topk_rows(dense, None, HYBRID_K),
                                    K1_SPLIT_NAMES,
                                    bound(4 * n + 8 * sortnet.k_pow2(HYBRID_K), 0),
                                    lambda: sortnet._topk_rows_plain(dense, None, HYBRID_K),
                                    lambda: torch.topk(dense, HYBRID_K, dim=1, largest=False))
            vecs, sqn, valid = hybrid.vector_index()._store.device_state()
            mask = torch.where(valid, sqn, torch.tensor(inf, device=dev))
            q1 = torch.from_numpy(np.ascontiguousarray(vector[None, :])).to(dev)
            dist, gmin = fused_scan._fused_scan_cuda(q1, vecs, mask, inf, False)
            pdist, pgmin = fused_scan._fused_dist_select_plain(q1, vecs, mask, inf, False)
            if not (torch.equal(dist, pdist) and torch.equal(gmin, pgmin)):
                raise AssertionError(f"K2 differs from its plain version over the {which} segment")
            cap = vecs.shape[0]
            rows["K2 flat float32"] = (
                lambda: fused_scan._fused_scan_cuda(q1, vecs, mask, inf, False),
                (("fewq_scan",), "fewq_scan"),
                bound(4 * (DIM + cap * DIM + 2 * cap + cap // 128), 2 * cap * DIM),
                lambda: fused_scan._fused_dist_select_plain(q1, vecs, mask, inf, False), None)
            parts = []
            # the device time a call: the three kernels in turns in one
            # profiler window, past the start a trace can lose
            dev_us = calls_device_us([r[0] for r in rows.values()], [r[1] for r in rows.values()])
            for (name, (fn, keys, b, plain_fn, lib)), us in zip(rows.items(), dev_us):
                ms = time_ms(fn, reps=21)
                device = "not measured (the trace kept no launch)" if us is None else (
                    f"{us:.1f} us")
                # the one PyTorch call of the same function: index_put_ for
                # the scorer, torch.topk for K1; K2 has none
                library = "none" if lib is None else f"{time_ms(lib, reps=21):.4f} ms"
                parts.append(f"{name} {ms:.4f} ms, device {device}, bound {b[0] * 1e3:.2f} us "
                             f"({b[1]}), plain {time_ms(plain_fn):.4f} ms, library {library}")
            tile, group = bm25.tile_shape(1, n, torch.cuda.get_device_properties(0)
                                          .multi_processor_count)
            print(f"store kernels alone, one query over the {which} segment ({n} documents, "
                  f"{cap} vector slots, {postings} postings, tiles of {tile}; each equal to its "
                  f"plain version): {'; '.join(parts)} {tag}")
            del dense, plain, dist, pdist, gmin, pgmin


def store_phase(corpus, queries, texts, qterms, dev, tag, time_ms, profile):
    """Section 12 of the module docstring. Returns {"launches": the phase's
    counts, "seconds": its wall time}."""
    import gc
    import shutil

    from comet_tpu_torch import (BM25SearchIndex, DistanceKind, FlatIndex, FusionKind,
                                 RoaringMetadataIndex, eq, storage)

    t_phase = time.perf_counter()
    shutil.rmtree(STORE_DIR, ignore_errors=True)
    cfg = storage.StorageConfig(
        base_dir=STORE_DIR,
        vector_index_factory=lambda: FlatIndex(DIM, DistanceKind.L2, device="cuda"),
        text_index_factory=lambda: BM25SearchIndex(device="cuda"),
        metadata_index_factory=RoaringMetadataIndex)
    meta = [{"cat": "abcd"[i % 4], "num": i % 1000} for i in range(STORE_N + STORE_WAL_N)]
    reset_launches()

    # 1. ingest with the reference's knobs: rotations and background flushes
    store = storage.open_persistent_hybrid_index(cfg)
    print(f"store knobs: memtable {cfg.memtable_size_limit} B, flush threshold "
          f"{cfg.flush_threshold} B, compaction every {cfg.compaction_interval} s at "
          f"{cfg.compaction_threshold} segments, WAL {cfg.wal_enabled}, fsync {cfg.wal_fsync}")
    ids = np.zeros(STORE_N + STORE_WAL_N, dtype=np.int64)
    t0 = time.perf_counter()
    for lo in range(0, STORE_N, STORE_BATCH):
        hi = min(lo + STORE_BATCH, STORE_N)
        ids[lo:hi] = store.add_batch([(corpus[i], texts[i], meta[i]) for i in range(lo, hi)])
    torch.cuda.synchronize()
    t_ingest = time.perf_counter() - t0
    n_bg = store.segments.count()
    rotations = n_bg + store.memtables.count() - 1
    print(f"store add_batch {STORE_N} documents (vector, text, metadata) in batches of "
          f"{STORE_BATCH}: {t_ingest:.1f} s = {STORE_N / t_ingest:.1f} docs/s; {rotations} "
          f"rotations, {n_bg} segments flushed in the background by then {tag}")

    # 2. flush
    t0 = time.perf_counter()
    store.flush()
    torch.cuda.synchronize()
    t_flush = time.perf_counter() - t0
    st = store.stats()
    ws = store.write_stats
    print(f"store flush(): {t_flush:.1f} s; {st['segments']} segments, {st['segment_bytes']} "
          f"bytes on disk; writing segment files so far: serialize {ws['serialize_s']:.1f} s, "
          f"deflate (level 9, {storage.segment.GZIP_WORKERS} threads) {ws['deflate_s']:.1f} s "
          f"of {sum(ws['bytes'].values())} bytes {tag}")
    serial_deflate(store, tag)

    # 3. remove flushed documents, then compact
    rng = np.random.default_rng(12)
    gone_rows = np.sort(rng.choice(STORE_N, STORE_REMOVE, replace=False))
    live = np.ones(STORE_N + STORE_WAL_N, dtype=bool)
    live[STORE_N:] = False
    t0 = time.perf_counter()
    for r in gone_rows.tolist():
        if not store.remove(int(ids[r])):
            raise AssertionError(f"store remove({ids[r]}) found nothing")
    t_remove = time.perf_counter() - t0
    live[gone_rows] = False
    gone = set(ids[gone_rows].tolist())

    def flat_over_live():
        flat = FlatIndex(DIM, DistanceKind.L2, device="cuda")
        flat.add_batch(corpus[np.flatnonzero(live)], ids=ids[live].astype(np.uint32))
        return flat

    sq = queries[:STORE_QUERIES]
    ref_flat = flat_over_live()
    store_vector_check(store, ref_flat, sq, "before compaction")
    before = store.segments.count()
    w0 = (ws["serialize_s"], ws["deflate_s"], sum(ws["bytes"].values()))
    t0 = time.perf_counter()
    store.maybe_compact()
    torch.cuda.synchronize()
    t_compact = time.perf_counter() - t0
    print(f"store remove {STORE_REMOVE} flushed documents: {t_remove:.2f} s; maybe_compact(): "
          f"{t_compact:.1f} s, segments {before} -> {store.segments.count()} (writing the merged "
          f"segment: serialize {ws['serialize_s'] - w0[0]:.1f} s, deflate "
          f"{ws['deflate_s'] - w0[1]:.1f} s of {sum(ws['bytes'].values()) - w0[2]} bytes) {tag}")

    # 4. 256 searches of each kind over every memtable and segment
    texts_q = bm25_queries(qterms, 2, count=STORE_QUERIES)
    filt = [eq("cat", "a")]
    n_src = store.memtables.count() + store.segments.count()
    torch.cuda.synchronize()
    v_secs, v_ids = store_vector_check(store, ref_flat, sq, "after compaction")
    th = store_text_checks(store, texts_q, sq, filt, FusionKind.RECIPROCAL_RANK)
    for name, secs in (("vector-only", v_secs), ("2-term text", th["text"][0]),
                       ("hybrid (vector + 2-term text, cat = a, reciprocal rank)",
                        th["hybrid"][0])):
        print(f"store {name} searches, {STORE_QUERIES} at k={HYBRID_K} over {n_src} sources: "
              f"{latency(secs)} {tag}")
    returned = set(v_ids.ravel().tolist()) | {i for _, res in (th["text"], th["hybrid"])
                                              for row in res for i, _ in row}
    if returned & gone:
        raise AssertionError(f"store searches returned removed ids: {sorted(returned & gone)[:8]}")
    if any(i % 4 != 1 for _, res in [th["hybrid"]] for row in res for i, _ in row):
        raise AssertionError("a hybrid store search returned a document outside the filter")
    print(f"store searches: vector-only equal to one FlatIndex over the live rows before and "
          f"after compaction ({STORE_QUERIES} queries each), {STORE_CHECK} text and "
          f"{STORE_CHECK} hybrid searches equal to their plain recomputation, no removed id "
          f"returned")
    store_kernels_alone(store, texts_q[0], sq[0], dev, tag, time_ms)
    if profile:
        profile_window(lambda: [store.new_search().with_vector(sq[i]).with_text(texts_q[i])
                                .with_metadata(*filt)
                                .with_fusion_kind(FusionKind.RECIPROCAL_RANK)
                                .with_k(HYBRID_K).execute() for i in range(min(64, len(sq)))],
                       "store, 64 hybrid searches")
    del ref_flat

    # 5. add without flushing, crash, reopen
    t0 = time.perf_counter()
    for lo in range(STORE_N, STORE_N + STORE_WAL_N, STORE_BATCH):
        hi = min(lo + STORE_BATCH, STORE_N + STORE_WAL_N)
        ids[lo:hi] = store.add_batch([(corpus[i], texts[i], meta[i]) for i in range(lo, hi)])
    live[STORE_N:] = True
    t_wal = time.perf_counter() - t0
    if store.memtables.count() != 1 or store.memtables.mutable.num_docs != STORE_WAL_N:
        raise AssertionError("the WAL-only documents did not stay in one memtable")
    # a crash: the workers stop (the flush worker not woken, which would
    # flush first), the WAL and a LOCK of a dead pid stay behind
    n_seg = store.segments.count()
    store._stop.set()
    store._flush_thread.join(timeout=5)
    store._compact_event.set()
    store._compact_thread.join(timeout=5)
    if store._flush_thread.is_alive() or store._compact_thread.is_alive():
        raise AssertionError("a store worker did not stop")
    with open(os.path.join(STORE_DIR, "LOCK"), "w") as f:
        f.write("999999999")
    wal_bytes = sum(os.path.getsize(p) for p in store.provider.list_wals())
    del store
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    store = storage.open_persistent_hybrid_index(cfg)
    t_reopen = time.perf_counter() - t0
    if store.segments.count() != n_seg or store.memtables.mutable.num_docs != STORE_WAL_N:
        raise AssertionError(f"the reopen found {store.segments.count()} segments (the crash "
                             f"left {n_seg}) and replayed {store.memtables.mutable.num_docs} of "
                             f"{STORE_WAL_N} logged documents")
    t0 = time.perf_counter()
    store.new_search().with_vector(sq[0]).with_text(texts_q[0]).with_metadata(*filt) \
        .with_fusion_kind(FusionKind.RECIPROCAL_RANK).with_k(HYBRID_K).execute()
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    loads = sum(seg.load_seconds for seg in store.segments.list())
    print(f"store add {STORE_WAL_N} documents without a flush: {t_wal:.1f} s; crash (WALs of "
          f"{wal_bytes} bytes left); reopen (WAL replay of {STORE_WAL_N} documents): "
          f"{t_reopen:.1f} s; first search (a hybrid "
          f"one, loading {store.segments.count()} segments onto the card, {loads:.1f} s of "
          f"loads summed over the pool's threads): {t_first:.1f} s {tag}")
    ref_flat = flat_over_live()
    store_vector_check(store, ref_flat, sq, "after the reopen")
    del ref_flat
    n_live = sum(mt.index.count() for mt in store.memtables.list_all())
    for seg in store.segments.list():
        index = seg.get_index()
        n_live += index.count() - sum(index.has_document(d) for d in store._tombstones)
    if n_live != STORE_N + STORE_WAL_N - STORE_REMOVE:
        raise AssertionError(f"{n_live} live documents after the reopen, "
                             f"{STORE_N + STORE_WAL_N - STORE_REMOVE} acknowledged")
    n_sample = min(4096, int(live[:STORE_N].sum()))
    sample = np.concatenate([ids[STORE_N:], rng.choice(ids[:STORE_N][live[:STORE_N]], n_sample,
                                                       replace=False)])
    if not all(store.has_document(int(d)) for d in sample):
        raise AssertionError("an acknowledged document is missing after the reopen")
    if any(store.has_document(int(d)) for d in list(gone)[:512]):
        raise AssertionError("a removed document is back after the reopen")
    print(f"store after the crash: {n_live} live documents = {STORE_N} + {STORE_WAL_N} added - "
          f"{STORE_REMOVE} removed; has_document for the {STORE_WAL_N} WAL-only ids and "
          f"{n_sample} others, not for {min(512, len(gone))} removed ones")

    # 6. close
    t0 = time.perf_counter()
    store.close()
    t_close = time.perf_counter() - t0
    launches = read_launches()
    seconds = time.perf_counter() - t_phase
    print(f"store close() (final flush of {STORE_WAL_N} documents): {t_close:.1f} s; phase 12 "
          f"took {seconds:.1f} s {tag}")
    print(f"kernel launches of phase 12: {launches}")
    if min(launches["topk_cl"], launches["fused_dist_select"], launches["bm25_score"]) <= 0:
        raise AssertionError(f"a kernel of the store path never launched: {launches}")
    del store
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(STORE_DIR, ignore_errors=True)
    return {"launches": launches, "seconds": seconds}


SHARD_COUNTS = (1, 2, 4, 8)   # flat meshes of section 13, every shard on the one card
SHARD_S = 4                   # the other searches' shard count


def sharded_counts(launches, what, total, need):
    """Print a search's K1 / K2 launches, add them to `total`, and fail if
    a kernel of `need` never launched."""
    for key, v in launches.items():
        total[key] = total.get(key, 0) + v
    used = {key: v for key, v in launches.items() if v}
    if any(launches[key] <= 0 for key in need):
        raise AssertionError(f"{what}: a kernel of the sharded path never launched: {used}")
    return used


def timed_batches(fn, rounds=ROUNDS):
    """A first call, then `rounds` steady ones. Returns (result of the
    first, first seconds, queries/s of the steady calls)."""
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(rounds):
        again = fn()
    torch.cuda.synchronize()
    qps = rounds * BATCH / (time.perf_counter() - t0)
    if not all(np.array_equal(a, b) for a, b in zip(out, again)):
        raise AssertionError("repeated sharded searches differ")
    return out, first, qps


def sharded_phase(corpus, queries, flat_ids, flat_scores, dev, tag, time_ms, profile):
    """Section 13 of the module docstring. Returns {"launches": the
    section's counts}."""
    from comet_tpu_torch import DistanceKind, HNSWIndex, IVFIndex, IVFPQIndex, PQIndex
    from comet_tpu_torch.indexes import hnsw as hnsw_mod
    from comet_tpu_torch.ops import kmeans as km
    from comet_tpu_torch.ops import sortnet
    from comet_tpu_torch.parallel import (ShardedFlatSearcher, ShardedHNSWSearcher,
                                          ShardedIVFPQSearcher, ShardedIVFSearcher,
                                          ShardedPQSearcher, ShardedSeededHNSWSearcher,
                                          make_corpus_mesh, make_sharded_kmeans_step,
                                          shard_rows)

    t_phase = time.perf_counter()
    ids = np.arange(1, N + 1, dtype=np.uint32)
    total = {}
    k12 = ("topk_cl", "fused_dist_select")
    mesh = {s: make_corpus_mesh([dev] * s) for s in SHARD_COUNTS}
    x_dev = torch.from_numpy(corpus).to(dev)
    q_dev = torch.from_numpy(queries).to(dev)
    allowed = (ids % 3) != 0
    with uncounted():
        ps, pi = plain_search(q_dev, x_dev, torch.from_numpy(allowed).to(dev), float("inf"),
                              DistanceKind.L2_SQUARED)
    del x_dev

    # -- flat at every shard count, and K1's merge at its shape -----------------
    for s in SHARD_COUNTS:
        t0 = time.perf_counter()
        flat = ShardedFlatSearcher(mesh[s], corpus)
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
        reset_launches()
        (scores, slots), first, qps = timed_batches(lambda: flat.search(queries, K))
        f_scores, f_slots = flat.search(queries, K, allowed=allowed)
        launches = read_launches()
        used = sharded_counts(launches, f"sharded flat S={s}", total, k12)
        if not (np.array_equal(slots.astype(np.int64) + 1, flat_ids)
                and np.array_equal(scores, flat_scores)):
            raise AssertionError(f"sharded flat S={s}: differs from the FlatIndex of section 3")
        if not (np.array_equal(f_slots, pi) and np.array_equal(f_scores, ps)):
            raise AssertionError(f"sharded flat S={s} with allowed: differs from the plain "
                                 f"pipeline under the same mask")
        print(f"sharded flat S={s} ({s} shard(s) on {dev}) {N} x {DIM} k={K}: ids and scores "
              f"equal to the FlatIndex (section 3), with allowed = ids % 3 != 0 equal to the "
              f"plain pipeline; {qps:.1f} queries/s steady, first batch {first:.3f} s, "
              f"searcher built in {t_build:.3f} s; launches of {2 + ROUNDS} searches {used} "
              f"{tag}")
        with uncounted(), capture(sortnet, "topk_cl", 0) as cap:
            flat.search(queries, K)
            vals, idx = cap.args[0], cap.args[1]
            gv, gi = sortnet.topk_cl(vals, idx, K)
            pv, pi_ = sortnet._topk_cl_plain(vals, idx, K)
            torch.cuda.synchronize()
            if not (torch.equal(gv, pv) and torch.equal(gi, pi_)):
                raise AssertionError(f"K1 merge at S={s} differs from its plain version")
            fin = torch.isfinite(pv)
            err = (gv[fin] - pv[fin]).abs().max().item() if fin.any() else 0.0
            ms = time_ms(lambda: sortnet.topk_cl(vals, idx, K))
            pms = time_ms(lambda: sortnet._topk_cl_plain(vals, idx, K))
            lms = time_ms(lambda: torch.topk(vals, K, dim=0, largest=False))
            # candidates' values and slots read once, k_pow2 pairs a query written
            b = bound(vals.numel() * 8 + BATCH * sortnet.k_pow2(K) * 8, 0)
        print(f"K1 topk_cl, the merge at S={s} [{vals.shape[0]}, {vals.shape[1]}] (candidates "
              f"x queries, ids) k={K}: equal to plain (max abs err {err}); kernel {ms:.4f} ms, "
              f"plain {pms:.3f} ms, torch.topk(dim=0, largest=False) {lms:.4f} ms; bound "
              f"{b[0]:.4f} ms ({b[1]}) {tag}")
        if profile and s == SHARD_S:
            profile_window(lambda: [flat.search(queries, K) for _ in range(2)],
                           f"sharded flat S={s}")
        del flat, cap, vals, idx
        torch.cuda.empty_cache()

    # -- IVF at S = 4 against the single-device dense route ------------------------
    ivf = IVFIndex(DIM, NLIST, DistanceKind.L2, device="cuda")
    ivf.train(corpus[:N_TRAIN])
    trained = ivf._centroids.copy()
    # integer centroids make every coarse distance exact: the sharded probes
    # (the full L2 distance) and the single-device ones (cn - 2 cq) rank alike
    ivf._set_centroids(np.rint(trained).astype(np.float32))
    ivf.add_batch(corpus, ids=ids)
    with uncounted(), env_set(COMET_IVF_SPARSE="0"):
        want_ids, want_scores = ivf.search_batch(queries, k=K, nprobes=10)
    sharded = ShardedIVFSearcher(mesh[SHARD_S], ivf)
    reset_launches()
    (scores, slots), first, qps = timed_batches(lambda: sharded.search(queries, K, nprobe=10))
    used = sharded_counts(read_launches(), "sharded IVF", total,
                          ("topk_cl", "fused_dist_select_nprobe"))
    if not np.array_equal(sharded.row_ids[slots], want_ids):
        raise AssertionError("sharded IVF ids differ from the single-device dense route")
    np.testing.assert_allclose(scores, want_scores, rtol=1e-4, atol=1e-4)
    print(f"sharded IVF S={SHARD_S} nlist {NLIST} (integer centroids) nprobe 10 k={K}: ids equal "
          f"and scores allclose(1e-4) to the single-device dense route (COMET_IVF_SPARSE=0); "
          f"recall@{K} {recall_at_k(sharded.row_ids[slots], flat_ids):.4f}; {qps:.1f} queries/s "
          f"steady, first batch {first:.3f} s; launches {used} {tag}")
    del sharded, ivf
    torch.cuda.empty_cache()

    # -- one k-means step at S = 4 from those centroids -------------------------------
    valid = np.ones(N, dtype=bool)
    prev = np.full(N, -1, dtype=np.int32)
    step = make_sharded_kmeans_step(mesh[SHARD_S], DistanceKind.L2_SQUARED)
    shards = shard_rows(mesh[SHARD_S], corpus, valid, prev)
    step(*shards, trained)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    assign, cents, changed = step(*shards, trained)
    torch.cuda.synchronize()
    t_step = time.perf_counter() - t0
    x_dev = torch.from_numpy(corpus).to(dev)
    c_dev = torch.from_numpy(trained).to(dev)
    want_a = km._nearest(x_dev, c_dev, DistanceKind.L2_SQUARED)
    sums = torch.zeros_like(c_dev).index_add_(0, want_a, x_dev)
    counts = torch.zeros(NLIST, device=dev).index_add_(0, want_a, torch.ones(N, device=dev))
    want_c = torch.where(counts[:, None] > 0, sums / counts.clamp_min(1.0)[:, None], c_dev)
    if not torch.equal(torch.cat(assign).long(), want_a):
        raise AssertionError("sharded k-means assignments differ from the plain step")
    torch.testing.assert_close(cents, want_c, rtol=1e-5, atol=1e-5)
    print(f"sharded k-means step S={SHARD_S} over {N} x {DIM} from {NLIST} centroids: assignments "
          f"equal to one plain single-device step, centroids allclose(1e-5) (changed "
          f"{int(changed)}); {t_step * 1e3:.3f} ms a step {tag}")
    del shards, assign, cents, x_dev, c_dev, want_a, sums, want_c
    torch.cuda.empty_cache()

    # -- PQ and IVFPQ at S = 4 against the single-device dense routes -------------------
    for cls in (PQIndex, IVFPQIndex):
        if cls is PQIndex:
            index = PQIndex(DIM, DistanceKind.L2, m=PQ_M, nbits=PQ_NBITS, device="cuda")
            make, kw, sk, what = ShardedPQSearcher, {}, {}, "PQ"
        else:
            index = IVFPQIndex(DIM, DistanceKind.L2, nlist=NLIST, m=PQ_M, nbits=PQ_NBITS,
                               device="cuda")
            make, kw, sk, what = ShardedIVFPQSearcher, {"nprobes": 10}, {"nprobe": 10}, "IVFPQ"
        index.train(corpus[:N_TRAIN])
        index.add_batch(corpus, ids=ids)
        twin = snapped_twin(index)
        sharded = make(mesh[SHARD_S], index)
        reset_launches()
        (scores, slots), first, qps = timed_batches(lambda: sharded.search(queries, K, **sk))
        used = sharded_counts(read_launches(), f"sharded {what}", total,
                              ("topk_cl", "fused_dist_select" if cls is PQIndex
                               else "fused_dist_select_nprobe"))
        with uncounted(), env_set(COMET_IVFPQ_SPARSE="0"):
            want_ids, want_scores = index.search_batch(queries, k=K, **kw)
            near = close_to_plain(f"sharded {what}", sharded.row_ids[slots], scores, want_ids,
                                  want_scores)
            t_ids, t_scores = twin.search_batch(queries, k=K, **kw)
            ts, tsl = make(mesh[SHARD_S], twin).search(queries, K, **sk)
            if not (np.array_equal(tsl.astype(np.int64) + 1, t_ids)
                    and np.array_equal(ts, t_scores)):
                raise AssertionError(f"sharded {what}: the integer twin differs from its "
                                     f"single-device dense route")
        print(f"sharded {what} S={SHARD_S} m={PQ_M} nbits={PQ_NBITS}"
              + (f" nlist {NLIST} nprobe 10" if kw else "") + f" k={K}: allclose(1e-5, 1e-4) "
              f"to the single-device dense route ({near} ids at near ties differ), the integer "
              f"twin equal to its dense route; recall@{K} "
              f"{recall_at_k(sharded.row_ids[slots], flat_ids):.4f}; {qps:.1f} queries/s "
              f"steady, first batch {first:.3f} s; launches {used} {tag}")
        del index, twin, sharded
        torch.cuda.empty_cache()

    # -- HNSW at S = 4 over a bulk-built graph: classic and seeded --------------------
    saved = hnsw_mod.BLOCKED_TABLE_BYTES_MAX
    hnsw_mod.BLOCKED_TABLE_BYTES_MAX = 0   # no routing table: the graph-beam search
    try:
        t0 = time.perf_counter()
        index = HNSWIndex(DIM, DistanceKind.L2, device="cuda")
        with uncounted():
            index.add_batch(corpus, ids=ids)
            index._ensure_seed()       # the index's own seed centroids
        torch.cuda.synchronize()
        print(f"HNSW for section 13: bulk build and seed centroids "
              f"{time.perf_counter() - t0:.3f} s {tag}")
        with uncounted():
            t0 = time.perf_counter()
            want_ids, want_scores = index.search_batch(queries, k=K, ef_search=EF_SEARCH)
            t_single = time.perf_counter() - t0
    finally:
        hnsw_mod.BLOCKED_TABLE_BYTES_MAX = saved
    sharded = ShardedHNSWSearcher(mesh[SHARD_S], index)
    reset_launches()
    t0 = time.perf_counter()
    scores, slots = sharded.search(queries, K, ef_search=EF_SEARCH)
    t_sharded = time.perf_counter() - t0
    if not (np.array_equal(slots.astype(np.int64) + 1, want_ids)
            and np.array_equal(scores, want_scores)):
        raise AssertionError("sharded HNSW differs from the single-device graph beam")
    print(f"sharded HNSW S={SHARD_S} M=16 ef={EF_SEARCH} k={K} (graph beam, queries sharded): ids "
          f"and scores equal to the single-device graph beam; recall@{K} "
          f"{recall_at_k(slots.astype(np.int64) + 1, flat_ids):.4f}; {BATCH / t_sharded:.1f} "
          f"queries/s ({t_sharded:.3f} s a batch; single device {t_single:.3f} s) {tag}")
    runs = []
    for s in (1, SHARD_S):
        seeded = ShardedSeededHNSWSearcher(mesh[s], index)
        reset_launches()
        t0 = time.perf_counter()
        runs.append(seeded.search(queries, K, ef_search=EF_SEARCH))
        t_seeded = time.perf_counter() - t0
        used = sharded_counts(read_launches(), f"sharded seeded HNSW S={s}", total,
                              ("topk_cl", "fused_dist_select_nprobe"))
        print(f"sharded seeded HNSW S={s} (the index's {seeded._nlist} seed centroids, nprobe "
              f"{seeded._nprobe_default}) k={K}: recall@{K} "
              f"{recall_at_k(runs[-1][1].astype(np.int64) + 1, flat_ids):.4f}; "
              f"{BATCH / t_seeded:.1f} queries/s ({t_seeded:.3f} s a batch); launches {used} "
              f"{tag}")
        del seeded
    if not all(np.array_equal(a, b) for a, b in zip(*runs)):
        raise AssertionError("sharded seeded HNSW differs between S=1 and S=4")
    print(f"sharded seeded HNSW: S=1 and S={SHARD_S} equal")
    del index, sharded
    torch.cuda.empty_cache()
    print(f"kernel launches of section 13 (the hybrid's in section 11): {total}; phase 13 took "
          f"{time.perf_counter() - t_phase:.1f} s {tag}")
    return {"launches": total}


def edge_checks(dev, seed, tag):
    """K1, K2's three modes, K3's two modes, K4's two, the scoring kernel,
    K5 and the BM25 scorer against their plain versions at edge shapes
    (ops/edge_cases.py, the cases of the card tests)."""
    from comet_tpu_torch.ops import edge_cases, sortnet

    t0 = time.perf_counter()
    for k, width in edge_cases.K1_CASES:
        edge_cases.check_k1(dev, k, width, seed)
    for case in edge_cases.K1_SPLIT_CASES:
        edge_cases.check_k1_split(dev, *case, seed=seed)
    torch.cuda.empty_cache()
    k2_err = max(edge_cases.check_k2(dev, q_n, d, n, seed) for q_n, d, n in edge_cases.K2_SHAPES)
    k2_err = max([k2_err] + [edge_cases.check_k2_fewq(dev, q_n, d, n, seed)
                             for q_n, d, n in edge_cases.K2_FEWQ_SHAPES])
    k3_err = max(edge_cases.check_k3(dev, layout, d, seed) for layout, d in edge_cases.K3_CASES)
    for case in edge_cases.K4_CASES:
        edge_cases.check_k4(dev, *case, seed=seed)
    for case in edge_cases.SCORE_CASES:
        edge_cases.check_scoring(dev, *case, seed=seed)
        edge_cases.check_k5(dev, *case, seed=seed)
    for case in edge_cases.BM25_CASES:
        edge_cases.check_bm25(dev, *case, seed=seed)
    torch.cuda.synchronize()
    print(f"edge shapes: K1 equal to its plain version in {3 * len(edge_cases.K1_CASES)} selects "
          f"(k {edge_cases.K1_KS}, widths 1-65539, both layouts and idx=None, in the launches "
          f"of its route for k_pow2 <= {sortnet.KP_MAX}) and its split route in "
          f"{3 * len(edge_cases.K1_SPLIT_CASES)} more ([1-256, 16385-2^20], k 10-8192: ~10^6 "
          f"+-0.0 zeros past fewer than k smaller values, runs across tile edges, +inf rows, "
          f"permuted and repeated indices, ties decided by the last value digit); K2's float32, "
          f"nprobe, bf16, float16 and int8 modes equal to their plain versions in "
          f"{11 * 2 * (len(edge_cases.K2_SHAPES) + len(edge_cases.K2_FEWQ_SHAPES))} scans "
          f"(Q 1-300, d 1-144; the few-query route at Q 1-32 also bit-equal to the 128-query tile, "
          f"Gaussian float32 included; cosine float32 "
          f"allclose(1e-5, 1e-6), max abs err {k2_err:.3g}); K3's float32 and bf16 modes in "
          f"{8 * len(edge_cases.K3_CASES)} scans (member counts "
          f"{edge_cases.K3_MEMBER_COUNTS} a step, dead steps, S = 1, a zero-padded group, d 3-128; "
          f"cosine float32 allclose(1e-5, 1e-6), max abs err {k3_err:.3g}); K4 split and fused "
          f"in {len(edge_cases.K4_CASES)} steps (ties, copies, SENT and +inf rows, ew 7-300, "
          f"beams and result sets out of slot order); the scoring kernel (nd, ns, adm; both "
          f"layouts, both modes) and K5 (stop = ef and ef / 4; also against the split pair) in "
          f"{len(edge_cases.SCORE_CASES)} shapes (W 1-64, d 3-1536, expand 1-23, Q 1-2048, ndig "
          f"2-3, 152-byte and shifted packed rows, -1 nodes and empty entries); the BM25 "
          f"scorer bit-equal in {len(edge_cases.BM25_CASES)} cases (empty queries, a term "
          f"without postings or covering every document, repeated terms, every document "
          f"deleted or filtered out, k above the matches, the padding edge, ragged chunks, "
          f"k = 1 and 1024, partial tiles, runs across tiles and in the last one, one query "
          f"over 70,000 and 330,000 documents, ragged query groups, shared and moved terms, "
          f"several windows of positions, untouched allowed documents) "
          f"({time.perf_counter() - t0:.1f} s) {tag}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="trace two steady flat, IVF and HNSW batches, one insertion "
                         "round, one IVFPQ batch, two BM25 and hybrid batches, 64 "
                         "hybrid store searches and two sharded flat batches with "
                         "torch.profiler")
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after holding K1-K5 and the scoring kernel to their plain "
                         "versions at the main path's shapes and timing them")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; this run needs an NVIDIA card")

    from comet_tpu_torch import Bitset, DistanceKind, FlatIndex
    from comet_tpu_torch.ops import _build, fused_scan, sortnet, topk
    from comet_tpu_torch.ops.distance import preprocess

    torch.backends.cuda.matmul.allow_tf32 = False   # exact float32 products
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    tag = f"[{card}]"

    # -- 1. the card and the build -------------------------------------------
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")
    print(f"nvcc: {_build.find_nvcc()}")
    _build.library()
    info = _build.build_info
    print(f"kernel build: {info['seconds']:.2f} s "
          f"({'compiled' if info['compiled'] else 'loaded'} {info['library']})")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line:
            print(f"  {line.strip()}")

    def time_ms(fn, reps=5):
        fn()
        times = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)

    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    corpus, queries, extra = sift_like(rng, N, BATCH, DIM, N_INSERT)
    print(f"data: {N} x {DIM} SIFT-range integer corpus, {BATCH} queries, {N_INSERT} held-out "
          f"rows ({time.perf_counter() - t0:.2f} s on the host)")

    # -- 2. kernels against their plain versions -----------------------------
    report = {}
    for c in (8192, 16384):
        for case in ("random", "ties"):
            if case == "random":
                v = rng.normal(size=(c, 256)).astype(np.float32)
            else:
                v = rng.integers(0, 4, size=(c, 256)).astype(np.float32)
            ix = rng.permuted(np.tile(np.arange(c, dtype=np.int32), (256, 1)), axis=1).T
            vt = torch.from_numpy(v).to(dev)
            it = torch.from_numpy(np.ascontiguousarray(ix)).to(dev)
            gv, gi = sortnet.topk_cl(vt, it, 128)
            pv, pi = sortnet._topk_cl_plain(vt, it, 128)
            torch.cuda.synchronize()
            if not (torch.equal(gi, pi) and torch.equal(gv, pv)):
                raise AssertionError(f"K1 differs from its plain version at C={c} ({case})")
            ms = time_ms(lambda: sortnet.topk_cl(vt, it, 128))
            pms = time_ms(lambda: sortnet._topk_cl_plain(vt, it, 128))
            lms = time_ms(lambda: torch.topk(vt, 128, dim=0, largest=False))
            print(f"K1 topk_cl C={c} L=256 k=128 {case}: equal to plain; "
                  f"kernel {ms:.3f} ms, plain {pms:.3f} ms, torch.topk {lms:.3f} ms {tag}")

    x_dev = torch.from_numpy(corpus).to(dev)
    q_dev = torch.from_numpy(queries[:256]).to(dev)
    invalid = torch.from_numpy(rng.random(N) < 0.1).to(dev)
    inf = torch.tensor(float("inf"), device=dev)
    # thresholds at the median distance of a sample, so that they cut
    sample = corpus[:: N // 1024].astype(np.float64)
    qh = queries[:256].astype(np.float64)
    d2_sample = (qh * qh).sum(1)[:, None] + (sample * sample).sum(1) - 2 * qh @ sample.T
    unit = lambda a: a / np.linalg.norm(a, axis=1, keepdims=True)  # noqa: E731
    cos_sample = 1.0 - unit(qh) @ unit(sample).T
    k2_err, k2_ms, k2_plain = 0.0, None, None
    for cosine in (False, True):
        if cosine:
            xs = x_dev / torch.linalg.vector_norm(x_dev, dim=1, keepdim=True)
            qs = q_dev / torch.linalg.vector_norm(q_dev, dim=1, keepdim=True)
            mask = torch.where(invalid, inf, torch.zeros((), device=dev))
            thr = float(np.median(cos_sample))
        else:
            xs, qs = x_dev, q_dev
            mask = torch.where(invalid, inf, (x_dev * x_dev).sum(dim=1))
            thr = float(np.median(d2_sample))
        dist, gsel = fused_scan.fused_dist_select(qs, xs, mask, thr, 128, cosine)
        pdist, pgmin = fused_scan._fused_dist_select_plain(qs, xs, mask, thr, cosine)
        pgsel = sortnet._topk_rows_plain(pgmin, None, 128)[1]
        torch.cuda.synchronize()
        name = "cosine" if cosine else "L2"
        both = torch.isfinite(dist) & torch.isfinite(pdist)
        err = (dist[both] - pdist[both]).abs().max().item()
        k2_err = max(k2_err, err)
        if cosine:
            torch.testing.assert_close(dist[both], pdist[both], rtol=1e-5, atol=1e-6)
            # only values within the tolerance of the threshold may fall on
            # different sides of it
            flip = torch.isfinite(dist) != torch.isfinite(pdist)
            near = torch.where(torch.isfinite(dist), dist, pdist)[flip]
            if ((near - thr).abs() > 1e-6 + 1e-5 * thr).any():
                raise AssertionError("K2 cosine: a masked entry differs from the plain version")
            if torch.isinf(dist[:, invalid]).logical_not().any():
                raise AssertionError("K2 cosine: a masked row came out finite")
        else:
            if not torch.equal(dist, pdist):
                raise AssertionError("K2 L2: dist differs from the plain version")
            if not torch.equal(gsel.sort(dim=1).values, pgsel.sort(dim=1).values):
                raise AssertionError("K2 L2: group selection differs from the plain version")
        ms = time_ms(lambda: fused_scan._fused_scan_cuda(qs, xs, mask, thr, cosine))
        pms = time_ms(lambda: fused_scan._fused_dist_select_plain(qs, xs, mask, thr, cosine))
        print(f"K2 fused_dist_select 256 x {N} x {DIM} kb=128 {name}: "
              f"{'equal to' if not cosine else 'allclose(1e-5, 1e-6) to'} plain "
              f"(max abs err {err:.3g}, {int(torch.isinf(dist).sum())} entries +inf); "
              f"kernel {ms:.3f} ms, plain {pms:.3f} ms {tag}")
        if not cosine:
            k2_ms, k2_plain = ms, pms
        del dist, pdist, pgmin, gsel, pgsel, xs, qs, mask
    # queries, corpus and mask read once; dist and the group minima written
    k2_bytes = 4 * (256 * DIM + N * DIM + N + 256 * N + 256 * (N // 128))
    report["fused_dist_select"] = dict(err=k2_err, ms=k2_ms, plain_ms=k2_plain, library_ms=None,
                                       bound=bound(k2_bytes, 2 * 256 * N * DIM))

    # K1 at the flat path's two selects, on the flat path's own inputs: the
    # group minima of 256 queries and the candidates of their kept groups
    dist, gmin = fused_scan._fused_scan_cuda(q_dev, x_dev, (x_dev * x_dev).sum(dim=1),
                                             float("inf"), False)
    gsel = sortnet._topk_rows_plain(gmin, None, 128)[1]
    cand = torch.gather(dist.view(256, N // 128, 128), 1,
                        gsel.long()[:, :, None].expand(256, 128, 128)).reshape(256, 128 * 128)
    cidx = (gsel[:, :, None] * 128
            + torch.arange(128, dtype=torch.int32, device=dev)).reshape(256, 128 * 128)
    del dist
    fin_v = cand.view(2048, 2048)[:, :256].contiguous()
    fin_i = cidx.view(2048, 2048)[:, :256].contiguous()
    k1_rows = {}
    for what, vals, idx, k in (("group select", gmin, None, 128),
                               ("candidate select", cand, cidx, K),
                               ("HNSW finalize", fin_v, fin_i, 128)):
        gv, gi = sortnet.topk_rows(vals, idx, k)
        pv, pi = sortnet._topk_rows_plain(vals, idx, k)
        torch.cuda.synchronize()
        if not (torch.equal(gi, pi) and torch.equal(gv, pv)):
            raise AssertionError(f"K1 {what} differs from its plain version")
        fin = torch.isfinite(pv)
        err = (gv[fin] - pv[fin]).abs().max().item() if fin.any() else 0.0
        ms = time_ms(lambda: sortnet.topk_rows(vals, idx, k))
        us = queued_device_ms(lambda: sortnet.topk_rows(vals, idx, k)) * 1e3
        pms = time_ms(lambda: sortnet._topk_rows_plain(vals, idx, k))
        lms = time_ms(lambda: torch.topk(vals, k, dim=1, largest=False))
        # the values (and indices) read once, k_pow2 (value, index) pairs of
        # each row written
        b = bound(vals.numel() * 4 + (idx.numel() * 4 if idx is not None else 0)
                  + vals.shape[0] * sortnet.k_pow2(k) * 8, 0)
        k1_rows[what] = (err, ms, pms, lms, b)
        print(f"K1 topk_rows {what} {list(vals.shape)} k={k}"
              f"{', idx=None' if idx is None else ''}: equal to plain; kernel {ms:.4f} ms "
              f"(device {us:.1f} us a call), plain {pms:.3f} ms, torch.topk(dim=1, "
              f"largest=False) {lms:.4f} ms; bound {b[0]:.4f} ms ({b[1]}) {tag}")
    err, ms, pms, lms, b = k1_rows["candidate select"]
    report["topk_cl"] = dict(err=err, ms=ms, plain_ms=pms, library_ms=lms, bound=b)
    del q_dev, invalid, gmin, gsel, cand, cidx, fin_v, fin_i
    torch.cuda.empty_cache()

    # K1's split route and K2's few-query route at their shapes
    report.update(k1_split_section(args.seed, dev, tag, time_ms))
    report.update(k2_fewq_section(x_dev, queries, dev, tag, time_ms))

    # K3 on the IVF layout, K4 and K5 on a beam state made from the seed
    report.update(k3_section(corpus, queries, dev, tag, time_ms))
    beam_section(x_dev, queries, args.seed, dev, tag, time_ms)
    if args.kernels_only:
        return

    edge_checks(dev, args.seed, tag)

    # -- 3. the main path at the users' size ----------------------------------
    ids = np.arange(1, N + 1, dtype=np.uint32)
    index = FlatIndex(DIM, DistanceKind.L2, device="cuda")
    t0 = time.perf_counter()
    index.add_batch(corpus, ids=ids)
    print(f"add_batch {N} x {DIM}: {time.perf_counter() - t0:.3f} s {tag}")

    reset_launches()
    t0 = time.perf_counter()
    got_ids, got_scores = index.search_batch(queries, k=K)
    first = time.perf_counter() - t0
    print(f"first search_batch {BATCH} queries k={K} (device upload included): "
          f"{first:.3f} s {tag}")
    t0 = time.perf_counter()
    for _ in range(ROUNDS):
        again_ids, again_scores = index.search_batch(queries, k=K)
    steady = time.perf_counter() - t0
    launches = read_launches()
    print(f"steady search: {ROUNDS} x {BATCH} queries in {steady:.3f} s = "
          f"{ROUNDS * BATCH / steady:.1f} queries/s {tag}")
    print(f"kernel launches of the {1 + ROUNDS} L2 search_batch calls: {launches}")
    if min(launches["topk_cl"], launches["fused_dist_select"]) <= 0:
        raise AssertionError(f"a kernel of the main path never launched: {launches}")
    if not (np.array_equal(again_ids, got_ids) and np.array_equal(again_scores, got_scores)):
        raise AssertionError("repeated searches differ")
    if got_ids.shape != (BATCH, K) or not np.isfinite(got_scores).all():
        raise AssertionError(f"bad result shape {got_ids.shape} or non-finite scores")
    if args.profile:
        profile_window(lambda: [index.search_batch(queries, k=K) for _ in range(2)])

    qs_all = torch.from_numpy(queries).to(dev)
    all_valid = torch.ones(N, dtype=torch.bool, device=dev)
    ps, pi = plain_search(qs_all, x_dev, all_valid, float("inf"),
                          DistanceKind.L2_SQUARED)
    if not np.array_equal(got_ids, pi.astype(np.int64) + 1):
        raise AssertionError("L2 search ids differ from the plain pipeline")
    if not np.array_equal(got_scores, ps):
        raise AssertionError("L2 search scores differ from the plain pipeline")
    t0 = time.perf_counter()
    hs, hd = host_topk(queries[:64], corpus, K)
    if not np.array_equal(got_ids[:64], hs + 1):
        raise AssertionError("L2 search ids differ from the float64 host brute force")
    if not np.array_equal(got_scores[:64], np.sqrt(hd).astype(np.float32)):
        raise AssertionError("L2 search scores differ from the float64 host brute force")
    print(f"L2 {N} x {DIM} k={K}: ids and scores array-equal to the plain pipeline "
          f"({BATCH} queries) and to the float64 host brute force (64 queries, "
          f"{time.perf_counter() - t0:.1f} s on the host)")

    # doc-ID filter and threshold on the same index
    allowed = (ids % 3) != 0
    bits = Bitset.from_array(ids[allowed])
    thr = float(np.median(got_scores[:, 9]))
    f_ids, f_scores = index.search_batch(queries, k=K, threshold=thr, document_ids=bits)
    thr2 = float(np.float32(thr) * np.float32(thr))
    allowed_dev = torch.from_numpy(allowed).to(dev)
    ps, pi = plain_search(qs_all, x_dev, allowed_dev, thr2, DistanceKind.L2_SQUARED)
    want = np.where(pi == topk.IDX_SENTINEL, 0xFFFFFFFF, pi.astype(np.int64) + 1)
    if not (np.array_equal(f_ids, want) and np.array_equal(f_scores, ps)):
        raise AssertionError("filtered + threshold search differs from the plain pipeline")
    hs, hd = host_topk(queries[:16], corpus, K, allowed=allowed, thr2=thr2)
    want = np.where(np.isfinite(hd), hs + 1, 0xFFFFFFFF)
    if not np.array_equal(f_ids[:16], want):
        raise AssertionError("filtered + threshold search differs from the host brute force")
    n_hits = int((f_ids != 0xFFFFFFFF).sum())
    if not 0 < n_hits < f_ids.size or (f_ids[f_ids != 0xFFFFFFFF] % 3 == 0).any():
        raise AssertionError("the filter or the threshold had no effect")
    print(f"L2 with doc-ID filter (2/3 of ids) and threshold {thr:.3f}: {n_hits} hits, "
          f"equal to the plain pipeline and to the host brute force (16 queries)")
    del index, x_dev, qs_all, all_valid, allowed_dev
    torch.cuda.empty_cache()

    # cosine at the same size, on data whose cosines are exact
    c_corpus = sparse_signs(rng, N, DIM)
    c_queries = sparse_signs(rng, BATCH, DIM)
    c_index = FlatIndex(DIM, DistanceKind.COSINE, device="cuda")
    c_index.add_batch(c_corpus, ids=ids)
    before = (sortnet.LAUNCHES, fused_scan.LAUNCHES)
    c_ids, c_scores = c_index.search_batch(c_queries, k=K)
    if sortnet.LAUNCHES <= before[0] or fused_scan.LAUNCHES <= before[1]:
        raise AssertionError("the cosine search did not run the kernels")
    xc = torch.from_numpy(preprocess(c_corpus, DistanceKind.COSINE)).to(dev)
    qc = torch.from_numpy(preprocess(c_queries, DistanceKind.COSINE)).to(dev)
    ps, pi = plain_search(qc, xc, torch.ones(N, dtype=torch.bool, device=dev),
                          float("inf"), DistanceKind.COSINE)
    if not np.array_equal(c_ids, pi.astype(np.int64) + 1):
        raise AssertionError("cosine search ids differ from the plain pipeline")
    np.testing.assert_allclose(c_scores, ps, rtol=1e-4, atol=1e-4)
    print(f"cosine {N} x {DIM} k={K}: ids equal, scores allclose(1e-4) to the plain "
          f"pipeline ({BATCH} queries)")

    del c_index, xc, qc
    torch.cuda.empty_cache()

    # -- 4. flat bf16 storage ------------------------------------------------------
    fb = flat_bf16_phase(corpus, queries, got_ids, got_scores, dev, tag, time_ms)

    # -- 5. the IVF path ----------------------------------------------------------
    ivf = ivf_phase(corpus, queries, c_corpus, c_queries, got_ids, got_scores,
                    dev, tag, time_ms, args.profile)

    # -- 6-7. the HNSW path ----------------------------------------------------------
    hnsw = hnsw_phase(corpus, queries, extra, c_corpus, c_queries, got_ids, dev, tag, time_ms,
                      args.profile)

    # -- 8. flat float16 / int8 storage ---------------------------------------------------
    fl8 = flat_lossy_phase(corpus, queries, got_ids, got_scores, dev, tag, time_ms)

    # -- 9. PQ and IVFPQ ----------------------------------------------------------------------
    pql = pq_phase(corpus, queries, got_ids, tag, args.profile)["launches"]

    # -- 10. BM25 ----------------------------------------------------------------------------
    bm = bm25_phase(args.seed, dev, tag, time_ms, args.profile)

    # -- 11. hybrid search --------------------------------------------------------------------
    hy = hybrid_phase(corpus, queries, bm["index"], bm["qterms"], dev, tag, time_ms,
                      args.profile)
    hyl = hy["launches"]
    bml, bm_report = bm["launches"], bm["report"]
    if min(bml["topk_cl_split"], hyl["topk_cl_split"]) <= 0:
        raise AssertionError(f"K1's split route never launched in sections 10-11: {bml}, {hyl}")
    texts, qterms = bm["texts"], bm["qterms"]
    del bm

    # -- 12. the persistent hybrid store ---------------------------------------------------
    stl = store_phase(corpus, queries, texts, qterms, dev, tag, time_ms,
                      args.profile)["launches"]
    del texts
    if min(stl["topk_cl_split"], stl["fused_dist_select_fewq"]) <= 0:
        raise AssertionError(f"a new route never launched in the store's searches: {stl}")

    # -- 13. sharding over meshes of the one card -------------------------------------------
    shl = sharded_phase(corpus, queries, got_ids, got_scores, dev, tag, time_ms,
                        args.profile)["launches"]
    sec13 = {key: shl.get(key, 0) + hy["sharded_launches"][key] for key in read_launches()}
    for key in ("topk_cl", "topk_cl_split", "fused_dist_select", "fused_dist_select_nprobe",
                "bm25_score"):
        if sec13[key] <= 0:
            raise AssertionError(f"section 13 never launched {key}: {sec13}")

    def entry(name, source, replaces, key, n_launches):
        r = (report.get(key) or fb["report"].get(key) or ivf["report"].get(key)
             or fl8["report"].get(key) or bm_report.get(key) or hnsw["report"][key])
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": n_launches, "max_abs_err": r["err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
                "bound_by": r["bound"][1], "library_ms": r["library_ms"]}

    il, hl, fl, l8 = ivf["launches"], hnsw["launches"], fb["launches"], fl8["launches"]

    def main_path(key):
        return sum(d.get(key, 0) for d in (launches, fl, il, hl, l8, pql, bml, hyl, stl, sec13))

    kernels = [
        entry("topk_cl", "comet_tpu_torch/csrc/topk.cu", "comet_tpu/ops/sortnet.py:142",
              "topk_cl", launches["topk_cl"] + fl["topk_cl"] + il["topk_cl"] + hl["topk_cl"]
              + l8["topk_cl"] + pql["topk_cl"] + bml["topk_cl"] + hyl["topk_cl"]
              + stl["topk_cl"] + sec13["topk_cl"]),
        entry("topk_cl_split", "comet_tpu_torch/csrc/topk.cu", "comet_tpu/ops/sortnet.py:142",
              "topk_cl_split", main_path("topk_cl_split")),
        entry("fused_dist_select_fewq", "comet_tpu_torch/csrc/fused_scan.cu",
              "comet_tpu/ops/pallas_scan.py:63", "fused_dist_select_fewq",
              main_path("fused_dist_select_fewq")),
        entry("fused_dist_select", "comet_tpu_torch/csrc/fused_scan.cu",
              "comet_tpu/ops/pallas_scan.py:63", "fused_dist_select",
              launches["fused_dist_select"] + hl["fused_dist_select"] + pql["fused_dist_select"]
              + hyl["fused_dist_select"] + stl["fused_dist_select"]
              + sec13["fused_dist_select"]),
        entry("fused_dist_select_nprobe", "comet_tpu_torch/csrc/fused_scan.cu",
              "comet_tpu/ops/pallas_scan.py:100", "fused_dist_select_nprobe",
              il["fused_dist_select_nprobe"] + pql["fused_dist_select_nprobe"]
              + sec13["fused_dist_select_nprobe"]),
        entry("fused_dist_select_bf16", "comet_tpu_torch/csrc/fused_scan.cu",
              "comet_tpu/ops/pallas_scan.py:82", "fused_dist_select_bf16",
              fl["fused_dist_select_bf16"]),
        entry("fused_dist_select_f16", "comet_tpu_torch/csrc/fused_scan.cu",
              "comet_tpu/ops/topk.py:155", "fused_dist_select_f16",
              l8["fused_dist_select_f16"]),
        entry("fused_dist_select_int8", "comet_tpu_torch/csrc/fused_scan.cu",
              "comet_tpu/ops/topk.py:155", "fused_dist_select_int8",
              l8["fused_dist_select_int8"]),
        entry("sparse_scan", "comet_tpu_torch/csrc/ivf_sparse.cu",
              "comet_tpu/ops/ivf_sparse.py:215", "sparse_scan",
              il["sparse_scan"] + pql["sparse_scan"]),
        entry("sparse_scan_bf16", "comet_tpu_torch/csrc/ivf_sparse.cu",
              "comet_tpu/ops/ivf_sparse.py:237", "sparse_scan_bf16", hl["sparse_scan_bf16"]),
        entry("beam_merge", "comet_tpu_torch/csrc/beam_merge.cu",
              "comet_tpu/ops/beam_kernel.py:391", "beam_merge", hl["beam_merge"]),
        entry("beam_merge_fused", "comet_tpu_torch/csrc/beam_merge.cu",
              "comet_tpu/ops/beam_kernel.py:391", "beam_merge_fused", hl["beam_merge_fused"]),
        entry("gather_score", "comet_tpu_torch/csrc/gather_score.cu",
              "comet_tpu/ops/beam_kernel.py:795", "gather_score", hl["gather_score"]),
        entry("gather_score_packed", "comet_tpu_torch/csrc/gather_score.cu",
              "comet_tpu/ops/beam_kernel.py:811", "gather_score_packed",
              hl["gather_score_packed"]),
        entry("fused_expand", "comet_tpu_torch/csrc/fused_expand.cu",
              "comet_tpu/ops/beam_kernel.py:582", "fused_expand", hl["fused_expand"]),
        entry("bm25_score", "comet_tpu_torch/csrc/bm25_score.cu",
              "comet_tpu/indexes/bm25.py:602", "bm25_score",
              bml["bm25_score"] + hyl["bm25_score"] + stl["bm25_score"]
              + sec13["bm25_score"]),
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
