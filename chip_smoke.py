"""Smoke run of comet_tpu_torch on one NVIDIA card.

    python3 chip_smoke.py [--seed N] [--profile]

1. Prints the card (name and power limit, as nvidia-smi gives them), the
   torch and CUDA versions, where nvcc is, and builds the CUDA kernels from
   the sources in this checkout.
2. Holds each kernel of the flat path against its plain PyTorch version on
   the card at the main path's shapes: K1 (top-k select, csrc/topk.cu) and
   K2 (fused distance scan, csrc/fused_scan.cu). Times are CUDA-event
   medians of 5; K1 is also timed against `torch.topk`, its yardstick.
3. Drives the flat path through the public API at the users' size: a
   FlatIndex of 1,048,576 x 128 SIFT-range integer vectors (L2), searched
   with 2048 queries at k = 100. On integer data every float32 distance is
   exact, so ids and scores must be array-equal to the plain pipeline
   (ops/topk.block_topk) on the card and, for 64 queries, to a float64 brute
   force on the host. Then a search with a doc-ID filter and a threshold,
   and a cosine index at the same size. The kernel launches of the L2
   searches are counted and reported.
4. The IVF path at the reference's operating point: an IVFIndex over the
   same corpus, nlist 1024 trained on the first 100,000 rows. Holds K2's
   nprobe mode (256 queries x 1M rows, the index's probes at nprobe 10) and
   K3 (block-sparse scan, csrc/ivf_sparse.cu, a 2048-query batch at nprobe
   10) against their plain versions, then searches 2048 queries at k = 100
   for nprobe 1, 5, 10, 20 and 32 on the default (sparse) route: scores
   array-equal and ids equal, but for ties at the k-th score, to the plain
   probed-lists pipeline on the card, recall@100 against the flat path's
   exact ids, queries/s. Then one dense-route search, one nprobe = nlist
   search (equal to the flat path), a filtered + thresholded search and a
   cosine index, with the launches of every kernel counted. `--profile`
   adds a torch.profiler breakdown of two steady nprobe-10 batches.

Any mismatch raises, so the run exits non-zero. The last line is
{"ok": true, "device": {...}}; the line before it names the kernels with
their launches, errors, times and bounds, and the line before that the card.
"""

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

N = 1 << 20        # corpus rows
DIM = 128
K = 100
BATCH = 2048       # queries per search_batch call
ROUNDS = 4         # steady-state search rounds
NLIST = 1024       # IVF lists (bench.py's IVF operating point)
N_TRAIN = 100_000  # IVF training rows
NPROBES = (1, 5, 10, 20, 32)

# NVIDIA's published peaks of one H100 SXM (at its 700 W limit): float32
# outside the tensor cores, and device memory bandwidth.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12


def bound(n_bytes, n_ops):
    """The least time the card could take: (ms, "bytes" or "operations")."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES * 1e3, n_ops / PEAK_FP32 * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sift_like(rng, n_corpus, n_queries, dim):
    """SIFT-range clustered data: a Gaussian mixture with low intrinsic
    dimension (bench.py's generator), rounded and clipped to 0..255."""
    centers = rng.uniform(0, 256, size=(1024, dim)).astype(np.float32)
    proj = rng.normal(scale=1.0, size=(16, dim)).astype(np.float32)

    def sample(count):
        which = rng.integers(0, len(centers), size=count)
        z = rng.normal(scale=12.0, size=(count, 16)).astype(np.float32)
        v = centers[which] + z @ proj
        return np.clip(np.rint(v), 0, 255).astype(np.float32)

    return sample(n_corpus), sample(n_queries)


def sparse_signs(rng, n, dim):
    """Vectors with dim/2 entries of +-1 and the rest 0: their norm is a
    power of two, so normalised entries and every cosine are exact."""
    support = rng.permuted(
        np.tile(np.repeat(np.array([1, 0], np.int8), dim // 2), (n, 1)), axis=1
    )
    signs = rng.integers(0, 2, size=(n, dim), dtype=np.int8) * 2 - 1
    return (support * signs).astype(np.float32)


def plain_search(queries, corpus, valid, thr, kind, chunk=256):
    """The plain pipeline, ops/topk.block_topk, over chunks of queries (a
    chunk's [chunk, N] distances fit the card). For L2_SQUARED the scores
    come back as their square roots, as FlatIndex returns L2 scores."""
    from comet_tpu_torch import DistanceKind
    from comet_tpu_torch.ops import topk
    from comet_tpu_torch.ops.distance import sqrt_f32

    sqn = (corpus * corpus).sum(dim=1)
    outs = [
        topk.block_topk(queries[q0:q0 + chunk], corpus, sqn, valid, thr, K, kind)
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
    from comet_tpu_torch.ops import fused_scan, ivf_sparse, sortnet

    sortnet.LAUNCHES = fused_scan.LAUNCHES = fused_scan.NPROBE_LAUNCHES = 0
    ivf_sparse.LAUNCHES = 0


def read_launches():
    from comet_tpu_torch.ops import fused_scan, ivf_sparse, sortnet

    return {"topk_cl": sortnet.LAUNCHES, "fused_dist_select": fused_scan.LAUNCHES,
            "fused_dist_select_nprobe": fused_scan.NPROBE_LAUNCHES,
            "sparse_scan": ivf_sparse.LAUNCHES}


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


def profile_window(fn):
    """torch.profiler over `fn`: prints the kernels by device time and the
    device's busy and idle share of the window's wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((dev_us, e.count, e.key))
    busy = sum(r[0] for r in rows)
    print(f"profile: {busy / 1e3:.3f} ms of device activity in {wall_us / 1e3:.3f} ms of wall "
          f"time, idle share {1 - busy / wall_us:.3f}")
    for dev_us, count, key in sorted(rows, reverse=True)[:12]:
        print(f"  {100 * dev_us / busy:6.2f} %  {count:5d} x {dev_us / count:10.3f} us  {key[:90]}")


def ivf_phase(corpus, queries, c_corpus, c_queries, flat_ids, flat_scores, dev, tag,
              time_ms, profile):
    """Section 4 of the module docstring. Returns {"report": per-kernel
    numbers of K2's nprobe mode and K3, "launches": the IVF path's counts}."""
    import os

    from comet_tpu_torch import Bitset, DistanceKind, IVFIndex
    from comet_tpu_torch.indexes.base import _additive_mask
    from comet_tpu_torch.ops import fused_scan, sortnet
    from comet_tpu_torch.ops import ivf_sparse as sp
    from comet_tpu_torch.ops.distance import preprocess

    inf = float("inf")
    ids = np.arange(1, N + 1, dtype=np.uint32)
    report = {}
    ivf = IVFIndex(DIM, NLIST, DistanceKind.L2, device="cuda")
    t0 = time.perf_counter()
    ivf.train(corpus[:N_TRAIN])
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    t0 = time.perf_counter()
    ivf.add_batch(corpus, ids=ids)
    torch.cuda.synchronize()
    print(f"IVF nlist={NLIST}: train on {N_TRAIN} rows {t_train:.3f} s, add_batch {N} x {DIM} "
          f"{time.perf_counter() - t0:.3f} s {tag}")
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

    # K3: the block-sparse scan of a 2048-query batch at nprobe 10
    qs_all = torch.from_numpy(queries).to(dev)
    S, UC, MC = sp.default_budgets(10, NLIST, st["nch_total"], st["max_chunks"])
    plan = sp.scan_plan(qs_all, cents, ivf._order_key, st["chunk_start"], st["nchunks"],
                        128, 10, S, UC, MC, NLIST, False)
    S, kb = plan["S"], plan["kb"]
    scan = (plan["qsorted"], st["corpus"], st["mask_vec"], plan["probes"],
            plan["chunk_ids"], plan["cluster_ids"])
    dist, gsel = sp._sparse_scan(*scan, inf, kb)
    pdist, pgmin = sp._sparse_scan_plain(*scan, inf, False)
    pgsel = sortnet._topk_rows_plain(pgmin.view(BATCH, 2 * S), None, kb)[1][:, :kb]
    torch.cuda.synchronize()
    if not (torch.equal(dist, pdist) and torch.equal(gsel.view(BATCH, kb), pgsel)):
        raise AssertionError("K3 differs from its plain version")
    fin = torch.isfinite(pdist)
    err = (dist[fin] - pdist[fin]).abs().max().item()
    n_fin = int(fin.sum())
    del dist, pdist, pgmin, gsel, pgsel, fin
    ms = time_ms(lambda: sp._sparse_scan_cuda(*scan, inf, False))
    pms = time_ms(lambda: sp._sparse_scan_plain(*scan, inf, False))
    g_n = BATCH // sp.QG
    live = plan["cluster_ids"] >= 0
    member = (plan["probes"].view(g_n, sp.QG, -1, 1)
              == plan["cluster_ids"].view(g_n, 1, 1, S)).any(dim=2)    # [G, QG, S]
    pairs = float(member.sum()) * sp.CHUNK
    chunks_read = int(torch.unique(plan["chunk_ids"][live]).numel())
    n_bytes = (4 * (BATCH * DIM + BATCH * plan["probes"].shape[1] + 2 * g_n * S
                    + BATCH * S * sp.CHUNK + BATCH * 2 * S)
               + 4 * chunks_read * sp.CHUNK * (DIM + 1))
    report["sparse_scan"] = dict(err=err, ms=ms, plain_ms=pms, library_ms=None,
                                 bound=bound(n_bytes, 2 * DIM * pairs))
    print(f"K3 sparse scan {BATCH} queries, nprobe 10, S={S} ({int(live.sum())} of "
          f"{g_n * S} steps live, {chunks_read} chunks, overflow "
          f"{int(plan['overflow'].sum())}): dist and group choice equal to plain "
          f"({n_fin} finite entries); kernel {ms:.3f} ms, plain {pms:.3f} ms; bound "
          f"{report['sparse_scan']['bound'][0]:.3f} ms ({report['sparse_scan']['bound'][1]}) {tag}")
    del plan, scan, member, live
    torch.cuda.empty_cache()

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


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="trace two steady IVF batches at nprobe 10 with torch.profiler")
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
    corpus, queries = sift_like(rng, N, BATCH, DIM)
    print(f"data: {N} x {DIM} SIFT-range integer corpus, {BATCH} queries "
          f"({time.perf_counter() - t0:.2f} s on the host)")

    # -- 2. kernels against their plain versions -----------------------------
    report = {}
    k1_err, k1_ms, k1_plain, k1_lib = 0.0, None, None, None
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
            fin = torch.isfinite(pv)
            k1_err = max(k1_err, (gv[fin] - pv[fin]).abs().max().item())
            ms = time_ms(lambda: sortnet.topk_cl(vt, it, 128))
            pms = time_ms(lambda: sortnet._topk_cl_plain(vt, it, 128))
            lms = time_ms(lambda: torch.topk(vt, 128, dim=0, largest=False))
            print(f"K1 topk_cl C={c} L=256 k=128 {case}: equal to plain; "
                  f"kernel {ms:.3f} ms, plain {pms:.3f} ms, torch.topk {lms:.3f} ms {tag}")
            if c == 16384 and case == "random":
                k1_ms, k1_plain, k1_lib = ms, pms, lms
    # (value, index) pairs read once, the k_pow2 = 128 best of 256 columns written
    report["topk_cl"] = dict(err=k1_err, ms=k1_ms, plain_ms=k1_plain, library_ms=k1_lib,
                             bound=bound(16384 * 256 * 8 + 128 * 256 * 8, 0))

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
    del q_dev, invalid
    torch.cuda.empty_cache()

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

    # -- 4. the IVF path ----------------------------------------------------------
    ivf = ivf_phase(corpus, queries, c_corpus, c_queries, got_ids, got_scores,
                    dev, tag, time_ms, args.profile)

    def entry(name, source, replaces, key, n_launches):
        r = report[key] if key in report else ivf["report"][key]
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": n_launches, "max_abs_err": r["err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
                "bound_by": r["bound"][1], "library_ms": r["library_ms"]}

    il = ivf["launches"]
    kernels = [
        entry("topk_cl", "comet_tpu_torch/csrc/topk.cu", "comet_tpu/ops/sortnet.py:142",
              "topk_cl", launches["topk_cl"] + il["topk_cl"]),
        entry("fused_dist_select", "comet_tpu_torch/csrc/fused_scan.cu",
              "comet_tpu/ops/pallas_scan.py:63", "fused_dist_select",
              launches["fused_dist_select"]),
        entry("fused_dist_select_nprobe", "comet_tpu_torch/csrc/fused_scan.cu",
              "comet_tpu/ops/pallas_scan.py:100", "fused_dist_select_nprobe",
              il["fused_dist_select_nprobe"]),
        entry("sparse_scan", "comet_tpu_torch/csrc/ivf_sparse.cu",
              "comet_tpu/ops/ivf_sparse.py:215", "sparse_scan", il["sparse_scan"]),
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
