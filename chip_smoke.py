"""Smoke run of comet_tpu_torch on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

1. Prints the card (name and power limit, as nvidia-smi gives them), the
   torch and CUDA versions, where nvcc is, and builds the CUDA kernels from
   the sources in this checkout.
2. Holds each kernel against its plain PyTorch version on the card at the
   main path's shapes: K1 (top-k select, csrc/topk.cu) and K2 (fused
   distance scan, csrc/fused_scan.cu). Times are CUDA-event medians of 5.
3. Drives the main path through the public API at the users' size: a
   FlatIndex of 1,048,576 x 128 SIFT-range integer vectors (L2), searched
   with 2048 queries at k = 100. On integer data every float32 distance is
   exact, so ids and scores must be array-equal to the plain pipeline
   (ops/topk.block_topk) on the card and, for 64 queries, to a float64 brute
   force on the host. Then a search with a doc-ID filter and a threshold,
   and a cosine index at the same size. The kernel launches of the L2
   searches are counted and reported.

Any mismatch raises, so the run exits non-zero. The last line is
{"ok": true, "device": {...}}; the line before it names the kernels with
their launches, errors and times.
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
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
    k1_err, k1_ms, k1_plain = 0.0, None, None
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
            print(f"K1 topk_cl C={c} L=256 k=128 {case}: equal to plain; "
                  f"kernel {ms:.3f} ms, plain {pms:.3f} ms {tag}")
            if c == 16384 and case == "random":
                k1_ms, k1_plain = ms, pms
    report["topk_cl"] = dict(err=k1_err, ms=k1_ms, plain_ms=k1_plain)

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
    report["fused_dist_select"] = dict(err=k2_err, ms=k2_ms, plain_ms=k2_plain)
    del q_dev, invalid
    torch.cuda.empty_cache()

    # -- 3. the main path at the users' size ----------------------------------
    ids = np.arange(1, N + 1, dtype=np.uint32)
    index = FlatIndex(DIM, DistanceKind.L2, device="cuda")
    t0 = time.perf_counter()
    index.add_batch(corpus, ids=ids)
    print(f"add_batch {N} x {DIM}: {time.perf_counter() - t0:.3f} s {tag}")

    sortnet.LAUNCHES = 0
    fused_scan.LAUNCHES = 0
    t0 = time.perf_counter()
    got_ids, got_scores = index.search_batch(queries, k=K)
    first = time.perf_counter() - t0
    print(f"first search_batch {BATCH} queries k={K} (device upload included): "
          f"{first:.3f} s {tag}")
    t0 = time.perf_counter()
    for _ in range(ROUNDS):
        again_ids, again_scores = index.search_batch(queries, k=K)
    steady = time.perf_counter() - t0
    launches = {"topk_cl": sortnet.LAUNCHES, "fused_dist_select": fused_scan.LAUNCHES}
    print(f"steady search: {ROUNDS} x {BATCH} queries in {steady:.3f} s = "
          f"{ROUNDS * BATCH / steady:.1f} queries/s {tag}")
    print(f"kernel launches of the {1 + ROUNDS} L2 search_batch calls: {launches}")
    if min(launches.values()) <= 0:
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

    kernels = [
        {"name": "topk_cl", "route": "cuda", "source": "comet_tpu_torch/csrc/topk.cu",
         "replaces": "comet_tpu/ops/sortnet.py:142",
         "launches": launches["topk_cl"], "max_abs_err": report["topk_cl"]["err"],
         "ms": report["topk_cl"]["ms"], "plain_ms": report["topk_cl"]["plain_ms"]},
        {"name": "fused_dist_select", "route": "cuda",
         "source": "comet_tpu_torch/csrc/fused_scan.cu",
         "replaces": "comet_tpu/ops/pallas_scan.py:63",
         "launches": launches["fused_dist_select"],
         "max_abs_err": report["fused_dist_select"]["err"],
         "ms": report["fused_dist_select"]["ms"],
         "plain_ms": report["fused_dist_select"]["plain_ms"]},
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
