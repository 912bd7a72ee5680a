"""Edge cases that hold K1 (top-k select), K2 (fused distance scan), K3
(block-sparse IVF scan), K4 (HNSW beam merge), the in-loop scoring kernel,
K5 (fused expand) and the BM25 scorer to their plain versions on the card,
shared by the card tests (tests/test_torch_cuda.py) and chip_smoke.py.

Each `check_*` runs a kernel's wrapper and its plain version on the same
CUDA tensors and raises AssertionError where they differ. The inputs are
made from a seed with numpy.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from comet_tpu_torch.ops import beam_kernel, bm25, fused_scan, ivf_sparse, sortnet
from comet_tpu_torch.ops.distance import bf16_round, preprocess, sqrt_f32
from comet_tpu_torch.types import DistanceKind

K1_KS = (1, 8, 100, 128, 1000, 8192)
INF = float("inf")


def k1_widths(k: int) -> list[int]:
    """Widths around k_pow2, 2 k_pow2 (direct sort against radix select)
    and SMEM_KEYS (one block a row against the split route)."""
    kp = sortnet.k_pow2(k)
    return sorted({1, kp - 1, kp, kp + 1, 4095, 4097, 16384, 16385, 65539})


K1_CASES = tuple((k, w) for k in K1_KS for w in k1_widths(k))   # (k, width)
K2_SHAPES = tuple(itertools.product((1, 127, 128, 129, 300), (1, 3, 20, 100, 128),
                                    (128, 384, 4096)))          # (Q, d, N)


def k1_rows(rng: np.random.Generator, width: int):
    """Ten rows: random, values 0..3, all equal, +-0.0 and +inf, and
    repeated (value, index) pairs, two of each; with their indices."""
    v = np.empty((10, width), np.float32)
    v[0:2] = rng.normal(size=(2, width))
    v[2:4] = rng.integers(0, 4, size=(2, width))
    v[4:6] = 2.5
    v[6:8] = rng.choice(np.array([-0.0, 0.0, np.inf], np.float32), size=(2, width))
    v[8:10] = rng.integers(0, 3, size=(2, width))
    idx = np.argsort(rng.random((10, width)), axis=1).astype(np.int32)
    idx[8:10] = rng.integers(0, 5, size=(2, width))
    return v, idx


def check_k1(dev: torch.device, k: int, width: int, seed: int = 0) -> None:
    """K1 array-equal to its plain version on `k1_rows` in the row layout
    (with idx and with idx=None) and the column layout, one launch a select
    where k_pow2 <= KP_MAX."""
    v, ix = k1_rows(np.random.default_rng((seed, k, width)), width)
    vt, it = torch.from_numpy(v).to(dev), torch.from_numpy(ix).to(dev)
    vc, ic = vt.T.contiguous(), it.T.contiguous()
    _k1_layouts(vt, it, vc, ic, k, f"width {width}, k {k}")


def _k1_layouts(vt, it, vc, ic, k, where):
    """K1 against its plain version on [L, C] rows (with `it` and with
    idx=None) and on their [C, L] columns (vc, ic), each select in the
    launches `sortnet.select_launches` gives where k_pow2 <= KP_MAX."""
    rows, width = vt.shape
    for layout, run, plain, has_idx in (
        ("rows", lambda: sortnet.topk_rows(vt, it, k), lambda: sortnet._topk_rows_plain(vt, it, k),
         True),
        ("rows, idx=None", lambda: sortnet.topk_rows(vt, None, k),
         lambda: sortnet._topk_rows_plain(vt, None, k), False),
        ("columns", lambda: sortnet.topk_cl(vc, ic, k), lambda: sortnet._topk_cl_plain(vc, ic, k),
         True),
    ):
        before = (sortnet.LAUNCHES, sortnet.SPLIT_LAUNCHES)
        got = run()
        if sortnet.k_pow2(k) <= sortnet.KP_MAX:
            n = sortnet.select_launches(rows, width, k, has_idx)
            split = n if sortnet.split_route(rows, width, sortnet.k_pow2(k)) else 0
            if (sortnet.LAUNCHES - before[0], sortnet.SPLIT_LAUNCHES - before[1]) != (n, split):
                raise AssertionError(
                    f"K1 took {sortnet.LAUNCHES - before[0]} launches "
                    f"({sortnet.SPLIT_LAUNCHES - before[1]} split) at {where} ({layout}), "
                    f"not {n} ({split})")
        want = plain()
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise AssertionError(f"K1 differs from its plain version at {where} ({layout})")


# K1's split route (ops/sortnet.split_route): (rows, width, k, kind). The
# widths of BM25's chunk rows (2^20) and of the store's largest and
# smallest segment (286,372 and 45,428) at 1, 2 and 256 rows; widths just
# past SMEM_KEYS (16,385 and 16,512); kp = 8192 on wide rows.
K1_SPLIT_CASES = (
    (1, 1 << 20, 10, "zeros"), (2, 1 << 20, 100, "zeros"), (256, 1 << 20, 10, "zeros"),
    (256, 1 << 20, 100, "random"), (1, 286_372, 10, "zeros"), (2, 286_372, 10, "random"),
    (256, 286_372, 100, "ties"), (1, 1 << 20, 100, "tile edges"),
    (2, 286_372, 1000, "tile edges"), (2, 286_372, 10, "inf"), (1, 1 << 20, 8192, "random"),
    (2, 70_000, 8192, "ties"), (1, 45_428, 10, "zeros"), (1, 16_385, 10, "random"),
    (8, 16_512, 100, "ties"), (3, 20_000, 128, "pairs"), (2, 286_372, 100, "near"),
    (1, 1 << 20, 10, "near"),
)
K1_SPLIT_KINDS = ("zeros", "random", "ties", "tile edges", "inf", "pairs", "near")


def k1_split_rows(rng: np.random.Generator, kind: str, rows: int, width: int, k: int):
    """[rows, width] float32 values and int32 indices of a K1_SPLIT_CASES kind:
    - zeros: BM25's negated scores where few documents match: +0.0 and
      -0.0 mixed, fewer than k negative values, a few positive ones, so
      the boundary falls inside ~width equal zeros;
    - random: Gaussian values;
    - ties: values 0..3;
    - tile edges: values past 10, but for runs of eight 1.0 across every
      multiple of 64 columns (every tile edge of the route's tilings and
      of a small test tiling), enough for the boundary to fall in them;
    - inf: every value +inf;
    - pairs: values 0..2 with indices 0..4, so whole (value, index) keys
      repeat across the boundary;
    - near: values past 100 but for 3 k of them, 1 + j 2^-23 with j in
      0..4: five values that share their first 22 bits, each repeated, so
      the boundary falls in a run that only the last value digit tells
      apart.
    Indices are a permutation of each row, c -> (a c + b) mod width with
    a random a prime to width (non-monotone, cheap at 2^28 keys), but for
    `pairs`."""
    if kind == "zeros":
        v = np.where(rng.random((rows, width)) < 0.5, np.float32(-0.0), np.float32(0.0))
        for r in range(rows):
            hit = rng.choice(width, size=max(k // 2, 1) + 64, replace=False)
            v[r, hit[:max(k // 2, 1)]] = -rng.random(max(k // 2, 1)).astype(np.float32) - 0.5
            v[r, hit[max(k // 2, 1):]] = rng.random(64).astype(np.float32) + 0.5
    elif kind == "random":
        v = rng.normal(size=(rows, width)).astype(np.float32)
    elif kind == "ties":
        v = rng.integers(0, 4, size=(rows, width)).astype(np.float32)
    elif kind == "tile edges":
        v = (10.0 + rng.random((rows, width))).astype(np.float32)
        edges = np.arange(64, width, 64)
        run = (edges[:, None] + np.arange(-4, 4)[None, :]).reshape(-1)
        v[:, run] = 1.0
    elif kind == "inf":
        v = np.full((rows, width), np.inf, np.float32)
    elif kind == "pairs":
        v = rng.integers(0, 3, size=(rows, width)).astype(np.float32)
    elif kind == "near":
        v = (100.0 + rng.random((rows, width))).astype(np.float32)
        for r in range(rows):
            hit = rng.choice(width, size=min(3 * k, width), replace=False)
            v[r, hit] = (np.float32(1.0).view(np.int32)
                         + rng.integers(0, 5, size=hit.shape[0])).astype(np.int32).view(np.float32)
    else:
        raise ValueError(f"unknown kind {kind}")
    if kind == "pairs":
        return v, rng.integers(0, 5, size=(rows, width)).astype(np.int32)
    idx = np.empty((rows, width), np.int32)
    cols = np.arange(width, dtype=np.int64)
    for r in range(rows):
        a = int(rng.integers(1, width)) | 1
        while np.gcd(a, width) != 1:
            a += 2
        idx[r] = (a * cols + int(rng.integers(0, width))) % width
    return v, idx


def check_k1_split(dev: torch.device, rows: int, width: int, k: int, kind: str,
                   seed: int = 0) -> None:
    """K1 array-equal to its plain version on a K1_SPLIT_CASES case, in the
    row layout (with idx and with idx=None) and the column layout."""
    if not sortnet.split_route(rows, width, sortnet.k_pow2(k)):
        raise ValueError(f"[{rows}, {width}], k {k} does not take the split route")
    v, ix = k1_split_rows(np.random.default_rng((seed, rows, width, k)), kind, rows, width, k)
    vt, it = torch.from_numpy(v).to(dev), torch.from_numpy(ix).to(dev)
    _k1_layouts(vt, it, vt.T.contiguous(), it.T.contiguous(), k,
                f"[{rows}, {width}], k {k}, {kind}")


# K2's few-query route (Q <= fused_scan.FEWQ_MAX; K2_SHAPES' Q = 1 takes it
# too): Q 2-32; d 3 and 20 (rows copied element by element but for float32
# at d = 20), 128 (whole stages of 128 bytes a row) and 144 (16-byte copies
# with a last stage cut short in every operand); N from one group to 512
K2_FEWQ_SHAPES = tuple(itertools.product((2, 5, 8, 17, 32), (3, 20, 128, 144), (128, 65536)))
K2_INT8_SCALES = (1.0, 0.0371, 3.5)   # abs-max scales of the int8 corpus cases


def k2_cases(q_n: int, d: int, n: int, dev: torch.device, seed: int = 0):
    """K2's modes at one shape: (name, queries, corpus, mask, kwargs,
    cosine, exact). Integer data make float32 L2 exact; the bf16, float16
    and int8 operands are bit-equal to their plain versions on any data
    (float16 values past +-2048, where float16 rounds integers, and int8
    rows at several scales with bf16-rounded Gaussian queries)."""
    g = np.random.default_rng((seed, q_n, d, n))
    inf = torch.tensor(float("inf"), device=dev)
    valid = torch.from_numpy(g.random(n) > 0.1).to(dev)
    q = torch.from_numpy(g.integers(0, 256, size=(q_n, d)).astype(np.float32)).to(dev)
    x = torch.from_numpy(g.integers(0, 256, size=(n, d)).astype(np.float32)).to(dev)
    qg = torch.from_numpy(3.0 * g.normal(size=(q_n, d)).astype(np.float32)).to(dev)
    xg = torch.from_numpy(3.0 * g.normal(size=(n, d)).astype(np.float32)).to(dev)
    qc = torch.from_numpy(preprocess(g.normal(size=(q_n, d)).astype(np.float32),
                                     DistanceKind.COSINE)).to(dev)
    xc = torch.from_numpy(preprocess(g.normal(size=(n, d)).astype(np.float32),
                                     DistanceKind.COSINE)).to(dev)
    zero = torch.zeros((), device=dev)
    xh = (1000.0 * xg).to(torch.float16)      # |values| past 2048 round in float16
    x8 = torch.from_numpy(g.integers(-127, 128, size=(n, d)).astype(np.int8)).to(dev)

    def sqn8(sc):
        deq = x8.to(torch.float32) * torch.tensor(sc, dtype=torch.float32, device=dev)
        return (deq * deq).sum(1)

    probe = dict(assign=torch.from_numpy(g.integers(-1, 70, size=n).astype(np.int32)).to(dev),
                 probes=torch.from_numpy(g.integers(0, 70, size=(q_n, 8)).astype(np.int32)).to(dev),
                 nlist=70)
    return (
        ("float32 L2", q, x, torch.where(valid, (x * x).sum(1), inf), {}, False, True),
        ("float32 cosine", qc, xc, torch.where(valid, zero, inf), {}, True, False),
        ("nprobe L2", q, x, torch.where(valid, (x * x).sum(1), inf), probe, False, True),
        ("bf16 L2", qg, xg.to(torch.bfloat16), torch.where(valid, (xg * xg).sum(1), inf), {},
         False, True),
        ("bf16 cosine", qc, xc.to(torch.bfloat16), torch.where(valid, zero, inf), {}, True, True),
        ("float16 L2", 1000.0 * qg, xh, torch.where(valid, (xh.float() * xh.float()).sum(1), inf),
         {}, False, True),
        ("float16 cosine", qc, xc.to(torch.float16), torch.where(valid, zero, inf), {}, True, True),
    ) + tuple(
        (f"int8 L2 scale {sc}", qg, x8, torch.where(valid, sqn8(sc), inf), {"scale": sc}, False,
         True) for sc in K2_INT8_SCALES
    ) + (
        ("int8 cosine", qc, x8, torch.where(valid, zero, inf), {"scale": 1.0 / 127}, True, True),
    )


def check_k2(dev: torch.device, q_n: int, d: int, n: int, seed: int = 0) -> float:
    """K2's modes and operands against their plain versions at one shape, without
    and with a threshold (the median finite distance): array-equal where
    `exact`, float32 cosine allclose(1e-5, 1e-6) with flips only at the
    threshold. Returns the largest absolute error of a finite entry."""
    kb = min(8, n // 128)
    err = 0.0
    for name, q, x, mask, kw, cosine, exact in k2_cases(q_n, d, n, dev, seed):
        full = fused_scan._fused_dist_select_plain(q, x, mask, float("inf"), cosine, **kw)[0]
        fin = full[torch.isfinite(full)]
        for thr in (float("inf"), float(fin.median()) if fin.numel() else float("inf")):
            dist, gsel = fused_scan.fused_dist_select(q, x, mask, thr, kb, cosine, **kw)
            pdist, pgmin = fused_scan._fused_dist_select_plain(q, x, mask, thr, cosine, **kw)
            pgsel = sortnet._topk_rows_plain(pgmin, None, kb)[1][:, :kb]
            where = f"{name} at Q={q_n}, d={d}, N={n}, threshold {thr:g}"
            if exact:
                if not (torch.equal(dist, pdist) and torch.equal(gsel, pgsel)):
                    raise AssertionError(f"K2 {where} differs from its plain version")
                continue
            both = torch.isfinite(dist) & torch.isfinite(pdist)
            torch.testing.assert_close(dist[both], pdist[both], rtol=1e-5, atol=1e-6)
            # sums in another order may put a value on the other side of the
            # threshold, but only within the tolerance of it
            flip = torch.isfinite(dist) != torch.isfinite(pdist)
            near = torch.where(torch.isfinite(dist), dist, pdist)[flip]
            if ((near - thr).abs() > 1e-6 + 1e-5 * abs(thr)).any():
                raise AssertionError(f"K2 {where}: a masked entry differs")
            if both.any():
                err = max(err, (dist[both] - pdist[both]).abs().max().item())
    return err


def check_k2_fewq(dev: torch.device, q_n: int, d: int, n: int, seed: int = 0) -> float:
    """K2's few-query route at one shape: `check_k2` against the plain
    versions, then dist and the group minima bit-equal to the 128-query
    tile's in every mode and operand, also on Gaussian float32 data (where
    only the same sum order gives the same bits), without and with a
    threshold; each call through the route counts one FEWQ_LAUNCHES.
    Returns check_k2's largest absolute error."""
    if q_n > fused_scan.FEWQ_MAX:
        raise ValueError(f"Q={q_n} does not take the few-query route")
    err = check_k2(dev, q_n, d, n, seed)
    g = np.random.default_rng((seed, q_n, d, n, 1))
    qg = torch.from_numpy(g.normal(size=(q_n, d)).astype(np.float32)).to(dev)
    xg = torch.from_numpy(g.normal(size=(n, d)).astype(np.float32)).to(dev)
    gauss = ("float32 L2 Gaussian", qg, xg, (xg * xg).sum(1), {}, False, True)
    saved = fused_scan.FEWQ_MAX
    for name, q, x, mask, kw, cosine, _ in k2_cases(q_n, d, n, dev, seed) + (gauss,):
        for thr in (float("inf"), float(fused_scan._fused_dist_select_plain(
                q, x, mask, float("inf"), cosine, **kw)[0].nan_to_num(0.0, 0.0).median())):
            before = fused_scan.FEWQ_LAUNCHES
            got = fused_scan._fused_scan_cuda(q, x, mask, thr, cosine, **kw)
            if fused_scan.FEWQ_LAUNCHES != before + 1:
                raise AssertionError(f"K2 {name} at Q={q_n} did not take the few-query route")
            try:
                fused_scan.FEWQ_MAX = 0
                tile = fused_scan._fused_scan_cuda(q, x, mask, thr, cosine, **kw)
            finally:
                fused_scan.FEWQ_MAX = saved
            if not (torch.equal(got[0], tile[0]) and torch.equal(got[1], tile[1])):
                raise AssertionError(f"K2 {name} at Q={q_n}, d={d}, N={n}, threshold {thr:g}: "
                                     f"the few-query route differs from the 128-query tile")
    return err


# -- K3 ---------------------------------------------------------------------------

K3_MEMBER_COUNTS = (0, 1, 15, 16, 17, 64, 128)   # probing queries of a step's cluster
K3_LAYOUTS = ("counts", "one step", "ragged")
K3_CASES = tuple(itertools.product(K3_LAYOUTS, (3, 20, 100, 128)))   # (layout, d)
K3_CHUNKS = 16          # chunks of the cluster-major corpus
K3_P = 16               # probes a query


def k3_case(layout: str, d: int, seed: int = 0):
    """One K3 layout in numpy: (q [G 128, d] float32, x [16 * 256, d],
    valid [16 * 256] bool, probes [G 128, 16] int32, chunk_ids [G, S],
    cluster_ids [G, S] int32). Step s of a group names cluster s + 1 (-1 on
    a dead step); a query probes the clusters of its steps and fills its
    other probes with clusters no step names, so a step's member count is
    exact.

    - "counts": two groups of nine steps, the member counts of
      K3_MEMBER_COUNTS and two dead steps, shuffled;
    - "one step": S = 1, 40 members;
    - "ragged": 200 queries padded with zero rows to two groups (as the
      pipeline pads a batch), four steps of random member counts.
    Vectors are integers 0..255 (every float32 L2 distance exact)."""
    g = np.random.default_rng((seed, K3_LAYOUTS.index(layout), d))
    if layout == "counts":
        counts = [list(K3_MEMBER_COUNTS) + [-1, -1] for _ in range(2)]
        for c in counts:
            g.shuffle(c)
    elif layout == "one step":
        counts = [[40]]
    else:
        counts = [list(g.integers(0, 129, size=4)) for _ in range(2)]
    g_n, s_n = len(counts), len(counts[0])
    q_n = g_n * ivf_sparse.QG
    q = g.integers(0, 256, size=(q_n, d)).astype(np.float32)
    if layout == "ragged":
        q[200:] = 0.0
    x = g.integers(0, 256, size=(K3_CHUNKS * ivf_sparse.CHUNK, d)).astype(np.float32)
    valid = g.random(len(x)) > 0.1
    cluster_ids = np.array([[s + 1 if c >= 0 else -1 for s, c in enumerate(row)]
                            for row in counts], np.int32)
    chunk_ids = g.integers(0, K3_CHUNKS, size=(g_n, s_n)).astype(np.int32)
    # filler probes: clusters 40.. that no step names
    probes = (40 + g.integers(0, 24, size=(q_n, K3_P))).astype(np.int32)
    for gi, row in enumerate(counts):
        slot = np.zeros(ivf_sparse.QG, np.int64)
        for s, c in enumerate(row):
            for r in g.permutation(ivf_sparse.QG)[:max(c, 0)]:
                probes[gi * ivf_sparse.QG + r, slot[r]] = s + 1
                slot[r] += 1
    probes = np.take_along_axis(probes, np.argsort(g.random(probes.shape), axis=1), axis=1)
    return q, x, valid, probes, chunk_ids, cluster_ids


def check_k3_minima(filled, got, where: str):
    """K3's shortlist mode (`minima=True`) against its exact-search mode on
    the same inputs: `filled` (cand, chunk_tab, None) of the exact-search
    mode, `got` (cand, chunk_tab, gmin) of the shortlist mode. The chunk
    tables equal, gmin equal to each 128-place group's minimum of the
    filled row, and every group whose minimum is finite equal to the
    filled row's; the rest of the shortlist mode's row is not read."""
    cand, tab, _ = filled
    gcand, gtab, gmin = got
    rows = cand.shape[0]
    if not torch.equal(gtab, tab):
        raise AssertionError(f"K3 {where}: the chunk table of the shortlist mode differs")
    groups = cand.view(rows, -1, ivf_sparse.SEL_GROUP)
    if not torch.equal(gmin, groups.amin(dim=2)):
        raise AssertionError(f"K3 {where}: the group minima differ from the row's")
    fin = torch.isfinite(gmin)
    if not torch.equal(gcand.view(rows, -1, ivf_sparse.SEL_GROUP)[fin], groups[fin]):
        raise AssertionError(f"K3 {where}: a scanned group of the shortlist mode differs")


def check_k3(dev: torch.device, layout: str, d: int, seed: int = 0) -> float:
    """K3 in both modes, L2 and cosine, without and with a threshold (the
    median finite distance), against its plain version on one `k3_case`:
    the rows and their chunk table array-equal (float32 cosine
    allclose(1e-5, 1e-6), flips only at the threshold), one launch a scan
    counted in the mode's counter. K3 works chunk by chunk and needs a chunk
    to belong to one cluster: it reads the layout with step s naming cluster
    s + 1 and that cluster owning chunk s alone (every other cluster
    empty), so the members of a chunk are those of its step in both groups
    (up to 256). The shortlist mode (`minima=True`) is held to the
    exact-search mode by `check_k3_minima`. Returns the largest absolute
    error of a finite entry."""
    qn_, xn, valid, probes, chunk_ids, cluster_ids = k3_case(layout, d, seed)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    inf = torch.tensor(float("inf"), device=dev)
    zero = torch.zeros((), device=dev)
    q, x, ok = t(qn_), t(xn), t(valid)
    nlist, s_n = 64, chunk_ids.shape[1]
    nchunks = np.zeros(nlist, np.int32)
    nchunks[1:s_n + 1] = 1
    chunk_start = np.concatenate([[0], np.cumsum(nchunks)]).astype(np.int32)
    lists = (t(probes), t(np.tile(np.arange(s_n, dtype=np.int32), (len(chunk_ids), 1))),
             t(cluster_ids), t(chunk_start), t(nchunks), K3_P, 1,
             ivf_sparse.compact_width(K3_P, 1))
    xc = x / torch.linalg.vector_norm(x, dim=1, keepdim=True).clamp_min(1.0)
    qc = q / torch.linalg.vector_norm(q, dim=1, keepdim=True).clamp_min(1.0)
    g = np.random.default_rng((seed, d))
    live = (np.abs(qn_).sum(axis=1, keepdims=True) > 0).astype(np.float32)  # zero rows stay zero
    qg = t(3.0 * g.normal(size=qn_.shape).astype(np.float32) * live)
    xg = t(3.0 * g.normal(size=xn.shape).astype(np.float32))
    xgb = xg.to(torch.bfloat16)
    # (name, queries, corpus, mask, cosine, qn, exact)
    modes = (
        ("float32 L2", q, x, torch.where(ok, (x * x).sum(1), inf), False, None, True),
        ("float32 cosine", qc, xc, torch.where(ok, zero, inf), True, None, False),
        ("bf16 L2", qg, xgb, torch.where(ok, bf16_round((xg * xg).sum(1)), inf), False,
         (qg * qg).sum(1), True),
        ("bf16 cosine", qc, xc.to(torch.bfloat16), torch.where(ok, zero, inf), True, None, True),
    )
    err = 0.0
    for name, qq, xx, mask, cosine, qn, exact in modes:
        full = ivf_sparse._compact_scan_plain(qq, xx, mask, *lists, float("inf"), cosine, qn)[0]
        fin = full[torch.isfinite(full)]
        for thr in (float("inf"), float(fin.median()) if fin.numel() else float("inf")):
            counter = "BF16_LAUNCHES" if xx.dtype == torch.bfloat16 else "LAUNCHES"
            before = getattr(ivf_sparse, counter)
            filled = ivf_sparse._compact_scan_cuda(qq, xx, mask, *lists, thr, cosine, qn)
            if getattr(ivf_sparse, counter) != before + 1:
                raise AssertionError(f"K3 {name} did not count one launch")
            cand, tab, _ = filled
            pcand, ptab, _ = ivf_sparse._compact_scan_plain(qq, xx, mask, *lists, thr, cosine, qn)
            where = f"{name} on the {layout!r} layout, d={d}, threshold {thr:g}"
            check_k3_minima(filled, ivf_sparse._compact_scan_cuda(
                qq, xx, mask, *lists, thr, cosine, qn, minima=True), where)
            if not torch.equal(tab, ptab):
                raise AssertionError(f"K3 {where}: the chunk table differs from plain")
            if exact:
                if not torch.equal(cand, pcand):
                    raise AssertionError(f"K3 {where}: the rows differ from plain")
                continue
            both = torch.isfinite(cand) & torch.isfinite(pcand)
            torch.testing.assert_close(cand[both], pcand[both], rtol=1e-5, atol=1e-6)
            flip = torch.isfinite(cand) != torch.isfinite(pcand)
            near = torch.where(torch.isfinite(cand), cand, pcand)[flip]
            if ((near - thr).abs() > 1e-6 + 1e-5 * abs(thr)).any():
                raise AssertionError(f"K3 {where}: a masked entry differs")
            if both.any():
                err = max(err, (cand[both] - pcand[both]).abs().max().item())
    return err


# Whole pipelines on one layout: (name, what it exercises)
K3_ROUTE_LAYOUTS = (
    "dead steps",      # an ample step budget: most steps of a group dead
    "overflow",        # a step budget the groups overflow (the rescan path's input)
    "empty probes",    # queries whose probed clusters are all empty
    "threshold",       # a threshold that drops rows
    "filter",          # a doc-ID filter: every third slot masked
    "narrow",          # a compact row narrower than k_pow2(k): one probe of one chunk
    "ragged",          # 200 queries, padded to two groups
    "ties",            # 0/1 vectors: 29 or more equal distances across the 128th place
)
K3_ROUTE_CASES = tuple(itertools.product(K3_ROUTE_LAYOUTS, (3, 20, 100, 128), (False, True)))


def k3_route_case(layout: str, d: int, seed: int = 0) -> dict:
    """One IVF layout for whole pipelines, numpy: integer rows (0..255, or 0/1
    for "ties") in clusters of 0-3 chunks (one chunk for "narrow"), integer
    centroids, every third cluster's rows scattered so that lists overlap
    in distance, and the pipeline's arguments: x [N, d], slot_ok [N] (the
    filter), centroids, assign, queries, k, nprobe, S, thr."""
    g = np.random.default_rng((seed, K3_ROUTE_LAYOUTS.index(layout), d))
    nlist, hi = 24, (2 if layout == "ties" else 256)
    sizes = g.integers(0, 700, size=nlist)
    if layout == "narrow":
        sizes = g.integers(1, 257, size=nlist)
    sizes[5] = 0
    cents = g.integers(0, hi, size=(nlist, d)).astype(np.float32)
    if layout == "empty probes":
        sizes[:4] = 0
        cents[1:4] = cents[0]
        cents[1:4, 0] = np.minimum(cents[0, 0] + np.arange(1, 4), 255)
    assign = np.repeat(np.arange(nlist), sizes).astype(np.int32)
    q_n = 200 if layout == "ragged" else 256
    q = cents[g.integers(0, nlist, size=q_n)]
    if hi > 2:
        x = np.clip(cents[assign] + g.integers(-40, 41, size=(len(assign), d)), 0, hi - 1)
        q = np.clip(q + g.integers(-30, 31, size=q.shape), 0, hi - 1)
    else:   # a tenth of the bits flipped
        x = np.abs(cents[assign] - (g.random((len(assign), d)) < 0.1))
        q = np.abs(q - (g.random(q.shape) < 0.1))
    spread = assign % 3 == 0
    x[spread] = g.integers(0, hi, size=(int(spread.sum()), d))
    if layout == "empty probes":
        q[:9] = cents[0]
    slot_ok = np.ones(len(x), bool)
    if layout == "filter":
        slot_ok[::3] = False
    return dict(x=x.astype(np.float32), slot_ok=slot_ok, cents=cents, assign=assign,
                q=q.astype(np.float32), k={"narrow": 300, "overflow": 16}.get(layout, 100),
                nprobe={"narrow": 1, "empty probes": 4, "overflow": 6}.get(layout, 3),
                S=8 if layout == "overflow" else 128,
                thr=float(900 * d) if layout == "threshold" else INF)


def k3_route_args(dev: torch.device, c: dict, bf16: bool) -> tuple:
    """The positional arguments of `ivf_sparse_pipeline` for one
    `k3_route_case` on dev, the corpus bfloat16 in the bf16 mode (HNSW's
    seed scan), its mask the float32 value of each row's bf16 squared
    norm."""
    lay = ivf_sparse.build_cluster_major(c["assign"], len(c["cents"]))
    perm = lay["perm"]
    pc = np.maximum(perm, 0)
    ok = (perm >= 0) & c["slot_ok"][pc]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    xr = t(c["x"][pc])
    sq = (xr * xr).sum(dim=1)
    corpus = xr
    if bf16:
        corpus, sq = xr.to(torch.bfloat16), bf16_round(sq)
    mask = torch.where(t(ok), sq, torch.full_like(sq, INF))
    nlist, S = len(c["cents"]), c["S"]
    return (t(c["q"]), corpus, mask, t(perm), c["thr"], t(c["cents"]),
            t(np.arange(nlist, dtype=np.int32) % 5), t(lay["chunk_start"]), t(lay["nchunks"]),
            c["k"], c["nprobe"], S, min(S, nlist), lay["max_chunks"], nlist)


def plain_shortlist(q, corpus, mask, row_slot, thr, cents, order_key, chunk_start, nchunks,
                    k, nprobe, S, UC, MC, nlist, kb_cap: int, qn=None):
    """`ivf_sparse_pipeline(..., sqrt_out=True, kb_cap=kb_cap, qn=qn)` as
    the reference computes it, in plain PyTorch, for a batch in one slice:
    the [G, QG, S x 256] tile of `_sparse_scan_plain`, each query's top-kb
    selection groups of it by (minimum, position), their distances
    gathered, the candidate select, the slots in (score, slot) order.
    Returns (scores, slots, overflow)."""
    q_n = q.shape[0]
    pad = -(-q_n // ivf_sparse.QG) * ivf_sparse.QG - q_n
    q = torch.cat([q, q.new_zeros((pad, q.shape[1]))])
    if qn is not None:
        qn = torch.cat([qn, qn.new_zeros(pad)])
    rows = q.shape[0]
    plan = ivf_sparse.scan_plan(q, cents, order_key, chunk_start, nchunks, k, nprobe, S, UC, MC,
                                nlist, False, kb_cap)
    kb, S, grp = plan["kb"], plan["S"], ivf_sparse.SEL_GROUP
    dist, gmin = ivf_sparse._sparse_scan_plain(
        plan["qsorted"], corpus, mask, plan["probes"], plan["chunk_ids"], plan["cluster_ids"],
        float(np.float32(thr)), False, None if qn is None else qn[plan["qperm"]])
    gsel = sortnet._topk_rows_plain(gmin.view(rows, 2 * S), None, kb)[1][:, :kb].long()
    cand = dist.view(rows, 2 * S, grp).gather(1, gsel[:, :, None].expand(rows, kb, grp))
    pos = (gsel[:, :, None] * grp + torch.arange(grp, device=q.device)).reshape(rows, kb * grp)
    fv, fi = sortnet._topk_rows_plain(cand.reshape(rows, kb * grp), pos.int(), k)
    # position -> step -> cluster-major row -> slot
    ok = torch.isfinite(fv) & (fi != ivf_sparse.IDX_SENTINEL)
    fi = torch.where(ok, fi, 0).long()
    chunks = plan["chunk_ids"].repeat_interleave(ivf_sparse.QG, dim=0).long()
    row = chunks.gather(1, fi // ivf_sparse.CHUNK) * ivf_sparse.CHUNK + fi % ivf_sparse.CHUNK
    slot = torch.where(ok, row_slot[row], ivf_sparse.IDX_SENTINEL)
    fv, slot = sortnet._topk_rows_plain(torch.where(ok, fv, INF), slot, fv.shape[1])
    inv = torch.argsort(plan["qperm"])
    return sqrt_f32(fv[:, :k])[inv][:q_n], slot[:, :k][inv][:q_n], plan["overflow"]


def check_k3_routes(dev: torch.device, layout: str, d: int, bf16: bool, seed: int = 0):
    """Two checks through `ivf_sparse_pipeline` on one `k3_route_case`, in
    float32 and in the bf16 mode: a shortlist at the exact bound (kb_cap =
    k, which keeps every selection group the exact search needs) equals
    the exact search (kb_cap = 0), and a shortlist below it (kb_cap = 8)
    equals `plain_shortlist`, the reference tile's; scores, slots and
    overflow array-equal, boundary ties included. On the card each
    pipeline launches K3 once. Returns (scores, slots, overflow) of the
    exact search."""
    c = k3_route_case(layout, d, seed)
    args = k3_route_args(dev, c, bf16)
    out = {}
    for kb_cap in (0, c["k"], 8):
        counter = "BF16_LAUNCHES" if bf16 else "LAUNCHES"
        before = getattr(ivf_sparse, counter)
        out[kb_cap] = ivf_sparse.ivf_sparse_pipeline(
            *args, sqrt_out=True, bf16_domain=bf16, kb_cap=kb_cap)
        if dev.type == "cuda" and getattr(ivf_sparse, counter) != before + 1:
            raise AssertionError(f"K3 did not launch once at kb_cap={kb_cap}")
    where = f"{layout!r}, d={d}, {'bf16' if bf16 else 'float32'}"
    pairs = (("a shortlist at the exact bound", out[c["k"]], out[0]),
             ("a shortlist of 8 groups", out[8], plain_shortlist(*args, 8)))
    for what, got, want in pairs:
        for name, a, b in zip(("scores", "slots", "overflow"), got, want):
            if not torch.equal(a, b):
                raise AssertionError(f"K3 on {where}: the {name} of {what} differ")
    s, i, ov = (a.cpu().numpy() for a in out[0])
    hit = i != ivf_sparse.IDX_SENTINEL
    checks = {
        "overflow": ov.max() > 0,
        "empty probes": (~hit[:9]).all() and hit[9:].any(),
        "threshold": (~hit).any() and hit.any(),
        "filter": hit.any() and (i[hit] % 3 != 0).all(),
        "narrow": (~hit).any(),
    }
    if not checks.get(layout, ov.max() == 0 and hit.any()):
        raise AssertionError(f"K3 on {where}: the layout missed its case")
    if layout == "ties":
        # the exact distances of each query's probed rows, in float64
        probes = fused_scan.coarse_probes(args[0], args[5], c["nprobe"], False,
                                          fused_scan.probe_pad(c["nprobe"])).cpu().numpy()
        x64, q64 = c["x"].astype(np.float64), c["q"].astype(np.float64)
        widest = 0
        for r in range(len(q64)):
            rows = np.flatnonzero(np.isin(c["assign"], probes[r]))
            dd = np.sort(((x64[rows] - q64[r]) ** 2).sum(axis=1))
            if len(dd) > 128:
                widest = max(widest, int((dd == dd[127]).sum()))
        if widest < 29:
            raise AssertionError(f"K3 on {where}: {widest} ties at the 128th place")
    return out[0]


# -- K4 ---------------------------------------------------------------------------

# (Q, ef, ew, expand, stop, kr): kr = 0 is the split mode
K4_CASES = (
    (300, 256, 256, 8, 256, 0), (300, 256, 256, 8, 64, 256),
    (257, 100, 40, 1, 17, 0), (257, 100, 40, 23, 100, 48),
    (130, 64, 7, 1, 1, 0), (130, 64, 7, 5, 30, 100),
    (70, 33, 200, 23, 33, 0), (70, 16, 300, 4, 8, 37),
)
K4_SENT = 2**31 - 1


def _k4_rows(g: np.random.Generator, table: np.ndarray, width: int, out_of_order: bool,
             gaps: bool = True):
    """Sorted rows (dist, slot) of distinct slots drawn from a per-query
    slot -> dist table; with `gaps`, (+inf, SENT) rows past a random length
    and a few (+inf, slot) rows; with `out_of_order`, the rows of tied
    distances of half the queries in random order (the rest sorted by
    (dist, slot)), and a few queries not sorted at all."""
    q_n, cap = table.shape
    slots = np.argsort(g.random((q_n, cap)), axis=1)[:, :width].astype(np.int64)
    dist = np.take_along_axis(table, slots, axis=1)
    if gaps:
        dist[g.random(dist.shape) < 0.05] = np.inf
        n = g.integers(0, width + 1, size=q_n)
        empty = np.arange(width)[None, :] >= n[:, None]
        dist = np.where(empty, np.inf, dist)
        slots = np.where(empty, K4_SENT, slots)
    dist = dist.astype(np.float32)
    tie = g.random((q_n, width)) if out_of_order else slots.astype(np.float64)
    order = np.lexsort((tie, dist), axis=1)
    if out_of_order:
        order[: q_n // 2] = np.lexsort((slots, dist), axis=1)[: q_n // 2]
        order[-3:] = np.argsort(g.random((3, width)), axis=1)
    dist, slots = np.take_along_axis(dist, order, 1), np.take_along_axis(slots, order, 1)
    return dist, slots.astype(np.int32)


def k4_case(q_n: int, ef: int, ew: int, kr: int, seed: int = 0, mid_search: bool = False):
    """A K4 input in numpy: (beam_d, beam_s, beam_e [Q, ef], new_d, new_s
    [Q, ew], res_d, res_s [Q, kr], adm [Q, ew]). Distances are integers
    0..7 from a per-query slot table (ties across the beam, the candidates
    and the result set; copies of a slot carry its one distance). The
    candidates mix fresh slots, copies of beam slots and copies among
    themselves, (+inf, SENT) and (+inf, slot) rows. With `mid_search` the
    state of a running search instead: distances uniform in [0, 10), and a
    full beam and result set sorted by (dist, slot)."""
    g = np.random.default_rng((seed, q_n, ef, ew, kr))
    cap = max(2 * (ef + ew + kr), 64)
    if mid_search:
        table = (10 * g.random((q_n, cap))).astype(np.float32)
    else:
        table = g.integers(0, 8, size=(q_n, cap)).astype(np.float32)
    edge = not mid_search
    bd, bs = _k4_rows(g, table, ef, out_of_order=edge, gaps=edge)
    be = np.where(bs != K4_SENT, g.integers(0, 2, size=bs.shape), 0).astype(np.int32)
    ns = g.integers(0, cap, size=(q_n, ew))
    from_beam = g.random((q_n, ew)) < 0.3
    ns = np.where(from_beam, np.take_along_axis(bs, g.integers(0, ef, size=(q_n, ew)), 1), ns)
    ns = np.where(g.random((q_n, ew)) < 0.2, np.take_along_axis(ns, g.integers(0, ew, size=(q_n, ew)), 1), ns)
    nd = np.take_along_axis(table, np.minimum(ns, cap - 1), 1)
    nd = np.where(ns == K4_SENT, np.inf, nd)
    empty = g.random((q_n, ew)) < 0.1
    nd = np.where(empty, np.inf, nd).astype(np.float32)
    ns = np.where(empty, K4_SENT, ns).astype(np.int32)
    nd[g.random((q_n, ew)) < 0.03] = np.inf          # (+inf, slot) rows
    rd, rs = _k4_rows(g, table, max(kr, 1), out_of_order=edge, gaps=edge)
    adm = (g.random((q_n, ew)) < 0.6).astype(np.int32)
    return bd, bs, be, nd, ns, rd[:, :kr], rs[:, :kr], adm


def equal(what: str, got, want, names=None) -> None:
    """Each output of `got` (a tensor or None) equal to `want`'s; raises
    naming the first that differs (`names[i]`, else its index)."""
    for i, (a, b) in enumerate(zip(got, want)):
        if (a is None) != (b is None) or (a is not None and not torch.equal(a, b)):
            raise AssertionError(f"{what}: {names[i] if names else f'output {i}'} differs")


def check_k4(dev: torch.device, q_n: int, ef: int, ew: int, expand: int, stop: int, kr: int,
             seed: int = 0) -> None:
    """K4 (`beam_merge_step`, fused when kr > 0) array-equal to its plain
    version on `k4_case`, one launch counted in the mode's counter."""
    arrs = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in k4_case(q_n, ef, ew, kr, seed)]
    bd, bs, be, nd, ns, rd, rs, adm = arrs
    fused = kr > 0
    extra = dict(res_d=rd, res_s=rs, adm=adm) if fused else {}
    before = (beam_kernel.LAUNCHES, beam_kernel.FUSED_LAUNCHES)
    got = beam_kernel.beam_merge_step(bd, bs, be, nd, ns, **extra, ef=ef, ew=ew, expand=expand,
                                      fused=fused, kr=kr, stop=stop)
    if (beam_kernel.LAUNCHES, beam_kernel.FUSED_LAUNCHES) != (before[0] + (not fused),
                                                              before[1] + fused):
        raise AssertionError("K4 did not count one launch in its mode's counter")
    want = beam_kernel._merge_plain(bd, bs, be, nd, ns, rd if fused else None,
                                    rs if fused else None, adm if fused else None,
                                    ef, ew, expand, fused, kr, stop)
    equal(f"K4 against its plain version at Q={q_n}, ef={ef}, ew={ew}, expand={expand}, "
          f"stop={stop}, kr={kr}", got, want, ("beam_d", "beam_s", "beam_e", "misc", "res_d",
                                               "res_s"))


# (Q, E, W, d, cap) of the scoring kernel and K5: W 1-64, d 3-1536, expand
# 1, 8 and 23 (several staging passes at W = 32, d = 128), Q 1, 130 and
# 2048; cap 16500 > 128^2 makes ndig = 3, W = 4, d = 16 at cap 4096 packed
# rows of 152 bytes, d = 3 and d = 100 vectors off a 16-byte boundary;
# W = 32 at d = 1536 and W = 64 at d = 768, where two buffers of one node
# pass the staging budget, so a pass holds a slice of a node's neighbours.
SCORE_CASES = (
    (1, 1, 1, 3, 4096), (130, 8, 1, 16, 16500), (2048, 23, 1, 100, 4096),
    (130, 1, 1, 128, 4096), (2048, 8, 4, 3, 4096), (130, 8, 4, 16, 4096),
    (1, 23, 4, 16, 4096), (130, 23, 4, 100, 16500), (2048, 1, 4, 128, 4096),
    (130, 23, 12, 3, 16500), (2048, 1, 12, 16, 4096), (130, 8, 12, 100, 4096),
    (1, 8, 12, 128, 16500), (2048, 8, 32, 3, 4096), (130, 1, 32, 16, 16500),
    (1, 23, 32, 100, 4096), (2048, 23, 32, 128, 4096), (2048, 8, 32, 128, 16500),
    (130, 23, 32, 128, 16500), (130, 8, 32, 1536, 16500), (130, 8, 64, 768, 4096),
)


def scoring_case(dev: torch.device, q_n: int, e: int, w: int, d: int, cap: int, seed: int = 0):
    """A graph of cap Gaussian rows with a random adjacency (a fifth of the
    entries empty, row 1 all empty), its routing tables and an iteration's
    nodes: a seventh -1, row 1 expanded by query 0, and the last query of
    several with nothing to expand. Returns (tables {name: (nbr_vecs, aux,
    nodes)}, qb, qn, allowed): the blocked pair, the packed table and,
    where a packed row is not a whole number of 16-byte units, the packed
    table from its second row (every row's start shifted off the
    boundaries the first layout had)."""
    g = np.random.default_rng((seed, q_n, e, w, d, cap))
    x = torch.from_numpy(g.normal(size=(cap, d)).astype(np.float32)).to(dev)
    adj = g.integers(0, cap, size=(cap, w)).astype(np.int32)
    adj[g.random(adj.shape) < 0.2] = -1
    adj[1] = -1
    nodes = g.integers(0, cap, size=(q_n, e)).astype(np.int32)
    nodes[g.random(nodes.shape) < 0.15] = -1
    nodes[0, 0] = 1
    if q_n > 1:
        nodes[-1] = -1
    q = torch.from_numpy(g.normal(size=(q_n, d)).astype(np.float32)).to(dev)
    allowed = torch.from_numpy(g.random(cap) < 0.7).to(dev)
    adj_t, nodes_t = torch.from_numpy(adj).to(dev), torch.from_numpy(nodes).to(dev)
    sqn = (x * x).sum(dim=1)
    nbr_vecs, aux = beam_kernel.build_blocked_tables(adj_t, x, sqn)
    packed = beam_kernel.build_packed_table(adj_t, x, sqn)
    tables = {"blocked": (nbr_vecs, aux, nodes_t), "packed": (packed, None, nodes_t)}
    if packed.shape[1] * 2 % 16:
        tables["packed, shifted"] = (packed[1:], None,
                                     torch.where(nodes_t < cap - 1, nodes_t, -1))
    return tables, q.to(torch.bfloat16), beam_kernel.row_sqnorms(q), allowed


def check_scoring(dev: torch.device, q_n: int, e: int, w: int, d: int, cap: int,
                  seed: int = 0) -> None:
    """The scoring kernel (`gather_score`) bit-equal to its plain version in
    every layout of `scoring_case` and both modes (nd, ns and adm), one
    launch counted in the layout's counter; the packed layout also equal
    to the blocked one."""
    tables, qb, qn, allowed = scoring_case(dev, q_n, e, w, d, cap, seed)
    nbr_vecs, aux, nodes = tables["blocked"]
    nd = beam_kernel._gather_score_plain(qb, qn, nbr_vecs, aux, nodes, None, INF, False)[0]
    fin = nd[torch.isfinite(nd)]
    thr = float(fin.median()) if fin.numel() else INF
    for fused in (False, True):
        blocked = None
        for layout, (table, aux, nodes) in tables.items():
            args = (qb, qn, table, aux, nodes, allowed, thr, fused)
            before = (beam_kernel.SCORE_LAUNCHES, beam_kernel.PACKED_SCORE_LAUNCHES)
            got = beam_kernel.gather_score(*args)
            packed = aux is None
            if (beam_kernel.SCORE_LAUNCHES, beam_kernel.PACKED_SCORE_LAUNCHES) != (
                    before[0] + (not packed), before[1] + packed):
                raise AssertionError("the scoring kernel did not count one launch in its "
                                     "layout's counter")
            what = (f"scoring kernel, {layout} table, {'fused' if fused else 'split'} mode, "
                    f"Q={q_n} E={e} W={w} d={d} cap={cap}")
            equal(what, got, beam_kernel._gather_score_plain(*args))
            if layout == "blocked":
                blocked = got
            elif layout == "packed":
                equal(what + " against the blocked table", got, blocked)


def check_k5(dev: torch.device, q_n: int, e: int, w: int, d: int, cap: int,
             seed: int = 0) -> None:
    """K5 (`fused_expand_merge`) bit-equal to its plain version and to the
    split pair's kernels (packed scoring, then K4 split), over each packed
    table of `scoring_case`, at stop = ef and stop < ef, one launch
    counted; the beam is `k4_case`'s running state with its distances
    scaled by a power of two to the candidates' range."""
    tables, qb, qn, _ = scoring_case(dev, q_n, e, w, d, cap, seed)
    ef = 256 if q_n > 1000 else 64
    ew = e * w
    bd, bs, be = (torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                  for a in k4_case(q_n, ef, ew, 0, seed, mid_search=True)[:3])
    for layout, (table, aux, nodes) in tables.items():
        if aux is not None:
            continue
        nd, ns, _ = beam_kernel.gather_score(qb, qn, table, None, nodes, None, INF, False)
        fin = nd[torch.isfinite(nd)]
        mid = float(fin.median()) if fin.numel() else 5.0
        bds = bd * 2.0 ** round(float(np.log2(max(mid, 1e-3) / 5)))
        for stop in (ef, max(1, ef // 4)):
            before = beam_kernel.FUSE_LAUNCHES
            got = beam_kernel.fused_expand_merge(nodes, table, qb, qn, bds, bs, be, ef=ef,
                                                 expand=e, stop=stop)
            if beam_kernel.FUSE_LAUNCHES != before + 1:
                raise AssertionError("K5 did not count one launch")
            what = f"K5, {layout} table, Q={q_n} E={e} W={w} d={d} cap={cap} ef={ef} stop={stop}"
            equal(what, got, beam_kernel._fused_expand_plain(nodes, table, qb, qn, bds, bs, be,
                                                              ef, e, stop))
            split = beam_kernel.beam_merge_step(bds, bs, be, nd, ns, ef=ef, ew=ew, expand=e,
                                                fused=False, stop=stop)
            equal(what + " against the split pair", got, split[:4])


# BM25 scorer cases: (name, n_pad, Q, k, chunk rows or None for the default)
BM25_CASES = (
    ("empty queries", 1000, 7, 10, None),
    ("a term without postings", 1000, 9, 10, None),
    ("a term covering every document", 4099, 33, 100, None),
    ("repeated terms", 2048, 17, 10, None),
    ("every document deleted", 1000, 5, 10, None),
    ("every document filtered out", 777, 6, 10, None),
    ("k above the matches", 300, 6, 1024, None),
    ("documents at the padding edge", 513, 9, 10, None),
    ("Q not a multiple of the block or the chunk", 2000, 37, 10, 8),
    ("k = 1", 5000, 12, 1, None),
    ("k = 1024", 20000, 12, 1024, None),
    # the kernel's tiling (ops/bm25.tile_shape; tiles of 128 documents here
    # on a card of 132 SMs, 256 and 1024 for the two one-query cases)
    ("n_pad not a multiple of the tile", 5000, 20, 10, None),
    ("a run across tiles and a run in the last partial tile", 3001, 16, 10, None),
    ("one query over a small segment", 70_000, 1, 10, None),
    ("one query over a large segment", 330_000, 1, 10, None),
    ("Q not a multiple of the query group", 3000, 37, 10, None),
    ("the same term at the same position in every query", 2000, 40, 10, None),
    ("the same term at different positions", 2000, 40, 10, None),
    ("queries longer than a window of term positions", 2000, 20, 10, None),
    ("untouched allowed documents beside filtered ones", 3001, 12, 1024, None),
)


def bm25_case(name: str, n_pad: int, q_n: int, seed: int = 0) -> dict:
    """A scorer input (numpy, the argument names of `bm25.bm25_topk`): 40
    terms over n_pad documents (postings by ascending slot, tf 1..5, term 0
    covering every document, term 1 none), Q queries of 0-6 terms, float32
    idf from the float64 formula at N = n_pad, allowed 90 %; the case's
    name shapes the terms, the queries or the mask."""
    g = np.random.default_rng((seed, n_pad, q_n, len(name)))
    n_terms = 40
    dfs = g.integers(0, n_pad + 1, size=n_terms)
    dfs[0], dfs[1] = n_pad, 0
    if name == "untouched allowed documents beside filtered ones":
        dfs[2:] = g.integers(0, n_pad // 50, size=n_terms - 2)
    runs = []
    for t, df in enumerate(dfs.tolist()):
        docs = np.sort(g.choice(n_pad, size=df, replace=False))
        if name == "documents at the padding edge" and 0 < df < n_pad:
            docs = np.unique(np.concatenate([docs[:-2], [0, n_pad - 1]]))
        if name == "a run across tiles and a run in the last partial tile" and t in (2, 3):
            # n_pad % 128 >= 5: the last 5 documents lie in the last tile
            # whatever its power-of-two size past 128
            docs = np.arange(n_pad - 5, n_pad) if t == 2 else np.arange(100, n_pad - 300, 3)
        dfs[t] = len(docs)
        runs.append(docs)
    post_slot = np.concatenate(runs).astype(np.int32)
    post_tf = g.integers(1, 6, size=len(post_slot)).astype(np.float32)
    starts = np.cumsum(dfs) - dfs
    counts = g.integers(0, 7, size=q_n)
    if name == "empty queries":
        counts[::2] = 0
    terms = [g.integers(0, n_terms, size=c) for c in counts]
    if name == "repeated terms":
        terms = [np.repeat(t[:3], 2) for t in terms]
    if name == "a term without postings":
        terms = [np.append(t, 1) for t in terms]
    if name == "a term covering every document":
        terms = [np.append(t, [0, 0]) for t in terms]
    if name == "a run across tiles and a run in the last partial tile":
        terms = [np.concatenate([t, [2, 3]] if i % 2 else [[3], t, [2]])
                 for i, t in enumerate(terms)]
    if name.startswith("one query over"):   # a 2-term query and its whitespace term
        terms = [np.array([g.integers(2, n_terms), 0, g.integers(2, n_terms)])]
    if name == "the same term at the same position in every query":
        # term 7 first, term 0 at every odd position (the whitespace term of
        # multi-word queries)
        terms = [np.concatenate([[7], np.column_stack([np.zeros_like(t), t]).ravel()])
                 for t in terms]
    if name == "the same term at different positions":
        terms = [np.insert(t, min(i % 5, len(t)), 9) for i, t in enumerate(terms)]
    if name == "queries longer than a window of term positions":
        terms = [g.integers(0, n_terms, size=g.integers(30, 80)) for _ in terms]
    if name == "untouched allowed documents beside filtered ones":
        terms = [t[t > 0] for t in terms]
    tids = np.concatenate(terms + [np.zeros(0, np.int64)]).astype(np.int64)
    n = float(n_pad)
    idf = [np.float32(np.log((n - d + 0.5) / (d + 0.5) + 1.0)) for d in dfs[tids].tolist()]
    allowed = g.random(n_pad) < (0.5 if name.startswith("untouched") else 0.9)
    if name in ("every document deleted", "every document filtered out"):
        allowed[:] = False
    doc_len = g.integers(1, 120, size=n_pad).astype(np.float32)
    return {
        "post_slot": post_slot, "post_tf": post_tf, "t_start": starts[tids].astype(np.int64),
        "t_len": dfs[tids].astype(np.int32), "t_idf": np.asarray(idf, np.float32),
        "q_off": np.concatenate([[0], np.cumsum([len(t) for t in terms])]).astype(np.int64),
        "doc_len": doc_len, "allowed": allowed, "avgdl": np.float32(doc_len.mean()),
    }


def bm25_tensors(case: dict, dev: torch.device) -> dict:
    """`bm25_case`'s arrays as tensors on `dev` (q_off and avgdl stay on
    the host)."""
    return {key: (torch.from_numpy(v).to(dev) if key not in ("q_off", "avgdl") else v)
            for key, v in case.items()}


def check_bm25(dev: torch.device, name: str, n_pad: int, q_n: int, k: int, chunk,
               seed: int = 0) -> float:
    """The BM25 scorer (`bm25.bm25_topk`) bit-equal to `_bm25_score_plain`
    on `bm25_case`'s input, and its dense rows to the plain rows, one
    launch a chunk. Returns the largest score difference (0)."""
    args = bm25_tensors(bm25_case(name, n_pad, q_n, seed), dev)
    saved = bm25.SCORE_BYTES_MAX
    if chunk is not None:
        bm25.SCORE_BYTES_MAX = 12 * n_pad * chunk
    try:
        before = bm25.LAUNCHES
        got = bm25.bm25_topk(**args, k=k)
        launches = bm25.LAUNCHES - before
        want = bm25._bm25_score_plain(**args, k=k)
    finally:
        bm25.SCORE_BYTES_MAX = saved
    what = f"BM25 scorer ({name}, n_pad {n_pad}, Q {q_n}, k {k})"
    chunks = -(-q_n // (chunk or bm25.chunk_rows(n_pad)))
    if launches != chunks:
        raise AssertionError(f"{what}: {launches} launches for {chunks} chunks")
    equal(what, (got[0].view(torch.int32), got[1]), (want[0].view(torch.int32), want[1]),
          ("negated scores", "slots"))
    q_off = args["q_off"]
    rows = min(q_n, 64)
    q_off_dev = torch.from_numpy(q_off[:rows + 1].astype(np.int32)).to(dev)
    plain_args = {key: v for key, v in args.items() if key not in ("q_off", "avgdl")}
    dense = bm25._bm25_dense_cuda(**plain_args, q_off_dev=q_off_dev, avgdl=float(args["avgdl"]))
    pdense = bm25._bm25_dense_plain(**plain_args, q_off=q_off[:rows + 1],
                                    avgdl=float(args["avgdl"]))
    equal(what + ", dense rows", (dense.view(torch.int32),), (pdense.view(torch.int32),))
    fin = torch.isfinite(want[0])
    return float((got[0][fin] - want[0][fin]).abs().max()) if fin.any() else 0.0
