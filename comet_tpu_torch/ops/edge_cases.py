"""Edge cases that hold K1 (top-k select) and K2 (fused distance scan) to
their plain versions on the card, shared by the card tests
(tests/test_torch_cuda.py) and chip_smoke.py.

Each `check_*` runs a kernel's wrapper and its plain version on the same
CUDA tensors and raises AssertionError where they differ. The inputs are
made from a seed with numpy.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from comet_tpu_torch.ops import fused_scan, sortnet
from comet_tpu_torch.ops.distance import preprocess
from comet_tpu_torch.types import DistanceKind

K1_KS = (1, 8, 100, 128, 1000, 8192)


def k1_widths(k: int) -> list[int]:
    """Widths around k_pow2, 2 k_pow2 (direct sort against radix select)
    and SMEM_KEYS (shared memory against the scratch row)."""
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
    for layout, run, plain in (
        ("rows", lambda: sortnet.topk_rows(vt, it, k), lambda: sortnet._topk_rows_plain(vt, it, k)),
        ("rows, idx=None", lambda: sortnet.topk_rows(vt, None, k),
         lambda: sortnet._topk_rows_plain(vt, None, k)),
        ("columns", lambda: sortnet.topk_cl(vc, ic, k), lambda: sortnet._topk_cl_plain(vc, ic, k)),
    ):
        before = sortnet.LAUNCHES
        got = run()
        if sortnet.k_pow2(k) <= sortnet.KP_MAX and sortnet.LAUNCHES != before + 1:
            raise AssertionError(f"K1 took {sortnet.LAUNCHES - before} launches at width {width}, "
                                 f"k {k} ({layout})")
        want = plain()
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise AssertionError(f"K1 differs from its plain version at width {width}, k {k} "
                                 f"({layout})")


def k2_cases(q_n: int, d: int, n: int, dev: torch.device, seed: int = 0):
    """K2's three modes at one shape: (name, queries, corpus, mask, kwargs,
    cosine, exact). Integer data make float32 L2 exact; the bf16 operand is
    bit-equal to its plain version on any data."""
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
    )


def check_k2(dev: torch.device, q_n: int, d: int, n: int, seed: int = 0) -> float:
    """K2's three modes against their plain versions at one shape, without
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
