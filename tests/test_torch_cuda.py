"""Card-only tests: the CUDA kernels of comet_tpu_torch against their plain
PyTorch versions on the same card.

A CUDA kernel has no CPU mode, so on a machine without a card every test
here skips. Where a card is, run this file without the suite's conftest,
which imports JAX, so that it needs only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from comet_tpu_torch import DistanceKind, FlatIndex
from comet_tpu_torch.ops import fused_scan, sortnet, topk
from comet_tpu_torch.ops.distance import sqrt_f32

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _topk_inputs(rng, c, l_real, case):
    if case == "random":
        v = rng.normal(size=(c, l_real)).astype(np.float32)
    elif case == "ties":
        v = rng.integers(0, 4, size=(c, l_real)).astype(np.float32)
    else:  # signed zeros and infinities
        v = rng.choice(np.array([-0.0, 0.0, 1.0, np.inf], np.float32), size=(c, l_real))
    idx = np.stack([rng.permutation(c) for _ in range(l_real)], axis=1).astype(np.int32)
    return v, idx


@pytest.mark.parametrize("c,l_real,k", [
    (5, 7, 1), (300, 130, 100), (8192, 256, 128), (20000, 64, 10),
    (16384, 16, 4000), (20000, 16, 9000),
])
@pytest.mark.parametrize("case", ["random", "ties", "zeros"])
def test_topk_cl_kernel_matches_plain(dev, c, l_real, k, case):
    rng = np.random.default_rng(c + k)
    v, idx = _topk_inputs(rng, c, l_real, case)
    vt, it = torch.from_numpy(v).to(dev), torch.from_numpy(idx).to(dev)
    before = sortnet.LAUNCHES
    got_v, got_i = sortnet.topk_cl(vt, it, k)
    torch.cuda.synchronize()
    assert sortnet.LAUNCHES > before
    want_v, want_i = sortnet._topk_cl_plain(vt, it, k)
    assert got_v.shape == (sortnet.k_pow2(k), l_real)
    assert torch.equal(got_i, want_i)
    assert torch.equal(got_v, want_v)


@pytest.mark.parametrize("k", [33, 9000])
def test_topk_rows_positions_as_indices(dev, k):
    rng = np.random.default_rng(3)
    v = torch.from_numpy(rng.integers(0, 9, size=(40, 3000)).astype(np.float32)).to(dev)
    got = sortnet.topk_rows(v, None, k)
    want = sortnet._topk_rows_plain(v, None, k)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _scan_inputs(rng, q_n, n, d, cosine):
    if cosine:
        q = rng.normal(size=(q_n, d)).astype(np.float32)
        x = rng.normal(size=(n, d)).astype(np.float32)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        x /= np.linalg.norm(x, axis=1, keepdims=True)
    else:
        q = rng.integers(0, 256, size=(q_n, d)).astype(np.float32)
        x = rng.integers(0, 256, size=(n, d)).astype(np.float32)
    valid = rng.random(n) > 0.1
    base = np.zeros(n, np.float32) if cosine else (x * x).sum(axis=1)
    mask = np.where(valid, base, np.inf).astype(np.float32)
    return q, x, mask


@pytest.mark.parametrize("cosine", [False, True])
@pytest.mark.parametrize("q_n,n,d", [(300, 4096, 20), (64, 1024, 128), (1, 2048, 3)])
def test_fused_dist_select_kernel_matches_plain(dev, cosine, q_n, n, d):
    rng = np.random.default_rng(q_n + d)
    q, x, mask = _scan_inputs(rng, q_n, n, d, cosine)
    args = [torch.from_numpy(a).to(dev) for a in (q, x, mask)]
    dist_k = fused_scan._fused_dist_select_plain(*args, float("inf"), cosine)[0]
    thr = float(np.median(dist_k[torch.isfinite(dist_k)].cpu().numpy()))
    before = fused_scan.LAUNCHES
    dist, gsel = fused_scan.fused_dist_select(*args, thr, 8, cosine)
    torch.cuda.synchronize()
    assert fused_scan.LAUNCHES == before + 1
    want_d, want_gmin = fused_scan._fused_dist_select_plain(*args, thr, cosine)
    want_g = sortnet._topk_rows_plain(want_gmin, None, 8)[1]
    if cosine:
        both = torch.isfinite(dist) & torch.isfinite(want_d)
        torch.testing.assert_close(dist[both], want_d[both], rtol=1e-5, atol=1e-6)
        # sums in another order may put a value on the other side of the
        # threshold, but only within the tolerance of it
        flip = torch.isfinite(dist) != torch.isfinite(want_d)
        near = torch.where(torch.isfinite(dist), dist, want_d)[flip]
        assert ((near - thr).abs() <= 1e-6 + 1e-5 * abs(thr)).all()
        assert torch.isinf(dist[:, torch.from_numpy(np.isinf(mask)).to(dev)]).all()
    else:
        # integer data: every partial sum is exact, so the kernel is bit-equal
        assert torch.equal(dist, want_d)
        assert torch.equal(gsel, want_g)


@pytest.mark.parametrize("k", [1, 100, 1000])
def test_pipeline_kernel_matches_plain(dev, k):
    """The kernel pipeline against the plain one, ops/topk.block_topk."""
    rng = np.random.default_rng(k)
    q, x, mask = _scan_inputs(rng, 600, 8192, 128, cosine=False)
    args = [torch.from_numpy(a).to(dev) for a in (q, x, mask)]
    thr = float(np.float32(3.0e6))
    s, i = fused_scan.flat_topk_pipeline(*args, thr, k, sqrt_out=True)
    qt, xt, mt = args
    ws, wi = topk.block_topk(qt, xt, (xt * xt).sum(dim=1), torch.isfinite(mt), thr, k,
                             DistanceKind.L2_SQUARED, super_tile=8192)
    assert torch.equal(i, wi)
    assert torch.equal(s, sqrt_f32(ws))


@pytest.mark.parametrize("k", [50, 0])   # k <= 0 means every row
def test_flat_index_cuda_matches_cpu(dev, k):
    rng = np.random.default_rng(7)
    x = rng.integers(0, 256, size=(9000, 32)).astype(np.float32)
    q = rng.integers(0, 256, size=(70, 32)).astype(np.float32)
    ids = list(range(10, 9010))
    out = []
    for device in ("cuda", "cpu"):
        idx = FlatIndex(32, DistanceKind.L2, device=device)
        idx.add_batch(x, ids=ids)
        idx.remove(12)
        res = idx.new_search().with_query(q[0]).with_k(k).execute()
        out.append(idx.search_batch(q, k=k or 9000, document_ids=range(10, 4000))
                   + ([r.node.id for r in res], [r.score for r in res]))
    for got, want in zip(*out):
        np.testing.assert_array_equal(got, want)


# -- IVF: K2's nprobe mode and K3 ---------------------------------------------------


@pytest.mark.parametrize("q_n,n,d,nlist,width", [(300, 4096, 20, 70, 8), (256, 8192, 128, 1024, 16)])
def test_fused_dist_select_nprobe_kernel_matches_plain(dev, q_n, n, d, nlist, width):
    """Integer data: dist and the group choice bit-equal to the plain
    version, nlist not a multiple of 32 and unassigned rows included."""
    rng = np.random.default_rng(nlist)
    q, x, mask = _scan_inputs(rng, q_n, n, d, cosine=False)
    assign = rng.integers(-1, nlist, size=n).astype(np.int32)
    probes = rng.integers(0, nlist, size=(q_n, width)).astype(np.int32)
    args = [torch.from_numpy(a).to(dev) for a in (q, x, mask)]
    ivf = dict(assign=torch.from_numpy(assign).to(dev), probes=torch.from_numpy(probes).to(dev),
               nlist=nlist)
    thr = float(np.float32(4.0e5 * d / 20))
    before = (fused_scan.LAUNCHES, fused_scan.NPROBE_LAUNCHES)
    dist, gsel = fused_scan.fused_dist_select(*args, thr, 8, False, **ivf)
    torch.cuda.synchronize()
    assert (fused_scan.LAUNCHES, fused_scan.NPROBE_LAUNCHES) == (before[0], before[1] + 1)
    want_d, want_gmin = fused_scan._fused_dist_select_plain(*args, thr, False, **ivf)
    assert torch.equal(dist, want_d)
    assert torch.equal(gsel, sortnet._topk_rows_plain(want_gmin, None, 8)[1])
    assert torch.isfinite(dist).any() and torch.isinf(dist).any()


def _sparse_case(dev, g_n, s_n, d, nlist, cosine, seed):
    from comet_tpu_torch.ops import ivf_sparse as sp

    rng = np.random.default_rng(seed)
    nr = 64 * sp.CHUNK
    q, x, mask = _scan_inputs(rng, g_n * sp.QG, nr, d, cosine)
    probes = rng.integers(0, nlist, size=(g_n * sp.QG, 8)).astype(np.int32)
    chunk_ids = rng.integers(0, 64, size=(g_n, s_n)).astype(np.int32)
    cluster_ids = rng.integers(-1, nlist, size=(g_n, s_n)).astype(np.int32)
    t = [torch.from_numpy(a).to(dev) for a in (q, x, mask, probes, chunk_ids, cluster_ids)]
    return sp, t


@pytest.mark.parametrize("cosine", [False, True])
@pytest.mark.parametrize("g_n,s_n,d", [(3, 40, 128), (2, 5, 20)])
def test_sparse_scan_kernel_matches_plain(dev, cosine, g_n, s_n, d):
    """K3 against `_sparse_scan_plain`: integer L2 bit-equal (group choice
    too); cosine within float32 summation-order error."""
    sp, t = _sparse_case(dev, g_n, s_n, d, 12, cosine, seed=g_n + s_n)
    thr = 1.0 if cosine else float(np.float32(4.0e5 * d / 20))
    kb = min(16, 2 * s_n)
    before = sp.LAUNCHES
    dist, gsel = sp._sparse_scan(*t, thr, kb, cosine)
    torch.cuda.synchronize()
    assert sp.LAUNCHES == before + 1
    want_d, want_gmin = sp._sparse_scan_plain(*t, thr, cosine)
    want_g = sortnet._topk_rows_plain(want_gmin.view(g_n * sp.QG, -1), None, kb)[1][:, :kb]
    dead = (t[5] < 0).repeat_interleave(sp.CHUNK, dim=1)[:, None, :].expand_as(dist)
    assert torch.isinf(dist[dead]).all()
    if cosine:
        both = torch.isfinite(dist) & torch.isfinite(want_d)
        torch.testing.assert_close(dist[both], want_d[both], rtol=1e-5, atol=1e-6)
        flip = torch.isfinite(dist) != torch.isfinite(want_d)
        near = torch.where(torch.isfinite(dist), dist, want_d)[flip]
        assert ((near - thr).abs() <= 1e-6 + 1e-5 * abs(thr)).all()
    else:
        assert torch.equal(dist, want_d)
        assert torch.equal(gsel.view(g_n * sp.QG, kb), want_g)


@pytest.mark.parametrize("route", ["0", "1"])
def test_ivf_index_cuda_matches_cpu(dev, route, monkeypatch):
    """The same IVF index on the card (kernels) and on the CPU (plain
    versions): integer data and centroids, so results are equal on both
    routes (nlist 64 keys queries by centroid id, the same on both)."""
    from comet_tpu_torch import IVFIndex

    monkeypatch.setenv("COMET_IVF_SPARSE", route)
    rng = np.random.default_rng(11)
    x = rng.integers(0, 256, size=(20000, 32)).astype(np.float32)
    q = rng.integers(0, 256, size=(300, 32)).astype(np.float32)
    out = []
    for device in ("cuda", "cpu"):
        idx = IVFIndex(32, 64, DistanceKind.L2, device=device)
        if device == "cuda":
            idx.train(x[:4000])
            # integer centroids make every coarse product exact: both probe alike
            centroids = np.rint(idx._centroids).astype(np.float32)
        idx._set_centroids(centroids)
        idx.add_batch(x, ids=range(5, 20005))
        idx.remove(9)
        out.append(idx.search_batch(q, k=40, nprobes=6, document_ids=range(5, 15000))
                   + idx.search_batch(q, k=40, nprobes=6, threshold=150.5))
    for got, want in zip(*out):
        np.testing.assert_array_equal(got, want)
