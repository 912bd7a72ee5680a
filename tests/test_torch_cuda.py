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
from comet_tpu_torch.ops import edge_cases, fused_scan, sortnet, topk
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


@pytest.mark.parametrize("k,width", edge_cases.K1_CASES)
def test_topk_select_edges_match_plain(dev, k, width):
    """The launches of its route per select (k_pow2 <= KP_MAX), array-equal
    to the plain version in both layouts and with idx=None: widths around
    k_pow2, 2 k_pow2 (direct sort against radix select) and SMEM_KEYS (one
    block a row against the split route), on ties, signed zeros, +inf and
    repeated keys."""
    edge_cases.check_k1(dev, k, width)


@pytest.mark.parametrize("rows,width,k,kind", edge_cases.K1_SPLIT_CASES)
def test_topk_split_route_edges_match_plain(dev, rows, width, k, kind):
    """K1's split route array-equal to the plain version in both layouts
    and with idx=None, in its launches: BM25's [256, 2^20] rows and the
    store's one-query rows, ~10^6 +-0.0 zeros past fewer than k smaller
    values, runs across tile edges, +inf rows, permuted and repeated
    indices, kp = 8192."""
    edge_cases.check_k1_split(dev, rows, width, k, kind)
    torch.cuda.empty_cache()


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


@pytest.mark.parametrize("q_n,d,n", edge_cases.K2_SHAPES)
def test_fused_scan_edges_match_plain(dev, q_n, d, n):
    """K2's three modes at ragged Q and d, with and without a threshold:
    float32 L2 and nprobe on integer data and the bf16 operand (L2 and
    cosine, Gaussian data) array-equal to the plain versions, float32
    cosine allclose(1e-5, 1e-6) with flips only at the threshold."""
    edge_cases.check_k2(dev, q_n, d, n)


@pytest.mark.parametrize("q_n,d,n", edge_cases.K2_FEWQ_SHAPES)
def test_fused_scan_fewq_edges_match_plain_and_tile(dev, q_n, d, n):
    """K2's few-query route at Q 2-32 in every mode and operand, with and
    without a threshold, d not a multiple of 4: held to the plain versions
    as check_k2 holds them, and bit-equal to the 128-query tile, Gaussian
    float32 included."""
    edge_cases.check_k2_fewq(dev, q_n, d, n)


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


@pytest.mark.parametrize("filtered", [False, True])
def test_h2d_bytes_of_a_one_query_flat_search(dev, filtered):
    """The copy counter under a profiler: once the index's mirrors are on
    the card, a one-query search copies its query and, with a filter, the
    filter's packed 64-bit words, each as two int64 halves."""
    from torch.profiler import ProfilerActivity, profile

    from comet_tpu_torch.utils import profiling

    rng = np.random.default_rng(3)
    x = rng.integers(0, 256, size=(5000, 128)).astype(np.float32)
    idx = FlatIndex(128, DistanceKind.L2, device="cuda")
    idx.add_batch(x, ids=range(1, 5001))

    def search():
        b = idx.new_search().with_query(x[7]).with_k(10)
        return (b.with_document_ids(range(1, 3000)) if filtered else b).execute()

    search()     # the mirrors of the corpus and the ids go to the card here
    with profile(activities=[ProfilerActivity.CPU]):
        search()
    words = 16 * ((2999 >> 6) + 1) if filtered else 0
    assert profiling.per_query("h2d_bytes") == x[7].nbytes + words


@pytest.mark.parametrize("route", ["1", "0"])
def test_h2d_bytes_of_an_ivf_batch(dev, route, monkeypatch):
    """The copy counter on the IVF path, each route: once the layouts are
    on the card, a batch copies its queries and nothing else."""
    from torch.profiler import ProfilerActivity, profile

    from comet_tpu_torch import IVFIndex
    from comet_tpu_torch.utils import profiling

    monkeypatch.setenv("COMET_IVF_SPARSE", route)
    rng = np.random.default_rng(4)
    x = rng.integers(0, 256, size=(5000, 128)).astype(np.float32)
    idx = IVFIndex(128, 16, DistanceKind.L2, device="cuda")
    idx.train(x[:2000])
    idx.add_batch(x, ids=range(1, 5001))
    q = x[:40] + 0.5
    idx.search_batch(q, k=10, nprobes=4)     # the layouts go to the card here
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        idx.search_batch(q, k=10, nprobes=4)
    assert profiling.per_query("h2d_bytes") == q[0].nbytes
    assert profiling.per_query("ivf_sparse_rows") == (1.0 if route == "1" else 0.0)


def test_a_flat_batch_maps_ids_on_the_card_as_the_host_map_did(dev, monkeypatch):
    """A [2048, 100] batch over 2^17 rows whose ids lie at and above 2^31:
    the ids mapped on the card equal the numpy host map of the same slots,
    and the whole search's peak memory grows by the id map's 4 bytes a
    slot, no more (the gather's temporaries fall after the scan's peak)."""
    from comet_tpu_torch.indexes import flat as flat_mod
    from comet_tpu_torch.indexes.base import INVALID_ID

    rng = np.random.default_rng(17)
    n = 1 << 17
    x = rng.integers(0, 256, size=(n, 128)).astype(np.float32)
    q = rng.integers(0, 256, size=(2048, 128)).astype(np.float32)
    ids = np.uint32(2**31) + rng.permutation(n).astype(np.uint32) * np.uint32(16381)
    ids[0] = 0xFFFFFFFE
    q[0] = x[0]                     # row 0, the largest id, is query 0's nearest
    idx = FlatIndex(128, DistanceKind.L2, device="cuda")
    idx.add_batch(x, ids=ids)
    idx.remove(int(ids[9]))
    store = idx._store
    store.device_state()

    def host_map(handle):
        _, s, i, _ = handle
        slots = i.cpu().numpy()
        hit = slots != topk.IDX_SENTINEL
        return (np.where(hit, ids_snap[np.where(hit, slots, 0)], INVALID_ID).astype(np.uint32),
                s.cpu().numpy())

    def searched():
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = idx.search_batch(q, k=100)
        torch.cuda.synchronize()
        return out, torch.cuda.max_memory_allocated() - base

    ids_snap = store.ids.copy()
    with monkeypatch.context() as m:
        m.setattr(store, "device_id_map", lambda: None)
        m.setattr(flat_mod, "collect_device_handle", host_map)
        want, host_peak = searched()
    got, peak = searched()          # the id map goes to the card at this launch
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[0].dtype == np.uint32 and (got[0] >= 2**31).all() and (got[0] == ids[0]).any()
    assert not (got[0] == ids[9]).any()
    assert peak - host_peak <= 4 * (store.capacity + 1) + 512     # the allocator's 512-byte blocks


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


def _k3_layout(dev, rng, g_n, s_n, nlist=12):
    """A cluster-major layout of nlist clusters of 0-5 chunks and each
    group's walk over its queries' 8 distinct probes at a step budget of
    s_n (which may drop chunks). Returns (rows NR, the layout arguments of
    K3's wrapper: probes, chunk_ids, cluster_ids, chunk_start, nchunks,
    n_places, MC, wc)."""
    from comet_tpu_torch.ops import ivf_sparse as sp

    nchunks = rng.integers(0, 6, size=nlist).astype(np.int32)
    nchunks[0] = max(nchunks[0], 1)
    chunk_start = np.concatenate([[0], np.cumsum(nchunks)]).astype(np.int32)
    probes = np.stack([rng.permutation(nlist)[:8] for _ in range(g_n * sp.QG)]).astype(np.int32)
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    mc = int(nchunks.max())
    chunk_ids, cluster_ids, _, _ = sp._group_chunk_lists(
        t(probes), t(chunk_start), t(nchunks), s_n, min(s_n, nlist), mc, nlist)
    return int(chunk_start[-1]) * sp.CHUNK, (t(probes), chunk_ids, cluster_ids, t(chunk_start),
                                            t(nchunks), 8, mc, sp.compact_width(8, mc))


@pytest.mark.parametrize("cosine", [False, True])
@pytest.mark.parametrize("g_n,s_n,d", [(3, 40, 128), (2, 5, 20)])
def test_compact_scan_kernel_matches_plain(dev, cosine, g_n, s_n, d):
    """K3 against `_compact_scan_plain` on a layout of uneven lists: the
    chunk table equal, the rows integer L2 bit-equal, cosine within
    float32 summation-order error; its shortlist mode (group minima, the
    row unfilled) held to it by `edge_cases.check_k3_minima`, and its
    minima integer L2 bit-equal to the plain version's."""
    from comet_tpu_torch.ops import ivf_sparse as sp

    rng = np.random.default_rng(g_n + s_n)
    nr, lay = _k3_layout(dev, rng, g_n, s_n)
    t = [torch.from_numpy(a).to(dev) for a in _scan_inputs(rng, g_n * sp.QG, nr, d, cosine)]
    thr = 1.0 if cosine else float(np.float32(4.0e5 * d / 20))
    before = sp.LAUNCHES
    filled = sp._compact_scan(*t, *lay, thr, cosine)
    torch.cuda.synchronize()
    assert sp.LAUNCHES == before + 1
    cand, tab, _ = filled
    want, want_tab, want_gmin = sp._compact_scan_plain(*t, *lay, thr, cosine, minima=True)
    got = sp._compact_scan(*t, *lay, thr, cosine, minima=True)
    edge_cases.check_k3_minima(filled, got, "float32")
    assert torch.isfinite(got[2]).any() and torch.isinf(got[2]).any()
    assert torch.equal(tab, want_tab)
    assert torch.isfinite(want).any() and torch.isinf(want).any()
    if cosine:
        both = torch.isfinite(cand) & torch.isfinite(want)
        torch.testing.assert_close(cand[both], want[both], rtol=1e-5, atol=1e-6)
        flip = torch.isfinite(cand) != torch.isfinite(want)
        near = torch.where(torch.isfinite(cand), cand, want)[flip]
        assert ((near - thr).abs() <= 1e-6 + 1e-5 * abs(thr)).all()
    else:
        assert torch.equal(cand, want) and torch.equal(got[2], want_gmin)


@pytest.mark.parametrize("layout,d", edge_cases.K3_CASES)
def test_sparse_scan_edges_match_plain(dev, layout, d):
    """K3 in both modes, L2 and cosine, with and without a threshold, at
    the member counts 0-128 a step, dead steps, S = 1 and a zero-padded
    last group (ops/edge_cases.py): equal to its plain version."""
    edge_cases.check_k3(dev, layout, d)


@pytest.mark.parametrize("layout,d,bf16", edge_cases.K3_ROUTE_CASES)
def test_sparse_compact_route_equals_the_dense_route(dev, layout, d, bf16):
    """Through the whole pipeline on one layout, in float32 and the bf16
    mode: a shortlist at the exact bound (kb_cap = k) equals the exact
    search (kb_cap = 0), and a shortlist of 8 groups equals the plain
    selection from the reference's dense tile; scores, slots and overflow
    array-equal at dead steps, an overflowing budget, queries probing only
    empty clusters, a threshold, a filter, a row narrower than k_pow2(k), a
    ragged batch and ties across the 128th place (ops/edge_cases.py)."""
    edge_cases.check_k3_routes(dev, layout, d, bf16)


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


# -- HNSW: K4, K3's bf16 mode, the in-loop scoring ------------------------------------

SENT = 2**31 - 1


def _merge_state(rng, q_n, ef, ew, cap=4096):
    """A valid beam state on float data: each query's beam holds distinct
    slots sorted by distance, with random expanded flags; the candidates
    mix new slots, copies of beam slots and copies among themselves, every
    copy at its slot's one distance (a per-query table)."""
    table = (rng.random((q_n, cap)) * 10).astype(np.float32)
    perm = np.argsort(rng.random((q_n, cap)), axis=1)
    nb = rng.integers(1, ef + 1, size=q_n)
    bs = perm[:, :ef].astype(np.int32)
    bd = np.take_along_axis(table, bs, axis=1)
    order = np.argsort(bd, axis=1, kind="stable")
    bs, bd = np.take_along_axis(bs, order, 1), np.take_along_axis(bd, order, 1)
    keep = np.arange(ef)[None, :] < nb[:, None]
    # keep the nb nearest as the beam (still sorted), the rest empty
    bd, bs = np.where(keep, bd, np.inf), np.where(keep, bs, SENT)
    be = np.where(keep, rng.integers(0, 2, size=(q_n, ef)), 0).astype(np.int32)
    pick_beam = rng.random((q_n, ew)) < 0.4
    from_beam = np.take_along_axis(bs, rng.integers(0, ef, size=(q_n, ew)) % nb[:, None], 1)
    fresh = perm[:, ef:ef + ew] if cap >= ef + ew else rng.integers(0, cap, size=(q_n, ew))
    ns = np.where(pick_beam, from_beam, fresh[:, rng.integers(0, ew, size=ew)]).astype(np.int32)
    nd = np.take_along_axis(table, ns, axis=1)
    empty = rng.random((q_n, ew)) < 0.1
    nd, ns = np.where(empty, np.inf, nd).astype(np.float32), np.where(empty, SENT, ns)
    return [np.ascontiguousarray(a)
            for a in (bd.astype(np.float32), bs, be, nd, ns.astype(np.int32))]


@pytest.mark.parametrize("q_n,ef,ew,expand,stop,kr", [
    (2048, 256, 256, 8, None, 0), (2048, 256, 256, 8, 256, 256), (300, 64, 32, 4, 16, 0),
    (130, 32, 96, 23, None, 64), (64, 1024, 256, 8, 128, 2048),
])
def test_beam_merge_kernel_matches_plain(dev, q_n, ef, ew, expand, stop, kr):
    """K4 against `_merge_plain` on float data, split (kr = 0) and fused
    mode: bit-equal (the step compares and moves values only)."""
    from comet_tpu_torch.ops import beam_kernel as bk

    rng = np.random.default_rng(q_n + ef + kr)
    state = [torch.from_numpy(a).to(dev) for a in _merge_state(rng, q_n, ef, ew)]
    fused = kr > 0
    extra = {}
    if fused:
        rd, rs = _merge_state(rng, q_n, kr, 8)[:2]
        adm = rng.integers(0, 2, size=(q_n, ew)).astype(np.int32)
        extra = dict(res_d=torch.from_numpy(rd).to(dev), res_s=torch.from_numpy(rs).to(dev),
                     adm=torch.from_numpy(adm).to(dev))
    before = (bk.LAUNCHES, bk.FUSED_LAUNCHES)
    got = bk.beam_merge_step(*state, **extra, ef=ef, ew=ew, expand=expand, fused=fused, kr=kr,
                             stop=stop)
    torch.cuda.synchronize()
    assert (bk.LAUNCHES, bk.FUSED_LAUNCHES) == (before[0] + (not fused), before[1] + fused)
    args = state + [extra.get("res_d"), extra.get("res_s"), extra.get("adm")]
    want = bk._merge_plain(*args, ef, ew, expand, fused, kr, stop or ef)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert torch.equal(g, w)
    assert (got[3][:, expand] == 1).any() and (got[3][:, 0] >= 0).any()


@pytest.mark.parametrize("q_n,ef,ew,expand,stop,kr", edge_cases.K4_CASES)
def test_beam_merge_edges_match_plain(dev, q_n, ef, ew, expand, stop, kr):
    """K4, split and fused, on ties across beam, candidates and result
    set, copies, SENT and +inf rows, ef + ew not a power of two, ew not a
    multiple of 32, and beams and result sets out of slot order on tied
    distances (ops/edge_cases.py): equal to its plain version."""
    edge_cases.check_k4(dev, q_n, ef, ew, expand, stop, kr)


def _seed_loop_case(dev, n=4096, d=128, w=32, q_n=128, seed=5):
    """Gaussian vectors and queries, a random adjacency, the blocked tables
    and a one-group K3 layout over every row."""
    from comet_tpu_torch.ops import beam_kernel as bk
    from comet_tpu_torch.ops.distance import bf16_round

    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).to(dev)
    q = torch.from_numpy(rng.normal(size=(q_n, d)).astype(np.float32)).to(dev)
    adj = torch.from_numpy(rng.integers(0, n, size=(n, w)).astype(np.int32)).to(dev)
    sqn = (x * x).sum(dim=1)
    nbr_vecs, aux = bk.build_blocked_tables(adj, x, sqn)
    mask = bf16_round(sqn)
    return bk, rng, x, q, adj, sqn, nbr_vecs, aux, mask


@pytest.mark.parametrize("q_n,s_n", [(128, 16), (384, 40)])
def test_sparse_scan_bf16_kernel_matches_plain(dev, q_n, s_n):
    """K3's bf16 mode on Gaussian (non-integer) data: rows and chunk table
    bit-equal to the plain version, which sums the exact bf16 products in
    the kernel's order, and so are the group minima of its shortlist mode
    (held to the filled rows by `edge_cases.check_k3_minima`); and its
    launches count apart from the float32 mode's."""
    from comet_tpu_torch.ops import ivf_sparse as sp

    rng = np.random.default_rng(q_n)
    nr, lay = _k3_layout(dev, rng, q_n // sp.QG, s_n)
    q = torch.from_numpy(rng.normal(size=(q_n, 128)).astype(np.float32)).to(dev)
    x = torch.from_numpy(rng.normal(size=(nr, 128)).astype(np.float32)).to(dev)
    sqn = (x * x).sum(dim=1)
    mask = torch.where(torch.from_numpy(rng.random(nr) < 0.1).to(dev), float("inf"),
                       sqn.to(torch.bfloat16).float())
    qn = (q * q).sum(dim=1)
    xb = x.to(torch.bfloat16)
    before = (sp.LAUNCHES, sp.BF16_LAUNCHES)
    filled = sp._compact_scan(q, xb, mask, *lay, float("inf"), False, True, qn)
    torch.cuda.synchronize()
    assert (sp.LAUNCHES, sp.BF16_LAUNCHES) == (before[0], before[1] + 1)
    cand, tab, _ = filled
    want, want_tab, want_gmin = sp._compact_scan_plain(q, xb, mask, *lay, float("inf"), False,
                                                       qn, minima=True)
    assert torch.equal(cand, want) and torch.equal(tab, want_tab)
    assert torch.isfinite(cand).any()
    got = sp._compact_scan(q, xb, mask, *lay, float("inf"), False, True, qn, minima=True)
    edge_cases.check_k3_minima(filled, got, "bf16 mode")
    assert torch.equal(got[2], want_gmin)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("d,w", [(128, 32), (100, 12)])
def test_gather_score_kernel_matches_plain(dev, d, w, fused):
    """Bit-equal to the plain version; d = 100 ends in a partial staging
    pass, and E W = 96 candidates a query put several queries in a block."""
    bk, rng, x, q, adj, sqn, nbr_vecs, aux, _ = _seed_loop_case(dev, d=d, w=w)
    n = x.shape[0]
    nodes = torch.from_numpy(rng.integers(-1, n, size=(q.shape[0], 8)).astype(np.int32)).to(dev)
    adj_cut = adj.clone()
    adj_cut[nodes[0, 0].clamp_min(0).long(), 5:] = -1
    nbr_vecs, aux = bk.build_blocked_tables(adj_cut, x, sqn)
    allowed = torch.from_numpy(rng.random(n) < 0.7).to(dev)
    qb, qn = q.to(torch.bfloat16), (q * q).sum(dim=1)
    before = bk.SCORE_LAUNCHES
    got = bk.gather_score(qb, qn, nbr_vecs, aux, nodes, allowed, 250.0, fused)
    torch.cuda.synchronize()
    assert bk.SCORE_LAUNCHES == before + 1
    want = bk._gather_score_plain(qb, qn, nbr_vecs, aux, nodes, allowed, 250.0, fused)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert torch.equal(g, w)
    if fused:
        assert 0 < int(got[2].sum()) < got[2].numel()


def test_seed_and_in_loop_distances_are_bit_equal(dev):
    """Gaussian data: the distance K3's bf16 mode gives a (query, slot) is
    bit-equal to the one the in-loop scoring kernel gives the same pair when
    a node whose neighbourhood holds the slot is expanded, and to the
    plain bf16 dot of the probe-starved entry start."""
    from comet_tpu_torch.ops import ivf_sparse as sp
    from comet_tpu_torch.ops.distance import bf16_dot

    bk, rng, x, q, adj, sqn, nbr_vecs, aux, mask = _seed_loop_case(dev)
    n, q_n, w = x.shape[0], q.shape[0], adj.shape[1]
    s_n = n // sp.CHUNK
    qn = (q * q).sum(dim=1)
    # one cluster of every chunk, one group's walk over all of them: chunk i
    # goes to place i of each query's row
    i32 = dict(dtype=torch.int32, device=dev)
    seed_d, _, _ = sp._compact_scan(
        q, x.to(torch.bfloat16), mask, torch.zeros((q_n, 8), **i32),
        torch.arange(s_n, **i32)[None, :], torch.zeros((1, s_n), **i32),
        torch.tensor([0, s_n], **i32), torch.tensor([s_n], **i32), 1, s_n, s_n, float("inf"),
        False, True, qn)                                      # [Q, n]: every (query, row)
    nodes = torch.from_numpy(rng.integers(0, n, size=(q_n, 8)).astype(np.int32)).to(dev)
    nd, ns, _ = bk.gather_score(q.to(torch.bfloat16), qn, nbr_vecs, aux, nodes,
                                torch.ones(n, dtype=torch.bool, device=dev), float("inf"), False)
    torch.cuda.synchronize()
    assert torch.equal(ns.view(q_n, 8, w), adj[nodes.long()])
    assert torch.equal(nd, seed_d.gather(1, ns.long()))
    entry = ns[:, 0].long()
    e_d = torch.clamp_min((qn + mask[entry]) - 2.0 * bf16_dot(q.to(torch.bfloat16),
                                                             x[entry].to(torch.bfloat16)), 0.0)
    assert torch.equal(e_d, nd[:, 0])
    assert not torch.equal(seed_d, torch.clamp_min((qn[:, None] + mask) - 2.0 * (q @ x.T), 0.0))


class _plain_versions:
    """Every wrapper of the package takes its plain version, also for CUDA
    tensors, while inside: the plain beam on the card."""

    def __enter__(self):
        from comet_tpu_torch.ops import beam_kernel, fused_scan, ivf_sparse

        self.mods = (sortnet, fused_scan, ivf_sparse, beam_kernel)
        self.saved = [m.use_plain for m in self.mods]
        for m in self.mods:
            m.use_plain = lambda t: True
        return self

    def __exit__(self, *exc):
        for m, f in zip(self.mods, self.saved):
            m.use_plain = f


@pytest.mark.parametrize("seeded", ["1", "0"])
def test_hnsw_index_cuda_matches_plain_and_cpu(dev, seeded, monkeypatch):
    """A small HNSWIndex built on the card: its graph equals the CPU
    build's (integer data), and its searches (default, filtered +
    thresholded, after removals) equal the plain beam on the card and the
    CPU index."""
    from comet_tpu_torch import HNSWConfig, HNSWIndex
    from comet_tpu_torch.ops import beam_kernel as bk

    monkeypatch.setenv("COMET_HNSW_SEED", seeded)
    rng = np.random.default_rng(21)
    x = rng.integers(0, 256, size=(6000, 32)).astype(np.float32)
    q = rng.integers(0, 256, size=(300, 32)).astype(np.float32)
    kw = [dict(), dict(threshold=300.0, document_ids=range(1, 6001, 2))]
    out = {}
    for device in ("cuda", "cpu"):
        idx = HNSWIndex(32, DistanceKind.L2, HNSWConfig(m=8, ef_construction=64, ef_search=64),
                        device=device)
        idx.add_batch(x, ids=range(1, 6001))
        res = [idx.search_batch(q, k=10, **a) for a in kw]
        for i in range(1, 6001, 97):
            idx.remove(i)
        res.append(idx.search_batch(q, k=10))
        out[device] = (idx, res)
    idx, res = out["cuda"]
    np.testing.assert_array_equal(idx._adj0, out["cpu"][0]._adj0)
    before = (bk.FUSED_LAUNCHES, bk.SCORE_LAUNCHES)
    again = idx.search_batch(q, k=10)
    # the removals make every search fused (result admission), so the
    # fused mode of K4 runs, with the scoring kernel
    assert min(bk.FUSED_LAUNCHES - before[0], bk.SCORE_LAUNCHES - before[1]) > 0
    with _plain_versions():
        plain = idx.search_batch(q, k=10)
    for got, want in zip(again + tuple(a for r in res for a in r),
                         plain + tuple(a for r in out["cpu"][1] for a in r)):
        np.testing.assert_array_equal(got, want)


def test_hnsw_cuda_insert_fuse_and_graph_beam_paths_run(dev, monkeypatch):
    """The calls that raised before insertion, the packed table, K5 and the
    graph beam were ported now run on the card: an add below the bulk-build
    size, the fused switch, and a table past the cap (graph beam)."""
    import comet_tpu_torch.indexes.hnsw as hnsw
    from comet_tpu_torch import HNSWIndex

    x = np.random.default_rng(2).integers(0, 256, size=(5000, 16)).astype(np.float32)
    idx = HNSWIndex(16, DistanceKind.L2, device="cuda")
    idx.add_batch(x[:100])
    assert idx.count() == 100
    monkeypatch.setenv("COMET_HNSW_FUSE", "1")
    fused = HNSWIndex(16, DistanceKind.L2, device="cuda")
    fused.add_batch(x)
    assert fused.search_batch(x[:5], k=1)[1][:, 0].tolist() == [0.0] * 5
    monkeypatch.delenv("COMET_HNSW_FUSE")
    monkeypatch.setattr(hnsw, "BLOCKED_TABLE_BYTES_MAX", 1 << 10)
    big = HNSWIndex(16, DistanceKind.L2, device="cuda")
    big.add_batch(x)
    assert big.search_batch(x[:5], k=1)[1][:, 0].tolist() == [0.0] * 5


# -- the packed table, K5, K2's bf16 operand -------------------------------------------


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("d,w", [(128, 32), (16, 4), (100, 12)])
def test_gather_score_packed_kernel_matches_plain(dev, d, w, fused):
    """The packed layout bit-equal to its plain version and to the blocked
    layout; d = 16, W = 4 gives 152-byte rows (cap 4096, ndig 2), so most
    rows start off a 16-byte boundary."""
    bk, rng, x, q, adj, sqn, _, _, _ = _seed_loop_case(dev, d=d, w=w)
    n = x.shape[0]
    nodes = torch.from_numpy(rng.integers(-1, n, size=(q.shape[0], 8)).astype(np.int32)).to(dev)
    adj[nodes[0, 0].clamp_min(0).long(), w // 2:] = -1
    nbr_vecs, aux = bk.build_blocked_tables(adj, x, sqn)
    packed = bk.build_packed_table(adj, x, sqn)
    allowed = torch.from_numpy(rng.random(n) < 0.7).to(dev)
    qb, qn = q.to(torch.bfloat16), (q * q).sum(dim=1)
    before = (bk.SCORE_LAUNCHES, bk.PACKED_SCORE_LAUNCHES)
    got = bk.gather_score(qb, qn, packed, None, nodes, allowed, 250.0, fused)
    torch.cuda.synchronize()
    assert (bk.SCORE_LAUNCHES, bk.PACKED_SCORE_LAUNCHES) == (before[0], before[1] + 1)
    want = bk._gather_score_plain(qb, qn, packed, None, nodes, allowed, 250.0, fused)
    blocked = bk.gather_score(qb, qn, nbr_vecs, aux, nodes, allowed, 250.0, fused)
    for g, wv, b in zip(got, want, blocked):
        assert (g is None) == (wv is None) == (b is None)
        if g is not None:
            assert torch.equal(g, wv) and torch.equal(g, b)


@pytest.mark.parametrize("q_n,ef,expand,w,d,stop", [
    (2048, 256, 8, 32, 128, None), (2048, 256, 8, 32, 128, 64), (300, 64, 4, 8, 16, 16),
    (130, 32, 23, 4, 16, None),
])
def test_fused_expand_kernel_matches_plain(dev, q_n, ef, expand, w, d, stop):
    """K5 bit-equal to its plain version (the split pair's plain versions)
    and to the split pair's kernels, on Gaussian data and a random beam."""
    from comet_tpu_torch.ops import beam_kernel as bk

    rng = np.random.default_rng(q_n + ef + d)
    n = 4096
    x = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).to(dev)
    q = torch.from_numpy(rng.normal(size=(q_n, d)).astype(np.float32)).to(dev)
    adj = torch.from_numpy(rng.integers(-1, n, size=(n, w)).astype(np.int32)).to(dev)
    sqn = (x * x).sum(dim=1)
    packed = bk.build_packed_table(adj, x, sqn)
    state = [torch.from_numpy(a).to(dev) for a in _merge_state(rng, q_n, ef, 8, cap=n)]
    nodes = torch.from_numpy(rng.integers(-1, n, size=(q_n, expand)).astype(np.int32)).to(dev)
    qb, qn = q.to(torch.bfloat16), (q * q).sum(dim=1)
    before = bk.FUSE_LAUNCHES
    got = bk.fused_expand_merge(nodes, packed, qb, qn, *state[:3], ef=ef, expand=expand,
                                stop=stop)
    torch.cuda.synchronize()
    assert bk.FUSE_LAUNCHES == before + 1
    want = bk._fused_expand_plain(nodes, packed, qb, qn, *state[:3], ef, expand, stop or ef)
    nd, ns, _ = bk.gather_score(qb, qn, packed, None, nodes, None, float("inf"), False)
    split = bk.beam_merge_step(*state[:3], nd, ns, ef=ef, ew=expand * w, expand=expand,
                               fused=False, stop=stop)
    for g, wv, sv in zip(got, want, split):
        assert torch.equal(g, wv) and torch.equal(g, sv)
    assert (got[3][:, expand] == 1).any()


@pytest.mark.parametrize("q_n,e,w,d,cap", edge_cases.SCORE_CASES)
def test_gather_score_edges_match_plain(dev, q_n, e, w, d, cap):
    """The scoring kernel's staging at edge shapes (W 1-64, d 3-1536, expand
    1-23, Q 1-2048, ndig 2-3, packed rows off 16-byte boundaries, passes of
    a slice of a node, -1 nodes and empty entries; ops/edge_cases.py): nd,
    ns and adm equal to the plain version in both layouts and both modes."""
    edge_cases.check_scoring(dev, q_n, e, w, d, cap)


@pytest.mark.parametrize("q_n,e,w,d,cap", edge_cases.SCORE_CASES)
def test_fused_expand_edges_match_plain(dev, q_n, e, w, d, cap):
    """K5 at the same edge shapes, at stop = ef and stop < ef: equal to its
    plain version and to the split pair's kernels."""
    edge_cases.check_k5(dev, q_n, e, w, d, cap)


@pytest.mark.parametrize("cosine", [False, True])
@pytest.mark.parametrize("q_n,n,d", [(300, 4096, 20), (64, 1024, 128), (256, 8192, 128)])
def test_fused_dist_select_bf16_kernel_matches_plain(dev, cosine, q_n, n, d):
    """K2's bf16 operand on Gaussian (non-integer) data: bit-equal to the
    plain version, which sums the exact bf16 products in the kernel's
    order; launches count apart from the float32 mode's."""
    rng = np.random.default_rng(q_n + n + cosine)
    q, x, mask = _scan_inputs(rng, q_n, n, d, True)
    if not cosine:
        q, x = q * 3.0, x * 3.0
        mask = np.where(np.isinf(mask), np.inf, (x * x).sum(axis=1)).astype(np.float32)
    qt, mt = torch.from_numpy(q).to(dev), torch.from_numpy(mask).to(dev)
    xb = torch.from_numpy(x).to(dev).to(torch.bfloat16)
    before = (fused_scan.LAUNCHES, fused_scan.BF16_LAUNCHES)
    dist, gsel = fused_scan.fused_dist_select(qt, xb, mt, float("inf"), 8, cosine)
    torch.cuda.synchronize()
    assert (fused_scan.LAUNCHES, fused_scan.BF16_LAUNCHES) == (before[0], before[1] + 1)
    want_d, want_gmin = fused_scan._fused_dist_select_plain(qt, xb, mt, float("inf"), cosine)
    assert torch.equal(dist, want_d)
    assert torch.equal(gsel, sortnet._topk_rows_plain(want_gmin, None, 8)[1])
    assert torch.isfinite(dist).any()


@pytest.mark.parametrize("rerank", [False, True])
def test_flat_bf16_index_cuda_matches_cpu(dev, rerank):
    rng = np.random.default_rng(8)
    x = rng.integers(0, 256, size=(9000, 32)).astype(np.float32)
    q = rng.integers(0, 256, size=(70, 32)).astype(np.float32)
    out = []
    for device in ("cuda", "cpu"):
        idx = FlatIndex(32, DistanceKind.L2, storage="bfloat16", rerank=rerank, device=device)
        idx.add_batch(x, ids=range(10, 9010))
        idx.remove(12)
        out.append(idx.search_batch(q, k=20) + idx.search_batch(q, k=20, threshold=300.0))
    for got, want in zip(*out):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("switch", ["COMET_HNSW_PACKED", "COMET_HNSW_FUSE"])
def test_hnsw_insert_packed_fused_cuda_matches_plain_and_cpu(dev, switch, monkeypatch):
    """Insertion on the card builds the CPU index's graph (integer data),
    the in-place tables equal fresh builds, and the packed / fused searches
    equal the plain beam and the CPU index."""
    from comet_tpu_torch import HNSWConfig, HNSWIndex
    from comet_tpu_torch.ops import beam_kernel as bk

    monkeypatch.setenv(switch, "1")
    monkeypatch.setenv("COMET_HNSW_SEED", "1")
    rng = np.random.default_rng(23)
    x = rng.integers(0, 256, size=(7000, 32)).astype(np.float32)
    q = rng.integers(0, 256, size=(300, 32)).astype(np.float32)
    out = {}
    for device in ("cuda", "cpu"):
        idx = HNSWIndex(32, DistanceKind.L2, HNSWConfig(m=8, ef_construction=64, ef_search=64),
                        device=device)
        idx.add_batch(x[:5000], ids=range(1, 5001))
        idx.search_batch(q, k=10)
        idx.add_batch(x[5000:], ids=range(5001, 7001))
        out[device] = (idx, idx.search_batch(q, k=10))
    idx, res = out["cuda"]
    np.testing.assert_array_equal(idx._adj0, out["cpu"][0]._adj0)
    vecs, sqn, _ = idx._store.device_state()
    adj = torch.from_numpy(idx._adj0).to(dev)
    packed, (table, aux) = idx._table
    assert packed and aux is None
    assert torch.equal(table, bk.build_packed_table(adj, vecs, sqn))
    before = (bk.FUSE_LAUNCHES, bk.PACKED_SCORE_LAUNCHES)
    again = idx.search_batch(q, k=10)
    ran = (bk.FUSE_LAUNCHES - before[0], bk.PACKED_SCORE_LAUNCHES - before[1])
    # an unfiltered search runs K5 alone, or the packed scoring alone
    assert (ran[0] > 0, ran[1] > 0) == ((True, False) if switch == "COMET_HNSW_FUSE"
                                        else (False, True))
    with _plain_versions():
        plain = idx.search_batch(q, k=10)
    for got, want, cpu in zip(again, plain, out["cpu"][1]):
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, cpu)
    np.testing.assert_array_equal(res[0], again[0])


# -- float16 / int8 flat storage, PQ and IVFPQ ----------------------------------------


@pytest.mark.parametrize("rerank", [False, True], ids=["scan", "rerank"])
@pytest.mark.parametrize("storage", ["float16", "int8"])
def test_flat_f16_int8_index_cuda_matches_cpu(dev, storage, rerank):
    """K2's float16 and int8 operands in the flat index against the CPU
    index (plain versions): integer rows, and an int8 scale of 2 (trained
    on a sample whose abs-max is 254), make every distance exact."""
    rng = np.random.default_rng(9)
    x = rng.integers(0, 256, size=(9000, 32)).astype(np.float32)
    q = rng.integers(0, 256, size=(70, 32)).astype(np.float32)
    out = []
    for device in ("cuda", "cpu"):
        idx = FlatIndex(32, DistanceKind.L2, storage=storage, rerank=rerank, device=device)
        if storage == "int8":
            idx.train(np.full((1, 32), 254.0, np.float32))
        idx.add_batch(x, ids=range(10, 9010))
        idx.remove(12)
        before = (fused_scan.F16_LAUNCHES, fused_scan.INT8_LAUNCHES)
        out.append(idx.search_batch(q, k=20) + idx.search_batch(q, k=20, threshold=300.0))
        if device == "cuda":
            after = (fused_scan.F16_LAUNCHES, fused_scan.INT8_LAUNCHES)
            assert after[storage == "int8"] > before[storage == "int8"]
    for got, want in zip(*out):
        np.testing.assert_array_equal(got, want)


def _int_pq_state(rng, n, d, m, nbits):
    books = rng.integers(-3, 4, size=(m, 1 << nbits, d // m)).astype(np.float32)
    codes = rng.integers(0, 1 << nbits, size=(n, m)).astype(np.int32)
    valid = rng.random(n) > 0.05
    return np.arange(1, n + 1, dtype=np.uint32), codes, valid, books


@pytest.mark.parametrize("route", ["dense", "adc"])
def test_pq_index_cuda_matches_plain_and_cpu(dev, route, monkeypatch):
    """PQ on the card (K2 and K1, or ADC with K1's selects) against the
    same index with every wrapper on its plain version and against the CPU
    index: integer codebooks make every distance exact."""
    from comet_tpu_torch import PQIndex
    from comet_tpu_torch.indexes import pq

    if route == "adc":
        monkeypatch.setattr(pq, "DECODED_BYTES_MAX", 0)
    rng = np.random.default_rng(12)
    ids, codes, valid, books = _int_pq_state(rng, 20000, 32, 8, 8)
    rot = np.eye(32, dtype=np.float32)[rng.permutation(32)]
    q = rng.integers(-6, 7, size=(300, 32)).astype(np.float32)
    out = []
    for device in ("cuda", "cpu"):
        idx = PQIndex.load_reference_state(ids, codes, valid, len(ids), books, rot,
                                           device=device)
        before = sortnet.LAUNCHES
        out.append(idx.search_batch(q, k=40) + idx.search_batch(q, k=40, threshold=9.5))
        if device == "cuda":
            assert sortnet.LAUNCHES > before
            with _plain_versions():
                plain = idx.search_batch(q, k=40) + idx.search_batch(q, k=40, threshold=9.5)
            for got, want in zip(out[0], plain):
                np.testing.assert_array_equal(got, want)
    for got, want in zip(*out):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("route", ["sparse", "dense", "walk"])
def test_ivfpq_index_cuda_matches_plain_and_cpu(dev, route, monkeypatch):
    """IVFPQ on each route on the card (K3, K2's nprobe mode, the walk; K1
    in every select and the device re-rank) against the plain versions on
    the card and the CPU index: integer state, so every distance is exact
    (the sparse route breaks ties at the k-th score by scan order on both
    devices alike)."""
    from comet_tpu_torch import IVFPQIndex
    from comet_tpu_torch.indexes import pq

    monkeypatch.setenv("COMET_IVFPQ_SPARSE", "1" if route == "sparse" else "0")
    if route == "walk":
        monkeypatch.setattr(pq, "DECODED_BYTES_MAX", 0)
    rng = np.random.default_rng(13)
    ids, codes, valid, books = _int_pq_state(rng, 20000, 32, 8, 8)
    cents = rng.integers(-20, 21, size=(64, 32)).astype(np.float32)
    assign = rng.integers(0, 64, size=20000).astype(np.int32)
    vectors = (cents[assign] + rng.integers(-4, 5, size=(20000, 32))).astype(np.float32)
    q = vectors[rng.integers(0, 20000, size=300)] + 1.0
    out = []
    for device in ("cuda", "cpu"):
        idx = IVFPQIndex.load_reference_state(ids, codes, assign, valid, len(ids), cents, books,
                                              vectors=vectors, device=device)
        before = sortnet.LAUNCHES
        res = (idx.search_batch(q, k=40, nprobes=6)
               + idx.search_batch(q, k=10, nprobes=6, nrefine=64)
               + idx.search_batch(q, k=40, nprobes=6, threshold=30.5))
        out.append(res)
        if device == "cuda":
            assert sortnet.LAUNCHES > before
            with _plain_versions():
                plain = (idx.search_batch(q, k=40, nprobes=6)
                         + idx.search_batch(q, k=10, nprobes=6, nrefine=64)
                         + idx.search_batch(q, k=40, nprobes=6, threshold=30.5))
            for got, want in zip(res, plain):
                np.testing.assert_array_equal(got, want)
    for got, want in zip(*out):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name,n_pad,q_n,k,chunk", edge_cases.BM25_CASES)
def test_bm25_scorer_edges_match_plain(dev, name, n_pad, q_n, k, chunk):
    """The BM25 scorer bit-equal to `_bm25_score_plain` (ids and scores)
    and its dense rows to the plain rows: empty queries, a term with no
    postings, one covering every document, repeated terms, every document
    deleted or filtered out, k above the matches, documents at the padding
    edge, Q not a multiple of the block or the chunk, k = 1 and 1024; and
    the kernel's tiling: n_pad not a multiple of the tile, runs across
    tiles and in the last one, one query over 70,000 and 330,000
    documents, Q not a multiple of the query group, a term shared at one
    position or at different ones, queries past one window of positions,
    untouched allowed documents (-0.0) beside filtered ones."""
    assert edge_cases.check_bm25(dev, name, n_pad, q_n, k, chunk) == 0.0


def _bm25_docs(rng, n_docs, n_vocab=300):
    vocab = [f"w{i}x" for i in range(n_vocab)]
    ranks = rng.zipf(1.3, size=(n_docs, 12)) % n_vocab
    return vocab, [" ".join(vocab[t] for t in row[: 2 + i % 10]) for i, row in enumerate(ranks)]


def test_bm25_index_cuda_matches_cpu(dev):
    """The same documents on the card and on the CPU: search_batch (with a
    soft delete and a filter, k = 10 and 1000) and execute (k = 10, every
    match) give the same ids and scores, bit for bit, the card launching
    the scorer."""
    from comet_tpu_torch import BM25SearchIndex
    from comet_tpu_torch.ops import bm25

    rng = np.random.default_rng(21)
    vocab, texts = _bm25_docs(rng, 3000)
    queries = [" ".join(vocab[t] for t in rng.integers(0, 300, size=n)) for n in (1, 2, 10) * 40]
    out = []
    for device in ("cuda", "cpu"):
        idx = BM25SearchIndex(device=device)
        idx.add_batch(range(1, 3001), texts)
        idx.remove(17)
        before = bm25.LAUNCHES
        res = [idx.search_batch(queries, k=10), idx.search_batch(queries, k=1000),
               idx.search_batch(queries, k=10, document_ids=range(1, 3001, 4))]
        execs = [idx.new_search().with_query(queries[i]).with_k(k).execute()
                 for i in (0, 1, 2) for k in (10, 0)]
        res.append([np.array([[r.id, r.score] for r in e]) for e in execs])
        if device == "cuda":
            assert bm25.LAUNCHES > before
        out.append(res)
    for got, want in zip(out[0][:3], out[1][:3]):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    for got, want in zip(out[0][3], out[1][3]):
        np.testing.assert_array_equal(got, want)


def test_hybrid_cuda_matches_cpu(dev):
    """A hybrid index of a FlatIndex, a BM25SearchIndex and a metadata
    index on the card against the same on the CPU: search_batch for every
    fusion kind under a filter, and execute, equal."""
    from comet_tpu_torch import (BM25SearchIndex, FusionKind, RoaringMetadataIndex, eq,
                                 new_hybrid_search_index)

    rng = np.random.default_rng(22)
    vocab, texts = _bm25_docs(rng, 2000)
    vecs = rng.integers(0, 16, size=(2000, 24)).astype(np.float32)
    q = rng.integers(0, 16, size=(50, 24)).astype(np.float32)
    qt = [" ".join(vocab[t] for t in rng.integers(0, 300, size=2)) for _ in range(50)]
    out = []
    for device in ("cuda", "cpu"):
        h = new_hybrid_search_index(FlatIndex(24, DistanceKind.L2, device=device),
                                    BM25SearchIndex(device=device), RoaringMetadataIndex())
        h.vector_index().add_batch(vecs, ids=range(1, 2001))
        h.text_index().add_batch(range(1, 2001), texts)
        h.metadata_index().add_columns(np.arange(1, 2001), {"cat": np.array(list("abcd") * 500)})
        res = [[(r.id, r.score) for row in h.search_batch(q, qt, k=10, fusion_kind=kind,
                                                          metadata_filters=[eq("cat", "a")])
                for r in row] for kind in FusionKind]
        res.append([(r.id, r.score) for r in h.new_search().with_vector(q[0]).with_text(qt[0])
                    .with_metadata(eq("cat", "b")).with_k(10).execute()])
        out.append(res)
    assert out[0] == out[1]


@pytest.mark.parametrize("kind", ["flat", "ivf", "hnsw"])
def test_store_cuda_matches_cpu(dev, kind, tmp_path, monkeypatch):
    """A persistent store with tiny thresholds whose factories make card
    indexes, rotated, flushed, with removals of flushed documents,
    compacted and reopened, against the same operations with CPU
    factories: vector, text and hybrid searches equal, the card launching
    the kernels. The IVF template trains from one CPU-trained state on
    both sides."""
    import io

    from comet_tpu_torch import (BM25SearchIndex, HNSWConfig, HNSWIndex, IVFIndex,
                                 RoaringMetadataIndex, eq, storage)
    from comet_tpu_torch.core import node
    from comet_tpu_torch.ops import bm25

    rng = np.random.default_rng(23)
    vocab, texts = _bm25_docs(rng, 600)
    vecs = rng.integers(0, 16, size=(600, 16)).astype(np.float32)
    q = rng.integers(0, 16, size=(20, 16)).astype(np.float32)
    qt = [" ".join(vocab[t] for t in rng.integers(0, 300, size=2)) for _ in range(20)]
    if kind == "ivf":
        template = IVFIndex(16, 8, DistanceKind.L2, device="cpu")
        template.train(vecs)
        buf = io.BytesIO()
        template.write_to(buf)
        monkeypatch.setattr(IVFIndex, "train", lambda self, v, max_iter=20: self.read_from(
            io.BytesIO(buf.getvalue())))

    def vector_factory(device):
        if kind == "flat":
            return lambda: FlatIndex(16, DistanceKind.L2, device=device)
        if kind == "ivf":
            return lambda: IVFIndex(16, 8, DistanceKind.L2, device=device)
        return lambda: HNSWIndex(16, DistanceKind.L2, HNSWConfig(m=8, ef_construction=32,
                                                                 ef_search=64), device=device)

    def searches(store):
        out = []
        for i in range(20):
            for b in (store.new_search().with_vector(q[i]),
                      store.new_search().with_text(qt[i]),
                      store.new_search().with_vector(q[i]).with_text(qt[i])
                      .with_metadata(eq("cat", "a"))):
                out.append([(r.id, r.score) for r in b.with_k(10).with_nprobes(4).execute()])
        return out

    out = []
    for device in ("cuda", "cpu"):
        node._reset_node_id_counter()
        cfg = storage.StorageConfig(
            base_dir=str(tmp_path / device), memtable_size_limit=64 << 10,
            compaction_threshold=3, vector_index_factory=vector_factory(device),
            text_index_factory=lambda: BM25SearchIndex(device=device),
            metadata_index_factory=RoaringMetadataIndex)
        before = (sortnet.LAUNCHES, bm25.LAUNCHES)
        with storage.open_persistent_hybrid_index(cfg) as store:
            if kind == "ivf":
                store.train(vecs)
            ids = store.add_batch([(vecs[i], texts[i], {"cat": "abcd"[i % 4], "num": i})
                                   for i in range(600)])
            rotated = store.memtables.count()
            store.flush()
            for doc_id in ids[::37]:
                assert store.remove(doc_id)
            n_seg = store.segments.count()
            store.maybe_compact()
            res = [rotated, n_seg, store.segments.count(), searches(store)]
        with storage.open_persistent_hybrid_index(cfg) as store:
            if kind == "ivf":
                store.train(vecs)
            res.append(searches(store))
            res.append([store.has_document(d) for d in ids[::37] + ids[1::37]])
        if device == "cuda":
            assert sortnet.LAUNCHES > before[0] and bm25.LAUNCHES > before[1]
            assert rotated > 3 and res[2] < n_seg
        out.append(res)
    assert out[0] == out[1]


def test_launch_counters_exact_across_threads(dev):
    """The wrappers' launch counters are exact when threads launch at once
    (the store searches its segments in a thread pool): 16 threads x 50
    selects with the interpreter switching every microsecond."""
    import sys
    import threading

    vals = torch.rand((4, 300), device=dev)
    before = sortnet.LAUNCHES
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [sortnet.topk_rows(vals, None, 5)
                                                    for _ in range(50)]) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    torch.cuda.synchronize()
    assert sortnet.LAUNCHES - before == 16 * 50


def test_profiling_timer_times_the_card(dev):
    """utils/profiling's Timer on a CUDA device: the span waits for the
    card's work and times it with CUDA events."""
    from comet_tpu_torch.utils import profiling

    a = torch.rand((2048, 2048), device=dev)
    with profiling.Timer("mm", device=dev) as t:
        b = t.sync(a @ a)
    assert b.shape == (2048, 2048)
    assert 0 < t.device_elapsed and t.device_elapsed <= t.elapsed * 1.01 + 1e-4
    with profiling.timed("span", dev) as s:
        a @ a
    assert s.device_elapsed > 0


# -- sharding: shards on one card ---------------------------------------------------


@pytest.mark.parametrize("shards", [1, 2, 4])
@pytest.mark.parametrize("searcher", ["flat", "ivf"])
def test_sharded_search_cuda_matches_single_device_and_plain(dev, searcher, shards):
    """A mesh of S shards on cuda:0: the sharded flat and IVF searches
    launch K2 and K1 (the merge included) and equal the single-device
    index and the same search on the plain versions; integer data and
    centroids, so every distance is exact."""
    from comet_tpu_torch import FlatIndex, IVFIndex
    from comet_tpu_torch.parallel import (ShardedFlatSearcher, ShardedIVFSearcher,
                                          make_corpus_mesh)

    rng = np.random.default_rng(17)
    x = rng.integers(0, 256, size=(20000, 32)).astype(np.float32)
    q = rng.integers(0, 256, size=(300, 32)).astype(np.float32)
    allowed = np.arange(20000) % 3 != 0
    mesh = make_corpus_mesh([dev] * shards)
    if searcher == "flat":
        single = FlatIndex(32, DistanceKind.L2, device="cuda")
        single.add_batch(x, ids=range(1, 20001))
        sharded = ShardedFlatSearcher(mesh, x, DistanceKind.L2)
        search = lambda **kw: sharded.search(q, 40, **kw)          # noqa: E731
        want = single.search_batch(q, k=40)
    else:
        single = IVFIndex(32, 64, DistanceKind.L2, device="cuda")
        single.train(x[:4000])
        single._set_centroids(np.rint(single._centroids).astype(np.float32))
        single.add_batch(x, ids=range(1, 20001))
        sharded = ShardedIVFSearcher(mesh, single)
        search = lambda **kw: sharded.search(q, 40, nprobe=6, **kw)  # noqa: E731
        want = single.search_batch(q, k=40, nprobes=6)
    before = (sortnet.LAUNCHES, fused_scan.LAUNCHES + fused_scan.NPROBE_LAUNCHES)
    scores, slots = search()
    torch.cuda.synchronize()
    assert sortnet.LAUNCHES > before[0]
    assert fused_scan.LAUNCHES + fused_scan.NPROBE_LAUNCHES > before[1]
    np.testing.assert_array_equal(slots + 1, want[0])
    np.testing.assert_array_equal(scores, want[1])
    f_scores, f_slots = search(allowed=allowed)
    with _plain_versions():
        for got, want in ((search(), (scores, slots)),
                          (search(allowed=allowed), (f_scores, f_slots))):
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])
    assert allowed[f_slots[f_slots != SENT]].all()
