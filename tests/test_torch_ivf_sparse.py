"""comet_tpu_torch.ops.ivf_sparse (block-sparse IVF scan, kernel K3, and its
pipeline) against comet_tpu.ops.ivf_sparse on the CPU, the reference's
Pallas kernel in interpret mode.

Inputs come from a seeded numpy generator and go to both packages. The
data are exact in float32: integer-valued vectors and centroids for L2,
vectors of +-0.5 entries for cosine, so both packages probe the same
clusters and compute the same distances. Bar: array-equal layouts, chunk
lists, overflow counts, distances, ids and scores. Each reference pipeline
is compiled once per static shape (`lru_cache`), and the cases share
shapes so that they share compiles.
"""

import os
from functools import lru_cache

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comet_tpu.ops import ivf_sparse as ref
from comet_tpu_torch.ops import edge_cases
from comet_tpu_torch.ops import ivf_sparse as sp

D = 16


# -- layout and budgets (host) --------------------------------------------------


@pytest.mark.parametrize("nlist,n,lo", [(7, 1000, -1), (3, 4, -1), (1, 1, 0), (16, 5000, 0)])
def test_build_cluster_major_matches_reference(nlist, n, lo):
    assign = np.random.default_rng(n).integers(lo, nlist, size=n).astype(np.int32)
    if n == 4:
        assign[:] = -1                        # nothing assigned
    want, got = ref.build_cluster_major(assign, nlist), sp.build_cluster_major(assign, nlist)
    assert got.keys() == want.keys()
    for key in ("perm", "chunk_start", "nchunks"):
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])
    assert got["max_chunks"] == want["max_chunks"]


def test_default_budgets_match_reference():
    for nprobe in (1, 3, 8, 10, 20, 32, 64):
        for nlist, total, mc in ((8, 16, 2), (1024, 4600, 40), (16, 32, 4), (100, 90, 3)):
            assert sp.default_budgets(nprobe, nlist, total, mc) == \
                ref.default_budgets(nprobe, nlist, total, mc)


# -- chunk lists ---------------------------------------------------------------


def _lists_both(probes, nchunks, S, UC, MC):
    nlist = len(nchunks)
    chunk_start = np.zeros(nlist + 1, np.int32)
    chunk_start[1:] = np.cumsum(nchunks)
    want = ref._group_chunk_lists(jnp.asarray(probes), jnp.asarray(chunk_start),
                                  jnp.asarray(nchunks), S=S, UC=UC, MC=MC, nlist=nlist)
    got = sp._group_chunk_lists(torch.from_numpy(probes), torch.from_numpy(chunk_start),
                                torch.from_numpy(nchunks), S, UC, MC, nlist)
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


@pytest.mark.parametrize("S,UC", [(64, 16), (8, 16), (32, 3)],
                         ids=["ample", "S-cut", "UC-cut"])
def test_group_chunk_lists_match_reference(S, UC):
    """Three groups with diverse probes over unbalanced clusters (some
    empty): chunk ids, cluster ids (-1 dead), kept and overflow counts."""
    rng = np.random.default_rng(S + UC)
    nlist = 16
    nchunks = rng.integers(0, 4, size=nlist).astype(np.int32)
    probes = np.stack([rng.permutation(nlist)[:6] for _ in range(3 * sp.QG)]).astype(np.int32)
    probes[: sp.QG] = probes[0]               # one group probes just 6 clusters
    probes = np.concatenate([probes, probes[:, :2]], axis=1)   # padded width 8
    want, got = _lists_both(probes, nchunks, S, UC, int(max(nchunks.max(), 1)))
    for g, w in zip(got, want):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, w)
    if S < 64 or UC < 16:
        assert want[3].max() > 0              # the cut shows as overflow


def test_group_chunk_lists_all_empty_clusters():
    """A group that probes only empty clusters walks dead steps only."""
    nchunks = np.array([0, 0, 3, 0], np.int32)
    probes = np.tile(np.array([[0, 1, 3, 0]], np.int32), (sp.QG, 1))
    want, got = _lists_both(probes, nchunks, 8, 4, 3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert (got[1] == -1).all() and (got[0] == 0).all() and got[3][0] == 0


# -- shared data for the scan and the pipelines ------------------------------------

NLIST = 8
N = NLIST * 500          # 500 rows a cluster: two 256-row chunks each
K = 8                    # one k for every interpret-mode pipeline (one compile each)
S_SMALL = 8              # a step budget that fits 4 clusters of a group, not 8


def _signs(rng, n):
    v = np.zeros((n, D), np.float32)
    for r in range(n):
        v[r, rng.choice(D, 4, replace=False)] = rng.choice([-0.5, 0.5], 4)
    return v


@lru_cache(maxsize=None)
def _corpus(cosine):
    """Corpus, centroids and assignments. L2: integer centroids on a line,
    rows = centroid + integer noise. Cosine: +-0.5 vectors, each assigned
    to its most similar centroid (ties to the lower id)."""
    rng = np.random.default_rng(50 + cosine)
    if cosine:
        cents = _signs(rng, NLIST)
        x = _signs(rng, N)
        assign = np.argmax(x @ cents.T, axis=1).astype(np.int32)
    else:
        cents = (np.arange(NLIST, dtype=np.float32)[:, None] * 40.0
                 + rng.integers(0, 3, size=(NLIST, D))).astype(np.float32)
        assign = np.repeat(np.arange(NLIST, dtype=np.int32), N // NLIST)
        x = (cents[assign] + rng.integers(-8, 9, size=(N, D))).astype(np.float32)
    return x, cents, assign


def _queries(cosine, spread, q_n, seed):
    """The first q_n of 2 QG queries. L2: near clusters 0-1 (`spread`
    False: a group probes 3 clusters) or near any cluster (`spread` True: a
    group probes all 8)."""
    rng = np.random.default_rng(seed)
    x, cents, _ = _corpus(cosine)
    if cosine:
        return _signs(rng, 2 * sp.QG)[:q_n]
    which = rng.integers(0, NLIST if spread else 2, size=2 * sp.QG)
    q = cents[which] + rng.integers(-8, 9, size=(2 * sp.QG, D))
    return q[:q_n].astype(np.float32)


def _layout(cosine, fmask=None):
    x, cents, assign = _corpus(cosine)
    lay = sp.build_cluster_major(assign, NLIST)
    perm = lay["perm"]
    pc = np.maximum(perm, 0)
    base = np.zeros(N, np.float32) if cosine else (x * x).sum(axis=1)
    ok = perm >= 0
    if fmask is not None:
        ok &= fmask[pc]
    mask = np.where(ok, base[pc], np.inf).astype(np.float32)
    return x[pc], mask, perm, cents, lay


ORDER_KEY = (np.arange(NLIST, dtype=np.int32) * 5) % 3   # a spatial key, same on both sides


def _args(cosine, fmask):
    xr, mask, perm, cents, lay = _layout(cosine, fmask)
    return xr, mask, perm, cents, ORDER_KEY, lay["chunk_start"], lay["nchunks"], lay


# -- the scan: _sparse_scan_plain and K1's group select against the interpret-mode kernel


@lru_cache(maxsize=None)
def _scan_case():
    xr, mask, perm, cents, lay = _layout(False)
    rng = np.random.default_rng(60)
    q = _queries(False, True, 2 * sp.QG, seed=61)
    probes = rng.integers(0, NLIST, size=(2 * sp.QG, 8)).astype(np.int32)
    chunk_ids = rng.integers(0, int(lay["chunk_start"][-1]), size=(2, 6)).astype(np.int32)
    # each step's cluster is its chunk's, as the chunk lists give it
    cluster_ids = (np.searchsorted(lay["chunk_start"], chunk_ids, side="right") - 1).astype(np.int32)
    cluster_ids[0, 2] = -1                    # a dead step
    return q, xr, mask, probes, chunk_ids, cluster_ids


THR_SCAN = 6.0e4   # cuts the rows of far clusters


@lru_cache(maxsize=None)
def _ref_scan():
    q, xr, mask, probes, chunk_ids, cluster_ids = _scan_case()
    dist, gsel = ref._sparse_scan(
        jnp.asarray(q), jnp.asarray(np.ascontiguousarray(xr.T)), jnp.asarray(mask),
        jnp.asarray(probes), jnp.asarray(chunk_ids), jnp.asarray(cluster_ids),
        jnp.asarray(np.float32(THR_SCAN)), kb=8, S=6, interpret=True,
    )
    return np.asarray(dist), np.asarray(gsel)


def _group_select(gmin, kb):
    """K1's group select of the tile's minima, as the pipeline makes it:
    each query's top-kb groups by (minimum, position)."""
    return sp.topk_rows(gmin.reshape(-1, gmin.shape[-1]), None, kb)[1][:, :kb]


def test_sparse_scan_matches_reference():
    """Integer data, a threshold, a dead step: `_sparse_scan_plain`'s dist
    array-equal, and K1's group select of its minima the same kept groups,
    ordered by (group minimum, scan position)."""
    q, xr, mask, probes, chunk_ids, cluster_ids = _scan_case()
    rdist, rgsel = _ref_scan()
    t = [torch.from_numpy(a) for a in (q, xr, mask, probes, chunk_ids, cluster_ids)]
    dist, pgmin = sp._sparse_scan_plain(*t, THR_SCAN, False)
    dist, gsel = dist.numpy(), _group_select(pgmin, 8).numpy()
    np.testing.assert_array_equal(dist, rdist)
    assert np.isinf(dist[0, :, 2 * sp.CHUNK:3 * sp.CHUNK]).all()   # the dead step
    fin = np.isfinite(dist)
    assert fin.any() and (dist[fin] <= THR_SCAN).all()
    gmin = dist.reshape(2 * sp.QG, 12, sp.SEL_GROUP).min(axis=2)
    order = np.lexsort((np.broadcast_to(np.arange(12), gmin.shape), gmin), axis=1)[:, :8]
    gsel = gsel.reshape(2 * sp.QG, 8)
    np.testing.assert_array_equal(gsel, order)
    # The kept groups with a finite minimum are the reference's. Where a
    # query has fewer than kb of them, the reference fills the rest with
    # stale ids, repeats included (its accumulation window resets values,
    # not ids: ROADMAP Queue 3); the port's fill is the next positions.
    rgsel = rgsel.transpose(0, 2, 1).reshape(2 * sp.QG, 8)
    for r in range(2 * sp.QG):
        fin = np.isfinite(gmin[r])
        assert {g for g in gsel[r] if fin[g]} == {g for g in rgsel[r] if fin[g]}, r
        assert len(set(gsel[r])) == 8
    assert (np.isfinite(gmin).sum(axis=1) >= 8).any()      # some rows need no fill
    # the group minima K1's choice reads are those of the distances
    np.testing.assert_array_equal(pgmin.numpy().reshape(2 * sp.QG, 12), gmin)


THR_MEMBERS = 2.5e5   # about the median distance of the member-count layout


@lru_cache(maxsize=None)
def _member_case(bf16):
    """The card edge cases' member-count layout at d = 20 (ops/edge_cases.py:
    steps probed by 0, 1, 15, 16, 17, 64 and 128 of a group's queries, two
    dead steps), with the reference's interpret-mode distances. Integer
    vectors 0..255 are exact in bf16 and their products and sums exact in
    float32, so both modes are exact on both sides."""
    q, x, valid, probes, chunk_ids, cluster_ids = edge_cases.k3_case("counts", 20)
    mask = np.where(valid, (x * x).sum(axis=1), np.inf).astype(np.float32)
    xt = jnp.asarray(np.ascontiguousarray(x.T))
    rdist, _ = ref._sparse_scan(
        jnp.asarray(q), xt.astype(jnp.bfloat16) if bf16 else xt, jnp.asarray(mask),
        jnp.asarray(probes), jnp.asarray(chunk_ids), jnp.asarray(cluster_ids),
        jnp.asarray(np.float32(THR_MEMBERS)), kb=8, S=chunk_ids.shape[1], bf16_domain=bf16,
        interpret=True,
    )
    return (q, x, mask, probes, chunk_ids, cluster_ids), np.asarray(rdist)


@pytest.mark.parametrize("bf16", [False, True], ids=["float32", "bf16"])
def test_sparse_scan_member_counts_match_reference(bf16):
    """`_sparse_scan_plain` at every member count a step can have (0 to
    128 probing queries, dead steps), in both modes, with a threshold:
    distances array-equal to the reference kernel; the rows of queries
    that do not probe a step's cluster +inf, and the group minima those of
    the distances."""
    (q, x, mask, probes, chunk_ids, cluster_ids), rdist = _member_case(bf16)
    t = torch.from_numpy
    corpus = t(x).to(torch.bfloat16) if bf16 else t(x)
    dist, gmin = sp._sparse_scan_plain(t(q), corpus, t(mask), t(probes), t(chunk_ids),
                                       t(cluster_ids), THR_MEMBERS, False)
    dist, gmin = dist.numpy(), gmin.numpy()
    np.testing.assert_array_equal(dist, rdist)
    g_n, s_n = chunk_ids.shape
    member = (probes.reshape(g_n, sp.QG, -1, 1) == cluster_ids[:, None, None, :]).any(axis=2)
    fin = np.isfinite(dist.reshape(g_n, sp.QG, s_n, sp.CHUNK)).any(axis=3)
    assert not (fin & ~member).any()
    counts = sorted(member.sum(axis=1)[0].tolist())
    assert counts == sorted(list(edge_cases.K3_MEMBER_COUNTS) + [0, 0])
    assert (fin.sum(axis=1) == member.sum(axis=1)).all()   # every member row has a hit
    np.testing.assert_array_equal(
        gmin, dist.reshape(g_n, sp.QG, 2 * s_n, sp.SEL_GROUP).min(axis=3))


# -- the pipeline ------------------------------------------------------------------


@lru_cache(maxsize=None)
def _ref_pipe(cosine, spread, q_n, thr, filtered, S, mem_gb):
    q = _queries(cosine, spread, q_n, seed=70 + spread)
    fmask = _filter() if filtered else None
    xr, mask, perm, cents, okey, cs, nch, lay = _args(cosine, fmask)
    old = os.environ.get("COMET_SPARSE_MEM_GB")
    os.environ["COMET_SPARSE_MEM_GB"] = str(mem_gb)
    try:
        s, i, ov = ref.ivf_sparse_pipeline(
            jnp.asarray(q), jnp.asarray(np.ascontiguousarray(xr.T)), jnp.asarray(mask),
            jnp.asarray(perm), jnp.asarray(np.float32(thr)), jnp.asarray(cents),
            jnp.asarray(okey), jnp.asarray(cs), jnp.asarray(nch),
            k=K, nprobe=3, S=S, UC=min(S, NLIST), MC=lay["max_chunks"], nlist=NLIST,
            coarse_cosine=cosine, cosine=cosine, sqrt_out=not cosine, interpret=True,
        )
    finally:
        if old is None:
            del os.environ["COMET_SPARSE_MEM_GB"]
        else:
            os.environ["COMET_SPARSE_MEM_GB"] = old
    return np.asarray(s), np.asarray(i), np.asarray(ov)


def _filter():
    f = np.ones(N, bool)
    f[::3] = False
    return f


def _port_pipe(cosine, spread, q_n, thr, filtered, S, mem_gb, monkeypatch):
    q = _queries(cosine, spread, q_n, seed=70 + spread)
    fmask = _filter() if filtered else None
    xr, mask, perm, cents, okey, cs, nch, lay = _args(cosine, fmask)
    monkeypatch.setenv("COMET_SPARSE_MEM_GB", str(mem_gb))
    t = torch.from_numpy
    s, i, ov = sp.ivf_sparse_pipeline(
        t(q), t(xr), t(mask), t(perm), thr, t(cents), t(okey), t(cs), t(nch),
        K, 3, S, min(S, NLIST), lay["max_chunks"], NLIST,
        coarse_cosine=cosine, cosine=cosine, sqrt_out=not cosine,
    )
    return s.numpy(), i.numpy(), ov.numpy()


# (cosine, spread, q_n, threshold, filtered, S, envelope GiB)
PIPE_CASES = {
    "l2": (False, False, sp.QG, np.inf, False, S_SMALL, 8),
    "l2-threshold-filter": (False, False, sp.QG, 200.0, True, S_SMALL, 8),
    "l2-overflow": (False, True, sp.QG, np.inf, False, S_SMALL, 8),
    "l2-envelope-slices": (False, False, 2 * sp.QG, np.inf, False, S_SMALL, 1e-9),
    "cosine": (True, True, sp.QG, 0.75, False, 32, 8),
}


@pytest.mark.parametrize("case", list(PIPE_CASES))
def test_sparse_pipeline_matches_reference(case, monkeypatch):
    """ids, scores and per-group overflow array-equal to the reference
    pipeline, boundary ties (broken in scan order by both) included."""
    cfg = PIPE_CASES[case]
    rs, ri, rov = _ref_pipe(*cfg)
    s, i, ov = _port_pipe(*cfg, monkeypatch)
    np.testing.assert_array_equal(ov, rov)
    np.testing.assert_array_equal(i, ri)
    np.testing.assert_array_equal(s, rs)
    if case == "l2-overflow":
        assert ov.max() > 0
    else:
        assert ov.max() == 0
    if case == "l2-threshold-filter":
        hit = i[i != sp.IDX_SENTINEL]
        assert (i == sp.IDX_SENTINEL).any() and len(hit) and (hit % 3 != 0).all()
    if case == "l2-envelope-slices":
        assert len(ov) == 2
        # the first slice is the single-group "l2" batch
        s1, i1, _ = _ref_pipe(*PIPE_CASES["l2"])
        np.testing.assert_array_equal(i[: sp.QG], i1)


def test_pipeline_pads_ragged_batches(monkeypatch):
    """The port pads a batch to a multiple of QG with zero queries and
    returns the real rows only; a QG-aligned batch needs no padding."""
    cfg = PIPE_CASES["l2"]
    s, i, ov = _port_pipe(*cfg, monkeypatch)
    q = _queries(False, False, sp.QG, seed=70)
    xr, mask, perm, cents, okey, cs, nch, lay = _args(False, None)
    t = torch.from_numpy
    s2, i2, ov2 = sp.ivf_sparse_pipeline(
        t(q[:50]), t(xr), t(mask), t(perm), np.inf, t(cents), t(okey), t(cs), t(nch),
        K, 3, S_SMALL, NLIST, lay["max_chunks"], NLIST, sqrt_out=True,
    )
    assert s2.shape == (50, K) and len(ov2) == 1
    # exact within the probed lists: the zero padding changes no real row
    np.testing.assert_array_equal(s2.numpy(), s[:50])


# -- the bf16 mode (HNSW seed scans) and kb_cap ------------------------------------------


def _bf16_layout():
    """The L2 layout with the bf16-domain mask: the float32 value of each
    row's bf16 squared norm (the rows are integers, some above 256, so
    bf16 rounds them; both packages round to nearest even)."""
    xr, mask, perm, cents, lay = _layout(False)
    xb = torch.from_numpy(xr).to(torch.bfloat16)
    sq = torch.from_numpy((xr * xr).sum(axis=1)).to(torch.bfloat16).float().numpy()
    bmask = np.where(np.isfinite(mask), sq, np.inf).astype(np.float32)
    return xb, bmask, perm, cents, lay


@lru_cache(maxsize=None)
def _ref_scan_bf16():
    q, _, _, probes, chunk_ids, cluster_ids = _scan_case()
    xb, bmask, _, _, _ = _bf16_layout()
    xt = jnp.asarray(np.ascontiguousarray(xb.float().numpy().T)).astype(jnp.bfloat16)
    dist, gsel = ref._sparse_scan(
        jnp.asarray(q), xt, jnp.asarray(bmask), jnp.asarray(probes), jnp.asarray(chunk_ids),
        jnp.asarray(cluster_ids), jnp.asarray(np.float32(THR_SCAN)), kb=8, S=6,
        bf16_domain=True, interpret=True,
    )
    return np.asarray(dist), np.asarray(gsel)


def test_sparse_scan_bf16_matches_reference():
    """The bf16 mode: bf16 queries and corpus, float32 query norms, the
    bf16-domain mask: `_sparse_scan_plain`'s dist array-equal to the
    reference kernel's, and K1's group select of its minima in (minimum,
    position) order; K3's wrapper refuses a float32 corpus in this mode."""
    q, _, _, probes, chunk_ids, cluster_ids = _scan_case()
    xb, bmask, _, _, lay = _bf16_layout()
    rdist, _ = _ref_scan_bf16()
    t = torch.from_numpy
    lists = (t(probes), t(chunk_ids), t(cluster_ids))
    dist, pgmin = sp._sparse_scan_plain(t(q), xb, t(bmask), *lists, THR_SCAN, False)
    np.testing.assert_array_equal(dist.numpy(), rdist)
    gmin = rdist.reshape(2 * sp.QG, 12, sp.SEL_GROUP).min(axis=2)
    order = np.lexsort((np.broadcast_to(np.arange(12), gmin.shape), gmin), axis=1)[:, :8]
    np.testing.assert_array_equal(_group_select(pgmin, 8).numpy(), order)
    # bf16 rounding moved some distances off the float32 mode's
    f32, _ = sp._sparse_scan_plain(*(t(a) for a in _scan_case()), THR_SCAN, False)
    assert not np.array_equal(f32.numpy(), rdist)
    mc = lay["max_chunks"]
    with pytest.raises(ValueError, match="corpus must be"):
        sp._compact_scan(t(q), xb.float(), t(bmask), *lists, t(lay["chunk_start"]),
                         t(lay["nchunks"]), 8, mc, sp.compact_width(8, mc), THR_SCAN, False, True)


K_CAP = 32   # k of the kb_cap pipeline: kb = k_pow2(8) = 8 groups, not 32


@lru_cache(maxsize=None)
def _ref_pipe_bf16(q_n):
    q = _queries(False, True, q_n, seed=71)
    xb, bmask, perm, cents, lay = _bf16_layout()
    xt = jnp.asarray(np.ascontiguousarray(xb.float().numpy().T)).astype(jnp.bfloat16)
    s, i, ov = ref.ivf_sparse_pipeline(
        jnp.asarray(q), xt, jnp.asarray(bmask), jnp.asarray(perm),
        jnp.asarray(np.float32(np.inf)), jnp.asarray(cents), jnp.asarray(ORDER_KEY),
        jnp.asarray(lay["chunk_start"]), jnp.asarray(lay["nchunks"]),
        k=K_CAP, nprobe=3, S=S_SMALL, UC=S_SMALL, MC=lay["max_chunks"], nlist=NLIST,
        bf16_domain=True, kb_cap=8, hier=False, interpret=True,
    )
    return np.asarray(s), np.asarray(i), np.asarray(ov)


def _port_pipe_bf16(q_n, qn=None):
    q = _queries(False, True, q_n, seed=71)
    xb, bmask, perm, cents, lay = _bf16_layout()
    t = torch.from_numpy
    s, i, ov = sp.ivf_sparse_pipeline(
        t(q), xb, t(bmask), t(perm), np.inf, t(cents), t(ORDER_KEY), t(lay["chunk_start"]),
        t(lay["nchunks"]), K_CAP, 3, S_SMALL, S_SMALL, lay["max_chunks"], NLIST,
        bf16_domain=True, kb_cap=8, qn=qn,
    )
    return s.numpy(), i.numpy(), ov.numpy()


def test_sparse_pipeline_bf16_kb_cap_matches_reference():
    """The HNSW seed scan's configuration: bf16 mode, kb_cap below the
    exactness bound (8 groups for k = 32) and the overflow of a spread
    batch left as it is: ids, scores and overflow array-equal."""
    rs, ri, rov = _ref_pipe_bf16(sp.QG)
    s, i, ov = _port_pipe_bf16(sp.QG)
    np.testing.assert_array_equal(ov, rov)
    np.testing.assert_array_equal(i, ri)
    np.testing.assert_array_equal(s, rs)
    assert ov.max() > 0 and (i == sp.IDX_SENTINEL).any()


def test_sparse_pipeline_takes_the_callers_query_norms():
    """`qn` replaces the norms the scan would compute: the same values give
    the same result; larger ones raise every unclamped distance by the
    difference (integers: exact)."""
    q = _queries(False, True, sp.QG, seed=71)
    qn = torch.from_numpy((q * q).sum(axis=1))
    s, i, _ = _port_pipe_bf16(sp.QG)
    s2, i2, _ = _port_pipe_bf16(sp.QG, qn)
    np.testing.assert_array_equal(s2, s)
    np.testing.assert_array_equal(i2, i)
    s3, i3, _ = _port_pipe_bf16(sp.QG, qn + 1024.0)
    same = (i3 == i) & (s > 0) & np.isfinite(s)
    assert same.sum() >= 0.9 * (np.isfinite(s) & (s > 0)).sum() > 0
    np.testing.assert_array_equal(s3[same], s[same] + 1024.0)


# -- shortlists (kb_cap > 0) against the exact search and the reference tile's ------------

ROUTE_CASES_CPU = [c for c in edge_cases.K3_ROUTE_CASES
                   if c[1] in (3, 20) or (c[1] == 128 and not c[2])]


@pytest.mark.parametrize("layout,d,bf16", ROUTE_CASES_CPU)
def test_compact_route_equals_the_dense_route(layout, d, bf16):
    """Through `ivf_sparse_pipeline` on one layout (ops/edge_cases.py: dead
    steps, an overflowing budget, queries that probe only empty clusters,
    a threshold, a filter, a row narrower than k_pow2(k), a ragged batch,
    ties across the 128th place), float32 and the bf16 mode: a shortlist
    at the exact bound equals the exact search, and a shortlist of 8
    groups equals the one the reference's dense tile gives
    (`edge_cases.plain_shortlist`); scores, slots and overflow
    array-equal."""
    edge_cases.check_k3_routes(torch.device("cpu"), layout, d, bf16)


@pytest.mark.parametrize("layout", edge_cases.K3_ROUTE_LAYOUTS)
def test_shortlists_read_no_group_whose_minimum_is_inf(layout, monkeypatch):
    """On the card a shortlist's row is not filled, so a group with nothing
    scanned holds whatever the memory held: with every group whose
    minimum is +inf poisoned (-1.0, which a select would take first), a
    shortlist of 8 groups still equals the reference tile's
    (`edge_cases.plain_shortlist`)."""
    scan = sp._compact_scan_plain

    def poisoned(*args, **kw):
        cand, tab, gmin = scan(*args, **kw)
        if gmin is not None:
            groups = cand.view(cand.shape[0], -1, sp.SEL_GROUP)
            groups[torch.isinf(gmin)] = -1.0
        return cand, tab, gmin

    monkeypatch.setattr(sp, "_compact_scan_plain", poisoned)
    args = edge_cases.k3_route_args(torch.device("cpu"), edge_cases.k3_route_case(layout, 20),
                                    False)
    got = sp.ivf_sparse_pipeline(*args, sqrt_out=True, kb_cap=8)
    for a, b in zip(got, edge_cases.plain_shortlist(*args, 8)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("layout", edge_cases.K3_ROUTE_LAYOUTS)
def test_compact_row_group_minima_are_the_tiles_member_groups(layout):
    """The selection groups a shortlist picks from: on each layout, the
    128-place group minima of a query's compact row are the minima of the
    reference tile's groups in the steps whose cluster the query probes,
    in the tile's order, then +inf; and every other group of the tile is
    +inf. So K1's (minimum, position) select of either picks the same
    groups in the same order. `minima=True` returns those minima."""
    c = edge_cases.k3_route_case(layout, 20)
    (q, corpus, mask, _, thr, cents, okey, cs, nch, k, nprobe, S, UC, mc,
     nlist) = edge_cases.k3_route_args(torch.device("cpu"), c, False)
    q = torch.cat([q, q.new_zeros((-(-len(q) // sp.QG) * sp.QG - len(q), q.shape[1]))])
    plan = sp.scan_plan(q, cents, okey, cs, nch, k, nprobe, S, UC, mc, nlist, False, 8)
    lists = (plan["probes"], plan["chunk_ids"], plan["cluster_ids"])
    _, gmin = sp._sparse_scan_plain(plan["qsorted"], corpus, mask, *lists, thr, False)
    wc = sp.compact_width(nprobe, mc, k, 8)
    cand, _, got = sp._compact_scan_plain(plan["qsorted"], corpus, mask, *lists, cs, nch, nprobe,
                                          mc, wc, thr, False, minima=True)
    rows = q.shape[0]
    row_min = cand.view(rows, 2 * wc, sp.SEL_GROUP).amin(dim=2).numpy()
    np.testing.assert_array_equal(got.numpy(), row_min)
    tile_min = gmin.view(rows, 2 * plan["S"]).numpy()
    probes, cluster_ids = plan["probes"].numpy(), plan["cluster_ids"].numpy()
    for r in range(rows):
        live = cluster_ids[r // sp.QG]
        member = (live >= 0) & np.isin(live, probes[r, :nprobe])
        want = tile_min[r].reshape(-1, 2)[member].ravel()
        np.testing.assert_array_equal(row_min[r, :len(want)], want, err_msg=f"query {r}")
        assert np.isinf(row_min[r, len(want):]).all(), r
        assert np.isinf(tile_min[r].reshape(-1, 2)[~member]).all(), r
    assert np.isfinite(row_min).any()


def test_compact_places_are_each_querys_chunks_in_scan_order():
    """`_compact_places` of a query's first nprobe (distinct) probes, on a
    walk with an S cut, empty clusters and probes padded past nprobe: a
    query's member steps, in the group's walk order, take places 0, 1, 2,
    ... of its row with no gap, within `compact_width`."""
    rng = np.random.default_rng(5)
    nlist = 16
    nchunks = rng.integers(0, 4, size=nlist).astype(np.int32)
    probes = np.stack([rng.permutation(nlist)[:5] for _ in range(2 * sp.QG)]).astype(np.int32)
    probes = np.concatenate([probes, probes[:, :3]], axis=1)       # padded width 8
    chunk_start = np.zeros(nlist + 1, np.int32)
    chunk_start[1:] = np.cumsum(nchunks)
    mc = int(nchunks.max())
    t = torch.from_numpy
    chunk_ids, cluster_ids, _, overflow = sp._group_chunk_lists(
        t(probes), t(chunk_start), t(nchunks), 12, 16, mc, nlist)
    assert overflow.max() > 0                                      # the cut drops chunks
    starts = sp._walk_starts(cluster_ids, nlist)
    places = sp._compact_places(t(probes[:, :5]), starts, t(nchunks), mc).numpy()
    assert places.dtype == np.int32 and places.shape == (2 * sp.QG, 5)
    chunk_ids, cluster_ids = chunk_ids.numpy(), cluster_ids.numpy()
    for r in range(2 * sp.QG):
        g = r // sp.QG
        want = 0
        for s in range(chunk_ids.shape[1]):
            c = cluster_ids[g, s]
            if c < 0 or c not in probes[r]:
                continue
            j = int(np.flatnonzero(probes[r] == c)[0])
            assert places[r, j] + chunk_ids[g, s] - chunk_start[c] == want, (r, s)
            want += 1
        assert want <= sp.compact_width(5, mc)


def test_the_envelope_slices_each_route_by_its_own_width(monkeypatch):
    """An envelope that holds two groups' rows at the compact width (QG x W
    x 4 bytes each): the exact search and a shortlist whose groups fit that
    width run a 2-group batch as one slice; a shortlist of more groups than
    it holds widens the row (`compact_width`) and runs as two slices. Each
    gives the exact search's answer (kb_cap = k keeps every group it
    needs)."""
    calls = []
    pipeline = sp._pipeline

    def spy(q, *args):
        calls.append(q.shape[0])
        return pipeline(q, *args)

    monkeypatch.setattr(sp, "_pipeline", spy)
    q = _queries(False, False, 2 * sp.QG, seed=70)
    xr, mask, perm, cents, okey, cs, nch, lay = _args(False, None)
    mc, nprobe = lay["max_chunks"], 3
    w = sp.compact_width(nprobe, mc)
    assert sp.compact_width(nprobe, mc, 64, 64) > w == sp.compact_width(nprobe, mc, K, K)
    assert sp.compact_width(nprobe, mc, 64) == w
    t = torch.from_numpy

    def pipe(k, kb_cap, envelope):
        monkeypatch.setenv("COMET_SPARSE_MEM_GB", repr(envelope))
        calls.clear()
        out = sp.ivf_sparse_pipeline(
            t(q), t(xr), t(mask), t(perm), np.inf, t(cents), t(okey), t(cs), t(nch),
            k, nprobe, S_SMALL, S_SMALL, mc, NLIST, sqrt_out=True, kb_cap=kb_cap)
        return out, list(calls)

    two_groups = 2 * sp.QG * w * sp.CHUNK * 4 / (1 << 30)
    for k, kb_cap, slices in ((K, 0, [2 * sp.QG]), (K, K, [2 * sp.QG]),
                              (64, 64, [sp.QG, sp.QG])):
        got, seen = pipe(k, kb_cap, two_groups)
        assert seen == slices, (k, kb_cap)
        want, _ = pipe(k, 0, 8)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_shortlists_take_the_dense_route_and_exact_scans_the_compact_one(monkeypatch):
    """Every caller scans with K3's one wrapper (`_compact_scan`); the
    shortlists, IVFPQ's nrefine and HNSW's default seed scan (kb_cap > 0),
    then select their groups from its rows, the reference's dense-tile
    selection (three K1 selects a slice: groups, candidates, the (score,
    slot) order), and IVF's search, IVFPQ without nrefine and HNSW's exact
    seed scan (seed_kb < 0) select the rows directly (two)."""
    import comet_tpu_torch as ct
    from comet_tpu_torch.indexes import hnsw as hnsw_mod

    seen = []
    for name in ("_compact_scan", "topk_rows"):
        fn = getattr(sp, name)
        monkeypatch.setattr(sp, name, lambda *a, _fn=fn, _name=name, **kw:
                            seen.append(_name) or _fn(*a, **kw))
    monkeypatch.setenv("COMET_IVF_SPARSE", "1")
    monkeypatch.setenv("COMET_IVFPQ_SPARSE", "1")
    monkeypatch.setenv("COMET_HNSW_SEED", "1")
    monkeypatch.setattr(hnsw_mod, "BULK_BUILD_MIN", 512)
    rng = np.random.default_rng(9)
    x = rng.integers(0, 16, size=(600, D)).astype(np.float32)
    q = x[:6] + 0.5

    def selects(search):
        seen.clear()
        search()
        assert seen[0] == "_compact_scan", seen
        return seen.count("topk_rows") / seen.count("_compact_scan")

    ivf = ct.IVFIndex(D, 8, ct.DistanceKind.L2, device="cpu")
    ivf.train(x)
    ivf.add_batch(x)
    assert selects(lambda: ivf.search_batch(q, k=5, nprobes=3)) == 2
    pq = ct.IVFPQIndex(D, ct.DistanceKind.L2, nlist=8, m=4, nbits=4, store_originals=True,
                       device="cpu")
    pq.train(x)
    pq.add_batch(x)
    assert selects(lambda: pq.search_batch(q, k=5, nprobes=3)) == 2
    assert selects(lambda: pq.search_batch(q, k=5, nprobes=3, nrefine=20)) == 3
    for seed_kb, want in ((0, 3), (-1, 2)):
        hn = ct.HNSWIndex(D, ct.DistanceKind.L2,
                          ct.HNSWConfig(m=8, ef_construction=32, ef_search=32, seed_kb=seed_kb),
                          device="cpu")
        hn.add_batch(x)
        assert selects(lambda: hn.search_batch(q, k=5)) == want, seed_kb
