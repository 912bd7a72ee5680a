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


# -- the scan: _sparse_scan_plain against the interpret-mode kernel ----------------


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


def test_sparse_scan_matches_reference():
    """Integer data, a threshold, a dead step: dist array-equal, the same
    kept groups, ordered by (group minimum, scan position)."""
    q, xr, mask, probes, chunk_ids, cluster_ids = _scan_case()
    rdist, rgsel = _ref_scan()
    t = [torch.from_numpy(a) for a in (q, xr, mask, probes, chunk_ids, cluster_ids)]
    dist, gsel = sp._sparse_scan(*t, THR_SCAN, 8)
    dist, gsel = dist.numpy(), gsel.numpy()
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
    # the plain version gives the group minima the kernel's K1 choice reads
    _, pgmin = sp._sparse_scan_plain(*t, THR_SCAN, False)
    np.testing.assert_array_equal(pgmin.numpy().reshape(2 * sp.QG, 12), gmin)


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
