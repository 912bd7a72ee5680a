"""comet_tpu_torch.parallel held to comet_tpu.parallel on the CPU.

The reference runs on the virtual 8-device CPU mesh of conftest.py; the
port on meshes of n `cpu` devices. Every case of tests/test_sharded.py,
tests/test_sharded_determinism.py and the sharded cases of
tests/test_seeded_beam.py is one case here, run at 1, 2, 4 and 8 shards
on both packages from the same numpy inputs; the trained indexes are the
reference's, carried across with the port's `load_reference_state`. Ids
are array-equal, scores allclose(1e-4) or, where the reference's own
test holds its runs to 1e-5, allclose(1e-5). Each reference result is
computed once (`lru_cache`).
"""

from functools import lru_cache

import jax
import numpy as np
import pytest
import torch

import comet_tpu
import comet_tpu.indexes.hnsw as ref_hnsw
from comet_tpu import parallel as ref
from comet_tpu.core.node import new_metadata_node_with_id as ref_meta_node
from comet_tpu.indexes import metadata as rmeta
from comet_tpu.ops.kmeans import kmeans as ref_kmeans
from comet_tpu.types import DistanceKind as RefKind
import comet_tpu_torch
import comet_tpu_torch.indexes.hnsw as port_hnsw
from comet_tpu_torch import parallel as port
from comet_tpu_torch.core.node import new_metadata_node_with_id as port_meta_node
from comet_tpu_torch.indexes import metadata as pmeta
from comet_tpu_torch.ops import kmeans as port_kmeans
from comet_tpu_torch.types import DistanceKind, InvalidConfigError

SHARDS = (1, 2, 4, 8)
SENT = 2**31 - 1
CPU = torch.device("cpu")


def ref_mesh(s):
    return ref.make_corpus_mesh(jax.devices()[:s])


def port_mesh(s):
    return port.make_corpus_mesh([CPU] * s)


def assert_same(got, want, tol):
    """(scores, slots): slots array-equal, scores allclose(tol)."""
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(want[1]))
    np.testing.assert_allclose(np.asarray(got[0]), np.asarray(want[0]), rtol=tol, atol=tol)


def gauss(seed, n, d):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


# -- the mesh ------------------------------------------------------------------


def test_mesh_has_8_devices():
    mesh = port_mesh(8)
    assert mesh.size == 8 and mesh.gather_device == CPU
    assert ref.make_corpus_mesh().devices.size == 8


def test_mesh_without_card_raises():
    """make_corpus_mesh() takes every CUDA device; it never builds a CPU
    mesh by itself."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the machine without one")
    with pytest.raises(InvalidConfigError):
        port.make_corpus_mesh()


def test_shard_rows_splits_evenly_and_replicates_scalars():
    mesh = port_mesh(4)
    x = np.arange(24, dtype=np.float32).reshape(8, 3)
    shards = port.shard_rows(mesh, x)
    assert [s.shape for s in shards] == [(2, 3)] * 4
    np.testing.assert_array_equal(torch.cat(shards).numpy(), x)
    v, t = port.shard_rows(mesh, np.ones(8, bool), np.float32(2.5))
    assert len(v) == 4 and all(float(s) == 2.5 for s in t)
    with pytest.raises(ValueError):
        port.shard_rows(mesh, np.zeros((6, 3), np.float32))


# -- flat ----------------------------------------------------------------------

# name: (n, d, queries, k, kind, tile, allowed share, tolerance); the first
# two are test_sharded.py's, the others test_sharded_determinism.py's
FLAT = {
    "oracle": (4096, 16, 5, 10, "l2", 256, None, 1e-4),
    "uneven_rows": (1000, 8, 3, 5, "l2", 64, None, 1e-4),
    "shard_counts": (1536, 24, 16, 10, "l2", 128, None, 1e-5),
    "allowed": (1536, 24, 16, 10, "l2", 128, 0.5, 1e-5),
    "cosine": (1536, 24, 16, 10, "cosine", 128, None, 1e-5),
}


@lru_cache(maxsize=None)
def flat_inputs(case):
    n, d, nq, k, kind, tile, share, _ = FLAT[case]
    corpus, queries = gauss(1, n, d), gauss(2, nq, d)
    allowed = np.random.default_rng(3).random(n) < share if share else None
    return corpus, queries, allowed


@lru_cache(maxsize=None)
def ref_flat(case, s):
    n, d, nq, k, kind, tile, _, _ = FLAT[case]
    corpus, queries, allowed = flat_inputs(case)
    searcher = ref.ShardedFlatSearcher(ref_mesh(s), corpus, RefKind(kind), tile=tile)
    return searcher.search(queries, k, allowed=allowed)


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("case", list(FLAT))
def test_flat_matches_reference(case, shards):
    n, d, nq, k, kind, tile, _, tol = FLAT[case]
    corpus, queries, allowed = flat_inputs(case)
    searcher = port.ShardedFlatSearcher(port_mesh(shards), corpus, DistanceKind(kind),
                                        tile=tile)
    got = searcher.search(queries, k, allowed=allowed)
    assert_same(got, ref_flat(case, shards), tol)
    if allowed is not None:
        hit = got[1][got[1] != SENT]
        assert allowed[hit].all()


def test_flat_cosine_fault_is_the_reference_s():
    """The reference's flat searcher preprocesses the queries but not the
    corpus: a cosine search over rows far from unit norm clips every inner
    product to 1, and all scores are 0. The port returns the same, while a
    single-device FlatIndex (which normalises the rows) does not."""
    rng = np.random.default_rng(5)
    corpus = (rng.normal(size=(256, 8)) * rng.uniform(1, 250, size=(256, 1))).astype(np.float32)
    queries = rng.normal(size=(4, 8)).astype(np.float32)
    want = ref.ShardedFlatSearcher(ref_mesh(2), corpus, RefKind.COSINE, tile=128).search(
        queries, 5)
    got = port.ShardedFlatSearcher(port_mesh(2), corpus, DistanceKind.COSINE,
                                   tile=128).search(queries, 5)
    assert_same(got, want, 1e-6)
    assert (np.asarray(want[0]) == 0).all() and (got[0] == 0).all()
    flat = comet_tpu_torch.FlatIndex(8, DistanceKind.COSINE, device="cpu")
    flat.add_batch(corpus, ids=range(1, 257))
    _, single = flat.search_batch(queries, k=5)
    assert (single > 0).any()


# -- the functional steps ------------------------------------------------------


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("step", ["search", "ivf_search"])
def test_sharded_steps_match_reference(step, shards):
    """make_sharded_search / make_sharded_ivf_search on shard_rows' blocks,
    with a finite threshold and invalid rows (2048 rows: 2048 / 8 = 256)."""
    corpus, queries = gauss(7, 2048, 16), gauss(8, 6, 16)
    valid = np.random.default_rng(9).random(2048) < 0.8
    sqn = (corpus * corpus).sum(axis=1).astype(np.float32)
    thr = np.float32(3.5)
    rm, pm = ref_mesh(shards), port_mesh(shards)
    if step == "search":
        want = ref.make_sharded_search(rm, 10, RefKind.L2, 128)(
            queries, *ref.shard_rows(rm, corpus, sqn, valid), thr)
        got = port.make_sharded_search(pm, 10, DistanceKind.L2, 128)(
            queries, *port.shard_rows(pm, corpus, sqn, valid), thr)
    else:
        centroids = corpus[::128].copy()
        assign = np.argmin(((corpus[:, None, :] - centroids[None]) ** 2).sum(-1), 1)
        assign = assign.astype(np.int32)
        want = ref.make_sharded_ivf_search(rm, 10, RefKind.L2, 3, 128)(
            queries, *ref.shard_rows(rm, corpus, sqn, assign, valid), centroids, thr)
        got = port.make_sharded_ivf_search(pm, 10, DistanceKind.L2, 3, 128)(
            queries, *port.shard_rows(pm, corpus, sqn, assign, valid), centroids, thr)
    assert_same((got[0].numpy(), got[1].numpy()), want, 1e-4)
    assert (got[1] != SENT).any() and (got[1] == SENT).any()


# -- IVF -----------------------------------------------------------------------

# name: (n, d, queries, nlist, k, nprobes, tile, allowed, tolerance)
IVF = {
    "single_device": (4096, 16, 7, 32, 10, (1, 4, 32), 128, None, 1e-4),
    "allowed": (1024, 8, 3, 8, 20, (8,), 64, "first_half", 1e-4),
    "shard_counts": (1536, 24, 16, 16, 10, (4,), 128, None, 1e-5),
    "fluent": (1536, 24, 16, 16, 10, (4,), 128, None, 1e-4),
}


@lru_cache(maxsize=None)
def ivf_pair(case):
    n, d, nq, nlist, *_ = IVF[case]
    corpus, queries = gauss(11, n, d), gauss(12, nq, d)
    idx = comet_tpu.IVFIndex(d, nlist, RefKind.L2)
    idx.train(corpus[: max(nlist, n // 2)])
    idx.add_batch(corpus, ids=np.arange(1, n + 1, dtype=np.uint32))
    s = idx._store
    port_idx = comet_tpu_torch.IVFIndex.load_reference_state(
        s.ids, s.vectors, s.valid, s.n, np.array(idx._centroids), idx._assign,
        DistanceKind.L2, device="cpu")
    allowed = None
    if IVF[case][7] == "first_half":
        allowed = np.zeros(n, bool)
        allowed[: n // 2] = True
    return idx, port_idx, queries, allowed


@lru_cache(maxsize=None)
def ref_ivf(case, s):
    idx, _, queries, allowed = ivf_pair(case)
    _, _, _, _, k, nprobes, tile, _, _ = IVF[case]
    searcher = ref.ShardedIVFSearcher(ref_mesh(s), idx, tile=tile)
    return [searcher.search(queries, k, nprobe=p, allowed=allowed) for p in nprobes]


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("case", list(IVF))
def test_ivf_matches_reference(case, shards):
    _, port_idx, queries, allowed = ivf_pair(case)
    _, _, _, _, k, nprobes, tile, _, tol = IVF[case]
    searcher = port.ShardedIVFSearcher(port_mesh(shards), port_idx, tile=tile)
    for p, want in zip(nprobes, ref_ivf(case, shards)):
        got = searcher.search(queries, k, nprobe=p, allowed=allowed)
        assert_same(got, want, tol)
        if allowed is not None:
            hit = got[1][got[1] != SENT]
            assert len(hit) and (hit < len(allowed) // 2).all()
        if case in ("single_device", "fluent"):
            # the port's own single-device index (its dense route here)
            ids, scores = port_idx.search_batch(queries, k=k, nprobes=p)
            np.testing.assert_array_equal(searcher.row_ids[np.clip(got[1], 0, None)], ids)
            np.testing.assert_allclose(got[0], scores, rtol=1e-4, atol=1e-4)


# -- PQ and IVFPQ -------------------------------------------------------------


@lru_cache(maxsize=None)
def pq_pair(case):
    if case == "single_device":     # test_sharded.py
        corpus, queries = gauss(21, 2048, 16), gauss(22, 6, 16)
        idx = comet_tpu.PQIndex(16, RefKind.L2, m=4, nbits=6)
        idx.train(corpus[:1024])
    else:                           # test_sharded_determinism.py
        corpus, queries = gauss(21, 1536, 24), gauss(22, 16, 24)
        idx = comet_tpu.PQIndex(24, m=4, distance_kind=RefKind.L2)
        idx.train(corpus)
    idx.add_batch(corpus, ids=range(1, len(corpus) + 1))
    s = idx._store
    port_idx = comet_tpu_torch.PQIndex.load_reference_state(
        s.ids, idx._codes, s.valid, s.n, idx._codebooks, idx._rot, DistanceKind.L2,
        device="cpu")
    return idx, port_idx, queries


def pq_allowed(case):
    """The "allowed" case: the determinism corpus under a random keep-mask."""
    return np.random.default_rng(23).random(1536) < 0.5 if case == "allowed" else None


@lru_cache(maxsize=None)
def ref_pq(case, s):
    idx, _, queries = pq_pair(case)
    return ref.ShardedPQSearcher(ref_mesh(s), idx, tile=128).search(
        queries, 10, allowed=pq_allowed(case))


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("case", ["single_device", "shard_counts", "allowed"])
def test_pq_matches_reference(case, shards):
    _, port_idx, queries = pq_pair(case)
    allowed = pq_allowed(case)
    got = port.ShardedPQSearcher(port_mesh(shards), port_idx, tile=128).search(
        queries, 10, allowed=allowed)
    assert_same(got, ref_pq(case, shards), 1e-4 if case == "single_device" else 1e-5)
    if allowed is not None:
        assert allowed[got[1][got[1] != SENT]].all()


# name: (n, d, queries, nlist, m, nbits, opq, removed ids, k, nprobes, allowed, tolerance).
# The reference's IVF scan cuts a shard into n_local // tile tiles of equal
# size, which fails for 900 rows on one shard at tile 128: the OPQ case
# takes the searchers' default tile.
IVFPQ = {
    "single_device": (2048, 16, 5, 16, 4, 6, False, 0, 10, (2, 16), False, 1e-4),
    "allowed_deletes": (1024, 8, 3, 8, 4, 6, False, 10, 20, (8,), True, 1e-4),
    "opq": (900, 16, 16, 4, 4, 6, True, 0, 10, (4,), False, 1e-4),
    "shard_counts": (1536, 24, 16, 16, 4, 8, False, 0, 10, (4,), False, 1e-5),
    "deletes": (1536, 24, 16, 16, 4, 8, False, 99, 10, (16,), False, 1e-5),
}


def ivfpq_tile(case):
    return 1 << 14 if IVFPQ[case][6] else 128


@lru_cache(maxsize=None)
def ivfpq_pair(case):
    n, d, nq, nlist, m, nbits, opq, removed, *_ = IVFPQ[case]
    corpus, queries = gauss(31, n, d), gauss(32, nq, d)
    if opq:   # anisotropic data, as the reference's OPQ test
        corpus = corpus @ np.diag(np.linspace(0.1, 2.0, d).astype(np.float32))
        idx = comet_tpu.IVFPQIndex(d, RefKind.L2, nlist=nlist, m=m, nbits=nbits, opq=True,
                                   opq_iters=2)
        idx.train(corpus)
    else:
        idx = comet_tpu.IVFPQIndex(d, RefKind.L2, nlist=nlist, m=m, nbits=nbits)
        idx.train(corpus[: max(1024, n // 2)])
    idx.add_batch(corpus, ids=range(1, n + 1))
    for doc in range(1, removed + 1):
        idx.remove(doc)
    s = idx._store
    port_idx = comet_tpu_torch.IVFPQIndex.load_reference_state(
        s.ids, idx._codes, idx._assign, s.valid, s.n, np.array(idx._centroids),
        idx._codebooks, idx._rot, None, DistanceKind.L2, device="cpu")
    allowed = None
    if IVFPQ[case][10]:
        allowed = np.zeros(n, bool)
        allowed[: n // 2] = True
    return idx, port_idx, queries, allowed


@lru_cache(maxsize=None)
def ref_ivfpq(case, s):
    idx, _, queries, allowed = ivfpq_pair(case)
    k, nprobes = IVFPQ[case][8:10]
    searcher = ref.ShardedIVFPQSearcher(ref_mesh(s), idx, tile=ivfpq_tile(case))
    return [searcher.search(queries, k, nprobe=p, allowed=allowed) for p in nprobes]


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("case", list(IVFPQ))
def test_ivfpq_matches_reference(case, shards):
    _, port_idx, queries, allowed = ivfpq_pair(case)
    removed, k, nprobes = IVFPQ[case][7], IVFPQ[case][8], IVFPQ[case][9]
    searcher = port.ShardedIVFPQSearcher(port_mesh(shards), port_idx, tile=ivfpq_tile(case))
    for p, want in zip(nprobes, ref_ivfpq(case, shards)):
        got = searcher.search(queries, k, nprobe=p, allowed=allowed)
        assert_same(got, want, IVFPQ[case][11])
        hit = got[1][got[1] != SENT]
        assert len(hit) and (hit >= removed).all()
        if allowed is not None:
            assert (hit < len(allowed) // 2).all()


# -- k-means -------------------------------------------------------------------

# name: (n, d, k, steps, valid share)
KMEANS = {
    "single_device": (512, 8, 4, 1, 1.0),
    "shard_counts": (1536, 24, 8, 1, 1.0),
    "multi_iteration": (1536, 24, 8, 5, 1.0),
    "invalid_rows": (1536, 24, 8, 2, 0.7),
}


def _kmeans_run(pkg, mesh, kind, x, valid, k, steps):
    """`steps` chained sharded steps from x[:k]: (assign, centroids, changed)
    of the last, on the host."""
    step = pkg.make_sharded_kmeans_step(mesh, kind)
    centroids = x[:k].copy()
    prev = np.full(len(x), -1, np.int32)
    for _ in range(steps):
        assign, centroids, changed = step(*pkg.shard_rows(mesh, x, valid, prev), centroids)
        prev = (np.asarray(assign) if pkg is ref
                else torch.cat(assign).numpy()).astype(np.int32)
        centroids = np.asarray(centroids)
    return prev, centroids, int(changed)


@lru_cache(maxsize=None)
def kmeans_inputs(case):
    n, d, k, steps, share = KMEANS[case]
    x = gauss(41, n, d)
    valid = np.random.default_rng(42).random(n) < share
    return x, valid


@lru_cache(maxsize=None)
def ref_kmeans_run(case, s):
    n, d, k, steps, _ = KMEANS[case]
    x, valid = kmeans_inputs(case)
    return _kmeans_run(ref, ref_mesh(s), RefKind.L2_SQUARED, x, valid, k, steps)


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("case", list(KMEANS))
def test_kmeans_step_matches_reference(case, shards):
    n, d, k, steps, _ = KMEANS[case]
    x, valid = kmeans_inputs(case)
    got = _kmeans_run(port, port_mesh(shards), DistanceKind.L2_SQUARED, x, valid, k, steps)
    want = ref_kmeans_run(case, shards)
    np.testing.assert_array_equal(got[0], want[0])
    tol = 1e-3 if steps > 1 else 1e-4      # the reference's own tolerances
    np.testing.assert_allclose(got[1], want[1], rtol=tol, atol=tol)
    assert got[2] == want[2]
    if steps == 1:
        # one plain single-device step: ops/kmeans' assignment and update
        xt = torch.from_numpy(x)
        a = torch.where(torch.from_numpy(valid),
                        port_kmeans._nearest(xt, xt[:k], DistanceKind.L2_SQUARED), k)
        np.testing.assert_array_equal(got[0], a.numpy())
        sums = torch.zeros((k + 1, d)).index_add_(0, a, xt)[:k]
        counts = torch.zeros(k + 1).index_add_(0, a, torch.ones(n))[:k, None]
        new = torch.where(counts > 0, sums / counts.clamp_min(1.0), xt[:k])
        np.testing.assert_allclose(got[1], new.numpy(), rtol=1e-5, atol=1e-5)


# -- HNSW ----------------------------------------------------------------------

# name: (n, d, queries, k, ef_search, allowed); test_sharded.py's two,
# test_sharded_determinism.py's one
HNSW = {
    "single_device": (600, 16, 24, 10, 64, False),
    "allowed_uneven": (300, 8, 13, 5, 64, True),
    "shard_counts": (1536, 24, 16, 10, 48, False),
}


def _port_hnsw(idx):
    s = idx._store
    cfg = port_hnsw.HNSWConfig(m=idx._cfg.m, ef_construction=idx._cfg.ef_construction,
                               ef_search=idx._cfg.ef_search)
    return port_hnsw.HNSWIndex.load_reference_state(
        s.ids, s.vectors, s.valid, s.n, idx._levels, idx._adj0, idx._upper, idx._entry_slot,
        idx._max_level, DistanceKind(idx._distance_kind.value), cfg,
        idx._rng.bit_generator.state, device="cpu")


@lru_cache(maxsize=None)
def hnsw_pair(case):
    n, d, nq, k, ef, masked = HNSW[case]
    corpus, queries = gauss(51, n, d), gauss(52, nq, d)
    idx = ref_hnsw.HNSWIndex(d, RefKind.L2, ref_hnsw.HNSWConfig(m=8, ef_construction=48,
                                                                ef_search=ef))
    idx.add_batch(corpus, ids=list(range(1, n + 1)))
    allowed = None
    if masked:
        allowed = np.zeros(idx._store.capacity, bool)
        allowed[0:n:2] = True
    return idx, _port_hnsw(idx), queries, allowed


@lru_cache(maxsize=None)
def ref_hnsw_run(case, s):
    idx, _, queries, allowed = hnsw_pair(case)
    return ref.ShardedHNSWSearcher(ref_mesh(s), idx).search(queries, k=HNSW[case][3],
                                                            allowed=allowed)


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("case", list(HNSW))
def test_hnsw_matches_reference(case, shards, monkeypatch):
    _, port_idx, queries, allowed = hnsw_pair(case)
    k = HNSW[case][3]
    got = port.ShardedHNSWSearcher(port_mesh(shards), port_idx).search(queries, k=k,
                                                                       allowed=allowed)
    assert got[1].shape == (len(queries), k)
    assert_same(got, ref_hnsw_run(case, shards), 1e-5)
    if allowed is not None:
        live = got[1][got[1] != SENT]
        assert len(live) and (live % 2 == 0).all()
    else:
        # the port's single-device graph-beam search
        monkeypatch.setattr(port_hnsw, "BLOCKED_TABLE_BYTES_MAX", 0)
        ids, scores = port_idx.search_batch(queries, k=k)
        assert (got[1] != SENT).all()
        np.testing.assert_array_equal(port_idx._store.ids[got[1]], ids)
        np.testing.assert_allclose(got[0], scores, rtol=1e-5, atol=1e-5)


# -- seeded HNSW (tests/test_seeded_beam.py) ----------------------------------

# name: (nprobe, allowed every third slot)
SEEDED = {"shard_counts": (4, False), "recall": (8, False), "allowed": (8, True)}


@lru_cache(maxsize=None)
def seeded_pair():
    corpus, queries = gauss(21, 1024, 16), gauss(22, 8, 16)
    idx = ref_hnsw.HNSWIndex(16, RefKind.L2, ref_hnsw.HNSWConfig(m=8, ef_construction=48,
                                                                 ef_search=64))
    idx.add_batch(corpus, ids=list(range(1, 1025)))
    cents, _ = ref_kmeans(corpus, 32, RefKind.L2_SQUARED, 10, return_assign=False)
    return idx, _port_hnsw(idx), corpus, queries, np.array(cents)


@lru_cache(maxsize=None)
def ref_seeded(case, s):
    idx, _, corpus, queries, cents = seeded_pair()
    nprobe, masked = SEEDED[case]
    mask = None
    if masked:
        mask = np.zeros(len(corpus), bool)
        mask[::3] = True
    searcher = ref.ShardedSeededHNSWSearcher(ref_mesh(s), idx, centroids=cents, nprobe=nprobe)
    return searcher.search(queries, k=10, allowed=mask), mask


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("case", list(SEEDED))
def test_seeded_hnsw_matches_reference(case, shards):
    _, port_idx, corpus, queries, cents = seeded_pair()
    want, mask = ref_seeded(case, shards)
    searcher = port.ShardedSeededHNSWSearcher(port_mesh(shards), port_idx, centroids=cents,
                                              nprobe=SEEDED[case][0])
    got = searcher.search(queries, k=10, allowed=mask)
    assert_same(got, want, 1e-5)
    live = got[1][got[1] != SENT]
    if mask is not None:
        assert len(live) and mask[live].all()
    if case == "recall":
        d = ((queries[:, None, :] - corpus[None]) ** 2).sum(-1)
        true = np.argsort(d, axis=1, kind="stable")[:, :10]
        hits = sum(len(set(a) & set(b)) for a, b in zip(got[1].tolist(), true.tolist()))
        assert hits / true.size >= 0.9


# -- hybrid --------------------------------------------------------------------


@lru_cache(maxsize=None)
def hybrid_pair(n, d):
    """The reference's hybrid corpus (test_sharded.py) in both packages."""
    rng = np.random.default_rng(61)
    corpus = rng.normal(size=(n, d)).astype(np.float32)
    ids = np.arange(1, n + 1, dtype=np.uint32)
    words = [f"w{i}" for i in range(64)]
    texts = [" ".join(words[int(t)] for t in rng.integers(0, 64, size=6)) for _ in range(n)]
    cats = ["a", "b", "c"]
    metas = [{"cat": cats[i % 3], "num": i % 50} for i in range(n)]
    r_text, r_meta = comet_tpu.BM25SearchIndex(), comet_tpu.RoaringMetadataIndex()
    r_text.add_batch(ids.tolist(), texts)
    r_meta.add_batch([ref_meta_node(int(ids[i]), metas[i]) for i in range(n)])
    p_text = comet_tpu_torch.BM25SearchIndex(device="cpu")
    p_meta = comet_tpu_torch.RoaringMetadataIndex()
    p_text.add_batch(ids.tolist(), texts)
    p_meta.add_batch([port_meta_node(int(ids[i]), metas[i]) for i in range(n)])
    queries = rng.normal(size=(5, d)).astype(np.float32)
    return corpus, ids, (r_text, r_meta), (p_text, p_meta), queries


TQ = ["w1 w2 w3", "w4 w5", "w6", "w7 w8", "w9"]

# name: [(vectors?, texts?, k, keyword arguments in both packages' terms)]
HYBRID = {
    "single_device": [
        (True, TQ, 10, {}),
        (True, TQ, 10, {"metadata_filters": ("eq", "cat", "a")}),
        (True, TQ, 10, {"metadata_filters": ("eq_gte", "b", 10),
                        "fusion_kind": "reciprocal_rank"}),
    ],
    "modality_subsets": [
        (True, None, 5, {}),
        (False, ["w1 w2", "w3"], 5, {}),
        (True, None, 5, {"metadata_filters": ("eq", "cat", "c")}),
    ],
}


def _hybrid_kwargs(kw, meta_mod, fusion_kind_cls):
    out = {}
    filt = kw.get("metadata_filters")
    if filt and filt[0] == "eq":
        out["metadata_filters"] = [meta_mod.eq(filt[1], filt[2])]
    elif filt:
        out["metadata_filters"] = [meta_mod.eq("cat", filt[1]), meta_mod.gte("num", filt[2])]
    if "fusion_kind" in kw:
        out["fusion_kind"] = fusion_kind_cls(kw["fusion_kind"])
    return out


def _rows(results):
    return [([r.id for r in row], [r.score for r in row]) for row in results]


@lru_cache(maxsize=None)
def ref_hybrid(case, s):
    n, d = (2048, 16) if case == "single_device" else (512, 8)
    corpus, ids, (r_text, r_meta), _, queries = hybrid_pair(n, d)
    vec = ref.ShardedFlatSearcher(ref_mesh(s), corpus, RefKind.L2,
                                  tile=256 if n == 2048 else 64)
    hy = ref.ShardedHybridSearcher(vec, ids, text_index=r_text, metadata_index=r_meta)
    out = []
    for use_vec, texts, k, kw in HYBRID[case]:
        nq = len(texts) if texts else 2 if n == 512 else 5
        out.append(_rows(hy.search_batch(queries[:nq] if use_vec else None, texts, k=k,
                                         **_hybrid_kwargs(kw, rmeta, comet_tpu.FusionKind))))
    return out


@lru_cache(maxsize=None)
def ref_hybrid_ivfpq(s):
    corpus = gauss(71, 512, 8)
    idx = comet_tpu.IVFPQIndex(8, RefKind.L2, nlist=8, m=4, nbits=6)
    idx.train(corpus)
    idx.add_batch(corpus, ids=np.arange(1, 513, dtype=np.uint32))
    sharded = ref.ShardedIVFPQSearcher(ref_mesh(s), idx, tile=64)
    hy = ref.ShardedHybridSearcher(sharded, sharded.row_ids)
    return idx, _rows(hy.search_batch(vectors=corpus[:3] + 0.01, k=5, nprobes=8))


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("case", ["single_device", "modality_subsets", "ivfpq_vector"])
def test_hybrid_matches_reference(case, shards):
    if case == "ivfpq_vector":
        idx, want = ref_hybrid_ivfpq(shards)
        s = idx._store
        p_idx = comet_tpu_torch.IVFPQIndex.load_reference_state(
            s.ids, idx._codes, idx._assign, s.valid, s.n, np.array(idx._centroids),
            idx._codebooks, idx._rot, None, DistanceKind.L2, device="cpu")
        sharded = port.ShardedIVFPQSearcher(port_mesh(shards), p_idx, tile=64)
        hy = port.ShardedHybridSearcher(sharded, sharded.row_ids)
        got = [_rows(hy.search_batch(vectors=gauss(71, 512, 8)[:3] + 0.01, k=5, nprobes=8))]
        want = [want]
        assert all(len(row[0]) == 5 for row in got[0])
    else:
        n, d = (2048, 16) if case == "single_device" else (512, 8)
        corpus, ids, _, (p_text, p_meta), queries = hybrid_pair(n, d)
        vec = port.ShardedFlatSearcher(port_mesh(shards), corpus, DistanceKind.L2,
                                       tile=256 if n == 2048 else 64)
        hy = port.ShardedHybridSearcher(vec, ids, text_index=p_text, metadata_index=p_meta)
        got = []
        for use_vec, texts, k, kw in HYBRID[case]:
            nq = len(texts) if texts else 2 if n == 512 else 5
            got.append(_rows(hy.search_batch(
                queries[:nq] if use_vec else None, texts, k=k,
                **_hybrid_kwargs(kw, pmeta, comet_tpu_torch.FusionKind))))
        want = ref_hybrid(case, shards)
    for g_batch, w_batch in zip(got, want):
        assert len(g_batch) == len(w_batch)
        for (g_ids, g_sc), (w_ids, w_sc) in zip(g_batch, w_batch):
            assert g_ids == w_ids
            np.testing.assert_allclose(g_sc, w_sc, rtol=1e-5, atol=1e-6)
