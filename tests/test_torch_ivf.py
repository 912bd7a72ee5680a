"""comet_tpu_torch.IVFIndex on the CPU against comet_tpu.IVFIndex.

The port is loaded, through `IVFIndex.load_reference_state`, with the state
of a trained reference index, and both answer the same queries. On the CPU
the reference runs its cursor walk over the probed lists; the port runs
the plain versions of its two routes, the dense masked scan
(COMET_IVF_SPARSE=0) and the block-sparse scan (=1). Data are SIFT-range
integers and the reference's centroids are rounded to integers before the
corpus is added, so every distance and every coarse product is exact in
float32 and both packages probe the same lists. Bar: scores array-equal;
ids array-equal, except that the sparse route breaks score ties at the
k-th place in scan order (comet_tpu/ops/ivf_sparse.py, divergence (a)), so
there ids are equal wherever the score is below the k-th.

Also: CIVF v2 byte-identical in both directions, the reference's contract
tests, training parity, the routing, and the sparse route's overflow
escalation.
"""

import io
from functools import lru_cache

import numpy as np
import pytest
import torch

import comet_tpu
from comet_tpu.ops.distance import preprocess as ref_preprocess
from comet_tpu_torch import (
    DistanceKind,
    InvalidConfigError,
    IVFIndex,
    NotTrainedError,
    VectorIndexKind,
)
from comet_tpu_torch.indexes import ivf as ivf_mod
from comet_tpu_torch.io.serial import SerializationError
from comet_tpu_torch.ops.topk import IDX_SENTINEL

from oracle import distances_np, recall_at_k, topk_np

D, NLIST, K = 16, 8, 10
N_CENTERS, N = 24, 3000
IDS = list(range(1, N + 1))
INVALID = 0xFFFFFFFF


def _sift_ints(rng, n, centers):
    which = rng.integers(0, len(centers), size=n)
    return np.clip(centers[which] + rng.integers(-20, 21, size=(n, D)), 0, 255).astype(np.float32)


@lru_cache(maxsize=None)
def _data(cosine=False):
    rng = np.random.default_rng(7 + cosine)
    centers = rng.integers(0, 256, size=(N_CENTERS, D))
    x, q = _sift_ints(rng, N, centers), _sift_ints(rng, 20, centers)
    if cosine:
        # +-1 in 4 places of 16: normalised entries +-0.5, exact cosines
        x = np.zeros((N, D), np.float32)
        q = np.zeros((20, D), np.float32)
        for v in (x, q):
            for r in range(len(v)):
                v[r, rng.choice(D, 4, replace=False)] = rng.choice([-1.0, 1.0], 4)
    return x, q


def _reference(kind="l2", removed=()):
    """A trained reference index with exact centroids: L2 rounds its
    k-means centroids to integers, cosine takes NLIST of its (exact,
    normalised) rows; the corpus is added after."""
    cosine = kind == "cosine"
    x, _ = _data(cosine)
    ref = comet_tpu.IVFIndex(D, NLIST, comet_tpu.DistanceKind(kind))
    ref.train(x[:1000])
    if cosine:
        ref._centroids = ref_preprocess(x[:NLIST * 50:50], ref._distance_kind)
    else:
        ref._centroids = np.rint(ref._centroids).astype(np.float32)
    ref.add_batch(x, ids=IDS)
    for i in removed:
        ref.remove(i)
    return ref


def _port_of(ref, kind="l2"):
    s = ref._store
    return IVFIndex.load_reference_state(
        s.ids, s.vectors, s.valid, s.n, ref._centroids, ref._assign,
        DistanceKind(kind), device="cpu",
    )


def _assert_same(ref_out, port_out, sparse):
    (rid, rs), (pid, ps) = ref_out, port_out
    np.testing.assert_array_equal(ps, rs)
    if not sparse:
        np.testing.assert_array_equal(pid, rid)
        return
    kth = rs[:, -1:]
    below = rs < kth
    np.testing.assert_array_equal(pid[below], rid[below])
    np.testing.assert_array_equal((pid != INVALID).sum(axis=1), (rid != INVALID).sum(axis=1))


@lru_cache(maxsize=None)
def _ref_search(kind, nprobe, scenario):
    removed = IDS[::11] if scenario in ("delete", "flush") else ()
    ref = _reference(kind, removed)
    if scenario == "flush":
        ref.flush()
    return ref, ref.search_batch(_data(kind == "cosine")[1], k=K, nprobes=nprobe,
                                 **_knobs(scenario))


def _knobs(scenario):
    if scenario == "filter":
        return {"document_ids": [i for i in IDS if i % 3]}
    if scenario == "threshold":
        return {"threshold": 50.5}    # 2550.25 squared: exact, between integers
    return {}


class _Routes:
    """Counts the pipeline calls of each route."""

    def __init__(self, monkeypatch):
        self.calls = {"sparse": 0, "dense": 0}
        sparse, dense = ivf_mod.sp.ivf_sparse_pipeline, ivf_mod.ivf_topk_pipeline

        def count(name, fn):
            def wrapped(*a, **kw):
                self.calls[name] += 1
                return fn(*a, **kw)
            return wrapped

        monkeypatch.setattr(ivf_mod.sp, "ivf_sparse_pipeline", count("sparse", sparse))
        monkeypatch.setattr(ivf_mod, "ivf_topk_pipeline", count("dense", dense))


@pytest.mark.parametrize("route", ["dense", "sparse"])
@pytest.mark.parametrize("kind,nprobe,scenario", [
    ("l2", 1, "plain"), ("l2", 3, "plain"), ("l2", NLIST, "plain"),
    ("l2", 3, "filter"), ("l2", 3, "threshold"), ("l2", 3, "delete"), ("l2", 3, "flush"),
    ("cosine", 3, "plain"),
])
def test_search_matches_reference(kind, nprobe, scenario, route, monkeypatch):
    monkeypatch.setenv("COMET_IVF_SPARSE", "1" if route == "sparse" else "0")
    routes = _Routes(monkeypatch)
    ref, want = _ref_search(kind, nprobe, scenario)
    port = _port_of(ref, kind)
    if scenario == "delete":
        assert port.count() == ref.count() == N - len(IDS[::11])
    got = port.search_batch(_data(kind == "cosine")[1], k=K, nprobes=nprobe, **_knobs(scenario))
    sparse = route == "sparse" and nprobe < NLIST        # nprobe = nlist scans densely
    assert routes.calls == {"sparse": int(sparse), "dense": int(not sparse)}
    _assert_same(want, got, sparse)
    ids = got[0][got[0] != INVALID]
    if scenario == "filter":
        assert len(ids) and (ids % 3 != 0).all()
    if scenario in ("delete", "flush"):
        assert not set(ids.tolist()) & set(IDS[::11])
    if scenario == "threshold":
        assert (got[0] == INVALID).any() and (got[1][got[0] != INVALID] <= 50.5).all()


def test_fluent_search_and_flat_oracle():
    """with_nprobes on the fluent builder; nprobe = nlist is exact search."""
    ref = _reference()
    port = _port_of(ref)
    x, q = _data()
    for qi in range(3):
        got = [(r.node.id, r.score) for r in
               port.new_search().with_query(q[qi]).with_k(K).with_nprobes(3).execute()]
        want = [(r.node.id, r.score) for r in
                ref.new_search().with_query(q[qi]).with_k(K).with_nprobes(3).execute()]
        assert got == want
    ws, wi = topk_np(distances_np(q, x, "l2"), K)
    ids, scores = port.search_batch(q, k=K, nprobes=NLIST)
    np.testing.assert_array_equal(ids, wi + 1)
    np.testing.assert_allclose(scores, ws, rtol=1e-4, atol=1e-4)


def test_search_stream_matches_batch(monkeypatch):
    monkeypatch.setenv("COMET_IVF_SPARSE", "1")
    port = _port_of(_reference())
    q = _data()[1]
    want = port.search_batch(q, k=K, nprobes=2)
    got = list(port.search_stream([q[:7], q[7:]], k=K, nprobes=2, depth=2))
    np.testing.assert_array_equal(np.concatenate([g[0] for g in got]), want[0])
    np.testing.assert_array_equal(np.concatenate([g[1] for g in got]), want[1])


def test_train_and_add_match_reference():
    """The port's own train + add_batch: on integer data k-means sums are
    exact, so centroids and list assignments equal the reference's."""
    x, _ = _data()
    ref = comet_tpu.IVFIndex(D, NLIST, comet_tpu.DistanceKind.L2)
    port = IVFIndex(D, NLIST, DistanceKind.L2, device="cpu")
    for index in (ref, port):
        index.train(x[:1000])
        index.add_batch(x, ids=IDS)
    np.testing.assert_array_equal(port._centroids, ref._centroids)
    np.testing.assert_array_equal(port._assign[:N], ref._assign[:N])
    # a retrain re-assigns the rows already in the index
    for index in (ref, port):
        index.train(x[1000:2000], max_iter=3)
    np.testing.assert_array_equal(port._centroids, ref._centroids)
    np.testing.assert_array_equal(port._assign[:N], ref._assign[:N])


def _write(index):
    buf = io.BytesIO()
    index.write_to(buf)
    return buf.getvalue()


@pytest.mark.parametrize("kind", ["l2", "cosine"])
def test_civf_v2_byte_identical_both_ways(kind):
    ref = _reference(kind, removed=IDS[::13])
    port = _port_of(ref, kind)
    ref_bytes, port_bytes = _write(ref), _write(port)    # both flush first
    assert port_bytes == ref_bytes
    from_ref = IVFIndex(D, NLIST, DistanceKind(kind), device="cpu")
    from_ref.read_from(io.BytesIO(ref_bytes))             # reference writes, port reads
    from_port = comet_tpu.IVFIndex(D, NLIST, comet_tpu.DistanceKind(kind))
    from_port.read_from(io.BytesIO(port_bytes))           # port writes, reference reads
    assert _write(from_ref) == ref_bytes and _write(from_port) == ref_bytes
    q = _data(kind == "cosine")[1]
    _assert_same(from_port.search_batch(q, k=K, nprobes=3),
                 from_ref.search_batch(q, k=K, nprobes=3), sparse=False)
    untrained = IVFIndex(D, NLIST, DistanceKind(kind), device="cpu")
    assert _write(untrained) == _write(comet_tpu.IVFIndex(D, NLIST, comet_tpu.DistanceKind(kind)))


def test_civf_rejects_mismatch_and_corruption():
    blob = _write(_reference())
    for bad_index in (IVFIndex(D, NLIST + 1, device="cpu"), IVFIndex(D + 1, NLIST, device="cpu"),
                      IVFIndex(D, NLIST, DistanceKind.COSINE, device="cpu")):
        with pytest.raises(SerializationError):
            bad_index.read_from(io.BytesIO(blob))
    bad = bytearray(blob)
    bad[len(bad) // 2] ^= 0xFF
    with pytest.raises(SerializationError):
        IVFIndex(D, NLIST, device="cpu").read_from(io.BytesIO(bytes(bad)))


# -- the reference's contract tests (tests/test_ivf.py) ----------------------------


def _clustered(rng, n_per=100, d=8):
    centers = np.array([[0.0] * d, [20.0] * d, [-20.0] * d], dtype=np.float32)
    return np.concatenate(
        [c + rng.normal(scale=0.5, size=(n_per, d)).astype(np.float32) for c in centers])


def _trained(rng, nlist=3, d=8):
    idx = IVFIndex(d, nlist, DistanceKind.L2, device="cpu")
    data = _clustered(rng, d=d)
    idx.train(data)
    idx.add_batch(data, ids=list(range(1, len(data) + 1)))
    return idx, data


def test_kind_and_params():
    idx = IVFIndex(4, 16, device="cpu")
    assert idx.kind() == VectorIndexKind.IVF
    assert idx.nlist == 16 and idx.default_nprobes() == 4
    assert not idx.trained()


def test_invalid_nlist():
    with pytest.raises(InvalidConfigError):
        IVFIndex(4, 0, device="cpu")


def test_add_and_search_before_train_error():
    idx = IVFIndex(4, 2, device="cpu")
    with pytest.raises(NotTrainedError):
        idx.add_batch(np.zeros((1, 4), dtype=np.float32))
    with pytest.raises(NotTrainedError):
        idx.new_search().with_query([0.0] * 4).execute()


def test_train_requires_nlist_vectors(rng):
    with pytest.raises(InvalidConfigError):
        IVFIndex(4, 10, device="cpu").train(rng.normal(size=(5, 4)).astype(np.float32))


def test_basic_search_and_nprobe_sanitisation(rng):
    idx, data = _trained(rng)
    res = idx.new_search().with_query(data[0]).with_k(5).execute()
    assert res[0].node.id == 1 and len(res) == 5
    assert res[0].score == pytest.approx(0.0, abs=1e-4)
    res0 = idx.new_search().with_query(data[0]).with_k(5).with_nprobes(0).execute()
    res_many = idx.new_search().with_query(data[0]).with_k(5).with_nprobes(99).execute()
    assert [r.node.id for r in res0] == [r.node.id for r in res_many]


def test_higher_nprobe_no_worse_recall(rng, monkeypatch):
    """Port of tests/test_ivf.py::test_higher_nprobe_no_worse_recall, on the
    sparse route."""
    monkeypatch.setenv("COMET_IVF_SPARSE", "1")
    d = 16
    idx = IVFIndex(d, 16, DistanceKind.L2, device="cpu")
    data = rng.normal(size=(2000, d)).astype(np.float32)
    idx.train(data[:1000])
    idx.add_batch(data, ids=list(range(1, 2001)))
    q = rng.normal(size=(8, d)).astype(np.float32)
    _, wi = topk_np(distances_np(q, data, "l2"), 10)
    recalls = [recall_at_k(idx.search_batch(q, k=10, nprobes=p)[0].tolist(), wi + 1)
               for p in (1, 4, 16)]
    assert recalls[0] <= recalls[1] + 1e-9 <= recalls[2] + 2e-9
    assert recalls[2] == 1.0


def test_stats_and_default_routing(monkeypatch):
    """Below 2^19 slots the dense route is the default; the sparse route
    takes the search when forced, and its overflow counters start at 0."""
    monkeypatch.delenv("COMET_IVF_SPARSE", raising=False)
    routes = _Routes(monkeypatch)
    port = _port_of(_reference())
    port.search_batch(_data()[1], k=K, nprobes=2)
    assert routes.calls == {"sparse": 0, "dense": 1}
    monkeypatch.setenv("COMET_IVF_SPARSE", "1")
    port.search_batch(_data()[1], k=K, nprobes=2)
    assert routes.calls == {"sparse": 1, "dense": 1}
    st = port.stats()
    assert st["nlist"] == NLIST and st["trained"]
    assert st["sparse_overflow_batches"] == st["sparse_overflow_chunks"] == 0


# -- overflow escalation (tests/test_ivf.py:216-265) ----------------------------------


def test_sparse_overflow_triggers_escalated_rescan(rng):
    """A nonzero overflow is counted in stats and fixed by a rescan with an
    escalated step budget, which is remembered per (nprobe, k_pad)."""
    idx, _ = _trained(rng)
    s1 = torch.full((1, 2), 9.0)
    i1 = torch.tensor([[5, IDX_SENTINEL]], dtype=torch.int32)
    overflow = torch.tensor([3], dtype=torch.int32)
    calls = []

    def fake_launch(q, k_pad, k_eff, nprobe, builder, S_override=None):
        calls.append(S_override)
        return ("sparse", torch.tensor([[1.0, 2.0]]), torch.tensor([[0, 1]], dtype=torch.int32),
                idx._store.ids, torch.zeros(1, dtype=torch.int32), None)

    idx._launch_sparse = fake_launch
    retry = (torch.zeros((128, 8)), 2, 2, 2, None, 8, 64)
    ids, scores = idx._search_collect(("sparse", s1, i1, idx._store.ids, overflow, retry))
    assert calls and calls[0] >= 8 + 3
    assert idx._sparse_S_hint.get((2, 2)) == calls[0]
    np.testing.assert_allclose(scores[0], [1.0, 2.0])
    st = idx.stats()
    assert st["sparse_overflow_batches"] == 1 and st["sparse_overflow_chunks"] == 3


def test_sparse_zero_overflow_no_rescan(rng):
    idx, _ = _trained(rng)
    handle = ("sparse", torch.tensor([[1.5]]), torch.tensor([[2]], dtype=torch.int32),
              idx._store.ids, torch.zeros(1, dtype=torch.int32), (None,) * 7)
    ids, scores = idx._search_collect(handle)
    np.testing.assert_allclose(scores[0], [1.5])
    assert idx.stats()["sparse_overflow_batches"] == 0


def test_real_overflow_rescans_to_exact(monkeypatch):
    """A step budget too small for the probes: the first scan overflows,
    the rescan covers every probe, and the learned budget is kept."""
    monkeypatch.setenv("COMET_IVF_SPARSE", "1")
    port = _port_of(_reference())
    st = port._device_sparse()
    monkeypatch.setattr(ivf_mod.sp, "default_budgets",
                        lambda nprobe, nlist, total, mc: (4, 4, mc))
    q = _data()[1]
    got = port.search_batch(q, k=8, nprobes=7)
    assert port.stats()["sparse_overflow_batches"] == 1
    assert port._sparse_S_hint[(7, 8)] > 4
    monkeypatch.setenv("COMET_IVF_SPARSE", "0")
    want = port.search_batch(q, k=8, nprobes=7)
    _assert_same(want, got, sparse=True)
    assert st is port._device_sparse()         # the layout was not rebuilt


def test_degenerate_budget_routes_dense(monkeypatch):
    """Once the learned budget reaches half the table, the shape goes dense."""
    monkeypatch.setenv("COMET_IVF_SPARSE", "1")
    routes = _Routes(monkeypatch)
    port = _port_of(_reference())
    q = _data()[1]
    port.search_batch(q, k=K, nprobes=2)
    port._sparse_S_hint[(2, 16)] = port._device_sparse()["nch_total"]
    port.search_batch(q, k=K, nprobes=2)
    assert routes.calls == {"sparse": 1, "dense": 1}
