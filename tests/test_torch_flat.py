"""comet_tpu_torch.FlatIndex on the CPU against comet_tpu.FlatIndex.

The same corpus and queries, made from a seeded numpy generator, go through
both packages' public API. Bar: ids array-equal, scores
`allclose(rtol=1e-4, atol=1e-4)`. Also: the CFLT v2 format across packages
(byte-identical files), state carried over from a reference slot store,
and a port of the reference's exactness-vs-oracle test.
"""

import io

import numpy as np
import pytest
import torch

import comet_tpu
import comet_tpu_torch
from comet_tpu_torch import DistanceKind, FlatIndex, InvalidConfigError
from comet_tpu_torch.io.serial import SerializationError

from oracle import distances_np, preprocess_np, topk_np

KINDS = ["l2", "l2_squared", "cosine"]
N, D, Q, K = 700, 16, 20, 10
IDS = list(range(100, 100 + N))


def _data(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, D)).astype(np.float32)
    q = rng.normal(size=(Q, D)).astype(np.float32)
    return x, q


def _pair(kind, x):
    ref = comet_tpu.FlatIndex(D, comet_tpu.DistanceKind(kind))
    ref.add_batch(x, ids=IDS)
    port = FlatIndex(D, DistanceKind(kind), device="cpu")
    port.add_batch(x, ids=IDS)
    return ref, port


def _assert_same(ref_out, port_out):
    np.testing.assert_array_equal(port_out[0], ref_out[0])
    fin = np.isfinite(ref_out[1])
    np.testing.assert_array_equal(np.isfinite(port_out[1]), fin)
    np.testing.assert_allclose(port_out[1][fin], ref_out[1][fin], rtol=1e-4, atol=1e-4)


def _fluent(index, q, **knobs):
    b = index.new_search().with_query(q).with_k(K)
    if "threshold" in knobs:
        b = b.with_threshold(knobs["threshold"])
    if "document_ids" in knobs:
        b = b.with_document_ids(knobs["document_ids"])
    res = b.execute()
    return [r.node.id for r in res], np.array([r.score for r in res], np.float32)


THRESHOLD = {"l2": 4.5, "l2_squared": 20.0, "cosine": 0.3}
FILTER = [i for i in IDS if i % 3 == 0]


@pytest.mark.parametrize("scenario", ["batch", "fluent", "filter", "threshold", "flush"])
@pytest.mark.parametrize("kind", KINDS)
def test_search_matches_reference(kind, scenario):
    x, q = _data()
    ref, port = _pair(kind, x)
    knobs = {}
    if scenario == "filter":
        knobs["document_ids"] = FILTER
    elif scenario == "threshold":
        knobs["threshold"] = THRESHOLD[kind]
    elif scenario == "flush":
        for index in (ref, port):
            for i in IDS[::9]:
                index.remove(i)
            index.flush()
    if scenario == "fluent":
        for qi in range(3):
            rid, rsc = _fluent(ref, q[qi])
            pid, psc = _fluent(port, q[qi])
            assert pid == rid
            np.testing.assert_allclose(psc, rsc, rtol=1e-4, atol=1e-4)
        return
    _assert_same(ref.search_batch(q, k=K, **knobs), port.search_batch(q, k=K, **knobs))
    if scenario == "threshold":
        assert (port.search_batch(q, k=K, **knobs)[0] == 0xFFFFFFFF).any()


def test_filter_and_threshold_fluent_and_bitset():
    x, q = _data(1)
    ref, port = _pair("l2", x)
    for qi in range(2):
        got = _fluent(port, q[qi], threshold=5.0, document_ids=FILTER)
        want = _fluent(ref, q[qi], threshold=5.0, document_ids=FILTER)
        assert got[0] == want[0]
        np.testing.assert_allclose(got[1], want[1], rtol=1e-4, atol=1e-4)
    bits = comet_tpu_torch.Bitset.from_array(FILTER)
    _assert_same(ref.search_batch(q, k=K, document_ids=FILTER),
                 port.search_batch(q, k=K, document_ids=bits))


def test_search_stream_and_post_steps_match_reference():
    x, q = _data(2)
    ref, port = _pair("l2", x)
    knobs = dict(k=K, cutoff=2, group_size=2)
    _assert_same(ref.search_batch(q, **knobs), port.search_batch(q, **knobs))
    got = list(port.search_stream([q[:8], q[8:]], k=K, depth=2))
    want = list(ref.search_stream([q[:8], q[8:]], k=K, depth=2))
    for g, w in zip(got, want):
        _assert_same(w, g)
    ids, scores = port.search_batch(q, k=K, wire_scores=False)
    np.testing.assert_array_equal(ids, ref.search_batch(q, k=K)[0])
    assert not scores.any()
    with pytest.raises(InvalidConfigError):
        port.search_batch(q, k=K, wire_scores=False, cutoff=3)


def _write(index):
    buf = io.BytesIO()
    index.write_to(buf)
    return buf.getvalue()


@pytest.mark.parametrize("kind", KINDS)
def test_cflt_v2_round_trip_across_packages(kind):
    x, q = _data(3)
    ref, port = _pair(kind, x)
    for index in (ref, port):
        index.remove(IDS[5])
    ref_bytes, port_bytes = _write(ref), _write(port)
    assert port_bytes == ref_bytes                       # byte-identical
    from_ref = FlatIndex(D, DistanceKind(kind), device="cpu")
    from_ref.read_from(io.BytesIO(ref_bytes))            # JAX writes, port reads
    from_port = comet_tpu.FlatIndex(D, comet_tpu.DistanceKind(kind))
    from_port.read_from(io.BytesIO(port_bytes))          # port writes, JAX reads
    assert from_ref.count() == from_port.count() == N - 1
    _assert_same(from_port.search_batch(q, k=K), from_ref.search_batch(q, k=K))
    assert _write(from_ref) == ref_bytes


def test_cflt_rejects_mismatch_and_corruption():
    x, _ = _data(4)
    ref, _ = _pair("l2", x)
    blob = _write(ref)
    with pytest.raises(SerializationError):
        FlatIndex(D, DistanceKind.COSINE, device="cpu").read_from(io.BytesIO(blob))
    with pytest.raises(SerializationError):
        FlatIndex(D + 1, DistanceKind.L2, device="cpu").read_from(io.BytesIO(blob))
    bad = bytearray(blob)
    bad[len(bad) // 2] ^= 0xFF
    with pytest.raises(SerializationError):
        FlatIndex(D, DistanceKind.L2, device="cpu").read_from(io.BytesIO(bytes(bad)))


@pytest.mark.parametrize("kind", KINDS)
def test_load_reference_state_with_soft_deletes(kind):
    x, q = _data(5)
    ref = comet_tpu.FlatIndex(D, comet_tpu.DistanceKind(kind))
    ref.add_batch(x, ids=IDS)
    for i in IDS[::4]:
        ref.remove(i)
    s = ref._store
    port = FlatIndex.load_reference_state(
        s.ids, s.vectors, s.valid, s.n, DistanceKind(kind), device="cpu"
    )
    assert port.count() == ref.count()
    assert port.stats()["soft_deleted"] == s.deleted
    _assert_same(ref.search_batch(q, k=K), port.search_batch(q, k=K))
    for index in (ref, port):
        index.flush()
    _assert_same(ref.search_batch(q, k=K), port.search_batch(q, k=K))


@pytest.mark.parametrize("kind", KINDS)
def test_exactness_vs_oracle(kind, rng):
    """Port of tests/test_flat.py::test_exactness_vs_oracle."""
    idx = FlatIndex(16, DistanceKind(kind), device="cpu")
    x = rng.normal(size=(500, 16)).astype(np.float32)
    ids = np.arange(100, 600, dtype=np.uint32)
    idx.add_batch(x, ids=ids.tolist())
    q = rng.normal(size=(4, 16)).astype(np.float32)
    ws, wi = topk_np(distances_np(preprocess_np(q, kind), preprocess_np(x, kind), kind), 10)
    for qi in range(4):
        res = idx.new_search().with_query(q[qi]).with_k(10).execute()
        assert [r.node.id for r in res] == [int(ids[j]) for j in wi[qi]]
        got_scores = np.array([r.score for r in res])
        np.testing.assert_allclose(got_scores, ws[qi], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("storage", ["float16", "int8", "int4"])
def test_non_f32_storage_raises(storage):
    """The reference's validation: float16 and int8 are storages of both
    packages now (their index builds, with rerank too); int4 is no storage
    of the reference and raises; rerank needs lossy storage."""
    if storage == "int4":
        with pytest.raises(InvalidConfigError, match="unsupported"):
            FlatIndex(8, DistanceKind.L2, storage=storage, device="cpu")
        with pytest.raises(comet_tpu.InvalidConfigError, match="unsupported"):
            comet_tpu.FlatIndex(8, comet_tpu.DistanceKind.L2, storage=storage)
    else:
        for rerank in (False, True):
            port = FlatIndex(8, DistanceKind.L2, storage=storage, rerank=rerank, device="cpu")
            ref = comet_tpu.FlatIndex(8, comet_tpu.DistanceKind.L2, storage=storage,
                                      rerank=rerank)
            assert port._storage == ref._storage == storage
            assert port._rerank == ref._rerank == rerank
    with pytest.raises(InvalidConfigError, match="lossy"):
        FlatIndex(8, DistanceKind.L2, rerank=True, device="cpu")


# -- bfloat16 storage ---------------------------------------------------------------
#
# SIFT-range integers (L2) and vectors of four +-1 entries (cosine, +-0.5
# once normalised) are exact in bf16, and every product and partial sum is
# exact in float32, so the bf16 scan's scores are array-equal to the
# reference's; the rerank re-scores in float32 on the host in both.


def _bf16_data(kind, seed=6):
    rng = np.random.default_rng(seed)
    if kind == "cosine":
        def signs(n):
            v = np.zeros((n, D), np.float32)
            for r in range(n):
                v[r, rng.choice(D, 4, replace=False)] = rng.choice([-1.0, 1.0], 4)
            return v
        return signs(N), signs(Q)
    x = rng.integers(0, 256, size=(N + Q, D)).astype(np.float32)
    return x[:N], x[N:]


BF16_THRESHOLD = {"l2": 300.0, "l2_squared": 9.0e4, "cosine": 0.6}


@pytest.mark.parametrize("rerank", [False, True], ids=["scan", "rerank"])
@pytest.mark.parametrize("scenario", ["batch", "filter-threshold", "remove"])
@pytest.mark.parametrize("kind", KINDS)
def test_bf16_storage_matches_reference(kind, scenario, rerank):
    x, q = _bf16_data(kind)
    ref = comet_tpu.FlatIndex(D, comet_tpu.DistanceKind(kind), storage="bfloat16", rerank=rerank)
    port = FlatIndex(D, DistanceKind(kind), storage="bfloat16", rerank=rerank, device="cpu")
    knobs = {}
    for index in (ref, port):
        index.add_batch(x, ids=IDS)
        if scenario == "remove":
            index.search_batch(q[:1], k=K)    # the bf16 copy of the first version
            for i in IDS[::5]:
                index.remove(i)
    if scenario == "filter-threshold":
        knobs = dict(threshold=BF16_THRESHOLD[kind], document_ids=FILTER)
    want = ref.search_batch(q, k=K, **knobs)
    got = port.search_batch(q, k=K, **knobs)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    hits = got[0][got[0] != 0xFFFFFFFF]
    assert len(hits)
    if scenario == "filter-threshold":
        assert len(hits) < got[0].size and (hits % 3 == 0).all()
    if scenario == "remove":
        assert not np.isin(hits, IDS[::5]).any()


def test_bf16_storage_fluent_copy_and_bytes():
    """The fluent builder, the bf16 copy made once per store version and
    re-made after a change, and CFLT bytes equal to the float32 index's."""
    x, q = _bf16_data("l2", seed=7)
    ref = comet_tpu.FlatIndex(D, comet_tpu.DistanceKind.L2, storage="bfloat16")
    port = FlatIndex(D, DistanceKind.L2, storage="bfloat16", device="cpu")
    f32 = FlatIndex(D, DistanceKind.L2, device="cpu")
    for index in (ref, port, f32):
        index.add_batch(x, ids=IDS)
    assert _fluent(port, q[0])[0] == _fluent(ref, q[0])[0]
    copy = port._dev_cast
    port.search_batch(q, k=K)
    assert port._dev_cast is copy and copy.dtype.itemsize == 2
    port.add_batch(q[:1], ids=[5000])
    ref.add_batch(q[:1], ids=[5000])
    np.testing.assert_array_equal(port.search_batch(q, k=K)[0], ref.search_batch(q, k=K)[0])
    assert port._dev_cast is not copy
    f32.add_batch(q[:1], ids=[5000])
    assert _write(port) == _write(f32)
    back = FlatIndex(D, DistanceKind.L2, storage="bfloat16", device="cpu")
    back.read_from(io.BytesIO(_write(port)))
    np.testing.assert_array_equal(back.search_batch(q, k=K)[0], port.search_batch(q, k=K)[0])


def test_slot_store_mirror_follows_adds_and_removes_in_place():
    """An add or a remove writes its rows into a current device mirror in
    place (the same tensors, current again, equal to a fresh upload); a
    flush or a capacity growth leaves it to a whole upload."""
    x, q = _data(8)
    port = FlatIndex(D, DistanceKind.L2, device="cpu")
    port.add_batch(x[:300], ids=IDS[:300])
    store = port._store
    mirror = store.device_state()
    port.add_batch(x[300:], ids=IDS[300:])
    port.remove(IDS[7])
    assert store._dev_version == store.version and store._dev is mirror
    got = [t.clone() for t in mirror]
    store._dev_version = -1                    # force a whole upload to compare with
    for g, w in zip(got, store.device_state()):
        assert torch.equal(g, w)
    port.flush()
    assert store._dev_version != store.version
    mirror = store.device_state()
    port.add_batch(np.repeat(q, 60, axis=0), ids=range(5000, 5000 + 60 * Q))   # grows to 2048
    assert store.capacity == 2048 and store._dev_version != store.version
    assert store.device_state()[0].shape == (2048, D)


def test_small_index_behaviour_matches_reference():
    """The reference's small-index behaviours: k clamps, with_node, multi-query
    sum aggregation with id tie-break, autocut, reranker, empty index."""
    vecs = np.array([[0, 0], [1, 0], [2, 0], [10, 0]], dtype=np.float32)
    port = FlatIndex(2, DistanceKind.L2, device="cpu")
    assert port.search_batch(vecs, k=3)[0].shape == (4, 0)
    port.add_batch(vecs, ids=[1, 2, 3, 4])
    ref = comet_tpu.FlatIndex(2, comet_tpu.DistanceKind.L2)
    ref.add_batch(vecs, ids=[1, 2, 3, 4])

    class Reverse:
        def rerank(self, results):
            return list(reversed(results))

    def run(index, build):
        return [(r.node.id, round(r.score, 5)) for r in build(index.new_search()).execute()]

    cases = [
        lambda b: b.with_query([0.0, 0.0]).with_k(0),
        lambda b: b.with_node(2).with_k(2),
        lambda b: b.with_query([0.0, 0.0]).with_query([2.0, 0.0]).with_k(10),
        lambda b: b.with_query([0.0, 0.0]).with_k(4).with_cutoff(1),
        lambda b: b.with_query([0.0, 0.0]).with_k(3).with_reranker(Reverse()),
    ]
    for build in cases:
        assert run(port, build) == run(ref, build)


# -- float16 and int8 storage ------------------------------------------------------
#
# The same data as the bf16 cases. float16 holds them exactly and every
# float16 product and partial sum is exact in float32, so the scan's scores
# are array-equal to the reference's. int8 quantises SIFT-range rows with
# the abs-max scale 255 / 127, which rounds the scaled sums and the
# dequantised norms (summed in another order): ids equal, scores
# allclose(1e-4, 1e-4). The rerank re-scores in float32 on the host in both.


@pytest.mark.parametrize("rerank", [False, True], ids=["scan", "rerank"])
@pytest.mark.parametrize("scenario", ["batch", "filter-threshold", "remove"])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("storage", ["float16", "int8"])
def test_f16_int8_storage_matches_reference(storage, kind, scenario, rerank):
    x, q = _bf16_data(kind)
    ref = comet_tpu.FlatIndex(D, comet_tpu.DistanceKind(kind), storage=storage, rerank=rerank)
    port = FlatIndex(D, DistanceKind(kind), storage=storage, rerank=rerank, device="cpu")
    knobs = {}
    for index in (ref, port):
        index.add_batch(x, ids=IDS)
        if scenario == "remove":
            index.search_batch(q[:1], k=K)    # the lossy copy of the first version
            for i in IDS[::5]:
                index.remove(i)
    if scenario == "filter-threshold":
        knobs = dict(threshold=BF16_THRESHOLD[kind], document_ids=FILTER)
    want = ref.search_batch(q, k=K, **knobs)
    got = port.search_batch(q, k=K, **knobs)
    if storage == "float16" or rerank:
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    else:
        _assert_same(want, got)
    hits = got[0][got[0] != 0xFFFFFFFF]
    assert len(hits)
    if scenario == "filter-threshold":
        assert len(hits) < got[0].size and (hits % 3 == 0).all()
    if scenario == "remove":
        assert not np.isin(hits, IDS[::5]).any()


def test_int8_scale_trained_or_fitted_per_version():
    """`train(sample)` fixes the abs-max scale (the reference's value, kept
    across adds); untrained, the scale follows the live rows of each store
    version. The int8 copy is made once a version; CFLT bytes are the
    float32 index's."""
    x, q = _bf16_data("l2", seed=9)
    ref = comet_tpu.FlatIndex(D, comet_tpu.DistanceKind.L2, storage="int8", rerank=True)
    port = FlatIndex(D, DistanceKind.L2, storage="int8", rerank=True, device="cpu")
    for index in (ref, port):
        index.train(x[:50] * 0.5)
        index.add_batch(x, ids=IDS)
    assert port._int8_scale == ref._int8_scale == np.float32(np.abs(x[:50] * 0.5).max() / 127)
    _assert_same(ref.search_batch(q, k=K), port.search_batch(q, k=K))
    assert port._dev_scale == float(port._int8_scale)
    assert np.abs(port._dev_cast.numpy()).max() == 127    # rows past the sample clip
    copy = port._dev_cast
    port.search_batch(q, k=K)
    assert port._dev_cast is copy and copy.dtype == torch.int8

    fit = FlatIndex(D, DistanceKind.L2, storage="int8", device="cpu")
    fit.add_batch(x[:100] * 0.5, ids=IDS[:100])
    fit.search_batch(q, k=K)
    first = fit._dev_scale
    assert first == float(np.float32(np.abs(x[:100] * 0.5).max() / 127))
    fit.add_batch(x[100:], ids=IDS[100:])
    fit.search_batch(q, k=K)
    assert fit._dev_scale == float(np.float32(np.abs(x).max() / 127)) != first
    f32 = FlatIndex(D, DistanceKind.L2, device="cpu")
    f32.add_batch(x, ids=IDS)
    assert _write(port) == _write(f32)
    back = FlatIndex(D, DistanceKind.L2, storage="int8", device="cpu")
    back.read_from(io.BytesIO(_write(fit)))
    np.testing.assert_array_equal(back.search_batch(q, k=K)[0], fit.search_batch(q, k=K)[0])
