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


@pytest.mark.parametrize("storage", ["bfloat16", "float16", "int8", "int4"])
def test_non_f32_storage_raises(storage):
    with pytest.raises(InvalidConfigError, match="ROADMAP"):
        FlatIndex(8, DistanceKind.L2, storage=storage, device="cpu")


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
