"""comet_tpu_torch.HybridSearchIndex on the CPU against comet_tpu's.

Both packages get the same seeded documents (integer vectors, whose
distances are exact, zipf texts and metadata) over a FlatIndex, a
BM25SearchIndex and a RoaringMetadataIndex. `search_batch` and the fluent
`execute` must give the reference's results for every fusion kind, with
and without metadata filters and autocut, text-only, vector-only and
metadata-only: ids equal, scores `allclose(rtol=1e-5, atol=1e-6)` (the
BM25 bar; reciprocal-rank scores are equal). Also: the port's batch equals
its own `execute` query by query, CHYB bytes equal both ways, and the
facade's bookkeeping.
"""

import io

import numpy as np
import pytest

import comet_tpu
import comet_tpu_torch
from comet_tpu.indexes import metadata as rmeta
from comet_tpu_torch import FusionKind, InvalidConfigError
from comet_tpu_torch.core import node as port_node
from comet_tpu_torch.indexes import metadata as pmeta

N, D, Q, K = 120, 8, 6, 7
KINDS = list(FusionKind)


@pytest.fixture(autouse=True)
def _reset_port_ids():
    port_node._reset_node_id_counter()
    yield


def _docs(seed=0):
    rng = np.random.default_rng(seed)
    vecs = rng.integers(0, 8, size=(N, D)).astype(np.float32)
    words = [f"t{i}" for i in range(30)]
    ranks = rng.zipf(1.3, size=(N, 6)) % len(words)
    texts = [" ".join(words[r] for r in row[: 2 + i % 5]) for i, row in enumerate(ranks)]
    metas = [{"cat": ["x", "y", "z"][i % 3], "num": i} for i in range(N)]
    queries = rng.integers(0, 8, size=(Q, D)).astype(np.float32)
    qtexts = [" ".join(words[r] for r in rng.integers(0, 12, size=1 + i % 3)) for i in range(Q)]
    return vecs, texts, metas, queries, qtexts


def _pair(seed=0):
    vecs, texts, metas, queries, qtexts = _docs(seed)
    ref = comet_tpu.new_hybrid_search_index(
        comet_tpu.FlatIndex(D, comet_tpu.DistanceKind.L2), comet_tpu.BM25SearchIndex(),
        comet_tpu.RoaringMetadataIndex())
    port = comet_tpu_torch.new_hybrid_search_index(
        comet_tpu_torch.FlatIndex(D, comet_tpu_torch.DistanceKind.L2, device="cpu"),
        comet_tpu_torch.BM25SearchIndex(device="cpu"), comet_tpu_torch.RoaringMetadataIndex())
    for i in range(N):
        ref.add_with_id(i + 1, vecs[i], texts[i], metas[i])
        port.add_with_id(i + 1, vecs[i], texts[i], metas[i])
    return ref, port, queries, qtexts


def _same(got, want):
    assert [r.id for r in got] == [r.id for r in want]
    np.testing.assert_allclose([r.score for r in got], [r.score for r in want],
                               rtol=1e-5, atol=1e-6)


FILTERS = {
    "none": ([], []),
    "eq": ([rmeta.eq("cat", "x")], [pmeta.eq("cat", "x")]),
    "group": ([rmeta.FilterGroup([rmeta.eq("cat", "y"), rmeta.gte("num", 60)], "OR")],
              [pmeta.FilterGroup([pmeta.eq("cat", "y"), pmeta.gte("num", 60)], "OR")]),
}


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("filt", list(FILTERS))
@pytest.mark.parametrize("cutoff", [-1, 1])
def test_search_batch_matches_reference(kind, filt, cutoff):
    ref, port, queries, qtexts = _pair()
    rf, pf = FILTERS[filt]
    groups = filt == "group"
    want = ref.search_batch(
        queries, qtexts, k=K, fusion_kind=comet_tpu.FusionKind(kind.value), cutoff=cutoff,
        metadata_filters=None if groups else rf, metadata_groups=rf if groups else None)
    got = port.search_batch(
        queries, qtexts, k=K, fusion_kind=kind, cutoff=cutoff,
        metadata_filters=None if groups else pf, metadata_groups=pf if groups else None)
    assert len(got) == len(want) == Q
    for g, w in zip(got, want):
        _same(g, w)


@pytest.mark.parametrize("mode", ["text", "vector"])
@pytest.mark.parametrize("filt", ["none", "eq"])
def test_one_modality_batches_match_reference(mode, filt):
    ref, port, queries, qtexts = _pair(1)
    rf, pf = FILTERS[filt]
    args = (None, qtexts) if mode == "text" else (queries, None)
    want = ref.search_batch(*args, k=K, metadata_filters=rf)
    got = port.search_batch(*args, k=K, metadata_filters=pf)
    for g, w in zip(got, want):
        _same(g, w)


@pytest.mark.parametrize("kind", KINDS)
def test_execute_matches_reference_and_the_port_batch(kind):
    """The batch equals `execute` query by query wherever the reference's
    do: with MIN fusion and no document in both legs, `execute` falls back
    to the metadata candidates at score 1.0 and the batch returns nothing,
    in both packages (comet_tpu/hybrid.py:413-425 against :596-597)."""
    ref, port, queries, qtexts = _pair(2)
    batch = port.search_batch(queries, qtexts, k=K, fusion_kind=kind,
                              metadata_filters=[pmeta.eq("cat", "z")])
    ref_batch = ref.search_batch(queries, qtexts, k=K,
                                 fusion_kind=comet_tpu.FusionKind(kind.value),
                                 metadata_filters=[rmeta.eq("cat", "z")])
    for qi in range(Q):
        want = (ref.new_search().with_vector(queries[qi]).with_text(qtexts[qi])
                .with_metadata(rmeta.eq("cat", "z"))
                .with_fusion_kind(comet_tpu.FusionKind(kind.value)).with_k(K).execute())
        got = (port.new_search().with_vector(queries[qi]).with_text(qtexts[qi])
               .with_metadata(pmeta.eq("cat", "z")).with_fusion_kind(kind).with_k(K).execute())
        _same(got, want)
        _same(batch[qi], ref_batch[qi])
        if [r.id for r in ref_batch[qi]] == [r.id for r in want]:
            assert [(r.id, r.score) for r in batch[qi]] == [(r.id, r.score) for r in got]
        else:
            assert kind == FusionKind.MIN and batch[qi] == []


def test_execute_one_modality_metadata_only_and_cutoff():
    ref, port, queries, qtexts = _pair(3)
    cases = [
        (lambda b: b.with_text(qtexts[0], qtexts[1]).with_k(K),) * 2,
        (lambda b: b.with_vector(queries[0]).with_k(3).with_threshold(6.0),) * 2,
        (lambda b: b.with_vector(queries[1]).with_text(qtexts[1]).with_cutoff(1).with_k(K),) * 2,
        (lambda b: b.with_metadata(rmeta.gte("num", 100)).with_k(50),
         lambda b: b.with_metadata(pmeta.gte("num", 100)).with_k(50)),
        (lambda b: b.with_text(qtexts[2]).with_metadata(rmeta.eq("cat", "nope")),
         lambda b: b.with_text(qtexts[2]).with_metadata(pmeta.eq("cat", "nope"))),
    ]
    for rb, pb in cases:
        _same(pb(port.new_search()).execute(), rb(ref.new_search()).execute())
    meta_only = port.new_search().with_metadata(pmeta.gte("num", 100)).with_k(50).execute()
    assert [r.score for r in meta_only] == [1.0] * 20


def test_chyb_bytes_equal_both_ways():
    ref, port, queries, qtexts = _pair(4)
    for idx in (ref, port):
        idx.remove(3)
    outs = []
    for idx in (ref, port):
        bufs = [io.BytesIO() for _ in range(4)]
        idx.write_to(*bufs)
        outs.append([b.getvalue() for b in bufs])
    assert outs[0] == outs[1]
    back = comet_tpu_torch.new_hybrid_search_index(
        comet_tpu_torch.FlatIndex(D, comet_tpu_torch.DistanceKind.L2, device="cpu"),
        comet_tpu_torch.BM25SearchIndex(device="cpu"), comet_tpu_torch.RoaringMetadataIndex())
    back.read_from(*[io.BytesIO(b) for b in outs[0]])
    assert back.count() == N - 1 and not back.has_document(3)
    _same(back.search_batch(queries, qtexts, k=K)[0], ref.search_batch(queries, qtexts, k=K)[0])
    v1 = bytearray(outs[0][0][:-4])
    v1[4:8] = (1).to_bytes(4, "little")
    again = comet_tpu_torch.new_hybrid_search_index(
        comet_tpu_torch.FlatIndex(D, comet_tpu_torch.DistanceKind.L2, device="cpu"),
        comet_tpu_torch.BM25SearchIndex(device="cpu"), comet_tpu_torch.RoaringMetadataIndex())
    again.read_from(io.BytesIO(bytes(v1)), *[io.BytesIO(b) for b in outs[0][1:]])
    assert again.count() == N - 1


def test_facade_bookkeeping():
    idx = comet_tpu_torch.new_hybrid_search_index(
        comet_tpu_torch.FlatIndex(2, comet_tpu_torch.DistanceKind.COSINE, device="cpu"),
        comet_tpu_torch.BM25SearchIndex(device="cpu"), comet_tpu_torch.RoaringMetadataIndex())
    ids = [idx.add(np.array([1.0, i], np.float32), f"doc {i}", {"i": i}) for i in range(3)]
    assert ids == [1, 2, 3] and idx.count() == 3
    idx.add_batch_with_ids([(10, None, "text only", None), (11, [0.5, 0.5], "", {"i": 9})])
    assert idx.has_document(10) and idx.count() == 5
    idx.remove(2)
    assert not idx.has_document(2)
    with pytest.raises(InvalidConfigError):
        idx.remove(2)
    s = idx.stats()
    assert s["docs"] == 4 and s["text"]["docs"] == 4 and s["metadata"]["docs"] == 3
    bare = comet_tpu_torch.HybridSearchIndex()
    with pytest.raises(InvalidConfigError):
        bare.add(np.ones(2, np.float32))
    with pytest.raises(InvalidConfigError):
        bare.new_search().with_text("x").execute()
    assert idx.search_batch(None, None, k=3) == []
