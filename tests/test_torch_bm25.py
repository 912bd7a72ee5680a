"""comet_tpu_torch.BM25SearchIndex on the CPU against comet_tpu's.

Every case of tests/test_bm25.py, run through both packages' public API
on the same documents. The reference scores with two scorers: its C loop
(`_native_search_batch`, taken by `search_batch` and `execute`) and, with
that patched out, its XLA scorer (`search_batch`) or its float64 host
loop (`execute`). The port is held to each: ids array-equal, scores
`allclose(rtol=1e-5, atol=1e-6)`, the reference's own bar between its two
scorers (tests/test_bm25.py:260-286). Also: CB25 bytes equal both ways,
v2 files readable, and state carried over with soft deletes.
"""

import contextlib
import io
import math

import numpy as np
import pytest
import torch

from comet_tpu import native
from comet_tpu.indexes import bm25 as ref_bm25
from comet_tpu_torch import Bitset, BM25SearchIndex, InvalidConfigError, NodeNotFoundError
from comet_tpu_torch.indexes import bm25 as port_bm25
from comet_tpu_torch.ops import bm25 as bm25_ops
from comet_tpu_torch.ops import edge_cases
from comet_tpu_torch.types import ScoreAggregationKind

CORPUS = {
    1: "the quick brown fox jumps over the lazy dog",
    2: "a quick brown dog runs in the park",
    3: "the lazy cat sleeps all day",
    4: "foxes are quick and clever animals",
    5: "dogs are loyal and friendly animals",
}
SCORERS = ["native", "xla"]


@pytest.fixture(autouse=True, scope="module")
def _needs_native():
    assert native.available(), "the reference's C scorer is not built"


def _pair(corpus=CORPUS, wordlike_only=False):
    ref = ref_bm25.BM25SearchIndex(wordlike_only=wordlike_only)
    port = BM25SearchIndex(wordlike_only=wordlike_only, device="cpu")
    for doc_id, text in corpus.items():
        ref.add(doc_id, text)
        port.add(doc_id, text)
    return ref, port


@contextlib.contextmanager
def _scorer(name):
    """The reference's C scorer, or (patched out) its other scorer."""
    if name == "native":
        yield
        return
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_bm25.BM25SearchIndex, "_native_search_batch", lambda *a, **k: None)
        yield


def _rows_equal(port_out, ref_out):
    np.testing.assert_array_equal(port_out[0], ref_out[0])
    np.testing.assert_allclose(port_out[1], ref_out[1], rtol=1e-5, atol=1e-6)


def _results_equal(port_res, ref_res):
    assert [r.id for r in port_res] == [r.id for r in ref_res]
    np.testing.assert_allclose([r.score for r in port_res], [r.score for r in ref_res],
                               rtol=1e-5, atol=1e-6)


def _both(ref, port, build, scorer):
    """Run the same builder on both indexes and hold the results equal."""
    with _scorer(scorer):
        want = build(ref.new_search()).execute()
    got = build(port.new_search()).execute()
    _results_equal(got, want)
    return got


def test_normalize_and_tokenize_match_reference():
    for text in ["HeLLo WORLD", "the quick-brown fox!", "café 123 a_b", "ＱＵＩＣＫ",
                 "don't", "1,000.50", "example.com", "Über straße ﬁ"]:
        assert port_bm25.normalize(text) == ref_bm25.normalize(text)
        assert port_bm25.tokenize(port_bm25.normalize(text)) == ref_bm25.tokenize(
            ref_bm25.normalize(text))


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        assert BM25SearchIndex()._device.type == "cuda"
    else:
        with pytest.raises(InvalidConfigError):
            BM25SearchIndex()


@pytest.mark.parametrize("scorer", SCORERS)
@pytest.mark.parametrize("query,k", [("quick fox", 10), ("the", 2), ("zebra", 10),
                                     ("zebra unicorn", 10), ("lazy dog", 3),
                                     ("fox fox fox", 10), ("!!!...", 10), ("", 10),
                                     ("!!! ...", 10)])
def test_execute_matches_reference(scorer, query, k):
    ref, port = _pair()
    _both(ref, port, lambda b: b.with_query(query).with_k(k), scorer)


@pytest.mark.parametrize("scorer", SCORERS)
def test_every_match_for_k_at_most_zero(scorer):
    ref, port = _pair()
    for k in (0, -1):
        got = _both(ref, port, lambda b: b.with_query("quick lazy").with_k(k), scorer)
        assert len(got) == len(CORPUS)


def test_requires_query_or_node():
    _, port = _pair()
    with pytest.raises(InvalidConfigError):
        port.new_search().with_k(5).execute()


@pytest.mark.parametrize("scorer", SCORERS)
def test_add_replaces_existing(scorer):
    ref, port = _pair()
    for idx in (ref, port):
        idx.add(1, "completely different content now")
    _both(ref, port, lambda b: b.with_query("fox").with_k(10), scorer)
    _both(ref, port, lambda b: b.with_query("different content").with_k(10), scorer)
    assert port.count() == ref.count() == 5


@pytest.mark.parametrize("scorer", SCORERS)
def test_soft_delete_then_flush(scorer):
    ref, port = _pair()
    for idx in (ref, port):
        idx.remove(1)
        idx.remove(999)
    assert port.count() == ref.count() == 4
    assert port.stats()["soft_deleted"] == 1
    _both(ref, port, lambda b: b.with_query("fox").with_k(10), scorer)
    for idx in (ref, port):
        idx.flush()
    _both(ref, port, lambda b: b.with_query("fox").with_k(10), scorer)
    for key in ("docs", "soft_deleted", "terms", "total_tokens", "avg_doc_len"):
        assert port.stats()[key] == ref.stats()[key], key


@pytest.mark.parametrize("scorer", SCORERS)
def test_document_filter_list_and_bitset(scorer):
    ref, port = _pair()
    _both(ref, port, lambda b: b.with_query("quick").with_k(10).with_document_ids([2, 4]), scorer)
    with _scorer(scorer):
        want = ref.new_search().with_query("quick animals").with_document_ids(
            ref_bm25.Bitset.from_array([1, 4, 5])).execute()
    got = port.new_search().with_query("quick animals").with_document_ids(
        Bitset.from_array([1, 4, 5])).execute()
    _results_equal(got, want)


@pytest.mark.parametrize("scorer", SCORERS)
def test_more_like_this(scorer):
    ref, port = _pair()
    got = _both(ref, port, lambda b: b.with_node(1).with_k(5), scorer)
    assert got[0].id == 1
    with pytest.raises(NodeNotFoundError):
        port.new_search().with_node(999).execute()
    port.remove(2)
    with pytest.raises(NodeNotFoundError):
        port.new_search().with_node(2).execute()


@pytest.mark.parametrize("scorer", SCORERS)
@pytest.mark.parametrize("agg", list(ScoreAggregationKind))
def test_multi_query_aggregation(scorer, agg):
    ref, port = _pair()
    _both(ref, port, lambda b: b.with_query("fox").with_query("dog").with_k(10)
          .with_score_aggregation(agg), scorer)


@pytest.mark.parametrize("scorer", SCORERS)
def test_autocut(scorer):
    docs = {1: "target target target target", 2: "target target target other",
            3: "unrelated words entirely here", 4: "more unrelated filler text"}
    ref, port = _pair(docs)
    got = _both(ref, port, lambda b: b.with_query("target").with_k(10).with_cutoff(1), scorer)
    assert {r.id for r in got} <= {1, 2}


def test_avg_doc_len_and_stats():
    ref, port = _pair()
    assert port.avg_doc_len == ref.avg_doc_len
    for key in ("docs", "soft_deleted", "terms", "total_tokens", "avg_doc_len"):
        assert port.stats()[key] == ref.stats()[key], key


@pytest.mark.parametrize("scorer", SCORERS)
def test_unicode_and_wordlike_only(scorer):
    docs = {1: "Der schnelle braune Fuchs überspringt den faulen Hund", 2: "café au lait",
            3: "don't stop: 1,000.50 at example.com!"}
    for wordlike in (False, True):
        ref, port = _pair(docs, wordlike_only=wordlike)
        for q in ("ÜBERSPRINGT", "café", "don't example.com", "stop! lait"):
            _both(ref, port, lambda b: b.with_query(q).with_k(5), scorer)


def test_cb25_bytes_equal_both_ways_and_v2_readable():
    ref, port = _pair()
    for idx in (ref, port):
        idx.remove(5)
        idx.add(6, "  two  spaces, and punctuation!! ")
    want, got = io.BytesIO(), io.BytesIO()
    ref.write_to(want)
    port.write_to(got)
    assert got.getvalue() == want.getvalue()
    back = BM25SearchIndex(device="cpu")
    back.read_from(io.BytesIO(want.getvalue()))
    again = io.BytesIO()
    back.write_to(again)
    assert again.getvalue() == want.getvalue()
    ref_back = ref_bm25.BM25SearchIndex()
    ref_back.read_from(io.BytesIO(got.getvalue()))
    _both(ref_back, back, lambda b: b.with_query("quick fox").with_k(10), "native")
    # v2: version 2 in the header, no CRC trailer
    v2 = bytearray(want.getvalue()[:-4])
    v2[4:8] = (2).to_bytes(4, "little")
    for idx in (ref_bm25.BM25SearchIndex(), BM25SearchIndex(device="cpu")):
        idx.read_from(io.BytesIO(bytes(v2)))
        assert idx.count() == 5


@pytest.mark.parametrize("block_docs,block_bytes", [(1, 3), (2, 17), (1 << 13, 1 << 24)])
def test_cb25_blocks_give_the_reference_bytes_and_leave_what_follows(monkeypatch, block_docs,
                                                                     block_bytes):
    """write_to encodes and read_from parses CB25 a block at a time: at any
    block size the bytes are the reference's, and the bytes after the
    payload are left in the stream for the next reader."""
    monkeypatch.setattr(port_bm25, "SERIAL_BLOCK_DOCS", block_docs)
    monkeypatch.setattr(port_bm25, "SERIAL_BLOCK_BYTES", block_bytes)
    ref, port = _pair({**CORPUS, 9: "", 10: "é  ü\u00a0x"})
    want, got = io.BytesIO(), io.BytesIO()
    ref.write_to(want)
    port.write_to(got)
    assert got.getvalue() == want.getvalue()
    stream = io.BytesIO(want.getvalue() + b"NEXT")
    back = BM25SearchIndex(device="cpu")
    back.read_from(stream)
    assert stream.read() == b"NEXT"
    again = io.BytesIO()
    back.write_to(again)
    assert again.getvalue() == want.getvalue()
    bad = bytearray(want.getvalue())
    bad[-5] ^= 1  # the last token byte: the checksum no longer holds
    with pytest.raises(Exception, match="checksum"):
        BM25SearchIndex(device="cpu").read_from(io.BytesIO(bytes(bad)))


def test_load_reference_state_keeps_soft_deletes():
    ref, _ = _pair()
    ref.remove(3)
    port = BM25SearchIndex(device="cpu")
    port.load_reference_state(list(ref._doc_tokens), list(ref._doc_tokens.values()),
                              ref._deleted.to_array())
    assert port.count() == ref.count() == 4
    for scorer in SCORERS:
        with _scorer(scorer):
            want = ref.search_batch(["lazy cat", "the"], k=5)
        _rows_equal(port.search_batch(["lazy cat", "the"], k=5), want)


@pytest.mark.parametrize("scorer", SCORERS)
def test_search_batch_delete_filter_and_post_steps(scorer):
    ref, port = _pair()
    queries = ["quick fox", "lazy dog", "electronics nothing", "animals"]
    cases = [dict(k=5), dict(k=10, document_ids=[2, 4]), dict(k=3, cutoff=1),
             dict(k=4, group_size=2, aggregation=ScoreAggregationKind.MAX)]
    for kw in cases:
        with _scorer(scorer):
            want = ref.search_batch(queries, **kw)
        _rows_equal(port.search_batch(queries, **kw), want)
    for idx in (ref, port):
        idx.remove(1)
    with _scorer(scorer):
        want = ref.search_batch(["fox"], k=10)
    _rows_equal(port.search_batch(["fox"], k=10), want)


def test_empty_index():
    port = BM25SearchIndex(device="cpu")
    ids, scores = port.search_batch(["anything"], k=5)
    assert (ids == 0xFFFFFFFF).all() and (scores == 0).all()
    assert port.new_search().with_query("anything").execute() == []


def _seeded_corpus(seed, n_docs, n_vocab=60, words=(2, 9)):
    rng = np.random.default_rng(seed)
    vocab = [f"w{i}x" for i in range(n_vocab)]
    ranks = rng.zipf(1.3, size=(n_docs, words[1])) % n_vocab
    lens = rng.integers(words[0], words[1] + 1, size=n_docs)
    return {i + 1: " ".join(vocab[t] for t in ranks[i, :lens[i]]) for i in range(n_docs)}, vocab


@pytest.mark.parametrize("scorer", SCORERS)
def test_seeded_corpus_batches_match_reference(scorer, monkeypatch):
    """300 documents; 1-, 2- and 10-term queries (the whitespace term and
    repeated terms included), a soft delete, with and without a filter, at
    k = 7 and 100; the scorer runs in chunks of 3 queries."""
    docs, vocab = _seeded_corpus(1, 300)
    ref, port = _pair(docs)
    for idx in (ref, port):
        idx.remove(5)
    rng = np.random.default_rng(2)
    queries = [" ".join(vocab[t] for t in rng.integers(0, len(vocab), size=n))
               for n in (1, 2, 10, 2, 1, 10, 3)] + ["absentterm", "", "w1x w1x w2x"]
    monkeypatch.setattr(bm25_ops, "SCORE_BYTES_MAX", 12 * 300 * 3)
    for doc_ids in (None, list(range(1, 200, 3))):
        for k in (7, 100):
            with _scorer(scorer):
                want = ref.search_batch(queries, k=k, document_ids=doc_ids)
            _rows_equal(port.search_batch(queries, k=k, document_ids=doc_ids), want)


def test_idf_is_the_float64_log_rounded_to_float32():
    docs, vocab = _seeded_corpus(3, 50)
    _, port = _pair(docs)
    slot_docs, _, _, _, df, term_start = port._postings()
    t_start, t_len, t_idf, q_off = port._query_terms([f"{vocab[1]} {vocab[2]}"], df, term_start)
    n = float(len(docs))
    want = [np.float32(math.log((n - d + 0.5) / (d + 0.5) + 1.0)) for d in t_len.tolist()]
    assert t_idf.tolist() == want
    assert q_off.tolist() == [0, 3] and t_len[1] == len(docs) - sum(
        1 for t in docs.values() if " " not in t)


def _float32_oracle(case, k):
    """The scorer in numpy float32, query by query and term by term, then
    (negated score, slot) ascending: the plain version's bits."""
    n_pad = len(case["doc_len"])
    q_off = case["q_off"]
    vals = np.full((len(q_off) - 1, k), np.inf, np.float32)
    slots = np.full((len(q_off) - 1, k), 2**31 - 1, np.int32)
    for q in range(len(q_off) - 1):
        s = np.zeros(n_pad, np.float32)
        for t in range(q_off[q], q_off[q + 1]):
            run = slice(case["t_start"][t], case["t_start"][t] + case["t_len"][t])
            sl, tf = case["post_slot"][run], case["post_tf"][run]
            norm = np.float32(1.0 - bm25_ops.B) + np.float32(bm25_ops.B) * (
                case["doc_len"][sl] / case["avgdl"])
            s[sl] += (case["t_idf"][t] * (tf * np.float32(bm25_ops.K1 + 1.0))) / (
                tf + np.float32(bm25_ops.K1) * norm)
        neg = np.where(case["allowed"], -s, np.float32(0.0))
        order = np.lexsort((np.arange(n_pad), neg))[:k]
        vals[q, :len(order)], slots[q, :len(order)] = neg[order], order
    return vals, slots


@pytest.mark.parametrize("name,n_pad,q_n,k,chunk", edge_cases.BM25_CASES)
def test_scorer_edge_cases_match_float32_oracle(name, n_pad, q_n, k, chunk, monkeypatch):
    """The CPU scorer (the plain rows and K1's plain select) on the card
    tests' edge cases equals a float32 numpy oracle bit for bit."""
    case = edge_cases.bm25_case(name, n_pad, q_n)
    if chunk is not None:
        monkeypatch.setattr(bm25_ops, "SCORE_BYTES_MAX", 12 * n_pad * chunk)
    got = bm25_ops.bm25_topk(**edge_cases.bm25_tensors(case, torch.device("cpu")), k=k)
    want = _float32_oracle(case, k)
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    np.testing.assert_array_equal(got[0].numpy(), want[0])


def _first_at_or_past(run, n_pad, x):
    """The kernel's search for the first posting of a run at or past slot
    x: only the window that distinct slots below n_pad leave, [x - (n_pad
    - len), x] (held to a search of the whole run)."""
    top = min(len(run), x)
    lo = min(top, max(0, x - (n_pad - len(run))))
    found = lo + int(np.searchsorted(run[lo:top], x, "left"))
    assert found == int(np.searchsorted(run, x, "left"))
    return found


def _tiled_model(case, tile, group):
    """The kernel of csrc/bm25_score.cu in numpy float32: a block a (tile of
    `tile` documents, group of `group` queries); per term position, each
    distinct (run, idf) of the group's entries there finds its sub-run by
    the window search, computes its contributions once and adds them to
    every row with that term there; the rows are written masked. Returns
    the dense [Q, n_pad] rows."""
    q_off, doc_len = case["q_off"], case["doc_len"]
    n_pad, rows = len(doc_len), len(q_off) - 1
    f32 = np.float32
    knorm = f32(bm25_ops._K1) * (f32(bm25_ops._1MB) + f32(bm25_ops._B) * (doc_len / case["avgdl"]))
    out = np.empty((rows, n_pad), np.float32)
    for q0 in range(0, rows, group):
        qg = min(group, rows - q0)
        first, cnt = q_off[q0:q0 + qg], np.diff(q_off[q0:q0 + qg + 1])
        for s0 in range(0, n_pad, tile):
            tw = min(tile, n_pad - s0)
            acc = np.zeros((qg, tw), np.float32)
            for j in range(int(cnt.max(initial=0))):
                keys = {}
                for r in np.flatnonzero(cnt > j).tolist():
                    t = first[r] + j
                    key = (int(case["t_start"][t]), int(case["t_len"][t]),
                           case["t_idf"][t].view(np.uint32).item())
                    if key[1]:
                        keys.setdefault(key, (t, []))[1].append(r)
                for (start, length, _), (t, members) in keys.items():
                    run = case["post_slot"][start:start + length]
                    lo = start + _first_at_or_past(run, n_pad, s0)
                    hi = start + _first_at_or_past(run, n_pad, s0 + tw)
                    x = case["post_slot"][lo:hi] - s0
                    assert ((x >= 0) & (x < tw)).all()
                    tf = case["post_tf"][lo:hi]
                    c = (case["t_idf"][t] * (tf * f32(bm25_ops._K1P1))) / (tf + knorm[s0 + x])
                    for r in members:
                        acc[r, x] += c
            out[q0:q0 + qg, s0:s0 + tw] = np.where(case["allowed"][s0:s0 + tw], -acc, f32(0.0))
    return out


@pytest.mark.parametrize("name,n_pad,q_n,k,chunk", edge_cases.BM25_CASES)
def test_tiled_scorer_model_equals_plain_rows(name, n_pad, q_n, k, chunk):
    """The kernel's tiled algorithm, modelled in numpy, gives the plain
    version's dense rows bit for bit (int32 views: an allowed document no
    posting touched is -0.0) on every edge case, at the tiling the
    wrapper picks for a 132-SM card and at small tiles and groups."""
    case = edge_cases.bm25_case(name, n_pad, q_n)
    args = edge_cases.bm25_tensors(case, torch.device("cpu"))
    want = bm25_ops._bm25_dense_plain(**{key: v for key, v in args.items() if key != "q_off"},
                                      q_off=case["q_off"]).numpy()
    shapes = {bm25_ops.tile_shape(q_n, n_pad, 132), (32, 3)} if n_pad <= 20000 else {
        bm25_ops.tile_shape(q_n, n_pad, 132)}
    for tile, group in sorted(shapes):
        got = _tiled_model(case, tile, group)
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32),
                                      err_msg=f"tile {tile}, group {group}")


@pytest.mark.parametrize("rows,n_pad", [(1, 70_000), (1, 330_000), (256, 1 << 20), (37, 3000),
                                        (1, 100), (5000, 1000)])
def test_tile_shape_fills_the_card(rows, n_pad):
    """Tiles are powers of two in [TILE_MIN, TILE_MAX] (multiples of 32, as
    the kernel needs); a group holds at most GROUP_MAX queries; the grid
    has two blocks an SM unless the tile is already the smallest."""
    tile, group = bm25_ops.tile_shape(rows, n_pad, 132)
    assert bm25_ops.TILE_MIN <= tile <= bm25_ops.TILE_MAX and tile & (tile - 1) == 0
    assert tile % 32 == 0 and group == min(rows, bm25_ops.GROUP_MAX)
    blocks = -(-rows // group) * -(-n_pad // tile)
    assert blocks >= 2 * 132 or tile == bm25_ops.TILE_MIN
    if tile < bm25_ops.TILE_MAX:
        assert -(-rows // group) * -(-n_pad // (2 * tile)) < 2 * 132
    assert bm25_ops.tile_shape(256, 1 << 20, 132) == (1024, 8)


def test_search_batch_rows_equal_execute():
    _, port = _pair()
    queries = ["quick fox", "lazy dog", "electronics nothing", "animals"]
    ids, scores = port.search_batch(queries, k=5)
    for qi, q in enumerate(queries):
        res = port.new_search().with_query(q).with_k(5).execute()
        hit = ids[qi] != 0xFFFFFFFF
        assert ids[qi][hit].tolist() == [r.id for r in res]
        np.testing.assert_array_equal(scores[qi][hit], np.float32([r.score for r in res]))
