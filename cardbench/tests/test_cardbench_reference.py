"""The plain references against brute forces written out in plain
Python and NumPy, at tiny sizes."""

import math

import numpy as np
import pytest
import torch

from cardbench_tiny import tiny_cell  # noqa: F401  (puts the harness on the path)
from harness import spec

flat_l2 = spec.load_module("references", "flat_l2")
hybrid_rrf = spec.load_module("references", "hybrid_rrf")


def brute_knn(x, q, k, allowed=None):
    ids, d2 = [], []
    for row, qq in enumerate(q.astype(np.int64)):
        d = ((x.astype(np.int64) - qq) ** 2).sum(1)
        order = sorted(i for i in range(len(x)) if allowed is None or allowed[row][i])
        order.sort(key=lambda i: (d[i], i))
        ids.append([i + 1 for i in order[:k]])
        d2.append([float(d[i]) for i in order[:k]])
    return np.array(ids), np.array(d2)


@pytest.mark.parametrize("filtered", [False, True])
def test_knn_matches_a_brute_force_with_ties(filtered):
    rng = np.random.default_rng(3)
    x = rng.integers(0, 4, size=(300, 8)).astype(np.float32)   # many tied distances
    x[50] = x[10]
    q = rng.integers(0, 4, size=(9, 8)).astype(np.float32)
    mask = (np.arange(300)[None, :] % 3) == (np.arange(9)[:, None] % 3) if filtered else None
    allowed = (lambda q0, q1: torch.from_numpy(mask[q0:q1])) if filtered else None
    ids, d2 = flat_l2.knn(torch.from_numpy(x), torch.from_numpy(q), 17, allowed)
    want_ids, want_d2 = brute_knn(x, q, 17, mask)
    assert np.array_equal(ids, want_ids) and np.array_equal(d2, want_d2)


def test_rows_order_batch_rows_by_distance_and_fluent_lists_by_score():
    ids = np.array([[7, 3, 9]])
    d2 = np.array([[4.0, 5.0, 5.0]])
    (bi, bs), = flat_l2.rows(ids, d2, "distance")
    assert bi.tolist() == [7, 3, 9] and bs.tolist() == [2.0, np.float32(math.sqrt(5)), np.float32(math.sqrt(5))]
    (fi, _), = flat_l2.rows(ids, d2, "score")
    assert fi.tolist() == [7, 3, 9]
    # two squared distances one apart can share a float32 root: a fluent
    # list orders them by id
    a = next(float(x) for x in range(16_000_000, 16_001_000)
             if flat_l2.sqrt_f32(x) == flat_l2.sqrt_f32(x + 1))
    b = a + 1.0
    (fi, _), = flat_l2.rows(np.array([[9, 4]]), np.array([[a, b]]), "score")
    assert fi.tolist() == [4, 9]


def test_tf32_round_keeps_ten_mantissa_bits_to_nearest_even():
    one = 1.0
    vals = torch.tensor([one, one + 2 ** -11, one + 3 * 2 ** -11, one + 2 ** -10 + 2 ** -12,
                         4097.0, 16_000_001.0], dtype=torch.float32)
    got = flat_l2.tf32_round(vals).tolist()
    assert got[:4] == [1.0, 1.0, 1.0 + 2 ** -9, 1.0 + 2 ** -10]
    assert got[4] == 4096.0 and got[5] == 1953 * 8192.0


def plain_bm25(docs, query, k1=1.2, b=0.75):
    """Every segment a token; idf = ln((N - df + .5) / (df + .5) + 1)."""
    seg = [hybrid_rrf.TOKEN.findall(d) for d in docs]
    n = len(docs)
    avgdl = sum(map(len, seg)) / n
    out = []
    for s in seg:
        total = 0.0
        for t in hybrid_rrf.TOKEN.findall(query):
            df = sum(1 for other in seg if t in other)
            if df == 0:
                continue
            tf = s.count(t)
            if tf:
                idf = math.log((n - df + 0.5) / (df + 0.5) + 1.0)
                total += idf * (tf * (k1 + 1)) / (tf + k1 * (1 - b + b * len(s) / avgdl))
        out.append(total)
    return np.array(out)


def test_text_leg_matches_bm25_written_out():
    cell = tiny_cell("hybrid-online-rrf")
    cf = dict(cell["config_spec"], n=200, vocab=40, words_per_doc=6)
    data = {}
    for name in cf["generators"]:
        spec.load_module("generators", name).make(cf, 11, "cpu", data)
    zt = spec.load_module("generators", "zipf_texts")
    vocab = zt.vocabulary(cf["vocab"])
    docs = zt.texts(data, 0, cf["n"])
    index_of = {w: i for i, w in enumerate(vocab)}
    leg = hybrid_rrf.TextLeg(data["tokens"], "exact")
    for query in (vocab[3], f"{vocab[5]} {vocab[2]}", " ".join(vocab[7:12]), f"{vocab[4]} zzzzx"):
        got, _ = leg.scores(hybrid_rrf.query_tokens(query, index_of))
        np.testing.assert_allclose(got.numpy(), plain_bm25(docs, query), rtol=1e-12, atol=0)


def test_text_top_orders_by_score_then_id_and_flags_near_ties():
    s = torch.tensor([0.0, 2.0, 3.0, 2.0, 1.0, 3.0 * (1 + 1e-7)], dtype=torch.float64)
    same = torch.tensor([0, 1, 2, 1, 3, 2])
    ok = torch.ones(6, dtype=torch.bool)
    ids, sc, decided = hybrid_rrf.text_top(s, same, ok, 3)
    assert ids.tolist() == [6, 3, 2] and decided   # 3.0 and 3.0(1 + 1e-7): one pattern
    _, _, decided = hybrid_rrf.text_top(s, torch.arange(6), ok, 3)
    assert not decided                              # the same scores from other frequencies
    ids, _, decided = hybrid_rrf.text_top(s, same, ok & (torch.arange(6) != 5), 10)
    assert ids.tolist() == [3, 2, 4, 5] and decided


def test_fusion_follows_reciprocal_rank_and_a_lone_vector_leg():
    v_ids, v_sc = np.array([5, 7, 9]), np.array([1.0, 2.0, 2.0])
    t_ids, t_sc = np.array([9, 4]), np.array([3.0, 1.0])
    ids, sc, ok = hybrid_rrf.fuse(v_ids, v_sc, t_ids, t_sc, 10)
    want = {5: 1 / 60, 7: 1 / 61, 9: 1 / 62 + 1 / 60, 4: 1 / 61}
    order = sorted(want, key=lambda i: (-want[i], i))
    assert ok and ids.tolist() == order and sc.tolist() == [want[i] for i in order]
    ids, sc, ok = hybrid_rrf.fuse(v_ids, v_sc, np.zeros(0, np.int64), np.zeros(0), 2)
    assert ok and ids.tolist() == [5, 7] and sc.tolist() == [1.0, 2.0]
