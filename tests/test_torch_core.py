"""comet_tpu_torch's node and aggregation helpers against comet_tpu's.

`new_vector_node`, `new_vector_node_with_id`, `aggregate_vector_results`
and `aggregate_text_results`, on the same inputs in both packages: the
cases of tests/test_aggregation.py, seeded multi-query result lists for
every aggregation kind, and the auto-id flow of tests/test_flat.py:211
through each package's FlatIndex. Results must be equal: ids, order and
float32 scores.
"""

import numpy as np
import pytest

import comet_tpu
import comet_tpu_torch

KINDS = ["sum", "max", "mean"]

# (vector (id, score) pairs, text (id, score) pairs) of tests/test_aggregation.py
CASES = [
    ([(42, 0.1), (7, 0.5), (42, 0.2), (42, 0.15)], [(1, 2.0), (2, 5.0), (1, 1.0)]),
    ([(1, 0.1), (1, 0.3), (2, 0.2)], [(3, 0.5), (3, 0.25)]),
    ([(1, 0.1), (1, 0.3), (1, 0.2)], [(4, 1.0)]),
    ([(9, 0.5), (3, 0.5), (5, 0.5)], [(9, 0.5), (3, 0.5), (5, 0.5)]),
    ([], []),
]


def _vector_results(pkg, pairs):
    return [pkg.VectorResult(node=pkg.VectorNode(i, np.zeros(2, dtype=np.float32)), score=s)
            for i, s in pairs]


def _text_results(pkg, pairs):
    return [pkg.TextResult(i, s) for i, s in pairs]


def _both(vec_pairs, text_pairs, kind):
    """Each package's aggregated vector and text results as (id, score)
    lists, with the nodes' vectors of the vector results."""
    out = []
    for pkg in (comet_tpu, comet_tpu_torch):
        k = pkg.ScoreAggregationKind(kind)
        vec = pkg.aggregate_vector_results(_vector_results(pkg, vec_pairs), k)
        text = pkg.aggregate_text_results(_text_results(pkg, text_pairs), k)
        out.append(([(r.node.id, np.float32(r.score)) for r in vec],
                    [r.node.vector.tolist() for r in vec],
                    [(r.id, np.float32(r.score)) for r in text]))
    return out


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("case", range(len(CASES)))
def test_aggregation_cases_match_reference(case, kind):
    want, got = _both(*CASES[case], kind)
    assert got == want


@pytest.mark.parametrize("kind", KINDS)
def test_seeded_multi_query_results_match_reference(kind):
    """Eight queries' top-20 over 50 ids, some scores tied: every id
    once, combined as the reference combines it, in its order."""
    rng = np.random.default_rng(11)
    ids = rng.integers(0, 50, size=(8, 20))
    scores = rng.integers(0, 40, size=(8, 20)) / np.float32(8.0)
    pairs = [(int(i), float(s)) for i, s in zip(ids.ravel(), scores.ravel())]
    want, got = _both(pairs, pairs, kind)
    assert got == want
    assert len(got[0]) == len(np.unique(ids))


def test_aggregation_passes_the_first_node_through():
    pkg_results = []
    for pkg in (comet_tpu, comet_tpu_torch):
        nodes = [pkg.VectorNode(5, np.array([1.0, 2.0], np.float32)),
                 pkg.VectorNode(5, np.array([3.0, 4.0], np.float32))]
        res = pkg.aggregate_vector_results(
            [pkg.VectorResult(node=n, score=0.5) for n in nodes], pkg.ScoreAggregationKind.MAX)
        pkg_results.append([(r.node.id, r.node.vector.tolist(), r.score) for r in res])
    assert pkg_results[1] == pkg_results[0]


def test_new_vector_node_matches_reference():
    for pkg in (comet_tpu, comet_tpu_torch):
        a = pkg.new_vector_node([1, 2, 3])
        b = pkg.new_vector_node(np.array([0.5, 0.25], dtype=np.float64))
        assert b.id == a.id + 1
        assert a.vector.dtype == np.float32 and a.vector.tolist() == [1.0, 2.0, 3.0]
        assert b.vector.dtype == np.float32 and b.vector.tolist() == [0.5, 0.25]
        c = pkg.new_vector_node_with_id(np.uint32(77), [4.0])
        assert c.id == 77 and type(c.id) is int and c.vector.dtype == np.float32
        assert isinstance(a, pkg.VectorNode)


def test_auto_id_nodes_search_like_reference():
    """tests/test_flat.py:211 in both packages: two auto-id nodes added one
    at a time; the nearest to the first query is the first node."""
    got = []
    for pkg, kw in ((comet_tpu, {}), (comet_tpu_torch, {"device": "cpu"})):
        idx = pkg.FlatIndex(2, **kw)
        n1 = pkg.new_vector_node(np.array([1.0, 0.0], dtype=np.float32))
        n2 = pkg.new_vector_node(np.array([0.0, 1.0], dtype=np.float32))
        idx.add(n1)
        idx.add(n2)
        assert n2.id == n1.id + 1
        res = idx.new_search().with_query([1.0, 0.0]).with_k(2).execute()
        assert res[0].node.id == n1.id and res[1].node.id == n2.id
        got.append([(r.node.id - n1.id, np.float32(r.score)) for r in res])
    assert got[1] == got[0]
