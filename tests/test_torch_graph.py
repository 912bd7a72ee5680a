"""comet_tpu_torch.ops.graph (the graph beam of insertion and of searches
without a routing table) against comet_tpu.ops.graph on the CPU.

Inputs come from a seeded numpy generator and go to both packages: a random
graph over integers in 0..1023 (L2, L2 squared; wide enough that equal
distances are rare but present) or over vectors of four +-1 entries
normalised to +-0.5 (cosine; every distance exact, many ties). Results are
array-equal, ties included: both packages keep equal distances in input
order (ops/graph.py module docstring).
"""

from functools import lru_cache

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comet_tpu.ops import graph as ref
from comet_tpu.types import DistanceKind as RefKind
from comet_tpu_torch.ops import graph
from comet_tpu_torch.types import DistanceKind

N, CAP, W, D, Q, EF, K = 700, 1024, 12, 16, 64, 32, 10
SENT = 2**31 - 1


@lru_cache(maxsize=None)
def _case(kind):
    rng = np.random.default_rng(len(kind))
    vectors = np.zeros((CAP, D), np.float32)
    if kind == "cosine":
        def signs(n):
            v = np.zeros((n, D), np.float32)
            for r in range(n):
                v[r, rng.choice(D, 4, replace=False)] = rng.choice([-0.5, 0.5], 4)
            return v
        vectors[:N] = signs(N)
        queries = signs(Q)
    else:
        vectors[:N] = rng.integers(0, 1024, size=(N, D))
        queries = rng.integers(0, 1024, size=(Q, D)).astype(np.float32)
    sqn = (vectors * vectors).sum(axis=1).astype(np.float32)
    adj = np.full((CAP, W), -1, np.int32)
    for i in range(N):
        row = rng.choice(N, size=W, replace=False)
        row = row[row != i][: W - 1]
        adj[i, : len(row)] = row
    entry = rng.integers(0, N, size=Q).astype(np.int32)
    allowed = np.zeros(CAP, bool)
    allowed[:N] = rng.random(N) < 0.6
    return vectors, sqn, adj, queries, entry, allowed


def _seeds(kind):
    """Metric-space seeds: each query's exact top 12 by the reference's
    distance, (dist, slot) order, padded to 16 rows; two queries get none."""
    vectors, sqn, _, queries, _, _ = _case(kind)
    d = np.asarray(ref._neighbor_dists(
        jnp.asarray(queries), jnp.sum(jnp.asarray(queries) ** 2, axis=1, keepdims=True),
        jnp.asarray(vectors), jnp.asarray(sqn),
        jnp.broadcast_to(jnp.arange(N, dtype=jnp.int32), (Q, N)), RefKind(kind)))
    order = np.lexsort((np.broadcast_to(np.arange(N), d.shape), d), axis=1)[:, :12]
    sd = np.full((Q, 16), np.inf, np.float32)
    ss = np.full((Q, 16), SENT, np.int32)
    sd[:, :12] = np.take_along_axis(d, order, axis=1)
    ss[:, :12] = order
    sd[[3, 40]], ss[[3, 40]] = np.inf, SENT
    return sd, ss


THR = {"l2": 900.0, "l2_squared": 8.0e5, "cosine": 0.6}
CASES = [(kind, fused, seeded) for kind in ("l2", "l2_squared", "cosine")
         for fused, seeded in ((False, False), (True, False), (True, True))]


@lru_cache(maxsize=None)
def _ref(kind, fused, seeded):
    vectors, sqn, adj, queries, entry, allowed = _case(kind)
    seeds = dict(zip(("seed_d", "seed_s"), (jnp.asarray(a) for a in _seeds(kind)))) if seeded else {}
    rd, rs = ref.beam_search_layer0(
        jnp.asarray(queries), jnp.asarray(entry), jnp.asarray(adj), jnp.asarray(vectors),
        jnp.asarray(sqn), jnp.asarray(allowed if fused else np.ones(CAP, bool)),
        jnp.asarray(np.float32(THR[kind] if fused else np.inf)), EF, K, RefKind(kind),
        (4 * EF + 32) + 16, 1, fused, stop=16 if seeded else None, **seeds)
    return np.asarray(rd), np.asarray(rs)


def _port(kind, fused, seeded):
    vectors, sqn, adj, queries, entry, allowed = _case(kind)
    t = torch.from_numpy
    seeds = dict(zip(("seed_d", "seed_s"), (t(a) for a in _seeds(kind)))) if seeded else {}
    pd, ps = graph.beam_search_layer0(
        t(queries), t(entry), t(adj), t(vectors), t(sqn),
        t(allowed if fused else np.ones(CAP, bool)),
        float(np.float32(THR[kind])) if fused else float("inf"), EF, K, DistanceKind(kind),
        (4 * EF + 32) + 16, 1, fused, stop=16 if seeded else None, **seeds)
    return pd.numpy(), ps.numpy()


@pytest.mark.parametrize("kind,fused,seeded", CASES)
def test_beam_search_layer0_matches_reference(kind, fused, seeded):
    rd, rs = _ref(kind, fused, seeded)
    pd, ps = _port(kind, fused, seeded)
    np.testing.assert_array_equal(ps, rs)
    np.testing.assert_array_equal(pd, rd)
    hits = ps != SENT
    if fused:       # the filter and the threshold cut, the rest is admitted
        _, _, _, _, _, allowed = _case(kind)
        assert hits.any() and not hits.all() and allowed[ps[hits]].all()
    else:
        assert hits.all()


@pytest.mark.parametrize("every", [1, 1000])
def test_loop_exit_matches_early_exit(every, monkeypatch):
    """Reading the flags every iteration, or never (all max_iters
    iterations run, an inactive query a fixed point), gives the reference's
    early-exit results."""
    monkeypatch.setattr(graph, "ALIVE_EVERY", every)
    calls = []
    real = graph._neighbor_dists
    monkeypatch.setattr(graph, "_neighbor_dists", lambda *a: calls.append(1) or real(*a))
    rd, rs = _ref("l2", True, False)
    pd, ps = _port("l2", True, False)
    np.testing.assert_array_equal(ps, rs)
    np.testing.assert_array_equal(pd, rd)
    # one entry-distance call, then one a loop iteration
    assert (len(calls) == 1 + (4 * EF + 32) + 16) == (every == 1000)


def test_scatter_graph_update_matches_reference():
    rng = np.random.default_rng(5)
    vectors = rng.integers(-50, 50, size=(64, D)).astype(np.float32)
    sqn = (vectors * vectors).sum(axis=1).astype(np.float32)
    adj = rng.integers(-1, 64, size=(64, W)).astype(np.int32)
    vrows, arows = np.array([3, 9, 40]), np.array([1, 9, 63, 0])
    vvals = rng.integers(-50, 50, size=(3, D)).astype(np.float32)
    avals = rng.integers(-1, 64, size=(4, W)).astype(np.int32)
    want = ref.scatter_graph_update(*(jnp.asarray(a) for a in (vectors, sqn, adj, vrows, vvals,
                                                                arows, avals)))
    t = torch.from_numpy
    got = graph.scatter_graph_update(t(vectors.copy()), t(sqn.copy()), t(adj.copy()), t(vrows),
                                     t(vvals), t(arows), t(avals))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
