"""comet_tpu_torch.ops.graph_build (bulk HNSW construction) against
comet_tpu.ops.graph_build on the CPU.

Inputs come from a seeded numpy generator and go to both packages. The
vectors are SIFT-range integers (0..255), so every float32 and bf16
distance of the build is exact and both packages order every candidate
alike. Bar: the layer-0 and upper-layer adjacency, the levels and the
entry point array-equal. The reference builds on the CPU with its host
kNN for every stage; the port takes every stage through its flat pipeline
(the plain versions of K2 and K1 on the CPU), so the comparison holds that
route too.
"""

from functools import lru_cache

import numpy as np
import pytest
import torch

import comet_tpu.indexes.hnsw as ref_hnsw
import comet_tpu_torch.indexes.hnsw as port_hnsw
from comet_tpu.ops import graph_build as ref_gb
from comet_tpu.types import DistanceKind as RefKind
from comet_tpu_torch import DistanceKind, HNSWConfig, HNSWIndex
from comet_tpu_torch.ops import graph_build as gb

N, D, M = 3000, 16, 8


def _sift(n, d, seed):
    return np.random.default_rng(seed).integers(0, 256, size=(n, d)).astype(np.float32)


@lru_cache(maxsize=None)
def _ref_index(kind="l2"):
    x = _sift(N, D, 1)
    old = ref_hnsw.BULK_BUILD_MIN
    ref_hnsw.BULK_BUILD_MIN = 512
    try:
        idx = ref_hnsw.HNSWIndex(D, RefKind(kind), ref_hnsw.HNSWConfig(m=M, ef_construction=64))
        idx.add_batch(x, ids=np.arange(1, N + 1))
    finally:
        ref_hnsw.BULK_BUILD_MIN = old
    return idx


@lru_cache(maxsize=None)
def _port_index(kind="l2"):
    x = _sift(N, D, 1)
    old = port_hnsw.BULK_BUILD_MIN
    port_hnsw.BULK_BUILD_MIN = 512
    try:
        idx = HNSWIndex(D, DistanceKind(kind), HNSWConfig(m=M, ef_construction=64), device="cpu")
        idx.add_batch(x, ids=np.arange(1, N + 1))
    finally:
        port_hnsw.BULK_BUILD_MIN = old
    return idx


def test_bulk_build_levels_and_entry_match_reference():
    ref, port = _ref_index(), _port_index()
    np.testing.assert_array_equal(port._levels[:N], ref._levels[:N])
    assert port._entry_slot == ref._entry_slot
    assert port._max_level == ref._max_level >= 2


def test_bulk_build_layer0_matches_reference():
    ref, port = _ref_index(), _port_index()
    np.testing.assert_array_equal(port._adj0[:N], ref._adj0[:N])
    fill = (port._adj0[:N] >= 0).sum(axis=1)
    assert fill.min() >= 1 and fill.max() == 2 * M


@pytest.mark.parametrize("level", [1, 2])
def test_bulk_build_upper_layers_match_reference(level):
    ref, port = _ref_index(), _port_index()
    assert sorted(port._upper) == sorted(ref._upper)
    np.testing.assert_array_equal(port._upper[level][:N], ref._upper[level][:N])
    members = np.flatnonzero(port._levels[:N] >= level)
    assert (port._upper[level][members] >= 0).any()
    others = np.setdiff1d(np.arange(N), members)
    assert (port._upper[level][others] == -1).all()


def test_bulk_build_takes_the_pipeline_route(monkeypatch):
    """Every layer-0 stage runs through the flat pipeline, the stage ladder
    64, 64, 128, ... in order."""
    calls = []
    real = gb.flat_topk_pipeline

    def spy(q, *args, **kw):
        calls.append(q.shape[0])
        return real(q, *args, **kw)

    monkeypatch.setattr(gb, "flat_topk_pipeline", spy)
    x = _sift(N, D, 1)
    vecs = torch.from_numpy(np.concatenate([x, np.zeros((4096 - N, D), np.float32)]))
    b = gb.BulkGraphBuilder(N, DistanceKind.L2, vecs, (vecs * vecs).sum(1))
    adj = b.build_layer(None, M, 2 * M)
    assert calls == [64, 64, 128, 256, 512, 1024, N - 2048]
    np.testing.assert_array_equal(adj, _port_index()._adj0[:N])


@pytest.mark.parametrize("cosine", [False, True])
@pytest.mark.parametrize("width", [8, 16])
def test_finalize_matches_reference(cosine, width):
    """Self-strip, duplicate slots at two distances, padding, the heuristic
    and the backfill: slots and distances equal to the reference's finalize
    on integer data (cosine on +-1 vectors of norm 4, exact too)."""
    rng = np.random.default_rng(5 + width + cosine)
    n, c, b = 512, 24, 40
    if cosine:
        x = rng.choice(np.array([-0.25, 0.25], np.float32), size=(n, D))
    else:
        x = _sift(n, D, 6)
    cand_s = np.stack([rng.choice(n, c, replace=False) for _ in range(b)]).astype(np.int32)
    cand_s[:, 5] = cand_s[:, 2]                        # a duplicate slot
    cand_s[3:, -3:] = gb.SENT                          # padding
    own = rng.integers(0, n, size=b).astype(np.int32)
    cand_s[::4, 7] = own[::4]                          # self
    v = x[np.where(cand_s == gb.SENT, 0, cand_s)]
    q = x[own]
    if cosine:
        cand_d = 1.0 - np.clip(np.einsum("bd,bcd->bc", q, v), -1, 1)
    else:
        cand_d = ((q[:, None, :] - v) ** 2).sum(-1)
    cand_d[:, 5] += 1.0                                # the copy is farther
    cand_d = np.where(cand_s == gb.SENT, np.inf, cand_d).astype(np.float32)
    import jax.numpy as jnp

    fin = ref_gb._make_finalize(cosine)
    rs, rd = fin(jnp.asarray(x), jnp.asarray(cand_s), jnp.asarray(cand_d), jnp.asarray(own),
                 width // 2, width)
    ps, pd = gb._finalize_math(torch.from_numpy(x), torch.from_numpy(cand_s),
                               torch.from_numpy(cand_d), torch.from_numpy(own), width // 2,
                               width, cosine)
    np.testing.assert_array_equal(ps.numpy(), np.asarray(rs))
    np.testing.assert_array_equal(pd.numpy(), np.asarray(rd))
    assert (ps.numpy() != own[:, None]).all()


def test_cosine_bulk_build_matches_reference():
    """Cosine: the index normalises the rows, so distances are not exact;
    the graph still agrees on all but a sliver of rows, and is complete."""
    ref, port = _ref_index("cosine"), _port_index("cosine")
    same = (port._adj0[:N] == ref._adj0[:N]).all(axis=1)
    assert same.mean() >= 0.99
    assert ((port._adj0[:N] >= 0).sum(axis=1) >= 1).all()
