"""comet_tpu_torch.ops.kmeans against comet_tpu.ops.kmeans on the CPU.

Inputs come from a seeded numpy generator and go to both packages. Bar:
on integer-valued data the centroids and assignments are array-equal (the
update sums small integers exactly in float32, and a division rounds the
same everywhere), and so is the spatial order key of ops/ivf_sparse.
"""

import numpy as np
import pytest
import torch

from comet_tpu.ops import ivf_sparse as ref_sp
from comet_tpu.ops import kmeans as ref
from comet_tpu.types import DistanceKind as RefKind
from comet_tpu_torch.ops import ivf_sparse as sp
from comet_tpu_torch.ops import adc, kmeans
from comet_tpu_torch.types import DistanceKind


def _ints(rng, n, d, hi=16):
    return rng.integers(0, hi, size=(n, d)).astype(np.float32)


def _port_kmeans(x, k, kind="l2_squared", max_iter=20):
    c, a = kmeans.kmeans(torch.from_numpy(x), k, DistanceKind(kind), max_iter)
    return c.numpy(), a.numpy()


@pytest.mark.parametrize("n,d,k,kind", [
    (500, 4, 7, "l2_squared"), (1200, 8, 32, "l2"), (300, 3, 5, "l2_squared"),
])
def test_kmeans_matches_reference_on_integers(n, d, k, kind):
    x = _ints(np.random.default_rng(n + k), n, d)
    rc, ra = ref.kmeans(x, k, RefKind(kind), 20)
    pc, pa = _port_kmeans(x, k, kind)
    np.testing.assert_array_equal(pc, rc)
    np.testing.assert_array_equal(pa, ra)


def test_kmeans_max_iter_and_tiled_assignment(monkeypatch):
    """The row tiles of the assignment change nothing: 3 iterations over
    tiles of 64 rows give the reference's centroids."""
    x = _ints(np.random.default_rng(1), 1000, 6)
    monkeypatch.setattr(kmeans, "ASSIGN_TILE", 64)
    rc, ra = ref.kmeans(x, 16, RefKind.L2_SQUARED, 3)
    pc, pa = _port_kmeans(x, 16, max_iter=3)
    np.testing.assert_array_equal(pc, rc)
    np.testing.assert_array_equal(pa, ra)


def test_empty_cluster_keeps_its_centroid():
    """Identical points: every point goes to centroid 0 (lowest index wins
    ties) and the empty cluster 1 keeps its init position."""
    v = np.ones((8, 3), dtype=np.float32)
    rc, ra = ref.kmeans(v, 2, max_iter=10)
    pc, pa = _port_kmeans(v, 2, max_iter=10)
    np.testing.assert_array_equal(pc, rc)
    np.testing.assert_array_equal(pa, ra)
    assert set(pa.tolist()) == {0}


@pytest.mark.parametrize("max_iter", [1, 20])
def test_empty_cluster_mid_training(max_iter):
    """Two duplicated init rows: cluster 1 empties at the first assignment
    (ties go to cluster 0) and keeps its centroid while the others move;
    later iterations fill it again."""
    x = np.array([[0, 0], [0, 0], [0, 0], [9, 9], [10, 9], [0, 1]], np.float32)
    rc, ra = ref.kmeans(x, 3, max_iter=max_iter)
    pc, pa = _port_kmeans(x, 3, max_iter=max_iter)
    np.testing.assert_array_equal(pc, rc)
    np.testing.assert_array_equal(pa, ra)
    if max_iter == 1:
        assert 1 not in pa.tolist()
        np.testing.assert_array_equal(pc[1], [0.0, 0.0])
        assert pc[0].tolist() != [0.0, 0.0]


def test_k_greater_than_n_and_empty_input():
    v = np.array([[0.0, 0.0], [5.0, 5.0]], dtype=np.float32)
    pc, pa = _port_kmeans(v, 10)
    rc, ra = ref.kmeans(v, 10)
    assert pc.shape == (2, 2)
    np.testing.assert_array_equal(pc, rc)
    np.testing.assert_array_equal(pa, ra)
    pc, pa = _port_kmeans(np.zeros((0, 3), np.float32), 4)
    assert pc.shape == (0, 3) and pa.shape == (0,)


def test_stride_init():
    v = np.arange(20, dtype=np.float32).reshape(10, 2)
    got = kmeans.init_centroids(torch.from_numpy(v), 3).numpy()
    np.testing.assert_array_equal(got, v[[0, 3, 6]])
    np.testing.assert_array_equal(got, ref.init_centroids(v, 3))


@pytest.mark.parametrize("kind", ["l2", "l2_squared"])
def test_find_nearest_centroid_matches_reference(kind, monkeypatch):
    rng = np.random.default_rng(9)
    x = _ints(rng, 700, 8)
    c = _ints(rng, 24, 8)
    c[5] = c[3]                       # an exact tie: the lower index wins
    monkeypatch.setattr(kmeans, "ASSIGN_TILE", 128)
    got = kmeans.find_nearest_centroid(torch.from_numpy(x), torch.from_numpy(c), DistanceKind(kind))
    want = ref.find_nearest_centroid(x, c, RefKind(kind))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    assert not (got.numpy() == 5).any()


def test_recovers_well_separated_clusters():
    """Port of tests/test_kmeans.py::test_recovers_well_separated_clusters."""
    rng = np.random.default_rng(42)
    centers = np.array([[0.0] * 4, [10.0] * 4, [-10.0] * 4], dtype=np.float32)
    pts = np.concatenate([c + rng.normal(scale=0.05, size=(50, 4)).astype(np.float32)
                          for c in centers])
    c, a = _port_kmeans(pts, 3, max_iter=50)
    for j in range(3):
        assert len(set(a[j * 50:(j + 1) * 50].tolist())) == 1
    for t in centers:
        assert np.min(np.linalg.norm(c - t, axis=1)) < 0.5


@pytest.mark.parametrize("nlist", [64, 200])
def test_cluster_order_key_matches_reference(nlist):
    cents = _ints(np.random.default_rng(nlist), nlist, 8, hi=64)
    want = ref_sp.cluster_order_key(cents)
    got = sp.cluster_order_key(cents, device="cpu")
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


# -- PQ codebooks and IVFPQ training -------------------------------------------------


@pytest.mark.parametrize("n,m,dsub,k,max_iter", [
    (400, 4, 4, 16, 20), (300, 2, 3, 300, 5), (257, 8, 2, 256, 3),
])
def test_kmeans_subspace_matches_reference_on_integers(n, m, dsub, k, max_iter):
    """All M subspaces in lockstep, with the stride init, ties to the
    lowest codeword and the convergence rule: codebooks and assignments
    array-equal to the reference's (k = n clamps)."""
    x = _ints(np.random.default_rng(n * m), n, m * dsub).reshape(n, m, dsub)
    rc, ra = ref.kmeans_subspace(x, k, max_iter)
    pc, pa = kmeans.kmeans_subspace(torch.from_numpy(x), k, max_iter)
    np.testing.assert_array_equal(pc.numpy(), rc)
    np.testing.assert_array_equal(pa.numpy(), ra)


def test_kmeans_subspace_tiles_and_empty():
    x = _ints(np.random.default_rng(3), 700, 8).reshape(700, 4, 2)
    rc, _ = ref.kmeans_subspace(x, 32, 6)
    tile = adc.ENCODE_CHUNK
    try:
        adc.ENCODE_CHUNK = 64
        pc, _ = kmeans.kmeans_subspace(torch.from_numpy(x), 32, 6)
    finally:
        adc.ENCODE_CHUNK = tile
    np.testing.assert_array_equal(pc.numpy(), rc)
    pc, pa = kmeans.kmeans_subspace(torch.zeros((0, 4, 2)), 8)
    assert tuple(pc.shape) == (4, 0, 2) and tuple(pa.shape) == (0, 4)


@pytest.mark.parametrize("kind", ["l2", "l2_squared"])
def test_kmeans_ivfpq_train_matches_reference_on_integers(kind):
    """Coarse k-means, residuals to the assigned centroids and the
    lockstep subspace loop: centroids and codebooks array-equal."""
    x = _ints(np.random.default_rng(7), 600, 8, hi=32)
    rc, rb = ref.kmeans_ivfpq_train(x, 6, RefKind(kind), 4, 16, 20)
    pc, pb = kmeans.kmeans_ivfpq_train(torch.from_numpy(x), 6, DistanceKind(kind), 4, 16, 20)
    np.testing.assert_array_equal(pc.numpy(), rc)
    np.testing.assert_array_equal(pb.numpy(), rb)
    assert pb.shape == (4, 16, 2)
