"""K-means clustering in plain PyTorch.

Counterpart of comet_tpu/ops/kmeans.py (`init_centroids`, `kmeans`,
`find_nearest_centroid`), which is XLA and no Pallas kernel, with the
reference trainer's rules (clustering.go:119-243 of the Go reference):

- deterministic init by uniform stride: centroid j = vectors[j * (n // k)];
- assignment by argmin, ties to the lowest centroid index;
- convergence checked BEFORE the update: when no assignment changed, the
  centroids stay as they are and the loop ends;
- an empty cluster keeps its centroid.

Tensors stay on the caller's device. The assignment runs in row tiles of
ASSIGN_TILE, so the [N, k] distances of a large batch never sit whole on
the device. The update sums rows per cluster with `index_add_`: on the
card its atomics add in no fixed order, so on non-integer data a centroid
may differ from run to run in its last bits; on integer data below 2^24
every sum is exact and the result is bit-equal to the reference's.
"""

from __future__ import annotations

import torch

from comet_tpu_torch.ops.distance import pairwise_scores
from comet_tpu_torch.types import DistanceKind

DEFAULT_MAX_ITER = 20  # clustering.go:14
ASSIGN_TILE = 1 << 16


def init_centroids(vectors: torch.Tensor, k: int) -> torch.Tensor:
    """Uniform-stride deterministic init (clustering.go:144-162)."""
    n = vectors.shape[0]
    idx = torch.clamp_max(torch.arange(k, device=vectors.device) * max(n // k, 1), n - 1)
    return vectors[idx].to(torch.float32)


def _nearest(vectors: torch.Tensor, centroids: torch.Tensor, kind: DistanceKind):
    """[n] int64 index of the nearest centroid, tile by tile."""
    out = torch.empty(vectors.shape[0], dtype=torch.int64, device=vectors.device)
    for r0 in range(0, vectors.shape[0], ASSIGN_TILE):
        dist = pairwise_scores(vectors[r0:r0 + ASSIGN_TILE], centroids, kind)
        out[r0:r0 + ASSIGN_TILE] = torch.argmin(dist, dim=1)  # first minimum
    return out


def kmeans(
    vectors: torch.Tensor,
    k: int,
    kind: DistanceKind = DistanceKind.L2_SQUARED,
    max_iter: int = DEFAULT_MAX_ITER,
):
    """Lloyd's k-means on `vectors` [n, d] float32 (on any device), with the
    reference's init, convergence and empty-cluster rules. k is clamped to
    n. Returns (centroids [k, d] float32, assignments [n] int64)."""
    vectors = vectors.to(torch.float32)
    n = vectors.shape[0]
    dev = vectors.device
    if n == 0 or k <= 0:
        d = vectors.shape[1] if vectors.ndim == 2 else 0
        return (torch.zeros((0, d), dtype=torch.float32, device=dev),
                torch.zeros(0, dtype=torch.int64, device=dev))
    k = min(k, n)
    if max_iter <= 0:
        max_iter = DEFAULT_MAX_ITER
    centroids = init_centroids(vectors, k)
    assign = torch.full((n,), -1, dtype=torch.int64, device=dev)
    ones = torch.ones(n, dtype=torch.float32, device=dev)
    for _ in range(int(max_iter)):
        new_assign = _nearest(vectors, centroids, kind)
        changed = bool((new_assign != assign).any())
        assign = new_assign
        if not changed:   # converged before the update (clustering.go:203-205)
            break
        sums = torch.zeros_like(centroids).index_add_(0, assign, vectors)
        counts = torch.zeros(k, dtype=torch.float32, device=dev).index_add_(0, assign, ones)
        col = counts[:, None]
        # empty clusters keep the old centroid (clustering.go:236-238)
        centroids = torch.where(col > 0, sums / torch.clamp_min(col, 1.0), centroids)
    return centroids, assign


def find_nearest_centroid(
    vectors: torch.Tensor,
    centroids: torch.Tensor,
    kind: DistanceKind = DistanceKind.L2_SQUARED,
) -> torch.Tensor:
    """Index of the nearest centroid per vector (clustering.go:259-272),
    [n] int64 on the vectors' device, ties to the lowest index."""
    vectors = torch.atleast_2d(vectors).to(torch.float32)
    return _nearest(vectors, centroids.to(vectors.device, torch.float32), kind)
