"""K-means clustering in plain PyTorch.

Counterpart of comet_tpu/ops/kmeans.py (`init_centroids`, `kmeans`,
`find_nearest_centroid`, the per-subspace trainer `kmeans_subspace` of PQ
codebooks and `kmeans_ivfpq_train`), which is XLA and no Pallas kernel,
with the reference trainer's rules (clustering.go:119-243 of the Go
reference), in every subspace alike:

- deterministic init by uniform stride: centroid j = vectors[j * (n // k)];
- assignment by argmin, ties to the lowest centroid index;
- convergence checked BEFORE the update: when no assignment changed, the
  centroids stay as they are and the loop ends;
- an empty cluster keeps its centroid.

Tensors stay on the caller's device. The assignment runs in row tiles of
ASSIGN_TILE, so the [N, k] distances of a large batch never sit whole on
the device: a tile's distances and their temporaries take ~16 x k x
ASSIGN_TILE bytes, 0.26 GB at k = 1000, under an IVF search's own
footprint. The update sums rows per cluster with `index_add_`: on the
card its atomics add in no fixed order, so on non-integer data a centroid
may differ from run to run in its last bits; on integer data below 2^24
every sum is exact and the result is bit-equal to the reference's.
"""

from __future__ import annotations

import torch

from comet_tpu_torch.ops.adc import pq_encode
from comet_tpu_torch.ops.distance import pairwise_scores
from comet_tpu_torch.types import DistanceKind

DEFAULT_MAX_ITER = 20  # clustering.go:14
ASSIGN_TILE = 1 << 14


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


def _subspace_step(vectors: torch.Tensor, prev_assign: torch.Tensor, codebooks: torch.Tensor):
    """One Lloyd step of all M subspaces at once (kmeans.py:165-209):
    returns (assign [n, M], per-codeword sums [M, k, dsub], counts [M, k],
    whether any assignment changed)."""
    n, m, dsub = vectors.shape
    k = codebooks.shape[1]
    assign = pq_encode(vectors, codebooks)   # ties to the lowest codeword
    # fold the subspace into the segment id: one index_add for all of them
    seg = (assign + torch.arange(m, device=vectors.device)[None, :] * k).reshape(-1)
    sums = torch.zeros((m * k, dsub), dtype=torch.float32, device=vectors.device)
    sums.index_add_(0, seg, vectors.reshape(-1, dsub))
    counts = torch.zeros(m * k, dtype=torch.float32, device=vectors.device)
    counts.index_add_(0, seg, torch.ones(n * m, dtype=torch.float32, device=vectors.device))
    changed = bool((assign != prev_assign).any())
    return assign, sums.view(m, k, dsub), counts.view(m, k), changed


def _subspace_loop(vectors: torch.Tensor, codebooks: torch.Tensor, max_iter: int):
    """Lloyd iterations of all M subspaces in lockstep (kmeans.py:299-325),
    with `kmeans`'s rules: convergence checked before the update, empty
    codewords kept. Returns (codebooks [M, k, dsub], assign [n, M])."""
    assign = torch.full(vectors.shape[:2], -1, dtype=torch.int64, device=vectors.device)
    for _ in range(int(max_iter)):
        assign, sums, counts, changed = _subspace_step(vectors, assign, codebooks)
        if not changed:
            break
        col = counts[:, :, None]
        codebooks = torch.where(col > 0, sums / torch.clamp_min(col, 1.0), codebooks)
    return codebooks, assign


def kmeans_subspace(vectors: torch.Tensor, k: int, max_iter: int = DEFAULT_MAX_ITER):
    """Per-subspace k-means of PQ codebooks (clustering.go:112-115: L2^2),
    all M subspaces of `vectors` [n, M, dsub] in lockstep, each with the
    stride init of `init_centroids`. k is clamped to n. Returns (codebooks
    [M, k, dsub] float32, assignments [n, M] int64)."""
    vectors = vectors.to(torch.float32)
    n, m, dsub = vectors.shape
    dev = vectors.device
    if n == 0 or k <= 0:
        return (torch.zeros((m, 0, dsub), dtype=torch.float32, device=dev),
                torch.zeros((n, m), dtype=torch.int64, device=dev))
    k = min(k, n)
    if max_iter <= 0:
        max_iter = DEFAULT_MAX_ITER
    init = init_centroids(vectors, k).transpose(0, 1).contiguous()   # [M, k, dsub]
    return _subspace_loop(vectors, init, max_iter)


def _residual_init(vectors: torch.Tensor, centroids: torch.Tensor, assign: torch.Tensor,
                   m: int, k: int):
    """Residuals of `vectors` [n, d] to their assigned centroids, as
    [n, m, d / m], and the stride init of k codewords in every subspace
    (kmeans.py:252-264)."""
    resid = (vectors - centroids[assign]).view(vectors.shape[0], m, -1)
    return resid, init_centroids(resid, k).transpose(0, 1).contiguous()


def kmeans_ivfpq_train(
    prepped: torch.Tensor,
    nlist: int,
    kind: DistanceKind,
    m: int,
    ksub: int,
    max_iter: int = DEFAULT_MAX_ITER,
):
    """IVFPQ training (kmeans.py:266-297; ivfpq_index.go:164-259 of the Go
    reference): coarse k-means of `prepped` [n, d] with `kind`, then
    per-subspace codebooks of the residuals to the assigned centroids.
    Returns (centroids [min(nlist, n), d], codebooks [m, min(ksub, n),
    d / m]), float32 on the input's device."""
    prepped = prepped.to(torch.float32)
    n = prepped.shape[0]
    if max_iter <= 0:
        max_iter = DEFAULT_MAX_ITER
    centroids, assign = kmeans(prepped, nlist, kind, max_iter)
    resid, init = _residual_init(prepped, centroids, assign, m, min(ksub, n))
    codebooks, _ = _subspace_loop(resid, init, max_iter)
    return centroids, codebooks
