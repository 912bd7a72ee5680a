"""Product quantisation: encoding, decoding and ADC (asymmetric distance).

Counterpart of comet_tpu/ops/adc.py, which is XLA and no Pallas kernel;
here plain PyTorch on the caller's device, with every select through K1
(ops/sortnet.topk_rows), whose (value, index) order is the reference's.

- `pq_encode`: per subspace, the nearest codeword by ||v||^2 + ||c||^2 -
  2 v.c, ties to the lowest codeword (the reference's strict `<` scan,
  pq_index.go:439-473).
- `ivfpq_assign_encode`: the coarse assignment of each row, then the PQ
  code of its residual, optionally in the OPQ-rotated space.
- `pq_decode`: codes back to the concatenated codewords.
- `build_lut`: per query, the [M, Ksub] table of squared subspace
  distances max(||q_m||^2 + ||c||^2 - 2 q_m.c, 0) (pq_index_search.go:243-263).
- `adc_topk`: the masked top-k of sqrt(sum_m lut[m, code_m]) (the square
  root for every metric, pq_index_search.go:292-296). The sum takes the
  subspaces in ascending order, one float32 add each, the order of the
  numpy oracle of tests/test_pq.py; the reference's one-hot matrix product
  is only a layout for the TPU's matrix unit, and a tree reduction over
  M would change the bits.

Encoding runs in row chunks of ENCODE_CHUNK; the reference's
`stream_device_map`, which dispatched every chunk before collecting any
to overlap a remote device's transfers, has no counterpart.
"""

from __future__ import annotations

import torch

from comet_tpu_torch.ops.distance import f32_matmul, pairwise_scores, sqrt_f32
from comet_tpu_torch.ops.sortnet import topk_rows
from comet_tpu_torch.ops.topk import IDX_SENTINEL, INF
from comet_tpu_torch.types import DistanceKind

ENCODE_CHUNK = 1 << 16     # rows a pq_encode step: [rows, M, Ksub] float32 distances
ADC_SUPER_TILE = 1 << 16   # codes an ADC step scores: [Q, tile] float32 sums


def _subspace_products(vectors: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """[B, M, Ksub] inner products of [B, M, dsub] rows with [M, Ksub, dsub]
    codebooks, in full float32."""
    if vectors.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("torch.backends.cuda.matmul.allow_tf32 is on: PQ needs "
                           "full-float32 products")
    return torch.bmm(vectors.transpose(0, 1), codebooks.transpose(1, 2)).transpose(0, 1)


def pq_encode(vectors: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """Codes of [B, M, dsub] float32 rows: [B, M] int64, per subspace the
    codeword of least ||v||^2 + ||c||^2 - 2 v.c, ties to the lowest."""
    cn = (codebooks * codebooks).sum(dim=2)                     # [M, Ksub]
    out = torch.empty(vectors.shape[:2], dtype=torch.int64, device=vectors.device)
    for r0 in range(0, vectors.shape[0], ENCODE_CHUNK):
        v = vectors[r0:r0 + ENCODE_CHUNK]
        vn = (v * v).sum(dim=2, keepdim=True)
        dist = vn + cn[None] - 2.0 * _subspace_products(v, codebooks)
        out[r0:r0 + ENCODE_CHUNK] = torch.argmin(dist, dim=2)   # first minimum
    return out


def ivfpq_assign_encode(chunk: torch.Tensor, centroids: torch.Tensor, codebooks: torch.Tensor,
                        kind: DistanceKind, rot: torch.Tensor | None = None):
    """IVFPQ ingest of preprocessed rows [B, d]: rotated by `rot` (OPQ,
    [d, d]) first when given, the nearest centroid by `kind` (ties to the
    lowest), then the PQ code of the residual. Returns (assign [B] int64,
    codes [B, M] int64)."""
    if rot is not None:
        chunk = f32_matmul(chunk, rot.T)
    m = codebooks.shape[0]
    assign = torch.empty(chunk.shape[0], dtype=torch.int64, device=chunk.device)
    codes = torch.empty((chunk.shape[0], m), dtype=torch.int64, device=chunk.device)
    for r0 in range(0, chunk.shape[0], ENCODE_CHUNK):
        c = chunk[r0:r0 + ENCODE_CHUNK]
        a = torch.argmin(pairwise_scores(c, centroids, kind), dim=1)
        assign[r0:r0 + ENCODE_CHUNK] = a
        codes[r0:r0 + ENCODE_CHUNK] = pq_encode((c - centroids[a]).view(c.shape[0], m, -1),
                                                codebooks)
    return assign, codes


def pq_decode(codes: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """[B, M] codes (any integer dtype) -> [B, M * dsub] float32
    reconstructions: one row gather from the flattened codebook."""
    m, ksub, dsub = codebooks.shape
    idx = codes.long() + torch.arange(m, device=codes.device)[None, :] * ksub
    return codebooks.reshape(m * ksub, dsub)[idx.reshape(-1)].view(codes.shape[0], m * dsub)


def build_lut(queries: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """[Q, M, dsub] queries -> [Q, M, Ksub] squared subspace distances."""
    ip = _subspace_products(queries, codebooks)
    qn = (queries * queries).sum(dim=2, keepdim=True)
    cn = (codebooks * codebooks).sum(dim=2)
    return torch.clamp_min(qn + cn[None] - 2.0 * ip, 0.0)


def adc_sum(lut_flat: torch.Tensor, codes: torch.Tensor, ksub: int) -> torch.Tensor:
    """sum_m lut[q, m, codes[n, m]] for [Q, M * Ksub] tables and [N, M]
    codes: [Q, N] float32, the subspaces added in ascending order."""
    acc = torch.zeros((lut_flat.shape[0], codes.shape[0]), dtype=torch.float32,
                      device=lut_flat.device)
    for mm in range(codes.shape[1]):
        acc = acc + lut_flat[:, mm * ksub + codes[:, mm].long()]
    return acc


def adc_topk(lut: torch.Tensor, codes: torch.Tensor, valid: torch.Tensor, threshold: float,
             k: int, super_tile: int = ADC_SUPER_TILE):
    """Masked exact-ADC top-k: lut [Q, M, Ksub], codes [N, M], valid [N]
    bool; rows not valid or with sqrt(sum) > threshold (on the final,
    square-rooted distance) are left out. Returns (scores [Q, k] float32,
    slots [Q, k] int32) by (score, slot) ascending; empty entries carry
    (+inf, IDX_SENTINEL)."""
    q_n, m, ksub = lut.shape
    lut_flat = lut.reshape(q_n, m * ksub)
    best_s = torch.full((q_n, k), INF, dtype=torch.float32, device=lut.device)
    best_i = torch.full((q_n, k), IDX_SENTINEL, dtype=torch.int32, device=lut.device)
    thr = torch.tensor(threshold, dtype=torch.float32, device=lut.device)
    for base in range(0, codes.shape[0], super_tile):
        dist = sqrt_f32(torch.clamp_min(adc_sum(lut_flat, codes[base:base + super_tile], ksub),
                                        0.0))
        keep = valid[base:base + super_tile][None, :] & (dist <= thr)
        dist = torch.where(keep, dist, torch.full_like(dist, INF))
        slots = torch.arange(base, base + dist.shape[1], dtype=torch.int32, device=lut.device)
        s, i = topk_rows(dist, slots.expand(q_n, -1), k)
        s, i = topk_rows(torch.cat([best_s, s[:, :k]], dim=1),
                         torch.cat([best_i, i[:, :k]], dim=1), k)
        best_s, best_i = s[:, :k], i[:, :k]
    best_i = torch.where(torch.isinf(best_s), torch.full_like(best_i, IDX_SENTINEL), best_i)
    return best_s, best_i
