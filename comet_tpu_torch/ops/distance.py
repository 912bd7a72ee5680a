"""Distances: batched query x corpus scoring in plain PyTorch.

Counterpart of comet_tpu/ops/distance.py:

- L2^2:   ||q||^2 + ||x||^2 - 2 q.x
- L2:     sqrt(L2^2)
- cosine: 1 - clip(q.x, -1, 1) on pre-normalized rows.

The products run in full float32. A lower-precision product (TF32 on the
card) perturbs distances enough to flip neighbour order and break exact
parity with the scalar-f32 reference, so `f32_matmul` refuses to run on a
CUDA tensor while PyTorch's TF32 switch for matrix products is on.

Host-side `preprocess` mirrors Distance.Preprocess (distance.go:244-290 of
the Go reference): cosine normalizes (a zero vector is an error), L2/L2^2
are no-ops.
"""

from __future__ import annotations

import numpy as np
import torch

from comet_tpu_torch.types import DistanceKind, ZeroVectorError


def f32_matmul(a: torch.Tensor, b_t: torch.Tensor) -> torch.Tensor:
    """a @ b_t.T in full float32."""
    if a.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "torch.backends.cuda.matmul.allow_tf32 is on: exact distances "
            "need full-float32 products"
        )
    return a @ b_t.T


def sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root on any device.

    PyTorch's float32 sqrt on the CPU is one ulp off the IEEE result for
    some inputs (267.0 is the smallest integer), where the reference's is
    exact; its float64 sqrt is exact, and the float64 root of a float32
    value rounds to the correctly rounded float32 root."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to bfloat16 (nearest even), kept as float32."""
    return x.to(torch.bfloat16).to(torch.float32)


def bf16_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The bf16-domain inner product over the last axis, [..., d] x [..., d]
    broadcast to [...] float32.

    Each bf16 x bf16 product is exact in float32, and the products are
    added to a float32 sum that starts at 0 in ascending order of the
    depth: the order of the FMA chain of the CUDA kernels (`dot_fma` in
    csrc/scan_tile.cuh). So this plain version, K3's bf16 mode and the
    beam's in-loop scoring give bit-equal distances for the same (query,
    row), which the beam's duplicate kill needs (ops/beam_kernel.py)."""
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    acc = torch.zeros(torch.broadcast_shapes(a.shape[:-1], b.shape[:-1]),
                      dtype=torch.float32, device=a.device)
    for k in range(a.shape[-1]):
        acc = acc + a[..., k] * b[..., k]
    return acc


# float16 x float16 products are exact in float32 too (11 + 11 significand
# bits), so K2's float16 operand sums them the same way and is bit-equal to
# this plain version.
f16_dot = bf16_dot


def pairwise_scores(
    queries: torch.Tensor, corpus: torch.Tensor, kind: DistanceKind
) -> torch.Tensor:
    """[Q, N] float32 distances (lower = more similar, all kinds) between
    preprocessed [Q, d] queries and a preprocessed [N, d] corpus."""
    return pairwise_scores_from_norms(
        queries, corpus, (corpus * corpus).sum(dim=1), kind
    )


def pairwise_scores_from_norms(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    corpus_sqnorms: torch.Tensor,
    kind: DistanceKind,
) -> torch.Tensor:
    """Like `pairwise_scores` with precomputed corpus squared norms."""
    ip = f32_matmul(queries, corpus)
    if kind == DistanceKind.COSINE:
        return 1.0 - torch.clamp(ip, -1.0, 1.0)
    qn = (queries * queries).sum(dim=1, keepdim=True)
    l2sq = torch.clamp_min(qn + corpus_sqnorms[None, :] - 2.0 * ip, 0.0)
    if kind == DistanceKind.L2_SQUARED:
        return l2sq
    return sqrt_f32(l2sq)


def preprocess(vectors: np.ndarray, kind: DistanceKind) -> np.ndarray:
    """Preprocess vectors for a metric (reference: distance.go:244-290).

    cosine: returns unit-normalized copies; raises ZeroVectorError on any
    zero row. L2/L2^2: returns the input unchanged.

    Accepts [d] or [B, d]; returns float32 with the same shape.
    """
    v = np.asarray(vectors, dtype=np.float32)
    if kind != DistanceKind.COSINE:
        return v
    squeeze = v.ndim == 1
    v2 = v[None, :] if squeeze else v
    norms = np.linalg.norm(v2, axis=1)
    if np.any(norms == 0.0):
        raise ZeroVectorError("zero vector not allowed for this metric")
    out = v2 / norms[:, None]
    return out[0] if squeeze else out
