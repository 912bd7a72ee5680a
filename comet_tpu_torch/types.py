"""Core enums and errors shared across the engine.

Mirrors the behavioral contracts of the reference's distance.go:19-38,
index.go:7-29 and aggregation/fusion kind enums, re-expressed as Python enums.
"""

from __future__ import annotations

import enum


class DistanceKind(str, enum.Enum):
    """Distance metric selector (reference: distance.go:19-38).

    - L2: Euclidean, sqrt(sum((a-b)^2)). Magnitude matters.
    - L2_SQUARED: squared Euclidean; preserves ordering, skips the sqrt.
    - COSINE: 1 - dot(a, b) on unit-normalized vectors; vectors are normalized
      at insert ("preprocess"), so search-time distance is a pure dot product
      that maps straight onto a matrix product.
    """

    L2 = "l2"
    L2_SQUARED = "l2_squared"
    COSINE = "cosine"


class VectorIndexKind(str, enum.Enum):
    """Vector index families (reference: index.go:7-29)."""

    FLAT = "flat"
    HNSW = "hnsw"
    IVF = "ivf"
    PQ = "pq"
    IVFPQ = "ivfpq"


class ScoreAggregationKind(str, enum.Enum):
    """Multi-query score aggregation (reference: aggregation.go)."""

    SUM = "sum"
    MAX = "max"
    MEAN = "mean"


class CometError(Exception):
    """Base error for comet_tpu_torch."""


class ZeroVectorError(CometError):
    """Zero vector not allowed for this metric (reference: distance.go:12)."""


class DimensionMismatchError(CometError):
    """Vector dimensionality does not match the index."""


class NotTrainedError(CometError):
    """Index requires training before this operation."""


class NodeNotFoundError(CometError):
    """Requested node ID does not exist (or is soft-deleted)."""


class InvalidConfigError(CometError):
    """Invalid constructor or search configuration."""
