"""Search results and the reranker extension hook.

Counterpart of comet_tpu/core/results.py: VectorResult scores are
distances (lower is better); TextResult scores are BM25 relevance (higher
is better); Reranker is the post-limit hook applied by every search
(index_search.go:50-60 of the Go reference).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Protocol, Sequence

from comet_tpu_torch.core.node import VectorNode


@dataclass
class VectorResult:
    """A vector search hit; score is a distance — lower is better."""

    node: VectorNode
    score: float

    def get_id(self) -> int:
        return self.node.id

    def get_score(self) -> float:
        return self.score


@dataclass
class TextResult:
    """A text search hit; score is BM25 relevance — higher is better."""

    id: int
    score: float

    def get_id(self) -> int:
        return self.id

    def get_score(self) -> float:
        return self.score


class Reranker(Protocol):
    """Post-processing hook applied after limit/autocut (index_search.go:50)."""

    def rerank(self, results: Sequence[VectorResult]) -> list[VectorResult]: ...
