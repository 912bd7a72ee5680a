"""Score fusion for hybrid search.

Counterpart of comet_tpu/fusion.py, the behavioral port of the Go
reference's fusion.go:

- WeightedSum (default, weights 1.0/1.0): score = v*wv + t*wt (fusion.go:123-149)
- ReciprocalRank (RRF): ranks vector scores ascending (distances) and text
  scores descending (relevance), 0-indexed, score = sum 1/(k + rank), k=60
  (fusion.go:166-243). The reference's O(n^2) bubble sort is replaced with a
  vectorized argsort; ties break by ascending doc ID (the reference's tie
  order is nondeterministic Go map order).
- Max: best score across modalities (fusion.go:252-276)
- Min: intersection-only worst score (fusion.go:285-306)

Fused scores are float64 on purpose, like the reference
(hybrid_search_index.go:309-314).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from comet_tpu_torch.types import FusionKind, InvalidConfigError


@dataclass
class FusionConfig:
    """Fusion knobs (fusion.go:49-68)."""

    vector_weight: float = 1.0
    text_weight: float = 1.0
    k: float = 60.0


def default_fusion_config() -> FusionConfig:
    return FusionConfig()


def _ranks(scores: dict[int, float], ascending: bool) -> dict[int, int]:
    """Score map -> 0-indexed ranks (fusion.go:206-243), ties by doc ID."""
    if not scores:
        return {}
    ids = np.fromiter(scores.keys(), dtype=np.int64)
    vals = np.fromiter(scores.values(), dtype=np.float64)
    key = vals if ascending else -vals
    order = np.lexsort((ids, key))
    return {int(ids[j]): i for i, j in enumerate(order)}


class Fusion:
    """Combine per-modality score maps into one (fusion.go:32-46)."""

    def __init__(self, kind: FusionKind, config: FusionConfig | None = None):
        self._kind = FusionKind(kind)
        self._config = config or FusionConfig()

    def kind(self) -> FusionKind:
        return self._kind

    def combine(
        self,
        vector_results: dict[int, float],
        text_results: dict[int, float],
    ) -> dict[int, float]:
        kind = self._kind
        cfg = self._config
        combined: dict[int, float] = {}

        if kind == FusionKind.WEIGHTED_SUM:
            for doc_id, score in vector_results.items():
                combined[doc_id] = score * cfg.vector_weight
            for doc_id, score in text_results.items():
                combined[doc_id] = combined.get(doc_id, 0.0) + score * cfg.text_weight
            return combined

        if kind == FusionKind.RECIPROCAL_RANK:
            for doc_id, rank in _ranks(vector_results, ascending=True).items():
                combined[doc_id] = 1.0 / (cfg.k + rank)
            for doc_id, rank in _ranks(text_results, ascending=False).items():
                combined[doc_id] = combined.get(doc_id, 0.0) + 1.0 / (cfg.k + rank)
            return combined

        if kind == FusionKind.MAX:
            combined.update(vector_results)
            for doc_id, score in text_results.items():
                if doc_id not in combined or score > combined[doc_id]:
                    combined[doc_id] = score
            return combined

        if kind == FusionKind.MIN:
            for doc_id, v in vector_results.items():
                if doc_id in text_results:
                    combined[doc_id] = min(v, text_results[doc_id])
            return combined

        raise InvalidConfigError(f"unknown fusion kind: {kind}")


def new_fusion(kind: FusionKind, config: FusionConfig | None = None) -> Fusion:
    return Fusion(kind, config)


def default_fusion() -> Fusion:
    """Default strategy is WeightedSum with weights 1.0/1.0 (fusion.go:106-108)."""
    return Fusion(FusionKind.WEIGHTED_SUM)
