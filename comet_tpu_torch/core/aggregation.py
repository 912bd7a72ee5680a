"""Multi-query score aggregation (dedup by node ID).

Counterpart of comet_tpu/core/aggregation.py: when a search runs several
queries, hits for the same node ID are combined with Sum (default), Max or
Mean, then sorted ascending for vector results (distances) and descending
for text results (relevance). Ties break by ascending node ID.
"""

from __future__ import annotations

import numpy as np

from comet_tpu_torch.core.results import TextResult, VectorResult
from comet_tpu_torch.types import ScoreAggregationKind


def aggregate_scores(
    ids: np.ndarray,
    scores: np.ndarray,
    kind: ScoreAggregationKind,
    ascending: bool,
) -> tuple[np.ndarray, np.ndarray]:
    """Deduplicate (ids, scores) by id and combine scores.

    Returns (unique_ids, combined_scores) sorted by score (direction per
    `ascending`), ties by ascending id.
    """
    ids = np.asarray(ids, dtype=np.uint32)
    scores = np.asarray(scores, dtype=np.float32)
    if ids.size == 0:
        return ids, scores

    uniq, inv = np.unique(ids, return_inverse=True)
    if kind == ScoreAggregationKind.SUM:
        agg = np.zeros(len(uniq), dtype=np.float32)
        np.add.at(agg, inv, scores)
    elif kind == ScoreAggregationKind.MAX:
        agg = np.full(len(uniq), -np.inf, dtype=np.float32)
        np.maximum.at(agg, inv, scores)
    elif kind == ScoreAggregationKind.MEAN:
        total = np.zeros(len(uniq), dtype=np.float64)
        count = np.zeros(len(uniq), dtype=np.int64)
        np.add.at(total, inv, scores.astype(np.float64))
        np.add.at(count, inv, 1)
        agg = (total / count).astype(np.float32)
    else:
        raise ValueError(f"unknown aggregation kind: {kind}")

    key = agg if ascending else -agg
    order = np.lexsort((uniq, key))
    return uniq[order], agg[order]


def aggregate_vector_results(
    results: list[VectorResult], kind: ScoreAggregationKind
) -> list[VectorResult]:
    """Object-level aggregation for vector results (ascending sort)."""
    if not results:
        return results
    ids = np.array([r.node.id for r in results], dtype=np.uint32)
    scores = np.array([r.score for r in results], dtype=np.float32)
    node_by_id = {r.node.id: r.node for r in results}
    uids, uscores = aggregate_scores(ids, scores, kind, ascending=True)
    return [
        VectorResult(node=node_by_id[int(i)], score=float(s))
        for i, s in zip(uids, uscores)
    ]


def aggregate_text_results(
    results: list[TextResult], kind: ScoreAggregationKind
) -> list[TextResult]:
    """Object-level aggregation for text results (descending sort)."""
    if not results:
        return results
    ids = np.array([r.id for r in results], dtype=np.uint32)
    scores = np.array([r.score for r in results], dtype=np.float32)
    uids, uscores = aggregate_scores(ids, scores, kind, ascending=False)
    return [TextResult(id=int(i), score=float(s)) for i, s in zip(uids, uscores)]
