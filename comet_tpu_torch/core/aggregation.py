"""Multi-query score aggregation (dedup by node ID).

Counterpart of comet_tpu/core/aggregation.py: when a search runs several
queries, hits for the same node ID are combined with Sum (default), Max or
Mean, then sorted ascending for distances. Ties break by ascending node ID.
"""

from __future__ import annotations

import numpy as np

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
