"""k-limiting and the autocut algorithm.

Behavioral port of limiter.go: `sanitize_k` (limiter.go:12-17), generic
result limiting (limiter.go:28), and `autocut` — cut before the Nth local
maximum of (normalized score curve minus the ideal linear ramp)
(limiter.go:81-118). Runs on host; inputs are tiny (<= k scores).
"""

from __future__ import annotations

from typing import Sequence, TypeVar

import numpy as np

T = TypeVar("T")


def sanitize_k(k: int, max_results: int) -> int:
    """Clamp k into [1, max_results]; k <= 0 or k > max means 'all'."""
    if k <= 0 or k > max_results:
        return max_results
    return k


def limit_results(results: list[T], k: int) -> list[T]:
    """Truncate results to k (limiter.go:28)."""
    return results[: sanitize_k(k, len(results))]


def autocut(y_values: Sequence[float], cut_off: int) -> int:
    """Index at which to cut a score curve (limiter.go:81-118).

    Normalizes scores to [0, 1], subtracts the ideal linear ramp, and returns
    the index of the `cut_off`-th local maximum of the difference curve
    (i.e. results before the first big score "jump" are kept).
    """
    y = np.asarray(y_values, dtype=np.float32)
    n = len(y)
    if n <= 1:
        return n

    denom = y[-1] - y[0]
    if denom == 0.0:
        # All scores equal: difference curve is -ramp, has no local maximum.
        return n
    step = 1.0 / (n - 1)
    x = np.arange(n, dtype=np.float32) * np.float32(step)
    diff = (y - y[0]) / denom - x

    extrema = 0
    for i in range(1, n):
        if i == n - 1:
            # Last element: compare against the two previous points
            # (limiter.go:103-110 quirk, kept for parity).
            if i >= 2 and diff[i] > diff[i - 1] and diff[i] > diff[i - 2]:
                extrema += 1
                if extrema >= cut_off:
                    return i
        else:
            if diff[i] > diff[i - 1] and diff[i] > diff[i + 1]:
                extrema += 1
                if extrema >= cut_off:
                    return i
    return n


def autocut_results(results: list[T], cutoff: int, scores: Sequence[float] | None = None) -> list[T]:
    """Apply autocut to a result list; cutoff == -1 disables (limiter.go:52)."""
    if cutoff == -1 or not results:
        return results
    if scores is None:
        scores = [r.get_score() for r in results]  # type: ignore[attr-defined]
    return results[: autocut(scores, cutoff)]
