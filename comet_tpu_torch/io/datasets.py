"""Standard ANN benchmark dataset loaders (SIFT1M / GloVe et al), local
files only.

Counterpart of comet_tpu/io/datasets.py, numpy only. Formats
(the texmex corpus layout):
  .fvecs — per row: int32 dim, then dim float32s
  .bvecs — per row: int32 dim, then dim uint8s
  .ivecs — per row: int32 dim, then dim int32s (ground-truth neighbor ids)

`load_sift_dir` discovers the conventional file names inside a directory
(e.g. sift_base.fvecs / sift_query.fvecs / sift_groundtruth.ivecs). Nothing
here downloads.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np


def read_fvecs(path: str | Path, limit: int | None = None) -> np.ndarray:
    """[N, d] float32 from an .fvecs file."""
    raw = np.fromfile(path, dtype=np.int32)
    if raw.size == 0:
        return np.zeros((0, 0), dtype=np.float32)
    d = int(raw[0])
    rows = raw.reshape(-1, d + 1)
    if limit is not None:
        rows = rows[:limit]
    if not (rows[:, 0] == d).all():
        raise ValueError(f"inconsistent fvecs dims in {path}")
    return rows[:, 1:].view(np.float32).copy()


def read_ivecs(path: str | Path, limit: int | None = None) -> np.ndarray:
    """[N, d] int32 from an .ivecs file (ground-truth neighbor lists)."""
    raw = np.fromfile(path, dtype=np.int32)
    if raw.size == 0:
        return np.zeros((0, 0), dtype=np.int32)
    d = int(raw[0])
    rows = raw.reshape(-1, d + 1)
    if limit is not None:
        rows = rows[:limit]
    if not (rows[:, 0] == d).all():
        raise ValueError(f"inconsistent ivecs dims in {path}")
    return rows[:, 1:].copy()


def read_bvecs(path: str | Path, limit: int | None = None) -> np.ndarray:
    """[N, d] float32 (widened from uint8) from a .bvecs file."""
    with open(path, "rb") as f:
        head = np.frombuffer(f.read(4), dtype=np.int32)
        if head.size == 0:
            return np.zeros((0, 0), dtype=np.float32)
        d = int(head[0])
    row_bytes = 4 + d
    raw = np.fromfile(path, dtype=np.uint8)
    rows = raw.reshape(-1, row_bytes)
    if limit is not None:
        rows = rows[:limit]
    return rows[:, 4:].astype(np.float32)


def _find(directory: Path, suffixes: tuple[str, ...]) -> Path | None:
    for name in sorted(os.listdir(directory)):
        low = name.lower()
        if low.endswith(suffixes[1]) and suffixes[0] in low:
            return directory / name
    return None


def load_sift_dir(
    directory: str | Path,
    max_base: int | None = None,
    max_queries: int | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray | None]:
    """Load (base, queries, ground_truth|None) from a texmex-style dir.

    Looks for *base*.fvecs/bvecs, *query*.fvecs/bvecs and
    *groundtruth*.ivecs. Raises FileNotFoundError when the base or query
    file is missing.
    """
    directory = Path(directory)
    base = _find(directory, ("base", ".fvecs")) or _find(directory, ("base", ".bvecs"))
    query = _find(directory, ("query", ".fvecs")) or _find(directory, ("query", ".bvecs"))
    gt = _find(directory, ("groundtruth", ".ivecs"))
    if base is None or query is None:
        raise FileNotFoundError(
            f"no *base*.fvecs/bvecs + *query*.fvecs/bvecs in {directory}"
        )

    def load_vec(p: Path, limit):
        return (
            read_bvecs(p, limit) if p.suffix == ".bvecs" else read_fvecs(p, limit)
        )

    base_v = load_vec(base, max_base)
    query_v = load_vec(query, max_queries)
    gt_v = read_ivecs(gt, max_queries) if gt is not None else None
    return base_v, query_v, gt_v
