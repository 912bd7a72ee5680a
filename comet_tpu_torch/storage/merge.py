"""Cross-index merging for compaction, and cross-source result merging.

Counterpart of comet_tpu/storage/merge.py. Compaction merges for real:
each index kind copies its internal representation (preprocessed vectors,
PQ codes and assignments), HNSW re-inserts its preprocessed vectors (graph
edges are index-local), metadata copies its bitset planes, and text is
re-added as the space-joined token list, exactly as the reference does.
That re-add is lossy under the default segmentation, where whitespace
runs are tokens themselves (ROADMAP Queue 3); the port follows the
reference. Result merging keeps the best score per doc ID (the Go
reference's storage_merge.go), with a direction flag because vector-only
scores are distances (lower is better).
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import numpy as np
import torch

from comet_tpu_torch.indexes.flat import FlatIndex
from comet_tpu_torch.indexes.hnsw import HNSWIndex
from comet_tpu_torch.indexes.ivf import IVFIndex
from comet_tpu_torch.indexes.ivfpq import IVFPQIndex
from comet_tpu_torch.indexes.pq import PQIndex
from comet_tpu_torch.ops.bitset import BSI, Bitset
from comet_tpu_torch.ops.kmeans import find_nearest_centroid
from comet_tpu_torch.types import CometError

if TYPE_CHECKING:
    from comet_tpu_torch.hybrid import HybridSearchIndex, HybridSearchResult


class MergeError(CometError):
    pass


def merge_hybrid(dst: "HybridSearchIndex", src: "HybridSearchIndex", skip: set[int]) -> set[int]:
    """Merge every doc of `src` not in `skip` into `dst`. Returns the merged IDs.

    Call newest source first so that `skip` gives LSM newest-wins semantics.
    """
    from comet_tpu_torch.hybrid import _DocInfo

    new_ids = [i for i in src._doc_info if i not in skip]
    if not new_ids:
        return set()

    vec_ids = [i for i in new_ids if src._doc_info[i].has_vector]
    txt_ids = [i for i in new_ids if src._doc_info[i].has_text]
    meta_ids = [i for i in new_ids if src._doc_info[i].has_metadata]

    if vec_ids:
        _merge_vector_rows(dst._vector, src._vector, vec_ids)
    if txt_ids:
        _merge_text_rows(dst._text, src._text, txt_ids)
    if meta_ids:
        _merge_metadata_rows(dst._metadata, src._metadata, meta_ids)

    for i in new_ids:
        info = src._doc_info[i]
        dst._doc_info[i] = _DocInfo(info.has_vector, info.has_text, info.has_metadata)
    return set(new_ids)


def _grown(arr: np.ndarray, capacity: int, fill) -> np.ndarray:
    """`arr` with its rows extended to `capacity`, new rows `fill`."""
    if capacity <= len(arr):
        return arr
    out = np.full((capacity,) + arr.shape[1:], fill, dtype=arr.dtype)
    out[: len(arr)] = arr
    return out


def _merge_vector_rows(dst, src, ids: list[int]) -> None:
    if dst is None or src is None:
        raise MergeError("vector index missing on one side of merge")
    if type(dst) is not type(src):
        raise MergeError(f"cannot merge {type(src).__name__} into {type(dst).__name__}")

    id_arr = np.asarray(ids, dtype=np.uint32)
    slots = np.asarray([src._store.id_to_slot[int(i)] for i in ids])

    if isinstance(dst, FlatIndex):
        # the vectors are already preprocessed: copy the rows
        dst._store.add_batch(id_arr, src._store.vectors[slots])
        return

    if isinstance(dst, IVFIndex):
        if not dst._trained:
            if not src._trained:
                raise MergeError("cannot merge untrained IVF indexes")
            dst._set_centroids(src._centroids.copy())
        vecs = src._store.vectors[slots]
        assign = find_nearest_centroid(
            torch.from_numpy(vecs).to(dst._device), dst._dev_centroids, dst._distance_kind
        ).cpu().numpy().astype(np.int32)
        new_slots = dst._store.add_batch(id_arr, vecs)
        dst._assign = _grown(dst._assign, dst._store.capacity, -1)
        dst._assign[new_slots] = assign
        dst._dense_version = dst._sparse_version = -1
        return

    if isinstance(dst, PQIndex):
        if not dst._trained:
            if not src._trained:
                raise MergeError("cannot merge untrained PQ indexes")
            dst._codebooks = src._codebooks.copy()
            dst._trained = True
        elif not np.array_equal(dst._codebooks, src._codebooks):
            raise MergeError("PQ codebooks differ; cannot merge codes exactly")
        new_slots = dst._store.add_batch(id_arr, np.zeros((len(id_arr), 0), dtype=np.float32))
        dst._codes = _grown(dst._codes, dst._store.capacity, 0)
        dst._codes[new_slots] = src._codes[slots]
        return

    if isinstance(dst, IVFPQIndex):
        if not dst._trained:
            if not src._trained:
                raise MergeError("cannot merge untrained IVFPQ indexes")
            dst._centroids = src._centroids.copy()
            dst._codebooks = src._codebooks.copy()
            dst._trained = True
        elif not (
            np.array_equal(dst._centroids, src._centroids)
            and np.array_equal(dst._codebooks, src._codebooks)
        ):
            raise MergeError("IVFPQ quantizers differ; cannot merge codes exactly")
        stored = (
            src._store.vectors[slots]
            if dst._store_originals and src._store_originals
            else np.zeros((len(id_arr), 0), dtype=np.float32)
        )
        new_slots = dst._store.add_batch(id_arr, stored)
        dst._codes = _grown(dst._codes, dst._store.capacity, 0)
        dst._assign = _grown(dst._assign, dst._store.capacity, -1)
        dst._codes[new_slots] = src._codes[slots]
        dst._assign[new_slots] = src._assign[slots]
        dst._reset_device()
        return

    if isinstance(dst, HNSWIndex):
        # graph edges are index-local: re-insert the preprocessed vectors
        dst._insert_preprocessed(id_arr, src._vectors_of_slots(slots))
        return

    raise MergeError(f"unsupported vector index type {type(dst).__name__}")


def _merge_text_rows(dst, src, ids: list[int]) -> None:
    if dst is None or src is None:
        raise MergeError("text index missing on one side of merge")
    for i in ids:
        tokens = src.doc_tokens(int(i))
        if tokens is not None:
            dst.add(int(i), " ".join(tokens))


def _merge_metadata_rows(dst, src, ids: list[int]) -> None:
    if dst is None or src is None:
        raise MergeError("metadata index missing on one side of merge")
    sel = Bitset.from_array(np.asarray(ids, dtype=np.uint64))
    dst._all_docs.ior(src._all_docs.and_(sel))
    for key, plane in src._categorical.items():
        picked = plane.and_(sel)
        if picked.is_empty():
            continue
        mine = dst._categorical.get(key)
        if mine is None:
            dst._categorical[key] = picked
        else:
            mine.ior(picked)
    id_set = set(int(i) for i in ids)
    for field_name, bsi in src._numeric.items():
        mine = dst._numeric.get(field_name)
        if mine is None:
            mine = dst._numeric[field_name] = BSI()
        docs, vals = bsi.doc_values()
        keep = np.array([int(d) in id_set for d in docs], dtype=bool)
        if keep.any():
            mine.set_values(docs[keep], vals[keep])


def merge_results(
    result_lists: "list[list[HybridSearchResult]]",
    k: int,
    descending: bool = True,
) -> "list[HybridSearchResult]":
    """Cross-source dedup keeping the BEST score of each doc
    (storage_merge.go:13-46; best is the largest for fused and text scores,
    the smallest for vector-only distances)."""
    from comet_tpu_torch.hybrid import HybridSearchResult

    best: dict[int, float] = {}
    for results in result_lists:
        for r in results:
            cur = best.get(r.id)
            if cur is None or (r.score > cur if descending else r.score < cur):
                best[r.id] = r.score

    merged = [HybridSearchResult(i, s) for i, s in best.items()]
    merged.sort(key=lambda r: ((-r.score if descending else r.score), r.id))
    return merged[:k] if 0 < k < len(merged) else merged
