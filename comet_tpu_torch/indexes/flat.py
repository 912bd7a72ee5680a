"""Flat (brute-force exact) vector index.

Counterpart of comet_tpu/indexes/flat.py with float32 storage: exact kNN
with soft delete + flush compaction, threshold, doc-ID pre-filter,
multi-query aggregation, autocut, reranker, and the CFLT v2 binary format
(byte-compatible with the reference package).

Search runs `ops.fused_scan.flat_topk_pipeline` over the device mirror of
the slot store: on a CUDA index through the K2 distance kernel and the K1
select kernel, on a CPU index through their plain PyTorch versions. The
doc-ID filter travels as packed 32-bit words and is expanded against the
slot ids on the device.
"""

from __future__ import annotations

from typing import BinaryIO, Iterable

import numpy as np
import torch

from comet_tpu_torch.core.limiter import sanitize_k
from comet_tpu_torch.core.node import VectorNode, reserve_node_ids
from comet_tpu_torch.indexes.base import (
    BaseVectorIndex,
    VectorSearchBuilder,
    collect_device_handle,
    threshold_scalar,
)
from comet_tpu_torch.io import serial
from comet_tpu_torch.ops.distance import preprocess
from comet_tpu_torch.ops.fused_scan import flat_topk_pipeline
from comet_tpu_torch.types import DistanceKind, InvalidConfigError, VectorIndexKind

MAGIC = b"CFLT"
VERSION = 2  # v2: CRC32 payload trailer (v1 readable, no trailer check)


class FlatIndex(BaseVectorIndex):
    """Exact brute-force kNN index (reference: flat_index.go:65-94).

    `device` is "cuda" (the default) or "cpu". Only `storage="float32"` is
    ported; the reduced-precision storages raise.
    """

    def __init__(
        self,
        dim: int,
        distance_kind: DistanceKind = DistanceKind.L2,
        storage: str = "float32",
        *,
        device="cuda",
    ):
        if storage != "float32":
            raise InvalidConfigError(
                f"flat storage {storage!r} is not available in comet_tpu_torch: "
                "only float32 is ported (ROADMAP.md, Queue 1: bf16/f16/int8 "
                "flat storage)"
            )
        super().__init__(dim, distance_kind, device)

    @classmethod
    def load_reference_state(
        cls,
        ids: np.ndarray,
        vectors: np.ndarray,
        valid: np.ndarray,
        n: int,
        distance_kind: DistanceKind = DistanceKind.L2,
        *,
        device="cuda",
    ) -> "FlatIndex":
        """An index holding the state of a comet_tpu slot store: its host
        arrays `ids`, `vectors` (already preprocessed for the metric),
        `valid` and `n`, soft-deleted slots included."""
        vectors = np.asarray(vectors, dtype=np.float32)
        idx = cls(vectors.shape[1], distance_kind, device=device)
        idx._store.load(ids, vectors, valid, n)
        return idx

    # -- contracts -----------------------------------------------------------

    def kind(self) -> VectorIndexKind:
        return VectorIndexKind.FLAT

    def train(self, vectors=None) -> None:
        """Flat index requires no training (parity: flat Train is a no-op)."""
        return None

    # -- mutation --------------------------------------------------------------

    def add(self, node: VectorNode) -> None:
        """Insert one node; the vector is preprocessed for the metric at
        insert time (flat_index.go:169-189)."""
        self.add_batch(np.asarray(node.vector, dtype=np.float32)[None, :], [node.id])

    def add_batch(self, vectors: np.ndarray, ids: Iterable[int] | None = None) -> list[int]:
        """Batch insert. Returns the node IDs (auto-assigned when `ids` is None)."""
        vectors = np.atleast_2d(np.asarray(vectors, dtype=np.float32))
        self._check_dim(vectors)
        if ids is None:
            first = reserve_node_ids(len(vectors))
            id_arr = np.arange(first, first + len(vectors), dtype=np.uint32)
        else:
            id_arr = np.asarray(list(ids), dtype=np.uint32)
            if len(id_arr) != len(vectors):
                raise InvalidConfigError("ids and vectors length mismatch")
        prepped = preprocess(vectors, self._distance_kind)
        with self._lock:
            for i in id_arr.tolist():
                if self._store.contains(i):
                    raise InvalidConfigError(f"duplicate node ID {i}")
            self._store.add_batch(id_arr, prepped)
        return id_arr.tolist()

    def remove(self, node_id: int) -> None:
        """Soft delete; excluded from search until flush hard-deletes."""
        with self._lock:
            self._store.remove(node_id)

    def flush(self) -> None:
        """Hard-delete soft-deleted rows and compact (flat_index.go:266-299)."""
        with self._lock:
            self._store.flush()

    # -- search ---------------------------------------------------------------

    def _search_launch(self, queries: np.ndarray, builder: VectorSearchBuilder):
        """Enqueue the search; the handle holds device tensors."""
        store = self._store
        n_slots = store.n  # includes soft-deleted rows, like len(index.vectors)
        if n_slots == 0:
            return ("empty", queries.shape[0])
        k_eff = sanitize_k(builder._k, n_slots)
        kind = self._distance_kind
        cosine = kind == DistanceKind.COSINE
        thr = threshold_scalar(builder._threshold)
        # the pipeline works on squared distances for L2
        thr_k = thr * thr if kind == DistanceKind.L2 else thr

        q = torch.as_tensor(preprocess(queries, kind), device=self._device)
        s, i = flat_topk_pipeline(
            q, store.device_state()[0], self._slot_mask(builder), thr_k, k_eff,
            cosine=cosine, sqrt_out=kind == DistanceKind.L2,
        )
        return ("dev", s if builder._wire_scores else None, i, store.ids)

    def _search_collect(self, handle):
        return collect_device_handle(handle)

    # -- serialization ----------------------------------------------------------

    def write_to(self, f: BinaryIO) -> None:
        """Serialize; flushes soft deletes first like the reference
        (flat_index.go:366-369). Format: CFLT v2 header + params + arrays +
        CRC32 trailer."""
        with self._lock:
            self._store.flush()
            w = serial.CrcWriter(f)
            serial.write_magic(w, MAGIC, VERSION)
            serial.write_str(w, self._distance_kind.value)
            serial.write_u32(w, self._dim)
            n = self._store.n
            serial.write_u64(w, n)
            serial.write_array(w, self._store.ids[:n])
            serial.write_array(w, self._store.vectors[:n])
            w.seal()

    def read_from(self, f: BinaryIO) -> None:
        """Deserialize into this index; stored params must match the
        receiving index's params (parity: flat_index.go ReadFrom validation)."""
        r = serial.CrcReader(f)
        version = serial.read_magic(r, MAGIC, VERSION)
        kind = DistanceKind(serial.read_str(r))
        dim = serial.read_u32(r)
        if kind != self._distance_kind:
            raise serial.SerializationError(
                f"distance kind mismatch: index={self._distance_kind.value}, stored={kind.value}"
            )
        if dim != self._dim:
            raise serial.SerializationError(
                f"dimension mismatch: index={self._dim}, stored={dim}"
            )
        n = serial.read_u64(r)
        ids = serial.read_array(r)
        vectors = serial.read_array(r)
        if version >= 2:
            r.verify()
        if len(ids) != n or vectors.shape != (n, dim):
            raise serial.SerializationError("corrupt flat index payload")
        with self._lock:
            self._store = type(self._store)(dim, capacity=max(n, 1), device=self._device)
            if n:
                self._store.add_batch(ids.astype(np.uint32), vectors.astype(np.float32))
