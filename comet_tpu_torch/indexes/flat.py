"""Flat (brute-force exact) vector index.

Counterpart of comet_tpu/indexes/flat.py with float32, bfloat16, float16
and int8 storage: exact kNN with soft delete + flush compaction, threshold, doc-ID
pre-filter, multi-query aggregation, autocut, reranker, and the CFLT v2
binary format (byte-compatible with the reference package).

Search runs `ops.fused_scan.flat_topk_pipeline` over the device mirror of
the slot store: on a CUDA index through the K2 distance kernel and the K1
select kernel, on a CPU index through their plain PyTorch versions. The
doc-ID filter travels as packed 32-bit words and is expanded against the
slot ids on the device.

The lossy storages scan a copy of the corpus made on the device from the
float32 mirror once per store version, with K2's operand of that type:
- `storage="bfloat16"` and `"float16"`: a cast (queries rounded to the
  same type for the product, float32 query norms and corpus squared
  norms);
- `storage="int8"`: symmetric abs-max quantisation (quantizer.go:180-247
  of the Go reference), rows round(v / scale) clipped to [-127, 127] with
  scale = abs-max / 127, fixed by `train(sample)` or, untrained, fitted
  to the live rows of each store version; the queries are rounded to
  bf16, the integer product is multiplied by the scale, and the mask
  holds the squared norms of the dequantised rows.
`rerank=True` over-fetches rerank_factor * k candidates and re-scores
them exactly in float32 on the host. The host copy stays float32, so
serialization and flush are lossless.
"""

from __future__ import annotations

from typing import BinaryIO, Iterable

import numpy as np
import torch

from comet_tpu_torch.core.limiter import sanitize_k
from comet_tpu_torch.core.node import VectorNode, reserve_node_ids
from comet_tpu_torch.indexes.base import (
    INVALID_ID,
    BaseVectorIndex,
    VectorSearchBuilder,
    collect_device_handle,
    threshold_scalar,
)
from comet_tpu_torch.io import serial
from comet_tpu_torch.ops.distance import preprocess
from comet_tpu_torch.ops.fused_scan import flat_topk_pipeline
from comet_tpu_torch.ops.topk import IDX_SENTINEL
from comet_tpu_torch.types import DistanceKind, InvalidConfigError, VectorIndexKind
from comet_tpu_torch.utils.profiling import count_h2d, span

MAGIC = b"CFLT"
VERSION = 2  # v2: CRC32 payload trailer (v1 readable, no trailer check)


class FlatIndex(BaseVectorIndex):
    """Exact brute-force kNN index (reference: flat_index.go:65-94).

    `device` is "cuda" (the default) or "cpu". `storage` is "float32"
    (exact, the reference's tie order), "bfloat16", "float16" or "int8"
    (module docstring). `rerank=True` needs lossy storage.
    """

    def __init__(
        self,
        dim: int,
        distance_kind: DistanceKind = DistanceKind.L2,
        storage: str = "float32",
        rerank: bool = False,
        rerank_factor: int = 4,
        *,
        device="cuda",
    ):
        if storage not in ("float32", "bfloat16", "float16", "int8"):
            raise InvalidConfigError(
                f"unsupported flat storage dtype: {storage!r} "
                "(use float32, bfloat16, float16, or int8)")
        if rerank and storage == "float32":
            raise InvalidConfigError(
                "rerank=True needs lossy storage (the float32 scan is exact)")
        super().__init__(dim, distance_kind, device)
        self._storage = storage
        self._rerank = bool(rerank)
        self._rerank_factor = max(int(rerank_factor), 2)
        self._int8_scale = None        # trained int8 scale (None: fit per version)
        self._dev_cast = None          # the lossy corpus copy, for one store version
        self._dev_cast_sqn = None      # its dequantised squared norms (int8)
        self._dev_scale = None         # its scale (int8)
        self._dev_cast_version = -1

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
        **kwargs,
    ) -> "FlatIndex":
        """An index holding the state of a comet_tpu slot store: its host
        arrays `ids`, `vectors` (already preprocessed for the metric),
        `valid` and `n`, soft-deleted slots included; `kwargs` are the
        constructor's storage options."""
        vectors = np.asarray(vectors, dtype=np.float32)
        idx = cls(vectors.shape[1], distance_kind, device=device, **kwargs)
        idx._store.load(ids, vectors, valid, n)
        return idx

    # -- contracts -----------------------------------------------------------

    def kind(self) -> VectorIndexKind:
        return VectorIndexKind.FLAT

    def train(self, vectors=None) -> None:
        """Flat index requires no training (parity: flat Train is a no-op),
        except int8 storage, where a sample fixes the abs-max scale
        (Int8Quantizer.Train); untrained int8 fits the scale to the live
        rows of each store version instead."""
        if self._storage == "int8" and vectors is not None:
            sample = np.atleast_2d(np.asarray(vectors, dtype=np.float32))
            self._check_dim(sample)
            prepped = preprocess(sample, self._distance_kind)
            amax = float(np.abs(prepped).max()) if prepped.size else 0.0
            with self._lock:
                self._int8_scale = np.float32(max(amax, 1e-30) / 127.0)
                self._dev_cast_version = -1    # requantise at the next search
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

    def _device_corpus(self):
        """What the scan reads: (corpus, squared norms for the mask or None
        for the store's, int8 scale or None). The float32 mirror, or its
        lossy copy made once per store version."""
        vecs, _, valid = self._store.device_state()
        if self._storage == "float32":
            return vecs, None, None
        if self._dev_cast_version != self._store.version:
            self._dev_cast = self._dev_cast_sqn = None   # free the old copy first
            if self._storage == "int8":
                self._quantize_int8(vecs, valid)
            else:
                dtype = torch.bfloat16 if self._storage == "bfloat16" else torch.float16
                self._dev_cast = vecs.to(dtype)
            self._dev_cast_version = self._store.version
        return self._dev_cast, self._dev_cast_sqn, self._dev_scale

    def _quantize_int8(self, vecs, valid) -> None:
        """The int8 copy of the float32 mirror, the squared norms of its
        dequantised rows and its scale, as the reference quantises its host
        copy (comet_tpu/indexes/flat.py:222-246)."""
        scale = self._int8_scale
        if scale is None:
            live = vecs[valid]
            amax = float(live.abs().max()) if live.numel() else 0.0
            scale = np.float32(max(amax, 1e-30) / 127.0)
        s = torch.tensor(scale, dtype=torch.float32, device=vecs.device)
        self._dev_cast = torch.clamp(torch.round(vecs / s), -127, 127).to(torch.int8)
        deq = self._dev_cast.to(torch.float32) * s
        self._dev_cast_sqn = (deq * deq).sum(dim=1)
        self._dev_scale = float(scale)

    def _search_launch(self, queries: np.ndarray, builder: VectorSearchBuilder):
        """Enqueue the search; the handle holds device tensors."""
        store = self._store
        n_slots = store.n  # includes soft-deleted rows, like len(index.vectors)
        if n_slots == 0:
            return ("empty", queries.shape[0])
        k_eff = sanitize_k(builder._k, n_slots)
        k_want = min(k_eff * self._rerank_factor, n_slots) if self._rerank else k_eff
        kind = self._distance_kind
        cosine = kind == DistanceKind.COSINE
        thr = threshold_scalar(builder._threshold)
        # the pipeline works on squared distances for L2
        thr_k = thr * thr if kind == DistanceKind.L2 else thr

        corpus, sqnorms, scale = self._device_corpus()
        id_map = None if self._rerank else store.device_id_map()
        mask = self._slot_mask(builder, sqnorms)
        with span("layer.vector.scan"):
            qprep = preprocess(queries, kind)
            count_h2d(qprep.nbytes, self._device)
            q = torch.as_tensor(qprep, device=self._device)
            s, i = flat_topk_pipeline(
                q, corpus, mask, thr_k, k_want,
                cosine=cosine, sqrt_out=kind == DistanceKind.L2, scale=scale,
            )
        if self._rerank:
            return ("rerank", i, store.ids, qprep, k_eff, builder._threshold)
        return ("dev", s if builder._wire_scores else None, i, id_map)

    def _search_collect(self, handle):
        if handle[0] == "rerank":
            return self._collect_rerank(*handle[1:])
        return collect_device_handle(handle)

    def _collect_rerank(self, slots_dev, ids_snap, qprep, k_eff, threshold):
        """Exact float32 refinement of a lossy scan's candidates (reference
        _collect_rerank): the rerank_factor * k candidates are re-scored from
        the host float32 vectors, the metric-space threshold is applied
        again, and the (score, slot)-ascending top k_eff is kept."""
        slots = slots_dev.cpu().numpy().astype(np.int64)
        hit = slots != IDX_SENTINEL
        vecs = self._store.vectors[np.where(hit, slots, 0)]        # [Q, kc, d]
        ip = np.einsum("qd,qcd->qc", qprep, vecs, optimize=True)
        if self._distance_kind == DistanceKind.COSINE:
            exact = 1.0 - np.clip(ip, -1.0, 1.0)
        else:
            xn = np.einsum("qcd,qcd->qc", vecs, vecs, optimize=True)
            qn = np.einsum("qd,qd->q", qprep, qprep)[:, None]
            exact = np.maximum(qn + xn - 2.0 * ip, 0.0)
            if self._distance_kind == DistanceKind.L2:
                exact = np.sqrt(exact)
        thr = threshold_scalar(threshold)
        exact = np.where(hit & (exact <= thr), exact, np.inf).astype(np.float32)
        slots = np.where(np.isfinite(exact), slots, IDX_SENTINEL)
        slot_key = np.where(slots == IDX_SENTINEL, np.iinfo(np.int64).max, slots)
        order = np.lexsort((slot_key, exact), axis=1)[:, :k_eff]
        exact = np.take_along_axis(exact, order, axis=1)
        slots = np.take_along_axis(slots, order, axis=1)
        hit = slots != IDX_SENTINEL
        ids = np.where(hit, ids_snap[np.where(hit, slots, 0)], INVALID_ID)
        return ids.astype(np.uint32), exact

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
            # the new store restarts its version at 0: drop the old lossy copy
            self._dev_cast, self._dev_cast_version = None, -1
            if n:
                self._store.add_batch(ids.astype(np.uint32), vectors.astype(np.float32))
