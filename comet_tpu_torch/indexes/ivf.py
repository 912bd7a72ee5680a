"""IVF (inverted file) vector index.

Counterpart of comet_tpu/indexes/ivf.py: a k-means-partitioned corpus,
nprobe-limited exact scan of the nearest inverted lists, soft delete +
flush, thresholds, doc-ID filters, the fluent and batch search API and the
CIVF v2 format (byte-identical to the reference package's). Defaults are
the reference's: train needs at least nlist vectors (ivf_index.go:206-215),
nprobe defaults to sqrt(nlist) and an out-of-range nprobe means nlist
(ivf_index.go:410, ivf_index_search.go:232-236).

Search takes one of two routes, each exact within the probed lists:

- sparse (`ops/ivf_sparse.ivf_sparse_pipeline`, kernel K3): a block-sparse
  scan of the probed chunks of a cluster-major copy of the corpus, whose
  work tracks nprobe. Taken at capacity >= 2^19 with nlist >= 8 and
  nprobe < nlist; COMET_IVF_SPARSE=1 forces it at any capacity and
  COMET_IVF_SPARSE=0 disables it. A batch whose groups want more chunks
  than the step budget S is rescanned with a larger S, which is remembered
  per (nprobe, k_pad); once that budget reaches half the table, the shape
  takes the dense route.
- dense (`ops/fused_scan.ivf_topk_pipeline`, kernel K2 in nprobe mode):
  the whole corpus with unprobed rows masked, everywhere else.

On a CUDA index both run their kernels, on a CPU index their plain PyTorch
versions.

Under a profiler (`utils/profiling.span`) a search records the steps
`layer.vector.scan` (the query's copy, and each pipeline's enqueue),
`layer.ivf.layout` (a rebuild of a route's layout after the store
changed) and `layer.ivf.rescan` (each overflow rescan, its wait
included), and counts `ivf_sparse_rows` (the queries a launch sends down
the sparse route; 0 on the dense one) and the copies to the card in
`h2d_bytes`.
"""

from __future__ import annotations

import logging
import math
import os
from typing import BinaryIO, Iterable

import numpy as np
import torch

from comet_tpu_torch.core.filter import DocumentFilter
from comet_tpu_torch.core.limiter import sanitize_k
from comet_tpu_torch.core.node import VectorNode, reserve_node_ids
from comet_tpu_torch.indexes.base import (
    BaseVectorIndex,
    VectorSearchBuilder,
    collect_device_handle,
    next_pow2,
    threshold_scalar,
)
from comet_tpu_torch.io import serial
from comet_tpu_torch.ops import ivf_sparse as sp
from comet_tpu_torch.ops.distance import preprocess
from comet_tpu_torch.ops.fused_scan import ivf_topk_pipeline
from comet_tpu_torch.ops.kmeans import find_nearest_centroid, kmeans
from comet_tpu_torch.ops.sortnet import k_pow2
from comet_tpu_torch.types import (
    DistanceKind,
    InvalidConfigError,
    NotTrainedError,
    VectorIndexKind,
)
from comet_tpu_torch.utils.profiling import count, count_h2d, span

logger = logging.getLogger(__name__)

MAGIC = b"CIVF"
VERSION = 2  # v2: CRC32 payload trailer (v1 readable, no trailer check)

SPARSE_MIN_CAPACITY = 1 << 19   # the sparse route's default threshold


class IVFIndex(BaseVectorIndex):
    """Inverted-file index (reference: ivf_index.go:82-119).

    `device` is "cuda" (the default) or "cpu"."""

    def __init__(self, dim: int, nlist: int,
                 distance_kind: DistanceKind = DistanceKind.L2, *, device="cuda"):
        super().__init__(dim, distance_kind, device)
        if nlist <= 0:
            raise InvalidConfigError("nlist must be positive")
        self._nlist = nlist
        self._centroids: np.ndarray | None = None
        self._assign = np.full(self._store.capacity, -1, dtype=np.int32)
        self._trained = False
        self._dev_centroids = None      # device copy of _centroids
        # dense masked-scan cache
        self._dense_version = -1
        self._dev_assign = None
        # block-sparse scan cache
        self._sparse_version = -1
        self._sparse = None             # dict of device tensors + budgets
        self._order_key_src = None      # centroids object the order key is for
        self._order_key = None
        self._sparse_overflow_batches = 0  # batches that needed a rescan
        self._sparse_overflow_chunks = 0   # chunks dropped by first scans
        self._sparse_S_hint: dict = {}     # (nprobe, k_pad) -> learned S

    @classmethod
    def load_reference_state(
        cls,
        ids: np.ndarray,
        vectors: np.ndarray,
        valid: np.ndarray,
        n: int,
        centroids: np.ndarray,
        assign: np.ndarray,
        distance_kind: DistanceKind = DistanceKind.L2,
        *,
        device="cuda",
    ) -> "IVFIndex":
        """A trained index holding the state of a comet_tpu IVF index: its
        slot store's host arrays `ids`, `vectors` (preprocessed for the
        metric), `valid` and `n`, soft-deleted slots included, its
        `centroids` [nlist, d] and its per-slot `assign`."""
        centroids = np.asarray(centroids, dtype=np.float32)
        vectors = np.asarray(vectors, dtype=np.float32)
        idx = cls(vectors.shape[1], len(centroids), distance_kind, device=device)
        idx._store.load(ids, vectors, valid, n)
        idx._assign = np.full(idx._store.capacity, -1, dtype=np.int32)
        idx._assign[:n] = np.asarray(assign)[:n]
        idx._set_centroids(centroids)
        return idx

    # -- contracts -----------------------------------------------------------

    def kind(self) -> VectorIndexKind:
        return VectorIndexKind.IVF

    def trained(self) -> bool:
        return self._trained

    @property
    def nlist(self) -> int:
        return self._nlist

    def default_nprobes(self) -> int:
        """sqrt(nlist), the reference default (ivf_index.go:410)."""
        return int(math.sqrt(self._nlist))

    def stats(self) -> dict:
        s = super().stats()
        s["nlist"] = self._nlist
        s["trained"] = self._trained
        s["sparse_overflow_batches"] = self._sparse_overflow_batches
        s["sparse_overflow_chunks"] = self._sparse_overflow_chunks
        return s

    # -- training --------------------------------------------------------------

    def _set_centroids(self, centroids: np.ndarray) -> None:
        self._centroids = centroids
        count_h2d(centroids.nbytes, self._device)
        self._dev_centroids = torch.from_numpy(centroids).to(self._device)
        self._trained = True

    def train(self, vectors: np.ndarray, max_iter: int = 20) -> None:
        """Learn the Voronoi partition via k-means (ivf_index.go:206-235).

        Requires at least nlist training vectors. Vectors already in the
        index are re-assigned to the new centroids, as the reference does."""
        vectors = np.atleast_2d(np.asarray(vectors, dtype=np.float32))
        self._check_dim(vectors)
        if len(vectors) < self._nlist:
            raise InvalidConfigError(
                f"need at least {self._nlist} training vectors for "
                f"{self._nlist} clusters (got {len(vectors)})"
            )
        prepped = torch.from_numpy(preprocess(vectors, self._distance_kind)).to(self._device)
        centroids, _ = kmeans(prepped, self._nlist, self._distance_kind, max_iter)
        del prepped
        with self._lock:
            self._set_centroids(centroids.cpu().numpy())
            n = self._store.n
            if n:
                vecs = self._store.device_state()[0][:n]
                self._assign[:n] = find_nearest_centroid(
                    vecs, self._dev_centroids, self._distance_kind
                ).cpu().numpy()
            self._dense_version = self._sparse_version = -1

    # -- mutation --------------------------------------------------------------

    def add(self, node: VectorNode) -> None:
        self.add_batch(np.asarray(node.vector, dtype=np.float32)[None, :], [node.id])

    def add_batch(self, vectors: np.ndarray, ids: Iterable[int] | None = None) -> list[int]:
        """Assign each vector to its nearest centroid list
        (ivf_index.go:251-280), on the index's device."""
        if not self._trained:
            raise NotTrainedError("index must be trained before adding vectors")
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
        assign = find_nearest_centroid(
            torch.from_numpy(prepped).to(self._device), self._dev_centroids,
            self._distance_kind,
        ).cpu().numpy()
        with self._lock:
            for i in id_arr.tolist():
                if self._store.contains(i):
                    raise InvalidConfigError(f"duplicate node ID {i}")
            slots = self._store.add_batch(id_arr, prepped)
            if self._store.capacity > len(self._assign):
                grown = np.full(self._store.capacity, -1, dtype=np.int32)
                grown[: len(self._assign)] = self._assign
                self._assign = grown
            self._assign[slots] = assign.astype(np.int32)
        return id_arr.tolist()

    def remove(self, node_id: int) -> None:
        with self._lock:
            self._store.remove(node_id)

    def flush(self) -> None:
        """Hard-delete and compact; list assignments follow the kept slots
        (parity with ivf_index.go:362-399)."""
        with self._lock:
            keep = np.flatnonzero(self._store.valid[: self._store.n])
            self._store.flush()
            kept_assign = self._assign[keep]
            self._assign[: len(kept_assign)] = kept_assign
            self._assign[len(kept_assign):] = -1

    # -- search caches ---------------------------------------------------------------

    def _sanitize_nprobes(self, nprobes: int | None) -> int:
        if nprobes is None:
            nprobes = self.default_nprobes()
        if nprobes <= 0 or nprobes > self._nlist:
            nprobes = self._nlist
        return nprobes

    def _device_sparse(self) -> dict:
        """Cluster-major layout for the block-sparse scan, rebuilt when the
        contents change. Soft-deleted slots are left out of the layout;
        padding rows carry +inf in the additive mask."""
        if self._order_key_src is not self._centroids or self._sparse_version != self._store.version:
            with span("layer.ivf.layout"):
                self._build_sparse()
        return self._sparse

    def _build_sparse(self) -> None:
        if self._order_key_src is not self._centroids:
            key = sp.cluster_order_key(self._centroids, device=self._device)
            count_h2d(key.nbytes, self._device)
            self._order_key = torch.from_numpy(key).to(self._device)
            self._order_key_src = self._centroids
        if self._sparse_version != self._store.version:
            self._sparse = None   # free the old layout before the new one
            n = self._store.n
            assign = np.where(self._store.valid[:n], self._assign[:n], -1).astype(np.int32)
            lay = sp.build_cluster_major(assign, self._nlist)
            vecs, sqnorms, _ = self._store.device_state()
            count_h2d(lay["perm"].nbytes + lay["chunk_start"].nbytes + lay["nchunks"].nbytes,
                      self._device)
            perm = torch.from_numpy(lay["perm"]).to(self._device)
            pc = perm.clamp_min(0).long()
            base = torch.zeros_like(sqnorms) if self._distance_kind == DistanceKind.COSINE else sqnorms
            self._sparse_S_hint.clear()  # budgets learned on the old layout
            self._sparse = {
                "corpus": vecs[pc],
                "mask_vec": torch.where(perm >= 0, base[pc], torch.full_like(base[pc], float("inf"))),
                "row_slot": perm,
                "pc": pc,
                "chunk_start": torch.from_numpy(lay["chunk_start"]).to(self._device),
                "nchunks": torch.from_numpy(lay["nchunks"]).to(self._device),
                "nch_total": int(lay["chunk_start"][-1]),
                "max_chunks": lay["max_chunks"],
            }
            self._sparse_version = self._store.version

    def _device_dense(self) -> torch.Tensor:
        """Device copy of the per-slot cluster ids for the dense scan."""
        if self._dense_version != self._store.version:
            with span("layer.ivf.layout"):
                assign = self._assign[: self._store.capacity].copy()
                count_h2d(assign.nbytes, self._device)
                self._dev_assign = torch.from_numpy(assign).to(self._device)
                self._dense_version = self._store.version
        return self._dev_assign

    # -- search ---------------------------------------------------------------

    def _launch_sparse(self, q, k_pad, k_eff, nprobe, builder, S_override=None):
        """Block-sparse scan of the probed chunks. The handle carries the
        per-group overflow counts; `_search_collect` checks them and rescans
        with a larger step budget until the scan covers every requested
        probe, updating `_sparse_S_hint[(nprobe, k_pad)]` so that later
        batches of the same shape start right-sized."""
        st = self._device_sparse()
        id_map = self._store.device_id_map()
        kind = self._distance_kind
        cosine = kind == DistanceKind.COSINE
        thr = threshold_scalar(builder._threshold)
        thr_k = thr * thr if kind == DistanceKind.L2 else thr
        mask_vec = st["mask_vec"]
        if DocumentFilter(builder._document_ids).enabled:
            # the slot mask, permuted through row_slot into the layout
            fm = self._slot_mask(builder)[st["pc"]]
            mask_vec = torch.where(st["row_slot"] >= 0, fm, torch.full_like(fm, float("inf")))
        S, UC, MC = sp.default_budgets(nprobe, self._nlist, st["nch_total"], st["max_chunks"])
        S = max(S, self._sparse_S_hint.get((nprobe, k_pad), 0))
        S_max = 1 << max(int(st["nch_total"] - 1).bit_length(), 5)
        if S_override is not None:
            S = max(S_override, S)
        S = min(S, S_max)
        UC = min(S, self._nlist)
        with span("layer.vector.scan"):
            s, i, overflow = sp.ivf_sparse_pipeline(
                q, st["corpus"], mask_vec, st["row_slot"], thr_k, self._dev_centroids,
                self._order_key, st["chunk_start"], st["nchunks"],
                k=k_pad, nprobe=nprobe, S=S, UC=UC, MC=MC, nlist=self._nlist,
                coarse_cosine=cosine, cosine=cosine, sqrt_out=kind == DistanceKind.L2,
            )
        # overflow counts chunks dropped beyond the EFFECTIVE budget (the
        # pipeline raises S to kb * SEL_GROUP / CHUNK): escalate from there
        S_eff = max(S, -(-k_pow2(k_pad) * sp.SEL_GROUP // sp.CHUNK))
        retry = (q, k_pad, k_eff, nprobe, builder, S_eff, S_max) if S_eff < S_max else None
        s = s[:, :k_eff] if builder._wire_scores else None
        return ("sparse", s, i[:, :k_eff], id_map, overflow, retry)

    def _search_launch(self, queries: np.ndarray, builder: VectorSearchBuilder):
        if not self._trained:
            raise NotTrainedError("index must be trained before searching")
        store = self._store
        if store.n == 0:
            return ("empty", queries.shape[0])
        k_eff = sanitize_k(builder._k, store.n)
        k_pad = min(next_pow2(k_eff), store.capacity)
        nprobe = self._sanitize_nprobes(builder._nprobes)
        kind = self._distance_kind

        sparse_env = os.environ.get("COMET_IVF_SPARSE", "")
        use_sparse = (
            sparse_env != "0"
            and (store.capacity >= SPARSE_MIN_CAPACITY or sparse_env == "1")
            and self._nlist >= 8
            and nprobe < self._nlist
        )
        if use_sparse and self._sparse is not None:
            # once probe-diverse batches have escalated the learned budget
            # toward the whole table, every group walks most chunks anyway:
            # the dense scan does the same work without the gathers
            hint = self._sparse_S_hint.get((nprobe, k_pad), 0)
            if 2 * hint >= self._sparse["nch_total"]:
                use_sparse = False
        if use_sparse:
            self._device_sparse()     # a rebuild is a step of its own, not the scan's
        else:
            vecs = store.device_state()[0]
            mask, assign = self._slot_mask(builder), self._device_dense()
        with span("layer.vector.scan"):
            qprep = preprocess(queries, kind)
            count_h2d(qprep.nbytes, self._device)
            q = torch.as_tensor(qprep, device=self._device)
            count("ivf_sparse_rows", len(qprep) if use_sparse else 0)
        if use_sparse:
            return self._launch_sparse(q, k_pad, k_eff, nprobe, builder)

        cosine = kind == DistanceKind.COSINE
        thr = threshold_scalar(builder._threshold)
        thr_k = thr * thr if kind == DistanceKind.L2 else thr
        id_map = store.device_id_map()
        with span("layer.vector.scan"):
            s, i = ivf_topk_pipeline(
                q, vecs, mask, thr_k, self._dev_centroids, assign, k_pad, nprobe,
                coarse_cosine=cosine, cosine=cosine, sqrt_out=kind == DistanceKind.L2,
            )
        s, i = s[:, :k_eff], i[:, :k_eff]
        return ("dev", s if builder._wire_scores else None, i, id_map)

    def _search_collect(self, handle):
        if handle[0] == "sparse":
            _, s, i, ids, overflow, retry = handle
            ov = overflow.cpu().numpy()
            dropped = int(ov.sum())
            if dropped > 0:
                self._sparse_overflow_batches += 1
                self._sparse_overflow_chunks += dropped
            # escalate the step budget past the worst group's want and
            # rescan until clean or capped at the table size
            while dropped > 0 and retry is not None:
                q, k_pad, k_eff, nprobe, builder, S_old, S_max = retry
                S_new = min(1 << int(S_old + int(ov.max()) - 1).bit_length(), S_max)
                if S_new <= S_old:
                    logger.warning("ivf sparse scan overflow at max budget: %d chunk(s)", dropped)
                    break
                logger.warning(
                    "ivf sparse scan overflow: %d chunk(s) dropped across %d group(s); "
                    "rescanning with S=%d (was %d)",
                    dropped, int((ov > 0).sum()), S_new, S_old,
                )
                self._sparse_S_hint[(nprobe, k_pad)] = S_new
                with span("layer.ivf.rescan"):
                    _, s, i, ids, overflow, retry = self._launch_sparse(
                        q, k_pad, k_eff, nprobe, builder, S_override=S_new)
                    ov = overflow.cpu().numpy()
                dropped = int(ov.sum())
            handle = ("dev", s, i, ids)
        return collect_device_handle(handle)

    # -- serialization ----------------------------------------------------------

    def write_to(self, f: BinaryIO) -> None:
        """CIVF v2: params + centroids + ids/vectors/assignments (flushed)
        + CRC32 trailer."""
        with self._lock:
            self.flush()
            w = serial.CrcWriter(f)
            serial.write_magic(w, MAGIC, VERSION)
            serial.write_str(w, self._distance_kind.value)
            serial.write_u32(w, self._dim)
            serial.write_u32(w, self._nlist)
            serial.write_u32(w, 1 if self._trained else 0)
            if self._trained:
                serial.write_array(w, self._centroids)
            n = self._store.n
            serial.write_u64(w, n)
            serial.write_array(w, self._store.ids[:n])
            serial.write_array(w, self._store.vectors[:n])
            serial.write_array(w, self._assign[:n])
            w.seal()

    def read_from(self, f: BinaryIO) -> None:
        r = serial.CrcReader(f)
        version = serial.read_magic(r, MAGIC, VERSION)
        kind = DistanceKind(serial.read_str(r))
        dim = serial.read_u32(r)
        nlist = serial.read_u32(r)
        if kind != self._distance_kind:
            raise serial.SerializationError(
                f"distance kind mismatch: index={self._distance_kind.value}, stored={kind.value}"
            )
        if dim != self._dim:
            raise serial.SerializationError(f"dimension mismatch: index={self._dim}, stored={dim}")
        if nlist != self._nlist:
            raise serial.SerializationError(f"nlist mismatch: index={self._nlist}, stored={nlist}")
        trained = bool(serial.read_u32(r))
        centroids = serial.read_array(r) if trained else None
        n = serial.read_u64(r)
        ids = serial.read_array(r)
        vectors = serial.read_array(r)
        assign = serial.read_array(r)
        if version >= 2:
            r.verify()
        if len(ids) != n or vectors.shape != (n, dim) or len(assign) != n:
            raise serial.SerializationError("corrupt IVF index payload")
        with self._lock:
            self._store = type(self._store)(dim, capacity=max(n, 1), device=self._device)
            self._assign = np.full(self._store.capacity, -1, dtype=np.int32)
            self._trained = False
            self._centroids = self._dev_centroids = None
            if trained:
                self._set_centroids(np.asarray(centroids, dtype=np.float32))
            if n:
                slots = self._store.add_batch(ids.astype(np.uint32), vectors.astype(np.float32))
                self._assign[slots] = assign.astype(np.int32)
            self._dense_version = self._sparse_version = -1
