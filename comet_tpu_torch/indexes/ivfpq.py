"""IVFPQ vector index: an IVF coarse quantizer and PQ of the residuals.

Counterpart of comet_tpu/indexes/ivfpq.py (ivfpq_index.go and
ivfpq_index_search.go of the Go reference): coarse k-means, one PQ
codebook set trained on the residuals to the assigned centroids (train
needs at least nlist * 10 vectors, ivfpq_index.go:185), search by the
square root of the summed residual-table entries of each probed list,
soft delete + flush, filters, thresholds, aggregation, autocut, rerankers,
the CIPQ v3 format (byte-identical to the reference package's), and the
reference package's two extensions: `with_nrefine(n)` / `nrefine=`, an
exact re-rank of the top n candidates on the stored originals
(`store_originals=True`), and the OPQ rotation, learned on the device with
a host float64 SVD. The model (centroids, codebooks, codes) lives in
rotated coordinates; the routes that scan reconstructions rotate them,
and the coarse centroids, back to user coordinates.

Search takes one of three routes, on both devices:

- sparse (ops/ivf_sparse.ivf_sparse_pipeline, K3 and K1 on the card): a
  block-sparse scan of the probed chunks of a cluster-major copy of the
  reconstruction, with the IVF index's overflow rescans and the learned
  step budget per (nprobe, k_pad). Taken at capacity >= 2^19 (or
  COMET_IVFPQ_SPARSE=1; =0 disables it) with nlist >= 8, nprobe < nlist
  and k_pad within K1's one-launch select (the reference's k_pad <= 256
  was a compile cliff of its sort network).
- dense (ops/fused_scan.ivf_topk_pipeline, K2's nprobe mode and K1): the
  whole reconstruction with unprobed rows masked.
- the LUT walk (`_ivfpq_walk`, torch ops and K1): each step every query
  scores one 256-row chunk of its current probed list by its residual
  table. It keeps no float32 reconstruction on the device (16 bytes a row
  at M = 16, against 512 at d = 128).

The first two need the decoded corpus on the device and are taken while
it fits pq.DECODED_BYTES_MAX (its derivation is in indexes/pq.py); past it
the walk serves. The scan routes and the walk give the same neighbours
(the ADC distance IS the L2 distance to the reconstruction) but not the
same bits. With nrefine, the scan routes keep an approximate shortlist
(`kb_cap`) and re-rank it on the device (`_refine_device`, K1's select);
the walk re-ranks on the host (`_refine`).
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
    INVALID_ID,
    BaseVectorIndex,
    SlotStore,
    VectorSearchBuilder,
    next_pow2,
    threshold_scalar,
)
from comet_tpu_torch.indexes.pq import (
    calculate_pq_params,
    check_pq_params,
    codes_to_device,
    opq_rotation,
)
from comet_tpu_torch.indexes import pq
from comet_tpu_torch.io import serial
from comet_tpu_torch.ops import ivf_sparse as sp
from comet_tpu_torch.ops.adc import build_lut, ivfpq_assign_encode, pq_decode
from comet_tpu_torch.ops.distance import f32_matmul, pairwise_scores, preprocess, sqrt_f32
from comet_tpu_torch.ops.fused_scan import ivf_topk_pipeline
from comet_tpu_torch.ops.kmeans import kmeans_ivfpq_train
from comet_tpu_torch.ops.sortnet import KP_MAX, k_pow2, topk_rows
from comet_tpu_torch.ops.topk import IDX_SENTINEL, INF
from comet_tpu_torch.types import (
    DistanceKind,
    InvalidConfigError,
    NodeNotFoundError,
    NotTrainedError,
    VectorIndexKind,
)

logger = logging.getLogger(__name__)

MAGIC = b"CIPQ"
VERSION = 3  # v3: optional OPQ rotation; v2: CRC32 trailer (older readable)

IVFPQ_QUERY_CHUNK = 256        # queries a LUT walk
LIST_CHUNK = 256               # inverted-list rows per chunk of the walk
SPARSE_MIN_CAPACITY = 1 << 19  # the sparse route's default threshold


def build_chunked_lists(assign: np.ndarray, nlist: int, chunk: int = LIST_CHUNK):
    """Fixed-size chunked inverted lists from per-slot assignments
    (comet_tpu/indexes/ivf.py:169-199): (chunk_slots [NC_pad, chunk] int32,
    -1 padded, slots ascending within a list; chunk_start [nlist + 1]
    int32; the most chunks of one list)."""
    order = np.argsort(assign, kind="stable")
    sorted_assign = assign[order]
    pos0 = np.searchsorted(sorted_assign, 0)
    assigned = order[pos0:].astype(np.int32)
    lists = sorted_assign[pos0:]
    counts = (np.bincount(lists, minlength=nlist) if len(lists)
              else np.zeros(nlist, dtype=np.int64))
    n_chunks = -(-counts // chunk)  # empty lists own 0 chunks
    chunk_start = np.zeros(nlist + 1, dtype=np.int32)
    np.cumsum(n_chunks, out=chunk_start[1:])
    nc_pad = next_pow2(max(int(chunk_start[-1]), 1), 4)
    chunk_slots = np.full((nc_pad, chunk), -1, dtype=np.int32)
    if len(assigned):
        starts = np.zeros(nlist, dtype=np.int64)
        np.cumsum(counts[:-1], out=starts[1:])
        within = np.arange(len(assigned)) - starts[lists]
        chunk_slots[chunk_start[lists] + within // chunk, within % chunk] = assigned
    return chunk_slots, chunk_start, max(int(n_chunks.max()) if nlist else 1, 1)


def _refine_device(q: torch.Tensor, slots: torch.Tensor, vectors: torch.Tensor, k: int,
                   kind: DistanceKind):
    """Exact re-rank of [Q, C] candidate slots (IDX_SENTINEL for none) on
    the stored originals [cap, d] (ivfpq.py:159-202): the [Q, C, d] rows
    gathered, their distances to the queries in full float32, and the
    (score, slot) top k by K1. The threshold is not applied again, as in
    the reference. Returns (scores [Q, k], slots [Q, k])."""
    hit = slots != IDX_SENTINEL
    v = vectors[torch.where(hit, slots, torch.zeros_like(slots)).long()]      # [Q, C, d]
    if v.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("torch.backends.cuda.matmul.allow_tf32 is on: the re-rank "
                           "needs full-float32 products")
    ip = torch.bmm(v, q[:, :, None])[:, :, 0]
    if kind == DistanceKind.COSINE:
        exact = 1.0 - torch.clamp(ip, -1.0, 1.0)
    else:
        qn = (q * q).sum(dim=1)
        exact = torch.clamp_min(qn[:, None] + (v * v).sum(dim=2) - 2.0 * ip, 0.0)
        if kind == DistanceKind.L2:
            exact = sqrt_f32(exact)
    exact = torch.where(hit, exact, torch.full_like(exact, INF))
    s, i = topk_rows(exact, torch.where(hit, slots, torch.full_like(slots, IDX_SENTINEL)), k)
    return s[:, :k], i[:, :k]


def _ivfpq_walk(q, centroids, codebooks, chunk_slots, chunk_start, codes, ok, thr,
                k: int, kind: DistanceKind, nprobe: int, max_steps: int):
    """The LUT walk over fixed-size list chunks (ivfpq.py:69-157), in model
    coordinates: the exact top-nprobe lists of each query by `kind` (ties
    to the lower list), then each step every query scores one chunk of its
    current list with the residual table of that list, ascending in the
    subspaces as `adc_topk` sums, and merges the chunk's top k into its
    running top k by (score, slot). The steps run until every query has
    walked its lists (at most `max_steps`). Returns (scores [Q, k], slots
    [Q, k])."""
    q_n = q.shape[0]
    m, ksub, _ = codebooks.shape
    dev = q.device
    probes = topk_rows(pairwise_scores(q, centroids, kind), None, nprobe)[1][:, :nprobe].long()
    starts = chunk_start.long()
    nch_p = starts[probes + 1] - starts[probes]                      # [Q, nprobe]
    steps = min(int(nch_p.clamp_min(1).sum(dim=1).max()), max_steps)
    rows = torch.arange(q_n, device=dev)
    offs_m = torch.arange(m, device=dev) * ksub
    probe_i = torch.zeros(q_n, dtype=torch.int64, device=dev)
    off = torch.zeros(q_n, dtype=torch.int64, device=dev)
    best_s = torch.full((q_n, k), INF, dtype=torch.float32, device=dev)
    best_i = torch.full((q_n, k), IDX_SENTINEL, dtype=torch.int32, device=dev)
    thr_t = torch.tensor(thr, dtype=torch.float32, device=dev)
    for _ in range(steps):
        alive = probe_i < nprobe
        p = probes[rows, probe_i.clamp_max(nprobe - 1)]
        base = starts[p]
        nch = starts[p + 1] - base
        have = alive & (off < nch)
        chunk = (base + off).clamp_max(chunk_slots.shape[0] - 1)
        lut = build_lut((q - centroids[p]).view(q_n, m, -1), codebooks).view(q_n, m * ksub)
        slots = torch.where(have[:, None], chunk_slots[chunk], torch.full_like(chunk_slots[chunk], -1))
        safe = slots.clamp_min(0).long()
        picked = torch.gather(lut, 1, (codes[safe].long() + offs_m).view(q_n, -1))
        picked = picked.view(q_n, slots.shape[1], m)
        acc = picked[:, :, 0]
        for mm in range(1, m):
            acc = acc + picked[:, :, mm]
        dist = sqrt_f32(torch.clamp_min(acc, 0.0))
        keep = (slots >= 0) & ok[safe] & (dist <= thr_t)
        dist = torch.where(keep, dist, torch.full_like(dist, INF))
        cand = torch.where(keep, slots, torch.full_like(slots, IDX_SENTINEL))
        s, i = topk_rows(dist, cand, k)
        s, i = topk_rows(torch.cat([best_s, s[:, :k]], dim=1), torch.cat([best_i, i[:, :k]], dim=1),
                         k)
        best_s, best_i = s[:, :k], i[:, :k]
        last = alive & (off + 1 >= nch)
        probe_i = torch.where(last, probe_i + 1, probe_i)
        off = torch.where(last, torch.zeros_like(off), torch.where(alive, off + 1, off))
    best_i = torch.where(torch.isinf(best_s), torch.full_like(best_i, IDX_SENTINEL), best_i)
    return best_s, best_i


class IVFPQIndex(BaseVectorIndex):
    """IVF + PQ-on-residuals index (reference: ivfpq_index.go:54-100).

    `device` is "cuda" (the default) or "cpu"."""

    def __init__(
        self,
        dim: int,
        distance_kind: DistanceKind = DistanceKind.L2,
        nlist: int = 100,
        m: int | None = None,
        nbits: int = 8,
        store_originals: bool = False,
        opq: bool = False,
        opq_iters: int = 6,
        *,
        device="cuda",
    ):
        super().__init__(dim, distance_kind, device)
        if nlist <= 0:
            raise InvalidConfigError("nlist must be positive")
        if m is None:
            m, nbits = calculate_pq_params(dim)
        check_pq_params(dim, m, nbits)
        self._nlist = nlist
        self._m = m
        self._nbits = nbits
        self._ksub = 1 << nbits
        self._dsub = dim // m
        self._store_originals = bool(store_originals)
        self._opq = bool(opq)
        self._opq_iters = int(opq_iters)
        self._rot: np.ndarray | None = None
        if not store_originals:
            self._store = SlotStore(0, device=self._device)
        self._codes = np.zeros((self._store.capacity, m), dtype=np.int32)
        self._assign = np.full(self._store.capacity, -1, dtype=np.int32)
        self._centroids: np.ndarray | None = None
        self._codebooks: np.ndarray | None = None
        self._trained = False
        self._reset_device()

    def _reset_device(self) -> None:
        """Drop every device copy (a new model or a new store)."""
        self._dev_model = None          # (centroids, codebooks, rot, user centroids)
        self._walk_version = -1         # the walk's lists and codes
        self._walk = None
        self._dense_version = -1        # the dense route's reconstruction
        self._dense = None
        self._sparse_version = -1       # the sparse route's cluster-major copy
        self._sparse = None
        self._sparse_S_hint: dict = {}  # (nprobe, k_pad) -> learned S
        self._order_key = None

    @classmethod
    def load_reference_state(
        cls,
        ids: np.ndarray,
        codes: np.ndarray,
        assign: np.ndarray,
        valid: np.ndarray,
        n: int,
        centroids: np.ndarray,
        codebooks: np.ndarray,
        rot: np.ndarray | None = None,
        vectors: np.ndarray | None = None,
        distance_kind: DistanceKind = DistanceKind.L2,
        *,
        device="cuda",
    ) -> "IVFPQIndex":
        """A trained index holding the state of a comet_tpu IVFPQ index:
        its slot store's `ids`, `valid` and `n` (soft-deleted slots
        included) and, with store_originals, its preprocessed `vectors`;
        its per-slot `codes` and `assign`, its `centroids` [nlist, d],
        `codebooks` [M, Ksub, dsub] and OPQ rotation `rot` or None."""
        centroids = np.array(centroids, dtype=np.float32)
        codebooks = np.array(codebooks, dtype=np.float32)
        m, ksub, _ = codebooks.shape
        idx = cls(centroids.shape[1], distance_kind, nlist=len(centroids), m=m,
                  nbits=ksub.bit_length() - 1, store_originals=vectors is not None,
                  opq=rot is not None, device=device)
        stored = (np.asarray(vectors, dtype=np.float32) if vectors is not None
                  else np.zeros((len(ids), 0), np.float32))
        idx._store.load(ids, stored, valid, n)
        idx._codes = np.zeros((idx._store.capacity, m), dtype=np.int32)
        idx._codes[:n] = np.asarray(codes)[:n]
        idx._assign = np.full(idx._store.capacity, -1, dtype=np.int32)
        idx._assign[:n] = np.asarray(assign)[:n]
        idx._centroids, idx._codebooks = centroids, codebooks
        idx._rot = None if rot is None else np.array(rot, dtype=np.float32)
        idx._trained = True
        return idx

    # -- contracts -----------------------------------------------------------

    def kind(self) -> VectorIndexKind:
        return VectorIndexKind.IVFPQ

    def trained(self) -> bool:
        return self._trained

    @property
    def nlist(self) -> int:
        return self._nlist

    @property
    def m(self) -> int:
        return self._m

    @property
    def nbits(self) -> int:
        return self._nbits

    def default_nprobes(self) -> int:
        return max(int(math.sqrt(self._nlist)), 1)

    # -- training --------------------------------------------------------------

    def train(self, vectors: np.ndarray, max_iter: int = 20) -> None:
        """Coarse k-means + shared PQ codebooks on the residuals
        (ivfpq_index.go:164-259), on the index's device; needs at least
        nlist * 10 vectors. With OPQ the rotation is learned first."""
        vectors = np.atleast_2d(np.asarray(vectors, dtype=np.float32))
        self._check_dim(vectors)
        if len(vectors) < self._nlist * 10:
            raise InvalidConfigError(
                f"need at least {self._nlist * 10} training vectors "
                f"(nlist*10), got {len(vectors)}"
            )
        y = torch.from_numpy(preprocess(vectors, self._distance_kind)).to(self._device)
        rot = self._train_opq(y, max_iter) if self._opq else None
        z = y if rot is None else f32_matmul(y, torch.from_numpy(rot.T.copy()).to(self._device))
        centroids, codebooks = kmeans_ivfpq_train(z, self._nlist, self._distance_kind,
                                                  self._m, self._ksub, max_iter)
        with self._lock:
            self._rot = rot
            self._centroids = centroids.cpu().numpy()
            self._codebooks = codebooks.cpu().numpy()
            self._trained = True
            self._reset_device()

    def _train_opq(self, y: torch.Tensor, max_iter: int) -> np.ndarray:
        """OPQ rotation whose model is a coarse + PQ fit (ivfpq.py:330-384)."""
        inner = max(2, min(4, max_iter))
        kind = self._distance_kind

        def fit(z):
            return kmeans_ivfpq_train(z, self._nlist, kind, self._m, self._ksub, inner)

        def reconstruct(zc, model):
            cent, books = model
            assign, codes = ivfpq_assign_encode(zc, cent, books, kind)
            return cent[assign] + pq_decode(codes, books)

        return opq_rotation(y, self._opq_iters, fit, reconstruct)

    # -- mutation --------------------------------------------------------------

    def add(self, node: VectorNode) -> None:
        self.add_batch(np.asarray(node.vector, dtype=np.float32)[None, :], [node.id])

    def add_batch(self, vectors: np.ndarray, ids: Iterable[int] | None = None) -> list[int]:
        """Assign each vector to its nearest centroid and encode its
        residual (ivfpq_index.go:279-319), on the index's device."""
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
        cents, books, rot, _ = self._device_model()
        assign, codes = ivfpq_assign_encode(torch.from_numpy(prepped).to(self._device), cents,
                                            books, self._distance_kind, rot)
        assign, codes = assign.cpu().numpy().astype(np.int32), codes.cpu().numpy()
        with self._lock:
            for i in id_arr.tolist():
                if self._store.contains(i):
                    raise InvalidConfigError(f"duplicate node ID {i}")
            stored = (prepped if self._store_originals
                      else np.zeros((len(id_arr), 0), dtype=np.float32))
            slots = self._store.add_batch(id_arr, stored)
            if self._store.capacity > len(self._codes):
                grown_c = np.zeros((self._store.capacity, self._m), dtype=np.int32)
                grown_c[: len(self._codes)] = self._codes
                self._codes = grown_c
                grown_a = np.full(self._store.capacity, -1, dtype=np.int32)
                grown_a[: len(self._assign)] = self._assign
                self._assign = grown_a
            self._codes[slots] = codes
            self._assign[slots] = assign
        return id_arr.tolist()

    def remove(self, node_id: int) -> None:
        with self._lock:
            self._store.remove(node_id)

    def flush(self) -> None:
        with self._lock:
            keep = self._store.flush()
            self._codes[: len(keep)] = self._codes[keep]
            self._codes[len(keep):] = 0
            kept_assign = self._assign[keep]
            self._assign[: len(kept_assign)] = kept_assign
            self._assign[len(kept_assign):] = -1

    # -- search caches ---------------------------------------------------------

    def _decode(self, slot: int) -> np.ndarray:
        """Reconstruction of one slot in user coordinates."""
        resid = pq_decode(torch.from_numpy(self._codes[slot][None, :]),
                          torch.from_numpy(self._codebooks)).numpy()[0]
        rec = self._centroids[self._assign[slot]] + resid
        if self._rot is not None:
            rec = rec @ self._rot.T  # model space -> user space
        return rec

    def _lookup_node_vectors(self, node_ids):
        out = []
        for node_id in node_ids:
            slot = self._store.id_to_slot.get(int(node_id))
            if slot is None:
                raise NodeNotFoundError(f"node ID {node_id} not found in index")
            out.append(np.array(self._store.vectors[slot]) if self._store_originals
                       else self._decode(slot))
        return out

    def _result_node(self, node_id: int) -> VectorNode:
        slot = self._store.id_to_slot[int(node_id)]
        if self._store_originals:
            return VectorNode(node_id, np.array(self._store.vectors[slot]))
        return VectorNode(node_id, self._decode(slot))

    def _device_model(self):
        """(centroids, codebooks, rotation or None, the centroids in user
        coordinates) on the device, uploaded once per model."""
        if self._dev_model is None:
            cents = torch.from_numpy(self._centroids).to(self._device)
            rot = None if self._rot is None else torch.from_numpy(self._rot).to(self._device)
            # OPQ: the coarse centroids rotate back with the reconstructions
            # (ivfpq.py:551-560), so user-space queries probe in user space
            cents_user = cents if rot is None else f32_matmul(cents, rot)
            self._dev_model = (cents, torch.from_numpy(self._codebooks).to(self._device),
                               rot, cents_user)
        return self._dev_model

    def _reconstruct(self, n: int) -> torch.Tensor:
        """[n, d] reconstructions of slots [0, n) in user coordinates:
        centroid + decoded residual, rotated back under OPQ."""
        cents, books, rot, _ = self._device_model()
        codes = codes_to_device(self._codes[:n], self._ksub, self._device)
        assign = torch.from_numpy(self._assign[:n]).to(self._device).long()
        rec = pq_decode(codes, books) + cents[assign.clamp_min(0)]
        return rec if rot is None else f32_matmul(rec, rot)

    def _device_dense(self):
        """(reconstruction [cap, d], its squared norms, assign [cap] int32)
        for the dense route, once per store version (ivfpq.py:523-587)."""
        if self._dense_version != self._store.version:
            self._dense = None   # free the old copy before the new one
            rec = self._reconstruct(self._store.capacity)
            assign = torch.from_numpy(self._assign[: self._store.capacity].copy()).to(self._device)
            self._dense = (rec, (rec * rec).sum(dim=1), assign)
            self._dense_version = self._store.version
        return self._dense

    def _device_sparse(self) -> dict:
        """Cluster-major reconstruction for the block-sparse scan, in user
        coordinates (ivfpq.py:589-655): the IVF layout of indexes/ivf.py
        over the reconstructions. Soft-deleted slots are left out."""
        _, _, _, cents_user = self._device_model()
        if self._order_key is None:
            self._order_key = torch.from_numpy(
                sp.cluster_order_key(cents_user.cpu().numpy(), device=self._device)
            ).to(self._device)
        if self._sparse_version != self._store.version:
            self._sparse = None   # free the old layout before the new one
            n = self._store.n
            assign = np.where(self._store.valid[:n], self._assign[:n], -1).astype(np.int32)
            lay = sp.build_cluster_major(assign, self._nlist)
            perm = torch.from_numpy(lay["perm"]).to(self._device)
            pc = perm.clamp_min(0).long()
            rows = self._reconstruct(n)[pc] if n else torch.zeros(
                (len(pc), self._dim), dtype=torch.float32, device=self._device)
            sqn = (rows * rows).sum(dim=1)
            self._sparse_S_hint.clear()  # budgets learned on the old layout
            self._sparse = {
                "corpus": rows,
                "mask_vec": torch.where(perm >= 0, sqn, torch.full_like(sqn, INF)),
                "row_slot": perm,
                "pc": pc,
                "chunk_start": torch.from_numpy(lay["chunk_start"]).to(self._device),
                "nchunks": torch.from_numpy(lay["nchunks"]).to(self._device),
                "nch_total": int(lay["chunk_start"][-1]),
                "max_chunks": lay["max_chunks"],
            }
            self._sparse_version = self._store.version
        return self._sparse

    def _device_walk(self):
        """(chunk_slots, chunk_start, most chunks of a list, codes [cap, M])
        for the LUT walk, once per store version (ivfpq.py:491-513)."""
        if self._walk_version != self._store.version:
            n = self._store.n
            chunk_slots, chunk_start, max_chunks = build_chunked_lists(self._assign[:n],
                                                                       self._nlist)
            self._walk = (torch.from_numpy(chunk_slots).to(self._device),
                          torch.from_numpy(chunk_start).to(self._device), max_chunks,
                          codes_to_device(self._codes, self._ksub, self._device))
            self._walk_version = self._store.version
        return self._walk

    # -- search ---------------------------------------------------------------

    def _sanitize_nprobes(self, nprobes: int | None) -> int:
        if nprobes is None:
            nprobes = self.default_nprobes()
        if nprobes <= 0 or nprobes > self._nlist:
            nprobes = self._nlist
        return nprobes

    def _refine_on_device(self, q, s, i, take, k_eff):
        """The scan routes' nrefine: `_refine_device` of the top `take`."""
        vecs = self._store.device_state()[0]
        return _refine_device(q, i[:, :take].contiguous(), vecs, k_eff, self._distance_kind)

    def _launch_sparse(self, q, k_pad, k_eff, take, nrefine, nprobe, builder, qprep,
                       S_override=None):
        """Block-sparse scan of the reconstruction + the optional device
        re-rank; the overflow counts ride the handle and `_search_collect`
        rescans with a larger budget, as indexes/ivf.py does."""
        st = self._device_sparse()
        _, _, _, cents_user = self._device_model()
        thr = threshold_scalar(builder._threshold)
        mask_vec = st["mask_vec"]
        if DocumentFilter(builder._document_ids).enabled:
            ok = self._slot_ok(builder)[st["pc"]] & (st["row_slot"] >= 0)
            mask_vec = torch.where(ok, mask_vec, torch.full_like(mask_vec, INF))
        S, UC, MC = sp.default_budgets(nprobe, self._nlist, st["nch_total"], st["max_chunks"])
        S = max(S, self._sparse_S_hint.get((nprobe, k_pad), 0))
        S_max = 1 << max(int(st["nch_total"] - 1).bit_length(), 5)
        if S_override is not None:
            S = max(S_override, S)
        S = min(S, S_max)
        UC = min(S, self._nlist)
        # an nrefine shortlist is re-rank input: cap the kept groups
        kb_cap = max(next_pow2(k_eff), 64) if nrefine else 0
        s, i, overflow = sp.ivf_sparse_pipeline(
            q, st["corpus"], mask_vec, st["row_slot"], thr * thr, cents_user,
            self._order_key, st["chunk_start"], st["nchunks"],
            k=k_pad, nprobe=nprobe, S=S, UC=UC, MC=MC, nlist=self._nlist,
            coarse_cosine=self._distance_kind == DistanceKind.COSINE, cosine=False,
            sqrt_out=True, kb_cap=kb_cap,
        )
        take_out, nrefine_out = take, nrefine
        if nrefine:
            s, i = self._refine_on_device(q, s, i, take, k_eff)
            take_out, nrefine_out = k_eff, 0
        kb = sp.select_groups(k_pad, kb_cap)
        S_eff = max(S, -(-kb * sp.SEL_GROUP // sp.CHUNK))
        retry = ((q, k_pad, k_eff, take, nrefine, nprobe, builder, qprep, S_eff, S_max)
                 if S_eff < S_max else None)
        return ("sparse", s if builder._wire_scores else None, i, take_out, nrefine_out,
                k_eff, qprep, self._store.ids, overflow, retry)

    def _search_launch(self, queries: np.ndarray, builder: VectorSearchBuilder):
        if not self._trained:
            raise NotTrainedError("index must be trained before searching")
        store = self._store
        if store.n == 0:
            return ("empty", queries.shape[0])
        k_eff = sanitize_k(builder._k, store.n)
        nrefine = 0
        if builder._nrefine and self._store_originals:
            nrefine = max(int(builder._nrefine), k_eff)
        k_pad = min(next_pow2(max(k_eff, nrefine)), store.capacity)
        nprobe = self._sanitize_nprobes(builder._nprobes)
        take = max(k_eff, nrefine)
        cosine = self._distance_kind == DistanceKind.COSINE
        thr = threshold_scalar(builder._threshold)
        qprep = preprocess(queries, self._distance_kind)
        q = torch.as_tensor(qprep, device=self._device)

        decoded_fits = store.capacity * self._dim * 4 <= pq.DECODED_BYTES_MAX
        sparse_env = os.environ.get("COMET_IVFPQ_SPARSE", "")
        use_sparse = (
            decoded_fits
            and sparse_env != "0"
            and (store.capacity >= SPARSE_MIN_CAPACITY or sparse_env == "1")
            and self._nlist >= 8
            and nprobe < self._nlist
            and k_pow2(k_pad) <= KP_MAX
        )
        if use_sparse and self._sparse is not None:
            # a learned budget near the table: the dense scan does the same
            # work without the gathers (indexes/ivf.py)
            if 2 * self._sparse_S_hint.get((nprobe, k_pad), 0) >= self._sparse["nch_total"]:
                use_sparse = False
        if use_sparse:
            return self._launch_sparse(q, k_pad, k_eff, take, nrefine, nprobe, builder, qprep)
        if decoded_fits:
            rec, sqn, assign = self._device_dense()
            ok = self._slot_ok(builder)
            mask = torch.where(ok, sqn, torch.full_like(sqn, INF))
            kb_cap = max(next_pow2(k_eff), 64) if nrefine else 0
            s, i = ivf_topk_pipeline(q, rec, mask, thr * thr, self._device_model()[3], assign,
                                     k_pad, nprobe, coarse_cosine=cosine, cosine=False,
                                     sqrt_out=True, kb_cap=kb_cap)
            if nrefine:
                s, i = self._refine_on_device(q, s, i, take, k_eff)
                take, nrefine = k_eff, 0
            return ("dev", s if builder._wire_scores else None, i, take, nrefine, k_eff,
                    qprep, store.ids)
        # the LUT walk: centroids and codebooks live in model space
        cents, books, rot, _ = self._device_model()
        qm = q if rot is None else f32_matmul(q, rot.T)
        chunk_slots, chunk_start, max_chunks, codes = self._device_walk()
        ok = self._slot_ok(builder)
        max_steps = next_pow2(nprobe * max_chunks, 4)
        outs = [_ivfpq_walk(qm[q0:q0 + IVFPQ_QUERY_CHUNK], cents, books, chunk_slots,
                            chunk_start, codes, ok, thr, k_pad, self._distance_kind, nprobe,
                            max_steps)
                for q0 in range(0, qm.shape[0], IVFPQ_QUERY_CHUNK)]
        s, i = torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])
        return ("dev", s if builder._wire_scores else None, i, take, nrefine, k_eff, qprep,
                store.ids)

    def _search_collect(self, handle):
        if handle[0] == "empty":
            q = handle[1]
            return (np.full((q, 0), INVALID_ID, dtype=np.uint32),
                    np.zeros((q, 0), dtype=np.float32))
        if handle[0] == "sparse":
            (_, s, i, take, nrefine, k_eff, qprep, ids_snap, overflow, retry) = handle
            ov = overflow.cpu().numpy()
            dropped = int(ov.sum())
            # escalate the step budget past the worst group's want and
            # rescan until clean or capped at the table size
            while dropped > 0 and retry is not None:
                (q, k_pad, k_eff, take_r, nrefine_r, nprobe, builder, qprep, S_old,
                 S_max) = retry
                S_new = min(1 << int(S_old + int(ov.max()) - 1).bit_length(), S_max)
                if S_new <= S_old:
                    logger.warning("ivfpq sparse scan overflow at max budget: %d chunk(s)",
                                   dropped)
                    break
                logger.warning(
                    "ivfpq sparse scan overflow: %d chunk(s) dropped across %d group(s); "
                    "rescanning with S=%d (was %d)",
                    dropped, int((ov > 0).sum()), S_new, S_old,
                )
                self._sparse_S_hint[(nprobe, k_pad)] = S_new
                (_, s, i, take, nrefine, k_eff, qprep, ids_snap, overflow,
                 retry) = self._launch_sparse(q, k_pad, k_eff, take_r, nrefine_r, nprobe,
                                              builder, qprep, S_override=S_new)
                ov = overflow.cpu().numpy()
                dropped = int(ov.sum())
            handle = ("dev", s, i, take, nrefine, k_eff, qprep, ids_snap)
        _, s, i, take, nrefine, k_eff, qprep, ids_snap = handle
        slots = i[:, :take].cpu().numpy()
        scores = (np.zeros(slots.shape, dtype=np.float32) if s is None
                  else s[:, :take].cpu().numpy())
        if nrefine:
            scores, slots = self._refine(qprep, slots, k_eff)
        else:
            scores, slots = scores[:, :k_eff], slots[:, :k_eff]
        hit = slots != IDX_SENTINEL
        ids = np.where(hit, ids_snap[np.where(hit, slots, 0)], INVALID_ID)
        return ids.astype(np.uint32), scores

    def _refine(self, queries, slots, k_eff):
        """Exact re-rank of the LUT walk's candidates on the stored
        originals, on the host (ivfpq.py:938-957)."""
        safe = np.where(slots != IDX_SENTINEL, slots, 0)
        vecs = self._store.vectors[safe]                 # [Q, C, d]
        if self._distance_kind == DistanceKind.COSINE:
            exact = 1.0 - np.clip(np.einsum("qd,qcd->qc", queries, vecs), -1.0, 1.0)
        else:
            diff = vecs - queries[:, None, :]
            exact = np.einsum("qcd,qcd->qc", diff, diff)
            if self._distance_kind == DistanceKind.L2:
                exact = np.sqrt(exact)
        exact = np.where(slots != IDX_SENTINEL, exact, np.inf).astype(np.float32)
        order = np.lexsort((slots, exact), axis=1)[:, :k_eff]
        return (np.take_along_axis(exact, order, axis=1),
                np.take_along_axis(slots, order, axis=1))

    # -- serialization ----------------------------------------------------------

    def write_to(self, f: BinaryIO) -> None:
        """CIPQ v3: params, the rotation, centroids and codebooks, then ids,
        codes, assignments and (store_originals) vectors, flushed, and a
        CRC32 trailer."""
        with self._lock:
            self.flush()
            w = serial.CrcWriter(f)
            serial.write_magic(w, MAGIC, VERSION)
            serial.write_str(w, self._distance_kind.value)
            serial.write_u32(w, self._dim)
            serial.write_u32(w, self._nlist)
            serial.write_u32(w, self._m)
            serial.write_u32(w, self._nbits)
            serial.write_u32(w, 1 if self._store_originals else 0)
            serial.write_u32(w, 1 if self._trained else 0)
            serial.write_u32(w, 1 if self._rot is not None else 0)
            if self._rot is not None:
                serial.write_array(w, self._rot)
            if self._trained:
                serial.write_array(w, self._centroids)
                serial.write_array(w, self._codebooks)
            n = self._store.n
            serial.write_u64(w, n)
            serial.write_array(w, self._store.ids[:n])
            code_dtype = np.uint8 if self._nbits <= 8 else np.uint32
            serial.write_array(w, self._codes[:n].astype(code_dtype))
            serial.write_array(w, self._assign[:n])
            if self._store_originals:
                serial.write_array(w, self._store.vectors[:n])
            w.seal()

    def read_from(self, f: BinaryIO) -> None:
        r = serial.CrcReader(f)
        version = serial.read_magic(r, MAGIC, VERSION)
        kind = DistanceKind(serial.read_str(r))
        dim = serial.read_u32(r)
        nlist = serial.read_u32(r)
        m = serial.read_u32(r)
        nbits = serial.read_u32(r)
        store_originals = bool(serial.read_u32(r))
        if kind != self._distance_kind or dim != self._dim:
            raise serial.SerializationError(
                f"param mismatch: index=({self._distance_kind.value}, dim={self._dim}), "
                f"stored=({kind.value}, dim={dim})"
            )
        if nlist != self._nlist or m != self._m or nbits != self._nbits:
            raise serial.SerializationError(
                f"IVFPQ param mismatch: index=(nlist={self._nlist}, M={self._m}, "
                f"Nbits={self._nbits}), stored=(nlist={nlist}, M={m}, Nbits={nbits})"
            )
        trained = bool(serial.read_u32(r))
        rot = None
        if version >= 3 and serial.read_u32(r):
            rot = serial.read_array(r).astype(np.float32)
        centroids = serial.read_array(r) if trained else None
        codebooks = serial.read_array(r) if trained else None
        n = serial.read_u64(r)
        ids = serial.read_array(r)
        codes = serial.read_array(r)
        assign = serial.read_array(r)
        vectors = serial.read_array(r) if store_originals else None
        if version >= 2:
            r.verify()
        if len(ids) != n or codes.shape != (n, m) or len(assign) != n:
            raise serial.SerializationError("corrupt IVFPQ index payload")
        with self._lock:
            self._store_originals = store_originals
            self._rot = rot
            self._opq = rot is not None
            self._centroids = centroids
            self._codebooks = codebooks
            self._trained = trained
            self._store = SlotStore(dim if store_originals else 0, capacity=max(n, 1),
                                    device=self._device)
            self._codes = np.zeros((self._store.capacity, self._m), dtype=np.int32)
            self._assign = np.full(self._store.capacity, -1, dtype=np.int32)
            if n:
                stored = (vectors.astype(np.float32) if store_originals
                          else np.zeros((n, 0), dtype=np.float32))
                slots = self._store.add_batch(ids.astype(np.uint32), stored)
                self._codes[slots] = codes.astype(np.int32)
                self._assign[slots] = assign.astype(np.int32)
            self._reset_device()
