"""PQ (product quantization) vector index.

Counterpart of comet_tpu/indexes/pq.py (pq_index.go and
pq_index_search.go of the Go reference): M subspaces x 2^Nbits codewords
trained per subspace, originals discarded after encoding, search by the
square root of the summed squared subspace distances, soft delete +
flush, thresholds / filters / aggregation / autocut / rerankers, the CPQX
v3 format (byte-identical to the reference package's; v2 and v1 files
read), `calculate_pq_params`, and the optional OPQ rotation, learned on
the device with a host float64 SVD.

Search takes one of two routes, on both devices, which give the same
neighbours (the ADC distance of a code IS the L2 distance to its decoded
vector) but not the same bits:

- dense: the decoded corpus, float32 in user coordinates, scanned by the
  flat pipeline (ops/fused_scan.flat_topk_pipeline: K2 and K1 on the
  card) with the reconstructions' squared norms as the mask, the
  threshold squared and the square root taken at the end. Taken while the
  decoded corpus fits DECODED_BYTES_MAX.
- ADC (ops/adc.adc_topk): per-query tables of squared subspace distances
  summed over the codes, in model coordinates, with K1's selects. It keeps
  no float32 reconstruction on the device (16 bytes a row at M = 16,
  against 512 for the decoded corpus at d = 128): past the cap it serves.

DECODED_BYTES_MAX replaces the reference's TPU gates (capacity <= 2^21,
capacity % 2048, pq.py:386-391), which sized the scan for a 16 GB v5e: on
an 80 GB H100 the dense route holds the decoded corpus (capacity x d x 4
bytes) and, per 256-query chunk, the [256, capacity] float32 distance
tile (1 KiB a row): at d = 128 and 8 GiB of reconstruction, 16M rows, the
two take 24 GiB, under the half of the card the port gives one index's
resident tables (indexes/hnsw.BLOCKED_TABLE_BYTES_MAX).

Node-based queries and result nodes use the decoded vectors: the index
no longer has the originals, by design.
"""

from __future__ import annotations

from typing import BinaryIO, Iterable

import numpy as np
import torch

from comet_tpu_torch.core.limiter import sanitize_k
from comet_tpu_torch.core.node import VectorNode, reserve_node_ids
from comet_tpu_torch.indexes.base import (
    BaseVectorIndex,
    SlotStore,
    VectorSearchBuilder,
    collect_device_handle,
    next_pow2,
    threshold_scalar,
)
from comet_tpu_torch.io import serial
from comet_tpu_torch.ops.adc import adc_topk, build_lut, pq_decode, pq_encode
from comet_tpu_torch.ops.distance import f32_matmul, preprocess
from comet_tpu_torch.ops.fused_scan import flat_topk_pipeline
from comet_tpu_torch.ops.kmeans import kmeans_subspace
from comet_tpu_torch.types import (
    DistanceKind,
    InvalidConfigError,
    NodeNotFoundError,
    NotTrainedError,
    VectorIndexKind,
)

MAGIC = b"CPQX"
VERSION = 3  # v3: optional OPQ rotation; v2: CRC32 trailer (older readable)

PQ_QUERY_CHUNK = 256        # queries an ADC step
DECODED_BYTES_MAX = 8 << 30  # the dense route's decoded float32 corpus at most
OPQ_CHUNK = 1 << 17         # rows an OPQ Procrustes step encodes


def calculate_pq_params(dim: int) -> tuple[int, int]:
    """Recommended (M, Nbits) for a dimension (pq_index.go:50-67)."""
    m = 8
    if dim % m != 0:
        for m in range(8, 33):
            if dim % m == 0:
                break
        if dim % m != 0:
            m = 4
    return m, 8


def check_pq_params(dim: int, m: int, nbits: int) -> None:
    if m <= 0:
        raise InvalidConfigError("parameter M must be positive")
    if dim % m != 0:
        raise InvalidConfigError(f"dimension {dim} must be divisible by M {m}")
    if nbits <= 0 or nbits > 16:
        raise InvalidConfigError("parameter Nbits must be in [1,16]")


def codes_to_device(codes: np.ndarray, ksub: int, device) -> torch.Tensor:
    """Codes as they sit on the device: uint8 up to 256 codewords, else
    int32; consumers widen them on read."""
    dtype = np.uint8 if ksub <= 256 else np.int32
    return torch.from_numpy(np.ascontiguousarray(codes, dtype=dtype)).to(device)


def opq_rotation(y: torch.Tensor, iters: int, fit, reconstruct) -> np.ndarray:
    """The OPQ-NP alternation (Ge et al., CVPR 2013; pq.py:161-209,
    ivfpq.py:330-384): fit a model to the rotated rows, reconstruct them,
    and solve the orthogonal Procrustes problem R = U V^T of Y^T Yhat on
    the host in float64. `fit(z)` returns a model of the rotated rows z,
    `reconstruct(z_chunk, model)` their reconstructions."""
    d = y.shape[1]
    rot = np.eye(d, dtype=np.float32)
    for _ in range(max(iters, 1)):
        z = f32_matmul(y, torch.from_numpy(np.ascontiguousarray(rot.T)).to(y.device))
        model = fit(z)
        mm = np.zeros((d, d), np.float64)
        for lo in range(0, y.shape[0], OPQ_CHUNK):
            rec = reconstruct(z[lo:lo + OPQ_CHUNK], model)
            part = f32_matmul(y[lo:lo + OPQ_CHUNK].T.contiguous(), rec.T.contiguous())
            mm += part.cpu().numpy().astype(np.float64)
        u, _, vt = np.linalg.svd(mm)
        rot = (u @ vt).astype(np.float32)
    return rot


class PQIndex(BaseVectorIndex):
    """Product-quantization index (reference: pq_index.go:75-120).

    `device` is "cuda" (the default) or "cpu"."""

    def __init__(
        self,
        dim: int,
        distance_kind: DistanceKind = DistanceKind.L2,
        m: int | None = None,
        nbits: int = 8,
        opq: bool = False,
        opq_iters: int = 6,
        *,
        device="cuda",
    ):
        super().__init__(dim, distance_kind, device)
        if m is None:
            m, nbits = calculate_pq_params(dim)
        check_pq_params(dim, m, nbits)
        self._m = m
        self._nbits = nbits
        self._ksub = 1 << nbits
        self._dsub = dim // m
        # OPQ: the model lives in rotated coordinates, serving in user ones
        self._opq = bool(opq)
        self._opq_iters = int(opq_iters)
        self._rot: np.ndarray | None = None
        # a vector-less slot store: PQ keeps codes, not originals
        self._store = SlotStore(0, device=self._device)
        self._codes = np.zeros((self._store.capacity, m), dtype=np.int32)
        self._codebooks: np.ndarray | None = None  # [M, Ksub, dsub]
        self._trained = False
        self._dev_version = -1          # codes and model on the device
        self._dev_codes = self._dev_codebooks = self._dev_rot = None
        self._decoded_version = -1      # the dense route's reconstruction
        self._dev_rec = self._dev_rec_sqn = None

    @classmethod
    def load_reference_state(
        cls,
        ids: np.ndarray,
        codes: np.ndarray,
        valid: np.ndarray,
        n: int,
        codebooks: np.ndarray,
        rot: np.ndarray | None = None,
        distance_kind: DistanceKind = DistanceKind.L2,
        *,
        device="cuda",
    ) -> "PQIndex":
        """A trained index holding the state of a comet_tpu PQ index: its
        slot store's `ids`, `valid` and `n` (soft-deleted slots included),
        its per-slot `codes` [>= n, M], its `codebooks` [M, Ksub, dsub] and
        its OPQ rotation `rot` or None."""
        codebooks = np.array(codebooks, dtype=np.float32)
        m, ksub, dsub = codebooks.shape
        idx = cls(m * dsub, distance_kind, m=m, nbits=ksub.bit_length() - 1,
                  opq=rot is not None, device=device)
        idx._store.load(ids, np.zeros((len(ids), 0), np.float32), valid, n)
        idx._codes = np.zeros((idx._store.capacity, m), dtype=np.int32)
        idx._codes[:n] = np.asarray(codes)[:n]
        idx._codebooks = codebooks
        idx._rot = None if rot is None else np.array(rot, dtype=np.float32)
        idx._trained = True
        return idx

    # -- contracts -----------------------------------------------------------

    def kind(self) -> VectorIndexKind:
        return VectorIndexKind.PQ

    def trained(self) -> bool:
        return self._trained

    @property
    def m(self) -> int:
        return self._m

    @property
    def nbits(self) -> int:
        return self._nbits

    @property
    def ksub(self) -> int:
        return self._ksub

    # -- training --------------------------------------------------------------

    def train(self, vectors: np.ndarray, max_iter: int = 20) -> None:
        """Learn per-subspace codebooks (pq_index.go:74-127): k-means with
        L2^2 in each of the M subspaces, on the index's device; needs at
        least Ksub training vectors. With OPQ the rotation is learned first
        and the codebooks are trained on the rotated rows."""
        vectors = np.atleast_2d(np.asarray(vectors, dtype=np.float32))
        self._check_dim(vectors)
        if len(vectors) < self._ksub:
            raise InvalidConfigError(f"need at least {self._ksub} vectors for training")
        y = torch.from_numpy(preprocess(vectors, self._distance_kind)).to(self._device)
        rot = self._train_opq(y, max_iter) if self._opq else None
        z = y if rot is None else f32_matmul(y, torch.from_numpy(rot.T.copy()).to(self._device))
        codebooks, _ = kmeans_subspace(z.view(len(z), self._m, self._dsub), self._ksub, max_iter)
        with self._lock:
            self._rot = rot
            self._codebooks = codebooks.cpu().numpy()
            self._trained = True
            # codes of rows already added were made with the old model, as
            # in the reference: retraining is meant for an empty index
            self._dev_version = self._decoded_version = -1

    def _train_opq(self, y: torch.Tensor, max_iter: int) -> np.ndarray:
        """OPQ rotation whose model is the codebooks alone (pq.py:161-209)."""
        inner = max(2, min(4, max_iter))
        m, dsub = self._m, self._dsub

        def fit(z):
            return kmeans_subspace(z.view(len(z), m, dsub), self._ksub, inner)[0]

        def reconstruct(zc, books):
            return pq_decode(pq_encode(zc.view(len(zc), m, dsub), books), books)

        return opq_rotation(y, self._opq_iters, fit, reconstruct)

    # -- mutation --------------------------------------------------------------

    def add(self, node: VectorNode) -> None:
        self.add_batch(np.asarray(node.vector, dtype=np.float32)[None, :], [node.id])

    def add_batch(self, vectors: np.ndarray, ids: Iterable[int] | None = None) -> list[int]:
        """Encode to M codes per vector on the index's device and discard
        the originals (pq_index.go:249-262)."""
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
        x = torch.from_numpy(preprocess(vectors, self._distance_kind)).to(self._device)
        _, codebooks, rot = self._device_model()
        if rot is not None:
            x = f32_matmul(x, rot.T)          # user -> model coordinates
        codes = pq_encode(x.view(len(x), self._m, self._dsub), codebooks).cpu().numpy()
        with self._lock:
            for i in id_arr.tolist():
                if self._store.contains(i):
                    raise InvalidConfigError(f"duplicate node ID {i}")
            slots = self._store.add_batch(id_arr, np.zeros((len(id_arr), 0), dtype=np.float32))
            if self._store.capacity > len(self._codes):
                grown = np.zeros((self._store.capacity, self._m), dtype=np.int32)
                grown[: len(self._codes)] = self._codes
                self._codes = grown
            self._codes[slots] = codes
        return id_arr.tolist()

    def remove(self, node_id: int) -> None:
        with self._lock:
            self._store.remove(node_id)

    def flush(self) -> None:
        with self._lock:
            keep = self._store.flush()
            kept = self._codes[keep]
            self._codes[: len(kept)] = kept
            self._codes[len(kept):] = 0

    # -- search ---------------------------------------------------------------

    def _decode(self, codes: np.ndarray) -> np.ndarray:
        """Reconstructions of [B, M] codes in user coordinates."""
        rec = pq_decode(torch.from_numpy(codes), torch.from_numpy(self._codebooks)).numpy()
        if self._rot is not None:
            rec = rec @ self._rot.T  # model space -> user space
        return rec

    def _lookup_node_vectors(self, node_ids):
        """WithNode queries run on decoded vectors (originals discarded)."""
        out = []
        for node_id in node_ids:
            slot = self._store.id_to_slot.get(int(node_id))
            if slot is None:
                raise NodeNotFoundError(f"node ID {node_id} not found in index")
            out.append(self._decode(self._codes[slot][None, :])[0])
        return out

    def _result_node(self, node_id: int) -> VectorNode:
        slot = self._store.id_to_slot[int(node_id)]
        return VectorNode(node_id, self._decode(self._codes[slot][None, :])[0])

    def _device_model(self):
        """(codes [cap, M], codebooks, rotation or None) on the device,
        uploaded once per store version."""
        if self._dev_version != self._store.version or self._dev_codebooks is None:
            self._dev_codes = codes_to_device(self._codes, self._ksub, self._device)
            self._dev_codebooks = torch.from_numpy(self._codebooks).to(self._device)
            self._dev_rot = (None if self._rot is None
                             else torch.from_numpy(self._rot).to(self._device))
            self._dev_version = self._store.version
        return self._dev_codes, self._dev_codebooks, self._dev_rot

    def _device_decoded(self):
        """The decoded corpus [cap, d] float32 in user coordinates and its
        squared norms, made on the device once per store version: the
        dense route's corpus (pq.py:310-346). The codes stay the index's
        record; this is a search-time cache."""
        if self._decoded_version != self._store.version:
            self._dev_rec = self._dev_rec_sqn = None   # free the old copy first
            codes, codebooks, rot = self._device_model()
            rec = pq_decode(codes, codebooks)
            if rot is not None:
                rec = f32_matmul(rec, rot)             # model -> user coordinates
            self._dev_rec, self._dev_rec_sqn = rec, (rec * rec).sum(dim=1)
            self._decoded_version = self._store.version
        return self._dev_rec, self._dev_rec_sqn

    def _search_launch(self, queries: np.ndarray, builder: VectorSearchBuilder):
        if not self._trained:
            raise NotTrainedError("index must be trained before searching")
        store = self._store
        if store.n == 0:
            return ("empty", queries.shape[0])
        k_eff = sanitize_k(builder._k, store.n)
        k_pad = min(next_pow2(k_eff), store.capacity)
        thr = threshold_scalar(builder._threshold)
        q = torch.as_tensor(preprocess(queries, self._distance_kind), device=self._device)
        ok = self._slot_ok(builder)
        id_map = store.device_id_map()
        if self._store.capacity * self._dim * 4 <= DECODED_BYTES_MAX:
            rec, sqn = self._device_decoded()
            # ADC is the square root of an L2 distance for every metric
            mask = torch.where(ok, sqn, torch.full_like(sqn, float("inf")))
            s, i = flat_topk_pipeline(q, rec, mask, thr * thr, k_pad, cosine=False,
                                      sqrt_out=True)
        else:
            codes, codebooks, rot = self._device_model()
            if rot is not None:
                q = f32_matmul(q, rot.T)            # ADC scores in model space
            outs = [adc_topk(build_lut(q[q0:q0 + PQ_QUERY_CHUNK].reshape(-1, self._m, self._dsub),
                                       codebooks), codes, ok, thr, k_pad)
                    for q0 in range(0, q.shape[0], PQ_QUERY_CHUNK)]
            s, i = torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])
        s, i = s[:, :k_eff], i[:, :k_eff]
        return ("dev", s if builder._wire_scores else None, i, id_map)

    def _search_collect(self, handle):
        return collect_device_handle(handle)

    # -- serialization ----------------------------------------------------------

    def write_to(self, f: BinaryIO) -> None:
        """CPQX v3: params, the rotation and codebooks, then ids and codes
        (flushed), and a CRC32 trailer."""
        with self._lock:
            self.flush()
            w = serial.CrcWriter(f)
            serial.write_magic(w, MAGIC, VERSION)
            serial.write_str(w, self._distance_kind.value)
            serial.write_u32(w, self._dim)
            serial.write_u32(w, self._m)
            serial.write_u32(w, self._nbits)
            serial.write_u32(w, 1 if self._trained else 0)
            serial.write_u32(w, 1 if self._rot is not None else 0)
            if self._rot is not None:
                serial.write_array(w, self._rot)
            if self._trained:
                serial.write_array(w, self._codebooks)
            n = self._store.n
            serial.write_u64(w, n)
            serial.write_array(w, self._store.ids[:n])
            code_dtype = np.uint8 if self._nbits <= 8 else np.uint32
            serial.write_array(w, self._codes[:n].astype(code_dtype))
            w.seal()

    def read_from(self, f: BinaryIO) -> None:
        r = serial.CrcReader(f)
        version = serial.read_magic(r, MAGIC, VERSION)
        kind = DistanceKind(serial.read_str(r))
        dim = serial.read_u32(r)
        m = serial.read_u32(r)
        nbits = serial.read_u32(r)
        if kind != self._distance_kind:
            raise serial.SerializationError(
                f"distance kind mismatch: index={self._distance_kind.value}, stored={kind.value}"
            )
        if dim != self._dim:
            raise serial.SerializationError(f"dimension mismatch: index={self._dim}, stored={dim}")
        if m != self._m or nbits != self._nbits:
            raise serial.SerializationError(
                f"PQ param mismatch: index=(M={self._m}, Nbits={self._nbits}), "
                f"stored=(M={m}, Nbits={nbits})"
            )
        trained = bool(serial.read_u32(r))
        rot = None
        if version >= 3 and serial.read_u32(r):
            rot = serial.read_array(r).astype(np.float32)
        codebooks = serial.read_array(r) if trained else None
        n = serial.read_u64(r)
        ids = serial.read_array(r)
        codes = serial.read_array(r)
        if version >= 2:
            r.verify()
        if len(ids) != n or codes.shape != (n, m):
            raise serial.SerializationError("corrupt PQ index payload")
        with self._lock:
            self._rot = rot
            self._opq = rot is not None
            self._codebooks = codebooks
            self._trained = trained
            self._store = SlotStore(0, capacity=max(n, 1), device=self._device)
            self._codes = np.zeros((self._store.capacity, self._m), dtype=np.int32)
            if n:
                slots = self._store.add_batch(ids.astype(np.uint32),
                                              np.zeros((n, 0), dtype=np.float32))
                self._codes[slots] = codes.astype(np.int32)
            # the new store restarts its version at 0: drop the device copies
            self._dev_version = self._decoded_version = -1
