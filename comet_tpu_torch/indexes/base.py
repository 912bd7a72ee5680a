"""Shared machinery for array-backed vector indexes.

Counterpart of comet_tpu/indexes/base.py. A padded slot store keeps the
host-canonical numpy arrays (power-of-two capacity, a validity mask for
soft deletes) and a device mirror of torch tensors on the index's device
(vectors, squared norms, valid mask), rebuilt only when the store's
`version` changes.

Every index runs on the card unless the caller asks for the CPU: `device`
defaults to "cuda", and "cpu" is the other choice. Nothing detects a card
or falls back to the CPU: without one, a CUDA index raises.

Every index exposes the reference's fluent search builder
(index_search.go:141-279 of the Go reference):
`.with_query(q).with_k(10).execute()`.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Iterable, Sequence

import numpy as np
import torch

from comet_tpu_torch.core.aggregation import aggregate_scores
from comet_tpu_torch.core.filter import DocumentFilter
from comet_tpu_torch.core.limiter import autocut, autocut_results, limit_results
from comet_tpu_torch.core.node import VectorNode
from comet_tpu_torch.core.results import Reranker, VectorResult
from comet_tpu_torch.ops.bitset import Bitset
from comet_tpu_torch.types import (
    DimensionMismatchError,
    DistanceKind,
    InvalidConfigError,
    NodeNotFoundError,
    ScoreAggregationKind,
)
from comet_tpu_torch.utils.memory import memory_report
from comet_tpu_torch.utils.profiling import count, count_h2d, span

MIN_CAPACITY = 1024
INVALID_ID = np.uint32(0xFFFFFFFF)


def next_pow2(x: int, minimum: int = 1) -> int:
    v = max(int(x), minimum)
    return 1 << (v - 1).bit_length()


def resolve_device(device) -> torch.device:
    """The index's device as given: "cpu" or a CUDA device. No detection,
    no fallback: a CUDA device without a card raises here."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise InvalidConfigError(f"device {dev} requested but no CUDA card is available")
    elif dev.type != "cpu":
        raise InvalidConfigError(f"unsupported device {dev} (use 'cpu' or 'cuda')")
    return dev


def _additive_mask(ok, sqnorms, cosine: bool):
    """Kernel mask: L2 -> squared norms, cosine -> 0; +inf where not ok."""
    base = torch.zeros_like(sqnorms) if cosine else sqnorms
    return torch.where(ok, base, torch.full_like(base, float("inf")))


def _words_ok(words32, ids, valid):
    """Validity and the doc-ID filter expanded from packed 32-bit words (bit
    i of word w = doc 32w + i), as [cap] bool. Ids beyond the words' span
    are excluded. `words32` is an int64 tensor of the unsigned words, `ids`
    the slots' uint32 ids' bits as int32."""
    n_words = words32.shape[0]
    widx = (ids >> 5) & 0x07FFFFFF     # the unsigned id's shift: no sign bits
    in_range = widx < n_words
    w = words32.index_select(0, widx.clamp(max=n_words - 1))
    fbit = (w >> (ids & 31)) & 1
    return valid & in_range & (fbit == 1)


class SlotStore:
    """Padded host-canonical vector storage with soft deletes.

    Slots [0, n) are occupied (possibly soft-deleted); [n, capacity) are free
    padding. `valid[slot]` False means deleted-or-padding. The device mirror
    follows `version`: an add or a remove writes its rows into a current
    mirror in place; a flush, a load or a capacity growth leaves it to be
    uploaded whole at the next `device_state`. The ids' device copy
    (`device_id_map`), which maps result slots and expands the doc-ID
    filter, follows `version` the same way.
    """

    def __init__(self, dim: int, capacity: int = MIN_CAPACITY, *, device: torch.device):
        self.dim = dim
        self.device = device
        self.capacity = next_pow2(capacity, MIN_CAPACITY)
        self.vectors = np.zeros((self.capacity, dim), dtype=np.float32)
        self.ids = np.zeros(self.capacity, dtype=np.uint32)
        self.valid = np.zeros(self.capacity, dtype=bool)
        self.n = 0
        self.id_to_slot: dict[int, int] = {}
        self.deleted = 0
        self.version = 0
        self._dev_version = -1
        self._dev = None  # (vectors, sqnorms, valid) tensors on self.device
        self._id_map_version = -1
        self._id_map = None  # int32 [capacity + 1] on self.device

    # -- mutation ----------------------------------------------------------

    def _grow_to(self, needed: int) -> None:
        new_cap = next_pow2(needed, MIN_CAPACITY)
        if new_cap <= self.capacity:
            return
        vectors = np.zeros((new_cap, self.dim), dtype=np.float32)
        vectors[: self.n] = self.vectors[: self.n]
        ids = np.zeros(new_cap, dtype=np.uint32)
        ids[: self.n] = self.ids[: self.n]
        valid = np.zeros(new_cap, dtype=bool)
        valid[: self.n] = self.valid[: self.n]
        self.vectors, self.ids, self.valid = vectors, ids, valid
        self.capacity = new_cap

    def add_batch(self, ids: np.ndarray, vectors: np.ndarray) -> np.ndarray:
        """Append preprocessed vectors; returns the assigned slots."""
        b = len(ids)
        if b > 1 and len(np.unique(ids)) != b:
            raise InvalidConfigError("duplicate node IDs within batch")
        self._grow_to(self.n + b)
        slots = np.arange(self.n, self.n + b)
        self.vectors[slots] = vectors
        self.ids[slots] = ids
        self.valid[slots] = True
        for i, s in zip(ids.tolist(), slots.tolist()):
            self.id_to_slot[i] = s
        self.n += b
        self.version += 1
        self._sync_rows(slots)
        return slots

    def load(self, ids: np.ndarray, vectors: np.ndarray, valid: np.ndarray, n: int) -> None:
        """Replace the contents with another store's host arrays, soft-deleted
        slots included: slot s < n holds ids[s], vectors[s], live if valid[s]."""
        ids = np.asarray(ids, dtype=np.uint32)
        vectors = np.asarray(vectors, dtype=np.float32)
        valid = np.asarray(valid, dtype=bool)
        n = int(n)
        if vectors.ndim != 2 or vectors.shape[1] != self.dim:
            raise DimensionMismatchError(
                f"vector dimension mismatch: expected {self.dim}, got {vectors.shape}"
            )
        if not (n <= len(ids) and n <= len(vectors) and n <= len(valid)):
            raise InvalidConfigError(f"n={n} exceeds the arrays given")
        live = np.flatnonzero(valid[:n])
        if len(np.unique(ids[live])) != len(live):
            raise InvalidConfigError("duplicate live node IDs")
        self.capacity = next_pow2(max(n, len(ids)), MIN_CAPACITY)
        self.vectors = np.zeros((self.capacity, self.dim), dtype=np.float32)
        self.ids = np.zeros(self.capacity, dtype=np.uint32)
        self.valid = np.zeros(self.capacity, dtype=bool)
        self.vectors[:n] = vectors[:n]
        self.ids[:n] = ids[:n]
        self.valid[:n] = valid[:n]
        self.n = n
        self.deleted = n - len(live)
        self.id_to_slot = {int(self.ids[s]): int(s) for s in live.tolist()}
        self.version += 1

    def remove(self, node_id: int) -> None:
        """Soft delete (reference: roaring deletedNodes bitmap, flat_index.go:89)."""
        slot = self.id_to_slot.pop(int(node_id), None)
        if slot is None:
            raise NodeNotFoundError(f"node ID {node_id} not found in index")
        self.valid[slot] = False
        self.deleted += 1
        self.version += 1
        self._sync_rows(np.array([slot]))

    def flush(self) -> np.ndarray:
        """Hard-delete: compact live slots to the front (flat_index.go:266-299).
        Returns the old slots of the kept rows, in their new order."""
        keep = np.flatnonzero(self.valid[: self.n])
        m = len(keep)
        self.vectors[:m] = self.vectors[keep]
        self.vectors[m : self.n] = 0.0
        self.ids[:m] = self.ids[keep]
        self.ids[m : self.n] = 0
        self.valid[:m] = True
        self.valid[m : self.n] = False
        self.n = m
        self.deleted = 0
        self.id_to_slot = {int(i): s for s, i in enumerate(self.ids[:m].tolist())}
        self.version += 1
        return keep

    # -- queries -----------------------------------------------------------

    def contains(self, node_id: int) -> bool:
        return int(node_id) in self.id_to_slot

    def get_vector(self, node_id: int) -> np.ndarray:
        slot = self.id_to_slot.get(int(node_id))
        if slot is None:
            raise NodeNotFoundError(f"node ID {node_id} not found in index")
        return self.vectors[slot]

    @property
    def live_count(self) -> int:
        return self.n - self.deleted

    def _sync_rows(self, slots: np.ndarray) -> None:
        """After one mutation of `slots`: write their rows (vector, squared
        norm, validity; id) into each mirror in place when it was current
        before it and the capacity is unchanged, and keep it current."""
        sync_dev = (self._dev is not None and self._dev_version == self.version - 1
                    and self._dev[0].shape[0] == self.capacity)
        sync_map = (self._id_map is not None and self._id_map_version == self.version - 1
                    and self._id_map.shape[0] == self.capacity + 1)
        if not (sync_dev or sync_map):
            return
        rows = torch.from_numpy(np.asarray(slots, dtype=np.int64)).to(self.device)
        if sync_dev:
            vecs, sqnorms, valid = self._dev
            v = torch.from_numpy(self.vectors[slots]).to(self.device)
            vecs[rows] = v
            sqnorms[rows] = (v * v).sum(dim=1)
            valid[rows] = torch.from_numpy(self.valid[slots]).to(self.device)
            self._dev_version = self.version
        if sync_map:
            self._id_map[rows] = torch.from_numpy(self.ids[slots].view(np.int32)).to(self.device)
            self._id_map_version = self.version

    def device_state(self):
        """Device mirror (vectors [cap, d], sqnorms [cap], valid [cap]),
        uploaded whole when it is not current."""
        if self._dev_version != self.version:
            self._dev = None  # free the old mirror before the new upload
            count_h2d(self.vectors.nbytes + self.valid.nbytes, self.device)
            vecs = torch.from_numpy(self.vectors).to(self.device, copy=True)
            sqnorms = (vecs * vecs).sum(dim=1)
            valid = torch.from_numpy(self.valid).to(self.device, copy=True)
            self._dev = (vecs, sqnorms, valid)
            self._dev_version = self.version
        return self._dev

    def device_id_map(self) -> torch.Tensor:
        """The slot -> id map on the device, for mapping result slots and
        expanding the doc-ID filter: the uint32 ids' bits as int32
        [capacity + 1], whose last entry, -1, is INVALID_ID's bits for an
        empty result slot. An add writes its rows in place, at slots no
        earlier search can return (a remove rewrites its row unchanged);
        any other change uploads a new tensor, so a pending search keeps
        the ids it was launched with."""
        if self._id_map_version != self.version:
            self._id_map = None  # free the old map before the new upload
            ids = np.append(self.ids, INVALID_ID).view(np.int32)
            count_h2d(ids.nbytes, self.device)
            self._id_map = torch.from_numpy(ids).to(self.device, copy=True)
            self._id_map_version = self.version
        return self._id_map


class VectorSearchBuilder:
    """Fluent search builder shared by all vector indexes
    (reference: index_search.go:141-279)."""

    def __init__(self, index):
        self._index = index
        self._queries: list[np.ndarray] = []
        self._node_ids: list[int] = []
        self._k = 10
        self._threshold = 0.0
        self._cutoff = -1
        self._aggregation = ScoreAggregationKind.SUM
        self._document_ids: list[int] | Bitset | None = None
        self._reranker: Reranker | None = None
        # per-index knobs, validated by the index that reads them
        self._nprobes: int | None = None      # IVF
        self._ef_search: int | None = None    # HNSW
        self._nrefine: int | None = None      # IVFPQ
        # batch-API control: False skips copying the scores to the host
        self._wire_scores = True

    def with_query(self, query) -> "VectorSearchBuilder":
        self._queries.append(np.asarray(query, dtype=np.float32))
        return self

    def with_queries(self, queries) -> "VectorSearchBuilder":
        for q in queries:
            self.with_query(q)
        return self

    def with_node(self, node_id: int) -> "VectorSearchBuilder":
        self._node_ids.append(int(node_id))
        return self

    def with_nodes(self, node_ids: Iterable[int]) -> "VectorSearchBuilder":
        self._node_ids.extend(int(i) for i in node_ids)
        return self

    def with_k(self, k: int) -> "VectorSearchBuilder":
        self._k = int(k)
        return self

    def with_threshold(self, threshold: float) -> "VectorSearchBuilder":
        self._threshold = float(threshold)
        return self

    def with_cutoff(self, cutoff: int) -> "VectorSearchBuilder":
        self._cutoff = int(cutoff)
        return self

    def with_score_aggregation(self, kind: ScoreAggregationKind) -> "VectorSearchBuilder":
        self._aggregation = ScoreAggregationKind(kind)
        return self

    def with_document_ids(self, document_ids) -> "VectorSearchBuilder":
        """Accepts an iterable of IDs or a packed Bitset (stays packed)."""
        if isinstance(document_ids, Bitset):
            self._document_ids = document_ids
        else:
            self._document_ids = [int(i) for i in document_ids]
        return self

    def with_reranker(self, reranker: Reranker) -> "VectorSearchBuilder":
        self._reranker = reranker
        return self

    def with_nprobes(self, nprobes: int) -> "VectorSearchBuilder":
        self._nprobes = int(nprobes)
        return self

    def with_ef_search(self, ef_search: int) -> "VectorSearchBuilder":
        """Per-query beam width override (HNSW; 0 = the index default)."""
        self._ef_search = int(ef_search)
        return self

    def with_nrefine(self, nrefine: int) -> "VectorSearchBuilder":
        """Exact re-ranking of the top `nrefine` ADC candidates (IVFPQ with
        store_originals=True). The Go reference's README promises this knob
        but its code never implements it (README.md:1779)."""
        self._nrefine = int(nrefine)
        return self

    def execute(self) -> list[VectorResult]:
        return self._index._execute_search(self)


class BaseVectorIndex:
    """Common behaviour of the array-backed indexes: node-based queries, the
    aggregate -> limit -> autocut -> rerank pipeline
    (flat_index_search.go:109-165) and the soft-delete bookkeeping.

    Subclasses implement `_search_launch`, which enqueues the device work
    and returns a handle holding device tensors, and `_search_collect`,
    which brings a handle's results to the host as (ids, scores)."""

    def __init__(self, dim: int, distance_kind: DistanceKind, device="cuda"):
        if dim <= 0:
            raise InvalidConfigError(f"dimension must be positive, got {dim}")
        self._dim = dim
        self._distance_kind = DistanceKind(distance_kind)
        self._device = resolve_device(device)
        self._store = SlotStore(dim, device=self._device)
        self._lock = threading.RLock()

    # -- contracts (index.go:32-63) -----------------------------------------

    def dimensions(self) -> int:
        return self._dim

    def distance_kind(self) -> DistanceKind:
        return self._distance_kind

    def trained(self) -> bool:
        return True

    def count(self) -> int:
        """Live (non-deleted) vector count."""
        with self._lock:
            return self._store.live_count

    def stats(self) -> dict:
        """Observability snapshot."""
        with self._lock:
            s = self._store
            return {
                "kind": self.kind().value,
                "dim": self._dim,
                "distance": self._distance_kind.value,
                "device": str(self._device),
                "live": s.live_count,
                "soft_deleted": s.deleted,
                "capacity": s.capacity,
                "host_bytes": int(s.vectors.nbytes + s.ids.nbytes + s.valid.nbytes),
                "device_synced": s._dev_version == s.version,
                "memory": memory_report(self),
            }

    def new_search(self) -> VectorSearchBuilder:
        return VectorSearchBuilder(self)

    def search_batch(
        self,
        queries: np.ndarray,
        k: int = 10,
        *,
        threshold: float = 0.0,
        document_ids: Iterable[int] | Bitset | None = None,
        nprobes: int | None = None,
        ef_search: int | None = None,
        nrefine: int | None = None,
        aggregation=None,
        cutoff: int = -1,
        group_size: int = 1,
        wire_scores: bool = True,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Many independent queries in one step.

        Unlike the fluent builder (where multiple queries are AGGREGATED into
        one result list), each row here is its own query. Returns
        (ids [Q, k] uint32, scores [Q, k] float32); empty slots carry
        id == INVALID_ID and score == +inf. `cutoff` applies autocut to each
        output row; `group_size` > 1 aggregates each consecutive group of
        rows into one output row with `aggregation` (Sum by default).
        `wire_scores=False` leaves the scores on the device and returns zeros.
        `nprobes` is the IVF probe count, `ef_search` the HNSW beam width
        and `nrefine` the IVFPQ re-rank depth (other indexes ignore them).
        """
        with span("layer.vector.search_batch"):
            queries = np.atleast_2d(np.asarray(queries, dtype=np.float32))
            self._check_dim(queries)
            count("queries", len(queries))
            builder = self._make_batch_builder(k, threshold, document_ids, nprobes, ef_search,
                                               nrefine, cutoff, group_size, wire_scores)
            with self._lock:
                ids, scores = self._launch_collect(queries, builder)
            with span("layer.vector.results"):
                return _finish_rows(ids, scores, k, aggregation, cutoff, group_size)

    def search_stream(
        self,
        batches: Iterable[np.ndarray],
        k: int = 10,
        *,
        threshold: float = 0.0,
        document_ids: Iterable[int] | Bitset | None = None,
        nprobes: int | None = None,
        ef_search: int | None = None,
        nrefine: int | None = None,
        depth: int = 2,
        aggregation=None,
        cutoff: int = -1,
        group_size: int = 1,
        wire_scores: bool = True,
    ):
        """Pipelined bulk search: yields (ids, scores) per input batch.

        Keeps up to `depth` batches enqueued on the device before bringing
        the oldest one's results to the host. Results reflect the index
        state at submission time; semantics per batch are those of
        `search_batch`.
        """
        # validate eagerly: bad knob combinations raise at the call site
        builder = self._make_batch_builder(k, threshold, document_ids, nprobes, ef_search,
                                           nrefine, cutoff, group_size, wire_scores)
        return self._search_stream_iter(
            batches, builder, k, depth, aggregation, cutoff, group_size
        )

    def _search_stream_iter(
        self, batches, builder, k, depth, aggregation, cutoff, group_size
    ):
        pending: deque = deque()

        def collect():
            ids, scores = self._search_collect(pending.popleft())
            return _finish_rows(ids, scores, k, aggregation, cutoff, group_size)

        for queries in batches:
            queries = np.atleast_2d(np.asarray(queries, dtype=np.float32))
            self._check_dim(queries)
            with self._lock:
                pending.append(self._search_launch(queries, builder))
            if len(pending) >= depth:
                yield collect()
        while pending:
            yield collect()

    def _make_batch_builder(
        self, k, threshold, document_ids, nprobes, ef_search, nrefine, cutoff, group_size,
        wire_scores,
    ) -> VectorSearchBuilder:
        if not wire_scores and (cutoff != -1 or group_size > 1):
            raise InvalidConfigError(
                "wire_scores=False cannot combine with cutoff/aggregation "
                "post-steps (they need the scores on host)"
            )
        builder = VectorSearchBuilder(self)
        builder._wire_scores = bool(wire_scores)
        builder._k = int(k)
        builder._threshold = float(threshold)
        if document_ids is None or isinstance(document_ids, Bitset):
            builder._document_ids = document_ids  # bitsets stay packed
        else:
            builder._document_ids = [int(i) for i in document_ids]
        builder._nprobes = nprobes
        builder._ef_search = ef_search
        builder._nrefine = nrefine
        return builder

    # -- helpers -------------------------------------------------------------

    def _check_dim(self, vectors: np.ndarray) -> None:
        if vectors.shape[-1] != self._dim:
            raise DimensionMismatchError(
                f"vector dimension mismatch: expected {self._dim}, got {vectors.shape[-1]}"
            )

    def _filter_words(self, doc_filter: DocumentFilter) -> torch.Tensor:
        """The filter's packed words over its id span, as int64 on device."""
        if doc_filter._bitset is not None:
            n_words = len(doc_filter._bitset.words)
        else:
            n_words = (int(doc_filter._ids.max()) >> 6) + 1
        words = doc_filter.word_mask(n_words).view(np.uint32).astype(np.int64)
        count_h2d(words.nbytes, self._device)
        return torch.from_numpy(words).to(self._device)

    def _slot_ok(self, builder: "VectorSearchBuilder") -> torch.Tensor:
        """[cap] bool: the slots a search may return, validity and the
        doc-ID filter, which travels as packed words and is expanded
        against the slot ids on the device."""
        valid = self._store.device_state()[2]
        doc_filter = DocumentFilter(builder._document_ids)
        if doc_filter.enabled:
            return _words_ok(self._filter_words(doc_filter),
                             self._store.device_id_map()[:-1], valid)
        return valid

    def _slot_mask(self, builder: "VectorSearchBuilder", sqnorms=None) -> torch.Tensor:
        """The kernels' additive mask over the slots (`_slot_ok`). `sqnorms`
        replaces the store's squared norms (an int8 copy's dequantised
        ones)."""
        with span("layer.vector.mask"):
            if sqnorms is None:
                sqnorms = self._store.device_state()[1]
            return _additive_mask(self._slot_ok(builder), sqnorms,
                                  self._distance_kind == DistanceKind.COSINE)

    def _lookup_node_vectors(self, node_ids: Sequence[int]) -> list[np.ndarray]:
        """WithNode resolution (flat_index_search.go:171-196)."""
        return [np.array(self._store.get_vector(node_id)) for node_id in node_ids]

    def _execute_search(self, builder: VectorSearchBuilder) -> list[VectorResult]:
        if not builder._queries and not builder._node_ids:
            raise InvalidConfigError("must specify either queries or node IDs")
        with span("layer.vector.execute"):
            with self._lock:
                queries = list(builder._queries)
                for q in queries:
                    self._check_dim(q)
                if builder._node_ids:
                    queries.extend(self._lookup_node_vectors(builder._node_ids))
                qarr = np.stack(queries).astype(np.float32)
                count("queries", len(qarr))
                ids, scores = self._launch_collect(qarr, builder)

            with span("layer.vector.results"):
                flat_ids = ids.reshape(-1)
                flat_scores = scores.reshape(-1)
                keep = flat_ids != INVALID_ID
                uids, uscores = aggregate_scores(
                    flat_ids[keep], flat_scores[keep], builder._aggregation, ascending=True
                )
                results = [
                    VectorResult(node=self._result_node(int(i)), score=float(s))
                    for i, s in zip(uids, uscores)
                ]
                results = limit_results(results, builder._k)
                results = autocut_results(results, builder._cutoff)
                if builder._reranker is not None:
                    results = builder._reranker.rerank(results)
                return results

    def _launch_collect(self, queries: np.ndarray, builder: VectorSearchBuilder):
        """`_search_launch` then `_search_collect`, each in its span (caller
        holds the lock)."""
        with span("layer.vector.launch"):
            handle = self._search_launch(queries, builder)
        with span("layer.vector.collect"):
            return self._search_collect(handle)

    def _result_node(self, node_id: int) -> VectorNode:
        return VectorNode(node_id, np.array(self._store.get_vector(node_id)))

    # subclasses implement:
    def kind(self):
        raise NotImplementedError

    def _search_launch(self, queries: np.ndarray, builder: VectorSearchBuilder):
        raise NotImplementedError

    def _search_collect(self, handle):
        raise NotImplementedError


def _finish_rows(ids, scores, k, aggregation, cutoff, group_size):
    if ids.shape[1] > k:
        ids, scores = ids[:, :k], scores[:, :k]
    return postprocess_batch_rows(
        ids, scores, k, aggregation=aggregation, cutoff=cutoff,
        group_size=group_size, ascending=True,
    )


def postprocess_batch_rows(
    ids: np.ndarray,
    scores: np.ndarray,
    k: int,
    *,
    aggregation=None,
    cutoff: int = -1,
    group_size: int = 1,
    ascending: bool = True,
    empty_score: float = np.inf,
) -> tuple[np.ndarray, np.ndarray]:
    """Fluent-pipeline post-steps for batched [Q, k] id/score rows.

    `group_size` > 1: each consecutive group of rows aggregates (dedup by
    id with Sum/Max/Mean, aggregation.go:72-83) into one output row, sorted
    by (score, id) in `ascending` direction. `cutoff` != -1 then applies
    autocut (limiter.go:81-118) per output row: slots past the cut are
    cleared to (INVALID_ID, `empty_score`). No-op (and copy-free) when
    neither knob is set.
    """
    if group_size > 1:
        q = ids.shape[0]
        if q % group_size:
            raise InvalidConfigError(
                f"query count {q} not divisible by group_size {group_size}"
            )
        agg = (
            ScoreAggregationKind(aggregation)
            if aggregation is not None
            else ScoreAggregationKind.SUM
        )
        g = q // group_size
        out_ids = np.full((g, k), INVALID_ID, dtype=np.uint32)
        out_scores = np.full((g, k), empty_score, dtype=np.float32)
        grp_i = ids.reshape(g, -1)
        grp_s = scores.reshape(g, -1)
        for gi in range(g):
            keep = grp_i[gi] != INVALID_ID
            uids, uscores = aggregate_scores(
                grp_i[gi][keep], grp_s[gi][keep], agg, ascending=ascending
            )
            m = min(k, len(uids))
            out_ids[gi, :m] = uids[:m]
            out_scores[gi, :m] = uscores[:m]
        ids, scores = out_ids, out_scores
    if cutoff != -1:
        ids = ids.copy() if group_size <= 1 else ids
        scores = scores.copy() if group_size <= 1 else scores
        for r in range(ids.shape[0]):
            nv = int((ids[r] != INVALID_ID).sum())
            cut = autocut(scores[r][:nv], cutoff) if nv else 0
            ids[r, cut:] = INVALID_ID
            scores[r, cut:] = empty_score
    return ids, scores


def collect_device_handle(handle):
    """Bring a `_search_launch` handle's results to the host as
    (ids [Q, k] uint32, scores [Q, k] float32).

    Handle forms:
      ("empty", q)                       — no rows in the index
      ("dev", scores, slots, id_map)     — device tensors: scores and slots
                                           [Q, k], scores None when they stay
                                           on the device; `id_map` is the
                                           store's `device_id_map()` at launch
    The slots are mapped to ids on the device; only the ids and the scores
    are copied out.
    """
    if handle[0] == "empty":
        q = handle[1]
        return (
            np.full((q, 0), INVALID_ID, dtype=np.uint32),
            np.zeros((q, 0), dtype=np.float32),
        )
    _, s, i, id_map = handle
    # an empty slot (IDX_SENTINEL) clamps to the map's last entry, INVALID_ID
    at = i.clamp(0, id_map.shape[0] - 1).reshape(-1)
    ids = id_map.index_select(0, at).view(i.shape).cpu().numpy().view(np.uint32)
    count("ids_on_card", i.shape[0])
    if s is None:
        scores = np.zeros(ids.shape, dtype=np.float32)
    else:
        scores = s.cpu().numpy()
    return ids, scores


def threshold_scalar(threshold: float) -> np.float32:
    """Reference semantics: threshold <= 0 means disabled
    (flat_index_search.go:269); disabled is +inf."""
    return np.float32(threshold) if threshold > 0 else np.float32(np.inf)
