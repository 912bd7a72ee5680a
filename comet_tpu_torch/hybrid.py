"""Hybrid search coordinator: vector + text + metadata with score fusion.

Counterpart of comet_tpu/hybrid.py (the Go reference's hybridSearchIndex,
hybrid_search_index.go): facade over the three indexes with a docInfo map
tracking which modalities each doc has (:42-58), auto-ID adds (:103-112),
and the execute pipeline (:477-615): metadata pre-filter -> candidate set ->
vector + text search restricted via document-ID filters -> fusion -> sort
desc -> k. Metadata-only hits get score 1.0 (:589-593); fused scores are
float64 on purpose (:309-314).

The metadata candidate set stays a PACKED BITSET end to end — it becomes
the slot mask of the vector scan and the allowed mask of the BM25 scorer —
instead of the Go reference's per-query candidate ID list
(hybrid_search_index.go:498-532). `search_batch` enqueues the vector batch
on the card before the text batch scores there, then collects both and
fuses on the host; the fluent `execute` runs the vector search to its end
first (the port's vector indexes have no launch / collect split for it),
with the same results.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, BinaryIO

import numpy as np

from comet_tpu_torch.core.node import MetadataNode, new_metadata_node_with_id, next_node_id
from comet_tpu_torch.fusion import Fusion, FusionConfig, default_fusion, new_fusion
from comet_tpu_torch.indexes.base import INVALID_ID, postprocess_batch_rows
from comet_tpu_torch.indexes.metadata import Filter, FilterGroup
from comet_tpu_torch.io import serial
from comet_tpu_torch.types import (
    FusionKind,
    InvalidConfigError,
    ScoreAggregationKind,
)
from comet_tpu_torch.utils.profiling import count, span

MAGIC = b"CHYB"
VERSION = 2  # v2: CRC32 payload trailer (v1 readable, no trailer check)


@dataclass
class HybridSearchResult:
    """Fused hit; score is float64 (hybrid_search_index.go:309-314)."""

    id: int
    score: float

    def get_id(self) -> int:
        return self.id

    def get_score(self) -> float:
        return self.score


@dataclass
class _DocInfo:
    has_vector: bool = False
    has_text: bool = False
    has_metadata: bool = False


class HybridSearchIndex:
    """Facade over vector + text + metadata indexes
    (reference: hybrid_search_index.go:42-58)."""

    def __init__(self, vector_index=None, text_index=None, metadata_index=None):
        self._vector = vector_index
        self._text = text_index
        self._metadata = metadata_index
        self._doc_info: dict[int, _DocInfo] = {}
        self._lock = threading.RLock()

    # -- accessors -----------------------------------------------------------

    def vector_index(self):
        return self._vector

    def text_index(self):
        return self._text

    def metadata_index(self):
        return self._metadata

    def count(self) -> int:
        with self._lock:
            return len(self._doc_info)

    def has_document(self, doc_id: int) -> bool:
        with self._lock:
            return int(doc_id) in self._doc_info

    def stats(self) -> dict:
        with self._lock:
            out = {"kind": "hybrid", "docs": len(self._doc_info)}
            for name, idx in (
                ("vector", self._vector),
                ("text", self._text),
                ("metadata", self._metadata),
            ):
                if idx is not None and hasattr(idx, "stats"):
                    out[name] = idx.stats()
            return out

    # -- mutation --------------------------------------------------------------

    def add(
        self,
        vector: np.ndarray | None = None,
        text: str = "",
        metadata: dict[str, Any] | None = None,
    ) -> int:
        """Add with an auto-generated ID (hybrid_search_index.go:103-112)."""
        doc_id = next_node_id()
        self.add_with_id(doc_id, vector, text, metadata)
        return doc_id

    def add_with_id(
        self,
        doc_id: int,
        vector: np.ndarray | None = None,
        text: str = "",
        metadata: dict[str, Any] | None = None,
    ) -> None:
        with self._lock:
            doc_id = int(doc_id)
            info = _DocInfo()
            if vector is not None and np.size(vector) > 0:
                self._require(self._vector, "vector")
                self._vector.add_batch(
                    np.asarray(vector, dtype=np.float32)[None, :], [doc_id]
                )
                info.has_vector = True
            if text:
                self._require(self._text, "text")
                self._text.add(doc_id, text)
                info.has_text = True
            if metadata:
                self._require(self._metadata, "metadata")
                self._metadata.add(new_metadata_node_with_id(doc_id, metadata))
                info.has_metadata = True
            self._doc_info[doc_id] = info

    def add_batch_with_ids(self, entries) -> None:
        """Bulk add of (doc_id, vector, text, metadata) rows: each modality's
        index gets ONE batched call (vector scatter, BM25 batch tokenize,
        metadata batch planes) instead of a per-document call."""
        with self._lock:
            vec_ids: list[int] = []
            vecs: list[np.ndarray] = []
            txt_ids: list[int] = []
            txts: list[str] = []
            meta_nodes = []
            for doc_id, vector, text, metadata in entries:
                doc_id = int(doc_id)
                info = _DocInfo()
                if vector is not None and np.size(vector) > 0:
                    self._require(self._vector, "vector")
                    vec_ids.append(doc_id)
                    vecs.append(np.asarray(vector, dtype=np.float32))
                    info.has_vector = True
                if text:
                    self._require(self._text, "text")
                    txt_ids.append(doc_id)
                    txts.append(text)
                    info.has_text = True
                if metadata:
                    self._require(self._metadata, "metadata")
                    meta_nodes.append(new_metadata_node_with_id(doc_id, metadata))
                    info.has_metadata = True
                self._doc_info[doc_id] = info
            if vec_ids:
                self._vector.add_batch(np.stack(vecs), vec_ids)
            if txt_ids:
                self._text.add_batch(txt_ids, txts)
            if meta_nodes:
                self._metadata.add_batch(meta_nodes)

    def remove(self, doc_id: int) -> None:
        with self._lock:
            doc_id = int(doc_id)
            info = self._doc_info.pop(doc_id, None)
            if info is None:
                raise InvalidConfigError(f"document {doc_id} not found")
            if info.has_vector:
                self._vector.remove(doc_id)
            if info.has_text:
                self._text.remove(doc_id)
            if info.has_metadata:
                self._metadata.remove(MetadataNode(doc_id, {}))

    def train(self, vectors: np.ndarray) -> None:
        """Trains the vector index (hybrid_search_index.go Train)."""
        self._require(self._vector, "vector")
        self._vector.train(vectors)

    def flush(self) -> None:
        for idx in (self._vector, self._text, self._metadata):
            if idx is not None:
                idx.flush()

    @staticmethod
    def _require(index, name: str):
        if index is None:
            raise InvalidConfigError(f"no {name} index configured")
        return index

    # -- search ---------------------------------------------------------------

    def new_search(self) -> "HybridSearchBuilder":
        return HybridSearchBuilder(self)

    def search_batch(
        self,
        vectors: np.ndarray | None = None,
        texts: "list[str] | None" = None,
        k: int = 10,
        *,
        metadata_filters: "list[Filter] | None" = None,
        metadata_groups: "list[FilterGroup] | None" = None,
        fusion: Fusion | None = None,
        fusion_kind=None,
        nprobes: int | None = None,
        ef_search: int | None = None,
        threshold: float = 0.0,
        cutoff: int = -1,
    ) -> "list[list[HybridSearchResult]]":
        """Batched hybrid search: Q independent queries (the Go reference
        searches one query at a time, hybrid_search_index.go:477-615).

        The metadata pre-filter compiles once into a packed candidate
        bitset shared by the batch; the vector search is LAUNCHED (device
        work enqueued) while BM25 tokenizes on the host and scores on the
        device; fusion runs on the host over the [Q, k] result arrays.
        Per-query semantics (candidate masking, metadata-only score 1.0,
        fused float64 scores, vector-only ascending order) match
        new_search().execute(); `cutoff` applies autocut per modality row
        before fusion, exactly where the fluent path applies it (the
        builder forwards with_cutoff into each sub-search).

        Returns a list of Q result lists.
        """
        with span("layer.hybrid.search_batch"):
            if vectors is not None:
                vectors = np.atleast_2d(np.asarray(vectors, dtype=np.float32))
            nq = (
                len(vectors) if vectors is not None
                else len(texts) if texts is not None else 0
            )
            count("queries", nq)
            if nq == 0:
                return []
            if vectors is not None and texts is not None and len(texts) != nq:
                raise InvalidConfigError("vectors and texts length mismatch")
            fus = fusion or (
                new_fusion(fusion_kind) if fusion_kind is not None else default_fusion()
            )

            # STEP 1: shared metadata pre-filter -> packed candidate bitset
            candidates = None
            if metadata_filters or metadata_groups:
                self._require(self._metadata, "metadata")
                with span("layer.hybrid.filter"):
                    candidates = self._metadata.filter_bitset(
                        metadata_filters or [], metadata_groups or []
                    )
                if candidates.is_empty():
                    return [[] for _ in range(nq)]

            # STEP 2: launch the vector batch (stays in flight on device)
            v_handle = None
            vec_idx = None
            if vectors is not None:
                vec_idx = self._require(self._vector, "vector")
                vec_idx._check_dim(vectors)
                builder = vec_idx._make_batch_builder(
                    k, threshold, candidates, nprobes, ef_search, None, -1, 1, True
                )
                with vec_idx._lock, span("layer.vector.launch"):
                    v_handle = vec_idx._search_launch(vectors, builder)

            # STEP 3: text batch (host tokenization overlaps the vector search)
            t_ids = t_sc = None
            if texts is not None:
                text_idx = self._require(self._text, "text")
                t_ids, t_sc = text_idx.search_batch(
                    texts, k=k, document_ids=candidates, cutoff=cutoff
                )

            v_ids = v_sc = None
            if v_handle is not None:
                with span("layer.vector.collect"):
                    v_ids, v_sc = vec_idx._search_collect(v_handle)
                v_ids, v_sc = v_ids[:, :k], v_sc[:, :k]
                if cutoff != -1:
                    v_ids, v_sc = postprocess_batch_rows(
                        v_ids, v_sc, k, cutoff=cutoff, ascending=True,
                    )

            # STEP 4: per-query fusion (host; k is small), with the result lists
            with span("layer.hybrid.fusion"):
                return fuse_batch_rows(v_ids, v_sc, t_ids, t_sc, candidates, fus, nq, k)

    # -- serialization ----------------------------------------------------------

    def write_to(
        self,
        hybrid_w: BinaryIO,
        vector_w: BinaryIO | None = None,
        text_w: BinaryIO | None = None,
        metadata_w: BinaryIO | None = None,
    ) -> None:
        """CHYB v1 header + docInfo to hybrid_w; each sub-index to its own
        writer (reference: 4-writer WriteTo, hybrid_search_index.go:655-773).
        Flushes soft deletes first."""
        with self._lock:
            self.flush()
            w = serial.CrcWriter(hybrid_w)
            serial.write_magic(w, MAGIC, VERSION)
            serial.write_u32(
                w,
                (1 if self._vector is not None else 0)
                | (2 if self._text is not None else 0)
                | (4 if self._metadata is not None else 0),
            )
            serial.write_u64(w, len(self._doc_info))
            for doc_id in sorted(self._doc_info):
                info = self._doc_info[doc_id]
                flags = (
                    (1 if info.has_vector else 0)
                    | (2 if info.has_text else 0)
                    | (4 if info.has_metadata else 0)
                )
                serial.write_u32(w, doc_id)
                serial.write_u32(w, flags)
            w.seal()
            if self._vector is not None:
                self._vector.write_to(self._require(vector_w, "vector writer"))
            if self._text is not None:
                self._text.write_to(self._require(text_w, "text writer"))
            if self._metadata is not None:
                self._metadata.write_to(self._require(metadata_w, "metadata writer"))

    def read_from(
        self,
        hybrid_r: BinaryIO,
        vector_r: BinaryIO | None = None,
        text_r: BinaryIO | None = None,
        metadata_r: BinaryIO | None = None,
    ) -> None:
        r = serial.CrcReader(hybrid_r)
        version = serial.read_magic(r, MAGIC, VERSION)
        present = serial.read_u32(r)
        n = serial.read_u64(r)
        with self._lock:
            doc_info: dict[int, _DocInfo] = {}
            for _ in range(n):
                doc_id = serial.read_u32(r)
                flags = serial.read_u32(r)
                doc_info[doc_id] = _DocInfo(
                    bool(flags & 1), bool(flags & 2), bool(flags & 4)
                )
            if version >= 2:
                r.verify()
            if present & 1:
                self._require(self._vector, "vector").read_from(
                    self._require(vector_r, "vector reader")
                )
            if present & 2:
                self._require(self._text, "text").read_from(
                    self._require(text_r, "text reader")
                )
            if present & 4:
                self._require(self._metadata, "metadata").read_from(
                    self._require(metadata_r, "metadata reader")
                )
            self._doc_info = doc_info


def fuse_batch_rows(
    v_ids, v_sc, t_ids, t_sc, candidates, fus: Fusion, nq: int, k: int
) -> "list[list[HybridSearchResult]]":
    """Per-query fusion of batched [Q, k] modality result arrays with
    execute()-identical semantics: candidate masking already applied by the
    searches, metadata-only hits score 1.0 (hybrid_search_index.go:589-593),
    fused float64 scores, vector-only results ascending (distances).

    Used by HybridSearchIndex.search_batch."""
    out: list[list[HybridSearchResult]] = []
    for qi in range(nq):
        vscores: dict[int, float] = {}
        if v_ids is not None:
            row_i, row_s = v_ids[qi], v_sc[qi]
            hit = row_i != INVALID_ID
            vscores = {
                int(i): float(s) for i, s in zip(row_i[hit], row_s[hit])
            }
        tscores: dict[int, float] = {}
        if t_ids is not None:
            row_i, row_s = t_ids[qi], t_sc[qi]
            hit = row_i != INVALID_ID
            tscores = {
                int(i): float(s) for i, s in zip(row_i[hit], row_s[hit])
            }
        if vscores and tscores:
            combined = fus.combine(vscores, tscores)
            vector_only = False
        elif vscores:
            combined, vector_only = vscores, True
        elif tscores:
            combined, vector_only = tscores, False
        else:
            combined = (
                {int(i): 1.0 for i in candidates.to_array()}
                if candidates is not None else {}
            )
            vector_only = False
        results = [HybridSearchResult(i, s) for i, s in combined.items()]
        if vector_only:
            results.sort(key=lambda r: (r.score, r.id))
        else:
            results.sort(key=lambda r: (-r.score, r.id))
        out.append(results[:k] if k < len(results) else results)
    return out


def new_hybrid_search_index(
    vector_index=None, text_index=None, metadata_index=None
) -> HybridSearchIndex:
    return HybridSearchIndex(vector_index, text_index, metadata_index)


class HybridSearchBuilder:
    """Fluent hybrid search (reference: hybrid_search_index.go:326-365)."""

    def __init__(self, index: HybridSearchIndex):
        self._index = index
        self._vector_query: np.ndarray | None = None
        self._text_queries: list[str] = []
        self._metadata_filters: list[Filter] = []
        self._metadata_groups: list[FilterGroup] = []
        self._k = 10
        self._nprobes = 0
        self._ef_search = 0
        self._threshold = 0.0
        self._aggregation = ScoreAggregationKind.SUM
        self._cutoff = -1
        self._fusion: Fusion = default_fusion()

    def with_vector(self, query) -> "HybridSearchBuilder":
        self._vector_query = np.asarray(query, dtype=np.float32)
        return self

    def with_text(self, *queries: str) -> "HybridSearchBuilder":
        self._text_queries.extend(queries)
        return self

    def with_metadata(self, *filters: Filter) -> "HybridSearchBuilder":
        self._metadata_filters.extend(filters)
        return self

    def with_metadata_groups(self, *groups: FilterGroup) -> "HybridSearchBuilder":
        self._metadata_groups.extend(groups)
        return self

    def with_k(self, k: int) -> "HybridSearchBuilder":
        self._k = int(k)
        return self

    def with_nprobes(self, nprobes: int) -> "HybridSearchBuilder":
        self._nprobes = int(nprobes)
        return self

    def with_ef_search(self, ef_search: int) -> "HybridSearchBuilder":
        self._ef_search = int(ef_search)
        return self

    def with_threshold(self, threshold: float) -> "HybridSearchBuilder":
        self._threshold = float(threshold)
        return self

    def with_score_aggregation(self, kind: ScoreAggregationKind) -> "HybridSearchBuilder":
        self._aggregation = ScoreAggregationKind(kind)
        return self

    def with_cutoff(self, cutoff: int) -> "HybridSearchBuilder":
        self._cutoff = int(cutoff)
        return self

    def with_fusion(self, fusion: Fusion) -> "HybridSearchBuilder":
        self._fusion = fusion
        return self

    def with_fusion_kind(
        self, kind: FusionKind, config: FusionConfig | None = None
    ) -> "HybridSearchBuilder":
        self._fusion = new_fusion(kind, config)
        return self

    def execute(self) -> list[HybridSearchResult]:
        """Pipeline parity with hybrid_search_index.go:477-615."""
        with span("layer.hybrid.execute"):
            idx = self._index
            count("queries", 1)

            # STEP 1: metadata pre-filter -> packed candidate bitset
            candidates = None
            if self._metadata_filters or self._metadata_groups:
                if idx._metadata is None:
                    raise InvalidConfigError(
                        "metadata filters specified but no metadata index configured"
                    )
                with span("layer.hybrid.filter"):
                    candidates = idx._metadata.filter_bitset(
                        self._metadata_filters, self._metadata_groups
                    )
                if candidates.is_empty():
                    return []

            # STEP 2: the vector search, run to its end (the Go reference runs
            # the steps strictly sequentially, hybrid_search_index.go:510-544)
            vector_scores: dict[int, float] = {}
            if self._vector_query is not None:
                if idx._vector is None:
                    raise InvalidConfigError(
                        "vector query specified but no vector index configured"
                    )
                vs = (
                    idx._vector.new_search()
                    .with_query(self._vector_query)
                    .with_k(self._k)
                    .with_score_aggregation(self._aggregation)
                    .with_cutoff(self._cutoff)
                )
                if self._nprobes > 0:
                    vs = vs.with_nprobes(self._nprobes)
                if self._ef_search > 0:
                    vs = vs.with_ef_search(self._ef_search)
                if self._threshold > 0:
                    vs = vs.with_threshold(self._threshold)
                if candidates is not None:
                    vs = vs.with_document_ids(candidates)
                for r in vs.execute():
                    vector_scores[r.get_id()] = float(r.get_score())

            # STEP 3: text search
            text_scores: dict[int, float] = {}
            if self._text_queries:
                if idx._text is None:
                    raise InvalidConfigError(
                        "text query specified but no text index configured"
                    )
                ts = (
                    idx._text.new_search()
                    .with_query(*self._text_queries)
                    .with_k(self._k)
                    .with_score_aggregation(self._aggregation)
                    .with_cutoff(self._cutoff)
                )
                if candidates is not None:
                    ts = ts.with_document_ids(candidates)
                for r in ts.execute():
                    text_scores[r.get_id()] = float(r.get_score())

            # STEP 4: fusion
            if vector_scores and text_scores:
                with span("layer.hybrid.fusion"):
                    combined = self._fusion.combine(vector_scores, text_scores)
            elif vector_scores:
                combined = vector_scores
            elif text_scores:
                combined = text_scores
            else:
                combined = {}

            with span("layer.hybrid.results"):
                # metadata-only search: every candidate scores 1.0 (:589-593)
                if not combined and candidates is not None:
                    combined = {int(i): 1.0 for i in candidates.to_array()}

                results = [HybridSearchResult(i, s) for i, s in combined.items()]
                # Sort: descending for fused/text scores (higher = better). For a
                # VECTOR-ONLY search the scores are distances, so ascending — the
                # reference sorts desc unconditionally (hybrid_search_index.go:596-613),
                # which ranks vector-only results worst-first; that quirk is not
                # replicated. Ties break by ascending id (the reference's tie order
                # is unspecified Go map order).
                vector_only = (bool(vector_scores) and not text_scores
                               and combined is vector_scores)
                if vector_only:
                    results.sort(key=lambda r: (r.score, r.id))
                else:
                    results.sort(key=lambda r: (-r.score, r.id))
                return results[: self._k] if self._k < len(results) else results
