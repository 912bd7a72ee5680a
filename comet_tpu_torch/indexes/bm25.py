"""BM25 full-text index.

Counterpart of comet_tpu/indexes/bm25.py (the Go reference's
BM25SearchIndex, bm25_index.go and bm25_index_search.go): K1 = 1.2,
B = 0.75, NFKC + lowercase normalization, UAX#29 segmentation that keeps
EVERY segment (whitespace and punctuation too; `wordlike_only=True` keeps
letter- and digit-bearing ones), IDF = log((N - df + 0.5) / (df + 0.5) + 1)
with TF saturation, add-replaces-existing, soft delete (N, df and avgdl
keep counting a soft-deleted document until flush), more-like-this
queries rebuilt from stored tokens, multi-query aggregation, k, autocut,
document-ID filters and the CB25 format, byte-identical to the reference.

Layout: a document keeps its tokens as term ids in token order; the terms
are numbered in order of first sight. The postings are derived from them
on the index's device when the contents change: one run a term (CSR) of
(slot, tf), a slot being the document's rank among the stored ids. Every
search, `execute` as well as `search_batch`, scores on that device
(ops/bm25.py: the kernel of csrc/bm25_score.cu and K1 on the card, the
plain version on the CPU); the index runs on the card unless it is given
`device="cpu"`, and nothing falls back from the card.
"""

from __future__ import annotations

import math
import struct
import threading
import unicodedata
import zlib
from typing import BinaryIO, Iterable

import numpy as np
import torch

from comet_tpu_torch.core.aggregation import aggregate_scores
from comet_tpu_torch.core.filter import DocumentFilter
from comet_tpu_torch.core.limiter import autocut_results, limit_results
from comet_tpu_torch.core.results import TextResult
from comet_tpu_torch.indexes import uax29
from comet_tpu_torch.indexes.base import INVALID_ID, postprocess_batch_rows, resolve_device
from comet_tpu_torch.io import serial
from comet_tpu_torch.ops import bm25 as bm25_ops
from comet_tpu_torch.ops.bitset import Bitset
from comet_tpu_torch.types import InvalidConfigError, NodeNotFoundError, ScoreAggregationKind
from comet_tpu_torch.utils.memory import memory_report
from comet_tpu_torch.utils.profiling import count, count_h2d, span

MAGIC = b"CB25"
VERSION = 3  # v3: CRC32 payload trailer (v2 readable, no trailer check)

K1 = bm25_ops.K1
B = bm25_ops.B

ADD_BATCH_DOCS = 1 << 16  # documents whose tokens add_batch maps at once
SERIAL_BLOCK_DOCS = 1 << 13    # documents write_to encodes at once
SERIAL_BLOCK_BYTES = 1 << 24   # bytes read_from parses at once


def normalize(text: str) -> str:
    """NFKC + lowercase (bm25_index.go:154-156)."""
    return unicodedata.normalize("NFKC", text).lower()


def tokenize(text: str) -> list[str]:
    """ALL UAX#29 word segments — whitespace and punctuation included —
    matching the reference's unfiltered words.FromString loop
    (bm25_index.go:159-166). See indexes/uax29.py."""
    return uax29.segment(text)


class _Vocab(dict):
    """term -> id; an unseen term takes the next id on lookup."""

    def __init__(self):
        super().__init__()
        self.terms: list[str] = []

    def __missing__(self, term: str) -> int:
        tid = self[term] = len(self.terms)
        self.terms.append(term)
        return tid


class BM25SearchIndex:
    """BM25 text index (reference: bm25_index.go:98-122)."""

    def __init__(self, wordlike_only: bool = False, device="cuda"):
        # wordlike_only=True filters segments to letter/digit-bearing ones
        # (a quality knob the reference lacks). It is NOT serialized: use
        # the same setting when reloading.
        self._wordlike_only = wordlike_only
        self._device = resolve_device(device)
        self._vocab = _Vocab()
        self._doc_terms: dict[int, np.ndarray] = {}  # doc id -> int32 term ids
        self._deleted = Bitset()
        self._num_docs = 0
        self._total_tokens = 0
        self._lock = threading.RLock()
        self._version = 0
        self._dev_version = -1
        # (slot_docs, post_slot, post_tf, doc_len, df, term_start)
        self._dev = None

    def _tokenize(self, text: str) -> list[str]:
        toks = tokenize(normalize(text))
        if self._wordlike_only:
            toks = uax29.wordlike(toks)
        return toks

    # -- contracts -----------------------------------------------------------

    def trained(self) -> bool:
        return True

    def train(self, *_args) -> None:
        return None

    def count(self) -> int:
        """Active (non-soft-deleted) document count."""
        with self._lock:
            return self._num_docs - self._deleted.count()

    @property
    def avg_doc_len(self) -> float:
        with self._lock:
            return self._total_tokens / self._num_docs if self._num_docs else 0.0

    def stats(self) -> dict:
        with self._lock:
            df = self._postings()[4] if self._doc_terms else np.zeros(0)
            return {
                "kind": "bm25",
                "device": str(self._device),
                "docs": self._num_docs,
                "soft_deleted": self._deleted.count(),
                "terms": int(np.count_nonzero(df)),
                "total_tokens": self._total_tokens,
                "avg_doc_len": self.avg_doc_len,
                "memory": memory_report(self),
            }

    # -- mutation --------------------------------------------------------------

    def add(self, doc_id: int, text: str) -> None:
        """Index a document; replaces an existing doc with the same ID
        (bm25_index.go:188-226)."""
        with self._lock:
            self._add_tokens(int(doc_id), self._tokenize(text))

    def _add_tokens(self, doc_id: int, tokens: list[str]) -> None:
        """Index pre-tokenized content (caller holds the lock)."""
        vocab = self._vocab
        self._add_terms(doc_id, np.fromiter(map(vocab.__getitem__, tokens), np.int32,
                                            count=len(tokens)))

    def _add_terms(self, doc_id: int, terms: np.ndarray) -> None:
        if doc_id in self._doc_terms:
            self._remove_internal(doc_id)
        self._deleted.discard(doc_id)
        self._doc_terms[doc_id] = terms
        self._num_docs += 1
        self._total_tokens += len(terms)
        self._version += 1

    def add_batch(self, ids: Iterable[int], texts: Iterable[str]) -> None:
        """Bulk indexing: the tokens of up to ADD_BATCH_DOCS documents are
        mapped to term ids in one pass; documents are stored in order (a
        repeated id replaces the earlier one, as a loop of `add` would)."""
        with self._lock:
            doc_ids: list[int] = []
            tokens: list[str] = []
            lens: list[int] = []

            def store():
                terms = np.fromiter(map(self._vocab.__getitem__, tokens), np.int32,
                                    count=len(tokens))
                for doc_id, arr in zip(doc_ids, np.split(terms, np.cumsum(lens)[:-1])):
                    self._add_terms(doc_id, arr)
                doc_ids.clear()
                tokens.clear()
                lens.clear()

            for doc_id, text in zip(ids, texts):
                toks = self._tokenize(text)
                doc_ids.append(int(doc_id))
                lens.append(len(toks))
                tokens += toks
                if len(doc_ids) == ADD_BATCH_DOCS:
                    store()
            store()

    def doc_tokens(self, doc_id: int) -> list[str] | None:
        """A stored document's tokens in order (soft-deleted documents
        included until flush), or None."""
        with self._lock:
            terms = self._doc_terms.get(int(doc_id))
            if terms is None:
                return None
            return list(map(self._vocab.terms.__getitem__, terms.tolist()))

    def remove(self, doc_id: int) -> None:
        """Soft delete: scoring skips the doc, but N/df/avgdl keep counting it
        until flush (parity: bm25_index.go:253-278)."""
        with self._lock:
            doc_id = int(doc_id)
            if doc_id not in self._doc_terms or self._deleted.contains(doc_id):
                return
            self._deleted.add(doc_id)

    def _remove_internal(self, doc_id: int) -> None:
        terms = self._doc_terms.pop(doc_id, None)
        if terms is None:
            return
        self._num_docs -= 1
        self._total_tokens -= len(terms)
        if self._num_docs <= 0:
            self._num_docs = 0
            self._total_tokens = 0
        self._version += 1

    def flush(self) -> None:
        """Hard-delete all soft-deleted docs (bm25_index.go:374-399)."""
        with self._lock:
            for doc_id in self._deleted.to_array().tolist():
                self._remove_internal(int(doc_id))
            self._deleted = Bitset()

    def load_reference_state(self, doc_ids, token_lists, deleted_ids=()) -> None:
        """Replace the contents with another index's: documents with their
        token lists (soft-deleted ones included) and the soft-deleted ids,
        which a CB25 file cannot carry (writing flushes them)."""
        with self._lock:
            self.__init__(wordlike_only=self._wordlike_only, device=self._device)
            for doc_id, tokens in zip(doc_ids, token_lists):
                self._add_tokens(int(doc_id), list(tokens))
            for doc_id in deleted_ids:
                self.remove(int(doc_id))

    # -- device postings -----------------------------------------------------------

    def _postings(self):
        """The postings on the index's device, rebuilt when the contents
        change: (slot_docs [n] int64 host, post_slot [P] int32, post_tf [P]
        float32, doc_len [n] float32, df [terms] int64 host, term_start
        [terms] int64 host). Slot s is the s-th smallest stored doc id; a
        term's run lists its documents by ascending slot."""
        if self._dev_version == self._version and self._dev is not None:
            return self._dev
        self._dev = None  # free the old postings before the new ones
        slot_docs = np.fromiter(sorted(self._doc_terms), dtype=np.int64,
                                count=len(self._doc_terms))
        arrays = [self._doc_terms[d] for d in slot_docs.tolist()]
        lens = np.fromiter(map(len, arrays), dtype=np.int64, count=len(arrays))
        n, dev = len(slot_docs), self._device
        terms = np.concatenate(arrays) if arrays else np.zeros(0, np.int32)
        count_h2d(terms.nbytes + lens.nbytes + 4 * n, dev)   # the lengths twice
        terms = torch.from_numpy(terms).to(dev).long()
        slots = torch.repeat_interleave(torch.arange(n, device=dev),
                                        torch.from_numpy(lens).to(dev))
        keys, tf = torch.unique(terms * max(n, 1) + slots, sorted=True, return_counts=True)
        post_term = keys // max(n, 1)
        df = torch.bincount(post_term, minlength=len(self._vocab.terms)).cpu().numpy()
        self._dev = (
            slot_docs,
            (keys - post_term * max(n, 1)).to(torch.int32),
            tf.to(torch.float32),
            torch.from_numpy(lens.astype(np.float32)).to(dev),
            df,
            np.cumsum(df) - df,
        )
        self._dev_version = self._version
        return self._dev

    def _query_terms(self, queries: list[str], df, term_start):
        """Each query's terms in token order, repeats included, skipping
        terms no stored document has: (t_start, t_len, t_idf, q_off) on the
        host; the idf is computed in float64 (math.log), then rounded to
        float32, as the reference computes it."""
        n = float(self._num_docs)
        vocab = self._vocab
        idf_of: dict[int, float] = {}
        tids: list[int] = []
        q_off = [0]
        for qtext in queries:
            for t in self._tokenize(qtext):
                tid = vocab.get(t)
                if tid is None or df[tid] == 0:
                    continue
                if tid not in idf_of:
                    d = float(df[tid])
                    idf_of[tid] = math.log((n - d + 0.5) / (d + 0.5) + 1.0)
                tids.append(tid)
            q_off.append(len(tids))
        tids_arr = np.asarray(tids, dtype=np.int64)
        return (
            term_start[tids_arr].astype(np.int64),
            df[tids_arr].astype(np.int32),
            np.asarray([idf_of[t] for t in tids], dtype=np.float32),
            np.asarray(q_off, dtype=np.int64),
        )

    def _allowed(self, slot_docs, document_ids) -> np.ndarray:
        """[n] bool over the slots: not soft-deleted and past the filter."""
        allowed = ~self._deleted.contains_many(slot_docs)
        fmask = DocumentFilter(document_ids).slot_mask(slot_docs.astype(np.uint32))
        if fmask is not None:
            allowed &= fmask
        return allowed

    def _score(self, queries: list[str], k: int, document_ids, k_all: bool = False):
        """Score every query on the device (caller holds the lock; the index
        holds documents): (ids [Q, k] uint32, scores [Q, k] float32), empty
        slots (INVALID_ID, 0). `k_all` replaces k by the most documents a
        query can touch, so each row holds every match."""
        with span("layer.text.postings"):
            slot_docs, post_slot, post_tf, doc_len, df, term_start = self._postings()
        with span("layer.text.terms"):
            t_start, t_len, t_idf, q_off = self._query_terms(queries, df, term_start)
        if k_all:
            touched = np.add.reduceat(np.append(t_len, 0).astype(np.int64), q_off[:-1])
            touched[np.diff(q_off) == 0] = 0
            k = max(1, min(len(slot_docs), int(touched.max(initial=0))))
        dev = self._device
        with span("layer.text.mask"):
            allowed = self._allowed(slot_docs, document_ids)
            count_h2d(allowed.nbytes, dev)
            allowed = torch.from_numpy(allowed).to(dev)
        with span("layer.text.score"):
            count_h2d(t_start.nbytes + t_len.nbytes + t_idf.nbytes, dev)
            vals, slots = bm25_ops.bm25_topk(
                post_slot, post_tf, torch.from_numpy(t_start).to(dev),
                torch.from_numpy(t_len).to(dev), torch.from_numpy(t_idf).to(dev), q_off,
                doc_len, allowed, np.float32(self._total_tokens / self._num_docs), k,
            )
        with span("layer.text.collect"):
            vals, slots = vals.cpu().numpy(), slots.cpu().numpy()
            miss = vals >= 0
            ids = np.where(miss, INVALID_ID, slot_docs[np.where(miss, 0, slots)]).astype(np.uint32)
            scores = np.where(miss, np.float32(0.0), -vals).astype(np.float32)
        return ids, scores

    # -- search ---------------------------------------------------------------

    def new_search(self) -> "BM25SearchBuilder":
        return BM25SearchBuilder(self)

    def search_batch(
        self,
        queries: list[str],
        k: int = 10,
        document_ids=None,
        *,
        aggregation=None,
        cutoff: int = -1,
        group_size: int = 1,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Each query string scores independently. Returns (ids [Q, k]
        uint32, scores [Q, k] float32); empty slots hold id == 0xFFFFFFFF /
        score == 0. `cutoff` / `group_size` / `aggregation` are the fluent
        pipeline's post-steps per row (descending text semantics)."""
        with span("layer.text.execute"):
            queries = list(queries)
            count("queries", len(queries))
            ids, scores = self._search_batch_core(queries, k, document_ids)
            with span("layer.text.results"):
                return postprocess_batch_rows(
                    ids, scores, k,
                    aggregation=aggregation, cutoff=cutoff, group_size=group_size,
                    ascending=False, empty_score=0.0,
                )

    def _search_batch_core(self, queries: list[str], k: int = 10, document_ids=None):
        with self._lock:
            if self._num_docs == 0:
                q = len(queries)
                return (
                    np.full((q, k), INVALID_ID, dtype=np.uint32),
                    np.zeros((q, k), dtype=np.float32),
                )
            return self._score(queries, k, document_ids)

    def _lookup_node_texts(self, node_ids: list[int]) -> list[str]:
        """More-like-this: rebuild query text from stored tokens
        (bm25_index_search.go:233-261)."""
        terms = self._vocab.terms
        out = []
        for node_id in node_ids:
            node_id = int(node_id)
            if node_id not in self._doc_terms or self._deleted.contains(node_id):
                raise NodeNotFoundError(f"document ID {node_id} not found in index")
            out.append(" ".join(map(terms.__getitem__, self._doc_terms[node_id].tolist())))
        return out

    # -- serialization ----------------------------------------------------------

    def write_to(self, f: BinaryIO) -> None:
        """CB25 v3: explicit per-doc token lists (postings are rebuilt on
        load — tokens round-trip verbatim, including whitespace segments).
        Flushes soft deletes first. The bytes are the reference's, made a
        block of documents at a time from the encoded vocabulary."""
        with self._lock:
            self.flush()
            w = serial.CrcWriter(f)
            serial.write_magic(w, MAGIC, VERSION)
            serial.write_u64(w, len(self._doc_terms))
            enc = [t.encode("utf-8") for t in self._vocab.terms]
            pieces = b"".join(len(e).to_bytes(4, "little") + e for e in enc)
            elen = np.fromiter((4 + len(e) for e in enc), np.int64, count=len(enc))
            docs = sorted(self._doc_terms)
            for lo in range(0, len(docs), SERIAL_BLOCK_DOCS):
                w.write(_encode_docs(docs[lo:lo + SERIAL_BLOCK_DOCS], self._doc_terms,
                                     pieces, elen))
            w.seal()

    def read_from(self, f: BinaryIO) -> None:
        """Reads CB25 v2 or v3 (the stream is read in blocks; bytes past
        the payload are given back with a seek)."""
        r = serial.CrcReader(f)
        version = serial.read_magic(r, MAGIC, VERSION)
        n = serial.read_u64(r)
        vocab = _Vocab()
        term_of: dict[bytes, int] = {}
        docs: list[tuple[int, np.ndarray]] = []
        buf, pos, crc = b"", 0, r._crc
        unpack = _U32.unpack_from
        while len(docs) < n:
            more = f.read(SERIAL_BLOCK_BYTES)
            if not more:
                raise serial.SerializationError("unexpected EOF in CB25 documents")
            buf = buf[pos:] + more
            pos = 0
            # parse every document that lies whole in the buffer
            while len(docs) < n and pos + 8 <= len(buf):
                doc_id, ntok = unpack(buf, pos)[0], unpack(buf, pos + 4)[0]
                p, tids = pos + 8, []
                for _ in range(ntok):
                    if p + 4 > len(buf):
                        break
                    q = p + 4 + unpack(buf, p)[0]
                    if q > len(buf):
                        break
                    raw = buf[p + 4:q]
                    tid = term_of.get(raw)
                    if tid is None:
                        tid = term_of[raw] = vocab[raw.decode("utf-8")]
                    tids.append(tid)
                    p = q
                else:
                    crc = zlib.crc32(buf[pos:p], crc)
                    docs.append((doc_id, np.array(tids, dtype=np.int32)))
                    pos = p
                    continue
                break  # the document runs past the buffer: read more
        rest = buf[pos:]
        if version >= 3:
            if len(rest) < 4:
                rest += f.read(4 - len(rest))
            if len(rest) < 4:
                raise serial.SerializationError("unexpected EOF: missing checksum trailer")
            (want,) = _U32.unpack_from(rest, 0)
            if want != crc:
                raise serial.SerializationError(
                    f"payload checksum mismatch: stored={want:#010x}, computed={crc:#010x}")
            rest = rest[4:]
        if rest:
            f.seek(-len(rest), 1)
        with self._lock:
            self.__init__(wordlike_only=self._wordlike_only, device=self._device)
            self._vocab = vocab
            for doc_id, terms in docs:
                self._add_terms(doc_id, terms)


_U32 = struct.Struct("<I")


def _encode_docs(docs: list[int], doc_terms: dict, pieces: bytes, elen: np.ndarray) -> bytes:
    """The CB25 bytes of `docs`: for each, u32 id, u32 token count, then each
    token as a u32 length and its UTF-8 bytes, gathered from `pieces` (each
    term's encoding, `elen` bytes long, in term-id order)."""
    arrays = [doc_terms[d] for d in docs]
    counts = np.fromiter(map(len, arrays), np.int64, count=len(arrays))
    tids = np.concatenate(arrays).astype(np.int64) if arrays else np.zeros(0, np.int64)
    head = np.empty((len(docs), 2), np.uint32)
    head[:, 0], head[:, 1] = docs, counts
    src = np.frombuffer(pieces + head.tobytes(), np.uint8)
    # pieces in output order: a document's header, then its tokens
    n_pieces = len(docs) + len(tids)
    at_head = np.arange(len(docs)) + np.cumsum(counts) - counts
    is_tok = np.ones(n_pieces, bool)
    is_tok[at_head] = False
    start = np.empty(n_pieces, np.int64)
    size = np.empty(n_pieces, np.int64)
    start[at_head] = len(pieces) + 8 * np.arange(len(docs))
    size[at_head] = 8
    term_start = np.cumsum(elen) - elen
    start[is_tok] = term_start[tids]
    size[is_tok] = elen[tids]
    shift = start - (np.cumsum(size) - size)
    return src[np.repeat(shift, size) + np.arange(int(size.sum()))].tobytes()


class BM25SearchBuilder:
    """Fluent text search (reference: bm25_index_search.go:19-175)."""

    def __init__(self, index: BM25SearchIndex):
        self._index = index
        self._queries: list[str] = []
        self._node_ids: list[int] = []
        self._k = 10
        self._aggregation = ScoreAggregationKind.SUM
        self._cutoff = -1
        self._document_ids: list[int] | Bitset | None = None

    def with_query(self, *queries: str) -> "BM25SearchBuilder":
        self._queries.extend(queries)
        return self

    def with_node(self, *node_ids: int) -> "BM25SearchBuilder":
        self._node_ids.extend(int(i) for i in node_ids)
        return self

    def with_k(self, k: int) -> "BM25SearchBuilder":
        self._k = int(k)
        return self

    def with_score_aggregation(self, kind: ScoreAggregationKind) -> "BM25SearchBuilder":
        self._aggregation = ScoreAggregationKind(kind)
        return self

    def with_cutoff(self, cutoff: int) -> "BM25SearchBuilder":
        self._cutoff = int(cutoff)
        return self

    def with_document_ids(self, doc_ids) -> "BM25SearchBuilder":
        """Accepts an iterable of IDs or a packed Bitset (stays packed)."""
        if isinstance(doc_ids, Bitset):
            self._document_ids = doc_ids
        else:
            self._document_ids = [int(i) for i in doc_ids]
        return self

    def execute(self) -> list[TextResult]:
        """Every query scores on the device, k per query (every match for
        k <= 0), before the aggregation (parity with searchSingleQuery
        returning k results per query)."""
        if not self._queries and not self._node_ids:
            raise InvalidConfigError("must specify either queries or node IDs")

        idx = self._index
        with span("layer.text.execute"):
            with idx._lock:
                queries = list(self._queries)
                if self._node_ids:
                    queries.extend(idx._lookup_node_texts(self._node_ids))
                count("queries", len(queries))
                if idx._num_docs == 0:
                    return []
                ids, scores = idx._score(queries, self._k, self._document_ids,
                                         k_all=self._k <= 0)
            with span("layer.text.results"):
                hit = ids != INVALID_ID
                if not hit.any():
                    return []
                uids, uscores = aggregate_scores(ids[hit], scores[hit], self._aggregation,
                                                 ascending=False)
                results = [TextResult(int(i), float(s)) for i, s in zip(uids, uscores)]
                results = limit_results(results, self._k)
                return autocut_results(results, self._cutoff)
