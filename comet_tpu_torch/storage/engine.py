"""PersistentHybridIndex: LSM-style durable hybrid search.

Counterpart of comet_tpu/storage/engine.py (the Go reference's storage.go),
with the same files, knobs and results: the write path Add -> WAL -> active
memtable -> size-triggered flush signal; background flush and compaction
workers; a flush serializes a frozen memtable to 4 gzip files plus a bloom
sidecar; the read path searches the memtables newest first, then every
segment in a thread pool, and merges; a LOCK file for single-process
exclusivity; Close = final flush + release of the lock. Defaults: 100 MiB
memtable / 200 MiB flush threshold / 5-minute compaction tick / 5-segment
threshold. As in the JAX package: compaction merges for real
(storage/merge.py); `remove` reaches flushed segments through durable
tombstones, masked into segment reads and consumed by compaction;
segment-search errors are logged.

The store detects no device: each memtable and segment index lives where
the configured factories put it (the port's indexes default to "cuda").
Every thread (the caller, the flush worker, the segment-search pool)
launches on its current stream, the default stream unless the caller set
another.
"""

from __future__ import annotations

import copy
import io
import logging
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np

from comet_tpu_torch.core.node import ensure_node_id_at_least, reserve_node_ids
from comet_tpu_torch.hybrid import HybridSearchBuilder, HybridSearchIndex, HybridSearchResult
from comet_tpu_torch.storage import wal as wal_mod
from comet_tpu_torch.storage.bloom import BloomFilter
from comet_tpu_torch.storage.memtable import Memtable, MemtableQueue
from comet_tpu_torch.storage.merge import merge_hybrid, merge_results
from comet_tpu_torch.storage.provider import StorageProvider
from comet_tpu_torch.storage.segment import SegmentManager, SegmentMetadata, write_segment_files
from comet_tpu_torch.types import CometError, InvalidConfigError

log = logging.getLogger("comet_tpu_torch.storage")

DEFAULT_MEMTABLE_SIZE_LIMIT = 100 * 1024 * 1024
DEFAULT_FLUSH_THRESHOLD = 200 * 1024 * 1024
DEFAULT_COMPACTION_INTERVAL = 300.0
DEFAULT_COMPACTION_THRESHOLD = 5


@dataclass
class StorageConfig:
    """Storage knobs (storage.go:87-118), with index FACTORIES instead of
    shared template instances. The factories decide the indexes' device."""

    base_dir: str
    memtable_size_limit: int = DEFAULT_MEMTABLE_SIZE_LIMIT
    flush_threshold: int = DEFAULT_FLUSH_THRESHOLD
    compaction_interval: float = DEFAULT_COMPACTION_INTERVAL
    compaction_threshold: int = DEFAULT_COMPACTION_THRESHOLD
    vector_index_factory: Callable[[], Any] | None = None
    text_index_factory: Callable[[], Any] | None = None
    metadata_index_factory: Callable[[], Any] | None = None
    # Write-ahead logging: crash durability of memtable contents (the Go
    # reference has none and loses unflushed writes).
    wal_enabled: bool = True
    wal_fsync: bool = False


def default_storage_config(base_dir: str) -> StorageConfig:
    return StorageConfig(base_dir=base_dir)


class StorageClosedError(CometError):
    pass


class PersistentHybridIndex:
    """Durable hybrid index with the same fluent search surface."""

    def __init__(self, config: StorageConfig):
        if config is None:
            raise InvalidConfigError("config cannot be nil")
        self.config = config
        self.provider = StorageProvider(config.base_dir)
        self.segments = SegmentManager()
        self._trained_vector_blob: bytes | None = None
        self._closed = False
        self._mu = threading.RLock()
        # serializes flushes: a user-thread flush()/close() racing the
        # background _flush_worker must not both serialize the same frozen
        # memtable into duplicate segments
        self._flush_mu = threading.Lock()
        # segment files written by flushes and compactions: host seconds
        # serializing and deflating, and the streams' bytes before deflating
        self.write_stats = {"serialize_s": 0.0, "deflate_s": 0.0,
                            "bytes": dict.fromkeys(("hybrid", "vector", "text", "metadata"), 0)}
        self._stats_mu = threading.Lock()

        for sid in self.provider.list_segments():
            self.segments.add(
                SegmentMetadata(
                    sid, self.provider.segment_paths(sid), self._make_index,
                    bloom_path=self.provider.bloom_path(sid),
                )
            )

        # Deletion tombstones: doc IDs removed AFTER they were flushed to an
        # immutable segment. Consulted by every segment read, consumed by
        # compaction, durable in a TOMBSTONES sidecar. The Go reference cannot
        # delete flushed docs at all (storage.go:278-296).
        self._tombstones: set[int] = set()
        self._tomb_mu = threading.Lock()
        self._load_tombstones()

        self._wal_seq = self.provider.max_wal_seq() + 1
        surviving_wals = self.provider.list_wals() if config.wal_enabled else []

        self.memtables = MemtableQueue(self._make_memtable, config.memtable_size_limit)

        # Crash recovery: replay surviving WALs into the fresh memtable
        # (records re-log into its new WAL), then discard the old files.
        if surviving_wals:
            self._replay_wals(surviving_wals)

        # Never reuse persisted doc IDs for fresh auto-ID adds.
        self._bump_id_counter()

        self._flush_event = threading.Event()
        self._compact_event = threading.Event()
        self._stop = threading.Event()
        self._flush_thread = threading.Thread(target=self._flush_worker, daemon=True)
        self._compact_thread = threading.Thread(
            target=self._compaction_worker, daemon=True
        )
        self._flush_thread.start()
        self._compact_thread.start()

    # -- index construction ----------------------------------------------------

    def _make_vector_index(self):
        if self.config.vector_index_factory is None:
            return None
        idx = self.config.vector_index_factory()
        if self._trained_vector_blob is not None:
            idx.read_from(io.BytesIO(self._trained_vector_blob))
        return idx

    def _make_index(self) -> HybridSearchIndex:
        return HybridSearchIndex(
            self._make_vector_index(),
            self.config.text_index_factory() if self.config.text_index_factory else None,
            self.config.metadata_index_factory()
            if self.config.metadata_index_factory
            else None,
        )

    def _make_memtable(self) -> Memtable:
        wal = None
        if self.config.wal_enabled:
            wal = wal_mod.WalWriter(
                self.provider.wal_path(self._wal_seq), fsync=self.config.wal_fsync
            )
            self._wal_seq += 1
        return Memtable(self._make_index(), self.config.memtable_size_limit, wal=wal)

    def _replay_wals(self, paths: list[str]) -> None:
        replayed = 0
        for path in paths:
            for op, doc_id, vector, text, metadata in wal_mod.replay(path):
                try:
                    if op == wal_mod.OP_ADD:
                        self.memtables.add_with_id(doc_id, vector, text, metadata)
                        replayed += 1
                    else:
                        self.memtables.remove(doc_id)
                except Exception:
                    log.exception("WAL replay failed for doc %s in %s", doc_id, path)
        for path in paths:
            try:
                os.remove(path)
            except FileNotFoundError:
                pass
        if replayed:
            log.info("recovered %d unflushed writes from WAL", replayed)

    def _bump_id_counter(self) -> None:
        max_id = 0
        for mt in self.memtables.list_all():
            if mt.index._doc_info:
                max_id = max(max_id, max(mt.index._doc_info))
        hint = os.path.join(self.provider.base_dir, "MAXID")
        try:
            with open(hint) as f:
                max_id = max(max_id, int(f.read().strip() or 0))
        except (OSError, ValueError):
            pass
        if max_id:
            ensure_node_id_at_least(max_id)

    def _persist_max_id(self) -> None:
        max_id = 0
        for seg in self.segments.list():
            if seg._cached is not None and seg._cached._doc_info:
                max_id = max(max_id, max(seg._cached._doc_info))
        for mt in self.memtables.list_all():
            if mt.index._doc_info:
                max_id = max(max_id, max(mt.index._doc_info))
        hint = os.path.join(self.provider.base_dir, "MAXID")
        try:
            with open(hint) as f:
                max_id = max(max_id, int(f.read().strip() or 0))
        except (OSError, ValueError):
            pass
        with open(hint, "w") as f:
            f.write(str(max_id))

    # -- deletion tombstones -----------------------------------------------------

    def _tombstones_path(self) -> str:
        return os.path.join(self.provider.base_dir, "TOMBSTONES")

    def _load_tombstones(self) -> None:
        try:
            with open(self._tombstones_path()) as f:
                live: set[int] = set()
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        op, doc = line[0], int(line[1:])
                    except ValueError:
                        continue  # torn tail: ignore the partial record
                    if op == "+":
                        live.add(doc)
                    elif op == "-":
                        live.discard(doc)
                self._tombstones = live
        except FileNotFoundError:
            pass

    def _append_tombstone_op(self, op: str, doc_id: int) -> None:
        with open(self._tombstones_path(), "a") as f:
            f.write(f"{op}{doc_id}\n")
            if self.config.wal_fsync:
                f.flush()
                os.fsync(f.fileno())

    def _add_tombstone(self, doc_id: int) -> None:
        with self._tomb_mu:
            if doc_id in self._tombstones:
                return
            self._tombstones.add(doc_id)
            self._append_tombstone_op("+", doc_id)

    def _discard_tombstone(self, doc_id: int) -> None:
        with self._tomb_mu:
            if doc_id not in self._tombstones:
                return
            self._tombstones.discard(doc_id)
            self._append_tombstone_op("-", doc_id)

    def _rewrite_tombstones(self) -> None:
        """Compact the op log to the live set (called from flush)."""
        with self._tomb_mu:
            path = self._tombstones_path()
            if not self._tombstones:
                try:
                    os.remove(path)
                except FileNotFoundError:
                    pass
                return
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                for doc in sorted(self._tombstones):
                    f.write(f"+{doc}\n")
                if self.config.wal_fsync:
                    f.flush()
                    os.fsync(f.fileno())
            os.replace(tmp, path)

    def _gc_tombstones(self) -> None:
        """Drop tombstones no remaining segment can contain (post-compaction;
        bloom false-positives only ever KEEP a tombstone — safe)."""
        with self._tomb_mu:
            if not self._tombstones:
                return
            segments = self.segments.list()
            dead = [
                doc
                for doc in self._tombstones
                if not any(seg.may_contain(doc) for seg in segments)
            ]
        for doc in dead:
            self._discard_tombstone(doc)

    # -- write path ------------------------------------------------------------

    def _check_open(self):
        if self._closed:
            raise StorageClosedError("storage is closed")

    def add(self, vector=None, text: str = "", metadata=None) -> int:
        self._check_open()
        doc_id = self.memtables.add(vector, text, metadata)
        self._maybe_schedule_flush()
        return doc_id

    def add_with_id(self, doc_id: int, vector=None, text: str = "", metadata=None) -> None:
        self._check_open()
        self._discard_tombstone(doc_id)  # re-adding resurrects the ID
        self.memtables.add_with_id(doc_id, vector, text, metadata)
        self._maybe_schedule_flush()

    def add_batch(self, docs) -> list[int]:
        """Bulk ingest: docs = iterable of (vector, text, metadata). One WAL
        write + one group-commit fsync per memtable chunk (wal.py), so
        fsync'd ingest runs at batch speed instead of per-record fsync."""
        self._check_open()
        docs = list(docs)
        if not docs:
            return []
        first = reserve_node_ids(len(docs))
        ids = list(range(first, first + len(docs)))
        self.memtables.add_batch(
            [(i, v, t, m) for i, (v, t, m) in zip(ids, docs)]
        )
        self._maybe_schedule_flush()
        return ids

    def remove(self, doc_id: int) -> bool:
        """Remove a document EVERYWHERE: memtables directly, and flushed
        immutable segments via a durable tombstone masked into every segment
        read and consumed by compaction. (The Go reference can only remove
        from the active memtable, storage.go:278-296.)"""
        self._check_open()
        removed_mem = self.memtables.remove(doc_id)
        removed_seg = False
        for seg in self.segments.list():
            if seg.may_contain(doc_id) and seg.get_index().has_document(doc_id):
                removed_seg = True
                break
        if removed_seg:
            self._add_tombstone(doc_id)
        return removed_mem or removed_seg

    def has_document(self, doc_id: int) -> bool:
        """Point lookup: memtables first, then segments — loading a segment
        only if its bloom sidecar says the ID may be present."""
        self._check_open()
        for mt in reversed(self.memtables.list_all()):
            if mt.index.has_document(doc_id):
                return True
        if doc_id in self._tombstones:
            return False  # deleted post-flush; segment copies are masked
        for seg in self.segments.list():
            if seg.may_contain(doc_id) and seg.get_index().has_document(doc_id):
                return True
        return False

    def train(self, vectors: np.ndarray) -> None:
        """Train the vector template; every future memtable/segment index
        clones the trained state (storage.go:328-347 trains its shared
        template instance)."""
        self._check_open()
        if self.config.vector_index_factory is None:
            raise InvalidConfigError("no vector index configured")
        template = self.config.vector_index_factory()
        template.train(vectors)
        buf = io.BytesIO()
        template.write_to(buf)
        self._trained_vector_blob = buf.getvalue()
        # the current mutable memtable was created untrained; rotate it out
        # if empty so new writes land on a trained index
        with self.memtables._mu:
            if self.memtables.mutable.num_docs == 0:
                old = self.memtables.mutable
                self.memtables.queue.remove(old)
                if old.wal is not None:
                    old.wal.delete()
                self.memtables.mutable = self._make_memtable()
                self.memtables.queue.append(self.memtables.mutable)

    def _maybe_schedule_flush(self) -> None:
        if self.memtables.total_size() >= self.config.flush_threshold:
            self._flush_event.set()

    # -- flush -----------------------------------------------------------------

    def flush(self) -> None:
        """Freeze the active memtable (if non-empty) and flush all frozen
        memtables to segments (storage.go:650-679)."""
        self._check_open()
        with self._flush_mu:
            if self.memtables.mutable.num_docs > 0:
                self.memtables.rotate()
            self._flush_frozen()
            self._rewrite_tombstones()

    def _flush_frozen(self) -> None:
        for mt in self.memtables.list_frozen():
            try:
                self._flush_memtable(mt)
            except Exception:  # pragma: no cover - defensive
                log.exception("flush of memtable failed")

    def _flush_memtable(self, mt: Memtable) -> None:
        """Serialize one frozen memtable to 4 gzip files (storage.go:682-799)."""
        if mt.num_docs == 0 or mt.index.count() == 0:
            self.memtables.drop(mt)
            if mt.wal is not None:
                mt.wal.delete()
            return
        sid = self.provider.next_segment_id()
        paths = self.provider.segment_paths(sid)
        self._write_segment(paths, mt.index)
        bloom_path = self.provider.bloom_path(sid)
        self._write_bloom(bloom_path, mt.index)
        segment = SegmentMetadata(
            sid, paths, self._make_index, bloom_path=bloom_path
        )
        segment._cached = mt.index  # already in memory; no need to reload
        self.segments.add(segment)
        self.memtables.drop(mt)
        self._persist_max_id()
        if mt.wal is not None:
            mt.wal.delete()  # contents now durable in the segment

    def _write_segment(self, paths: dict[str, str], index: HybridSearchIndex) -> None:
        """The 4 gzip'd files of a segment (segment.write_segment_files),
        counted in `write_stats`."""
        ser, defl, sizes = write_segment_files(paths, index)
        with self._stats_mu:
            self.write_stats["serialize_s"] += ser
            self.write_stats["deflate_s"] += defl
            for kind, n in sizes.items():
                self.write_stats["bytes"][kind] += n

    def _write_bloom(self, path: str, index: HybridSearchIndex) -> None:
        """Doc-ID bloom sidecar so point lookups can skip this segment
        without loading it (storage/bloom.py)."""
        try:
            BloomFilter.build(list(index._doc_info)).save(path)
        except OSError:  # pragma: no cover - sidecar is best-effort
            log.exception("bloom sidecar write failed for %s", path)

    def _flush_worker(self) -> None:
        while not self._stop.is_set():
            if self._flush_event.wait(timeout=0.1):
                self._flush_event.clear()
                try:
                    self.flush()
                except StorageClosedError:
                    return
                except Exception:  # pragma: no cover - defensive
                    log.exception("background flush failed")

    # -- compaction --------------------------------------------------------------

    def trigger_compaction(self) -> None:
        self._compact_event.set()

    def _compaction_worker(self) -> None:
        while not self._stop.is_set():
            if self._compact_event.wait(timeout=self.config.compaction_interval):
                self._compact_event.clear()
            if self._stop.is_set():
                return
            try:
                self.maybe_compact()
            except StorageClosedError:
                return
            except Exception:  # pragma: no cover - defensive
                log.exception("background compaction failed")

    def maybe_compact(self) -> None:
        """Merge the oldest `compaction_threshold` segments into one, for
        real (the Go reference's merge is a data-losing stub,
        storage_compaction.go:66-72)."""
        with self._mu:
            self._check_open()
            candidates = self.segments.list()
            if len(candidates) < self.config.compaction_threshold:
                return
            to_merge = candidates[: self.config.compaction_threshold]

            merged = self._make_index()
            # tombstoned docs are consumed here: seeding `skip` drops them
            # from the merged output for good
            with self._tomb_mu:
                seen: set[int] = set(self._tombstones)
            # newest source first => newest version of a doc wins
            for seg in reversed(to_merge):
                seen |= merge_hybrid(merged, seg.get_index(), seen)

            if merged._doc_info:
                sid = self.provider.next_segment_id()
                paths = self.provider.segment_paths(sid)
                self._write_segment(paths, merged)
                bloom_path = self.provider.bloom_path(sid)
                self._write_bloom(bloom_path, merged)
                new_seg = SegmentMetadata(
                    sid, paths, self._make_index, bloom_path=bloom_path
                )
                new_seg._cached = merged
                self.segments.add(new_seg)
            for seg in to_merge:
                self.segments.remove(seg.segment_id)
                self.provider.delete_segment(seg.segment_id)
        # tombstones whose last possible copy was just compacted away are done
        self._gc_tombstones()

    # -- read path ---------------------------------------------------------------

    def new_search(self) -> "PersistentHybridSearchBuilder":
        self._check_open()
        return PersistentHybridSearchBuilder(self)

    def _search_all_sources(self, builder: HybridSearchBuilder, k: int) -> list[HybridSearchResult]:
        # memtables newest first, then segments (parallel), storage.go:489-629
        sources: list[HybridSearchIndex] = [
            mt.index for mt in reversed(self.memtables.list_all())
        ]
        segments = self.segments.list()

        def run(index: HybridSearchIndex):
            b = copy.copy(builder)
            b._index = index
            # call the base implementation: the persistent builder's own
            # execute() is the fan-out entry point
            return HybridSearchBuilder.execute(b)

        result_lists = [run(idx) for idx in sources]
        if segments:
            tombstones = self._tombstones  # snapshot reference; set ops are atomic

            # the lazy gzip load happens INSIDE the worker so a corrupt or
            # truncated segment fails that one source, not the whole search
            def run_segment(seg: SegmentMetadata):
                hits = run(seg.get_index())
                if tombstones:
                    # deleted-after-flush docs are masked out of segment reads
                    hits = [r for r in hits if r.id not in tombstones]
                return hits

            with ThreadPoolExecutor(max_workers=min(8, len(segments))) as pool:
                futures = [pool.submit(run_segment, seg) for seg in segments]
                for fut in futures:
                    try:
                        result_lists.append(fut.result())
                    except Exception:
                        log.exception("segment search failed")

        vector_only = builder._vector_query is not None and not builder._text_queries
        return merge_results(result_lists, k, descending=not vector_only)

    # -- lifecycle / stats --------------------------------------------------------

    def stats(self) -> dict[str, int]:
        return {
            "memtables": self.memtables.count(),
            "memtable_bytes": self.memtables.total_size(),
            "segments": self.segments.count(),
            "segment_bytes": self.segments.total_size(),
        }

    def close(self) -> None:
        """Final flush, stop workers, release the lock (storage.go:849-870)."""
        with self._mu:
            if self._closed:
                return
            try:
                self.flush()
                # everything durable in segments: drop now-empty WALs
                for mt in self.memtables.list_all():
                    if mt.num_docs == 0 and mt.wal is not None:
                        mt.wal.delete()
            finally:
                self._closed = True
        self._stop.set()
        self._flush_event.set()
        self._compact_event.set()
        self._flush_thread.join(timeout=5)
        self._compact_thread.join(timeout=5)
        self.provider.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def open_persistent_hybrid_index(config: StorageConfig) -> PersistentHybridIndex:
    return PersistentHybridIndex(config)


class PersistentHybridSearchBuilder(HybridSearchBuilder):
    """Same fluent surface; fans out over memtables + segments and merges."""

    def __init__(self, store: PersistentHybridIndex):
        super().__init__(index=None)  # bound per-source at execute time
        self._store = store

    def execute(self) -> list[HybridSearchResult]:
        self._store._check_open()
        return self._store._search_all_sources(self, self._k)
