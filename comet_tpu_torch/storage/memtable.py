"""Memtables: in-memory write buffers over fresh hybrid indexes.

Counterpart of comet_tpu/storage/memtable.py (the Go reference's
storage_memtable.go): the heuristic size of a document (vec*4 + text*2 +
fields*96 + 64), freeze before flush, rotation when full. Every memtable
gets FRESH indexes from the store's factories (the Go reference passes the
same index instances into every rotated memtable), so each holds the
port's `HybridSearchIndex` on the device its factories name.
"""

from __future__ import annotations

import threading
import time
from typing import Callable

import numpy as np

from comet_tpu_torch.core.node import next_node_id
from comet_tpu_torch.hybrid import HybridSearchIndex
from comet_tpu_torch.types import CometError


class MemtableFrozenError(CometError):
    pass


def estimate_document_size(vector, text: str, metadata) -> int:
    """Heuristic bytes of a document (storage_memtable.go:200-224)."""
    size = 64
    if vector is not None:
        size += int(np.size(vector)) * 4
    if text:
        size += len(text) * 2
    if metadata:
        size += len(metadata) * 96
    return size


class Memtable:
    def __init__(self, index: HybridSearchIndex, size_limit: int, wal=None):
        self.index = index
        self.size_limit = size_limit
        self.wal = wal  # optional WalWriter (storage/wal.py)
        self.size_used = 0
        self.num_docs = 0
        self.frozen = False
        self.created_at = time.time()
        self._mu = threading.RLock()

    def has_room_for(self, vector, text, metadata) -> bool:
        return self.size_used + estimate_document_size(vector, text, metadata) <= self.size_limit

    def add(self, vector, text, metadata) -> int:
        doc_id = next_node_id()
        self.add_with_id(doc_id, vector, text, metadata)
        return doc_id

    def add_with_id(self, doc_id: int, vector, text, metadata) -> None:
        with self._mu:
            if self.frozen:
                raise MemtableFrozenError("memtable is frozen")
            # WAL first: a crash between the two leaves at worst an
            # unacknowledged write in the log (replay re-adds it), never an
            # acknowledged in-memory write that recovery cannot replay. A
            # WAL write error raises before the index is touched.
            if self.wal is not None:
                self.wal.append_add(doc_id, vector, text, metadata)
            self.index.add_with_id(doc_id, vector, text, metadata)
            self.size_used += estimate_document_size(vector, text, metadata)
            self.num_docs += 1

    def add_batch(self, entries) -> None:
        """Add many (doc_id, vector, text, metadata) rows: ONE WAL write +
        one group-commit fsync for the whole batch (see wal.py), then the
        in-memory index adds."""
        with self._mu:
            if self.frozen:
                raise MemtableFrozenError("memtable is frozen")
            if self.wal is not None:
                self.wal.append_add_batch(entries)
            self.index.add_batch_with_ids(entries)
            for _doc_id, vector, text, metadata in entries:
                self.size_used += estimate_document_size(vector, text, metadata)
                self.num_docs += 1

    def remove(self, doc_id: int) -> bool:
        with self._mu:
            if not self.index.has_document(doc_id):
                return False
            if self.wal is not None:
                self.wal.append_remove(doc_id)  # WAL before the index mutates
            self.index.remove(doc_id)
            self.num_docs -= 1
            return True

    def freeze(self) -> None:
        with self._mu:
            self.frozen = True

    @property
    def age(self) -> float:
        return time.time() - self.created_at


class MemtableQueue:
    """Active memtable + frozen queue (storage_memtable.go:240-336)."""

    def __init__(
        self,
        memtable_factory: Callable[[], Memtable],
        size_limit: int,
    ):
        self._factory = memtable_factory
        self._size_limit = size_limit
        self._mu = threading.RLock()
        self.mutable = memtable_factory()
        self.queue: list[Memtable] = [self.mutable]

    def add(self, vector, text, metadata) -> int:
        with self._mu:
            if not self.mutable.has_room_for(vector, text, metadata):
                self._rotate()
            return self.mutable.add(vector, text, metadata)

    def add_with_id(self, doc_id: int, vector, text, metadata) -> None:
        with self._mu:
            if not self.mutable.has_room_for(vector, text, metadata):
                self._rotate()
            self.mutable.add_with_id(doc_id, vector, text, metadata)

    def add_batch(self, entries) -> None:
        """Batch insert with rotation between size-limit-sized chunks."""
        with self._mu:
            pending: list = []
            pending_size = 0
            for entry in entries:
                sz = estimate_document_size(entry[1], entry[2], entry[3])
                if (
                    pending
                    and self.mutable.size_used + pending_size + sz
                    > self._size_limit
                ):
                    self.mutable.add_batch(pending)
                    pending, pending_size = [], 0
                    self._rotate()
                pending.append(entry)
                pending_size += sz
            if pending:
                if self.mutable.size_used + pending_size > self._size_limit:
                    if self.mutable.num_docs > 0:
                        self._rotate()
                self.mutable.add_batch(pending)

    def remove(self, doc_id: int) -> bool:
        """Remove from whichever memtable holds the doc (newest wins)."""
        with self._mu:
            for mt in reversed(self.queue):
                with mt._mu:
                    if mt.index.has_document(doc_id):
                        if mt.wal is not None:
                            mt.wal.append_remove(doc_id)
                        mt.index.remove(doc_id)
                        mt.num_docs -= 1
                        return True
            return False

    def rotate(self) -> None:
        with self._mu:
            self._rotate()

    def _rotate(self) -> None:
        self.mutable.freeze()
        self.mutable = self._factory()
        self.queue.append(self.mutable)

    def list_all(self) -> list[Memtable]:
        """All memtables, oldest first (incl. mutable)."""
        with self._mu:
            return list(self.queue)

    def list_frozen(self) -> list[Memtable]:
        """Frozen memtables only (excludes the mutable tail,
        storage_memtable.go:349-361)."""
        with self._mu:
            return [m for m in self.queue if m.frozen]

    def drop(self, memtable: Memtable) -> None:
        with self._mu:
            self.queue = [m for m in self.queue if m is not memtable]

    def total_size(self) -> int:
        with self._mu:
            return sum(m.size_used for m in self.queue)

    def count(self) -> int:
        with self._mu:
            return len(self.queue)
