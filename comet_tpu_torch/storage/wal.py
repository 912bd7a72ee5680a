"""Write-ahead log for memtable durability.

Counterpart of comet_tpu/storage/wal.py, with the same record bytes: every
memtable write appends a length-prefixed binary record to
`wal_NNNNNN.log` before it touches the in-memory index; on reopen after a
crash the surviving WALs replay into a fresh memtable. A memtable's WAL
is deleted once its contents are durably flushed to a segment.

Record format (little-endian): u32 total length, then
  u8 op (1=add, 2=remove), u32 doc_id,
  u8 has_vector [+ f32 array], str text, str metadata-json.
A torn tail (a partial last record after a crash) is detected by the
length prefix and dropped; a corrupt record stops replay at the last good
one.
"""

from __future__ import annotations

import io
import json
import os
import struct
import threading
from typing import Any, Iterator

import numpy as np

from comet_tpu_torch.io import serial

OP_ADD = 1
OP_REMOVE = 2


def _encode(op: int, doc_id: int, vector, text: str, metadata) -> bytes:
    body = io.BytesIO()
    body.write(struct.pack("<BI", op, doc_id))
    if op == OP_ADD:
        has_vec = vector is not None and np.size(vector) > 0
        body.write(struct.pack("<B", 1 if has_vec else 0))
        if has_vec:
            serial.write_array(body, np.asarray(vector, dtype=np.float32))
        serial.write_str(body, text or "")
        serial.write_str(body, json.dumps(metadata) if metadata else "")
    raw = body.getvalue()
    return struct.pack("<I", len(raw)) + raw


def _decode(raw: bytes):
    f = io.BytesIO(raw)
    op, doc_id = struct.unpack("<BI", f.read(5))
    if op == OP_REMOVE:
        return op, doc_id, None, "", None
    (has_vec,) = struct.unpack("<B", f.read(1))
    vector = serial.read_array(f) if has_vec else None
    text = serial.read_str(f)
    meta_raw = serial.read_str(f)
    metadata = json.loads(meta_raw) if meta_raw else None
    return op, doc_id, vector, text, metadata


class WalWriter:
    """Append-only log of one memtable.

    With ``fsync=True`` durability uses GROUP COMMIT: concurrent appends
    elect one leader that issues a single fsync covering every record
    written (and flushed) before it; followers wait for a sync whose
    coverage includes their record. A batch append writes all its records
    in one call and joins the same protocol, so fsync'd bulk ingest pays
    about one fsync a batch.
    """

    def __init__(self, path: str, fsync: bool = False):
        self.path = path
        self._fsync = fsync
        self._f = open(path, "ab")
        self._mu = threading.Lock()
        # group-commit state (guarded by the condition's own lock)
        self._sync_cv = threading.Condition()
        self._write_seq = 0   # appends written and flushed (under _mu)
        self._sync_seq = 0    # highest write_seq covered by an fsync
        self._syncing = False

    def append_add(self, doc_id: int, vector, text: str, metadata) -> None:
        self._append(_encode(OP_ADD, doc_id, vector, text, metadata))

    def append_add_batch(self, entries) -> None:
        """Append many (doc_id, vector, text, metadata) records: one write,
        one flush and (with fsync) one group-commit fsync."""
        blob = b"".join(
            _encode(OP_ADD, doc_id, vector, text, metadata)
            for doc_id, vector, text, metadata in entries
        )
        if blob:
            self._append(blob)

    def append_remove(self, doc_id: int) -> None:
        self._append(_encode(OP_REMOVE, doc_id, None, "", None))

    def _append(self, record: bytes) -> None:
        with self._mu:
            self._f.write(record)
            self._f.flush()
            self._write_seq += 1
            my_seq = self._write_seq
        if self._fsync:
            self._group_sync(my_seq)

    def _group_sync(self, my_seq: int) -> None:
        with self._sync_cv:
            while self._sync_seq < my_seq:
                if not self._syncing:
                    self._syncing = True
                    break
                self._sync_cv.wait()
            else:
                return  # a leader's fsync already covered this record
        # the leader (outside the condition's lock: fsync can be slow)
        try:
            with self._mu:
                cover = self._write_seq  # every record flushed so far
                os.fsync(self._f.fileno())
        finally:
            with self._sync_cv:
                self._syncing = False
                self._sync_seq = max(self._sync_seq, cover)
                self._sync_cv.notify_all()

    def close(self) -> None:
        with self._mu:
            if not self._f.closed:
                self._f.close()

    def delete(self) -> None:
        self.close()
        try:
            os.remove(self.path)
        except FileNotFoundError:
            pass


def replay(path: str) -> Iterator[tuple[int, int, Any, str, Any]]:
    """Yield (op, doc_id, vector, text, metadata) records; a torn last
    record (a crash mid-write) is dropped silently."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except FileNotFoundError:
        return
    pos = 0
    while pos + 4 <= len(data):
        (length,) = struct.unpack_from("<I", data, pos)
        if pos + 4 + length > len(data):
            break  # torn tail
        try:
            record = _decode(data[pos + 4 : pos + 4 + length])
        except Exception:
            break  # corrupt record: stop at the last good prefix
        yield record
        pos += 4 + length
