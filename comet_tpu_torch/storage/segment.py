"""Immutable on-disk segments with lazy load + cache.

Counterpart of comet_tpu/storage/segment.py (the Go reference's
storage_segment.go): gzip'd 4-file snapshots, double-checked lazy loading
into a cached in-memory hybrid index, cache eviction, the doc-ID bloom
sidecar, and the segment manager. A segment's first search after a reopen
loads it: the files are parsed on the host and the indexes' device state
is built on the device the store's factories name.

Segment files are written as the reference writes them through
`gzip.open(p, "wb")`: the same decompressed bytes, deflated at the same
level (9, gzip's default), into one gzip member each. Level 9 deflates
this data at about 1-3 MB/s a core, so `write_segment_files` deflates
1 MiB blocks in a thread pool, each block primed with the 32 KiB before it
and ended on a byte boundary (pigz's layout); only the compressed bytes
differ from a serial deflate, and they differ anyway by the header's time.
"""

from __future__ import annotations

import gzip
import io
import os
import struct
import threading
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Callable

from comet_tpu_torch.hybrid import HybridSearchIndex
from comet_tpu_torch.storage.bloom import BloomFilter

GZIP_LEVEL = 9             # gzip.open's default, the reference's level
GZIP_BLOCK = 1 << 20       # bytes one worker deflates at once
GZIP_WINDOW = 1 << 15      # deflate's window: the dictionary of a block
GZIP_WORKERS = min(8, os.cpu_count() or 1)


def _deflate_block(data: memoryview, lo: int, hi: int) -> bytes:
    """Raw deflate of data[lo:hi] primed with the window before it; a
    middle block ends with a sync flush (byte-aligned, not final), the
    last with the final block."""
    prime = {"zdict": bytes(data[max(0, lo - GZIP_WINDOW):lo])} if lo else {}
    c = zlib.compressobj(GZIP_LEVEL, zlib.DEFLATED, -zlib.MAX_WBITS, **prime)
    last = hi == len(data)
    return c.compress(data[lo:hi]) + c.flush(zlib.Z_FINISH if last else zlib.Z_SYNC_FLUSH)


def _gzip_header(path: str) -> bytes:
    """The header gzip.GzipFile writes at level 9: the file's name without
    '.gz' and the time."""
    name = os.path.basename(path).encode("latin-1")
    if name.endswith(b".gz"):
        name = name[:-3]
    return (b"\037\213\010" + bytes([0x08 if name else 0])
            + struct.pack("<I", int(time.time())) + b"\002\377"
            + (name + b"\000" if name else b""))


def write_segment_files(paths: dict[str, str], index: HybridSearchIndex):
    """Write `index` to its 4 gzip'd files (kind -> path). Returns the
    seconds spent serializing and deflating, and each stream's bytes
    before deflating (kind -> bytes)."""
    t0 = time.perf_counter()
    bufs = {kind: io.BytesIO() for kind in paths}
    index.write_to(bufs["hybrid"], bufs["vector"], bufs["text"], bufs["metadata"])
    t1 = time.perf_counter()
    views = {kind: buf.getbuffer() for kind, buf in bufs.items()}
    with ThreadPoolExecutor(GZIP_WORKERS) as pool:
        # every stream's blocks are queued before any is collected
        jobs = {kind: [pool.submit(_deflate_block, v, lo, min(lo + GZIP_BLOCK, len(v)))
                       for lo in range(0, max(len(v), 1), GZIP_BLOCK)]
                for kind, v in views.items()}
        for kind, path in paths.items():
            v = views[kind]
            with open(path, "wb") as f:
                f.write(_gzip_header(path))
                for job in jobs[kind]:
                    f.write(job.result())
                f.write(struct.pack("<II", zlib.crc32(v), len(v) & 0xFFFFFFFF))
    sizes = {kind: len(v) for kind, v in views.items()}
    for v in views.values():
        v.release()
    return t1 - t0, time.perf_counter() - t1, sizes


class SegmentMetadata:
    def __init__(
        self,
        segment_id: int,
        paths: dict[str, str],
        index_factory: Callable[[], HybridSearchIndex],
        bloom_path: str | None = None,
    ):
        self.segment_id = segment_id
        self.paths = paths
        self._factory = index_factory
        self._mu = threading.Lock()
        self._cached: HybridSearchIndex | None = None
        self._bloom_path = bloom_path
        self._bloom = None
        self._bloom_loaded = False
        self.load_seconds = 0.0  # the last lazy load's host + device time

    # -- doc-ID bloom sidecar (storage/bloom.py) -----------------------------------

    def _get_bloom(self):
        if not self._bloom_loaded:
            with self._mu:
                if not self._bloom_loaded:
                    if self._bloom_path is not None:
                        try:
                            self._bloom = BloomFilter.load(self._bloom_path)
                        except (OSError, ValueError):
                            self._bloom = None  # missing/corrupt: can't skip
                    self._bloom_loaded = True
        return self._bloom

    def may_contain(self, doc_id: int) -> bool:
        bloom = self._get_bloom()
        return True if bloom is None else bloom.may_contain(doc_id)

    def may_contain_any(self, doc_ids) -> bool:
        bloom = self._get_bloom()
        return True if bloom is None else bloom.may_contain_any(doc_ids)

    def get_index(self) -> HybridSearchIndex:
        """Lazy double-checked load (storage_segment.go:58-166)."""
        cached = self._cached
        if cached is not None:
            return cached
        with self._mu:
            if self._cached is None:
                t0 = time.perf_counter()
                index = self._factory()
                streams = {}
                try:
                    for kind, path in self.paths.items():
                        if os.path.exists(path):
                            streams[kind] = gzip.open(path, "rb")
                        else:
                            streams[kind] = None
                    index.read_from(
                        streams["hybrid"],
                        streams["vector"],
                        streams["text"],
                        streams["metadata"],
                    )
                finally:
                    for s in streams.values():
                        if s is not None:
                            s.close()
                self._cached = index
                self.load_seconds = time.perf_counter() - t0
            return self._cached

    def evict_cache(self) -> None:
        with self._mu:
            self._cached = None

    @property
    def is_cached(self) -> bool:
        return self._cached is not None

    def total_size(self) -> int:
        size = 0
        for path in self.paths.values():
            try:
                size += os.path.getsize(path)
            except OSError:
                pass
        return size


class SegmentManager:
    def __init__(self):
        self._mu = threading.RLock()
        self._segments: dict[int, SegmentMetadata] = {}

    def add(self, segment: SegmentMetadata) -> None:
        with self._mu:
            self._segments[segment.segment_id] = segment

    def remove(self, segment_id: int) -> SegmentMetadata | None:
        with self._mu:
            return self._segments.pop(segment_id, None)

    def get(self, segment_id: int) -> SegmentMetadata | None:
        with self._mu:
            return self._segments.get(segment_id)

    def list(self) -> list[SegmentMetadata]:
        """Segments sorted oldest first."""
        with self._mu:
            return [self._segments[i] for i in sorted(self._segments)]

    def count(self) -> int:
        with self._mu:
            return len(self._segments)

    def total_size(self) -> int:
        with self._mu:
            return sum(s.total_size() for s in self._segments.values())

    def evict_all_caches(self) -> None:
        with self._mu:
            for s in self._segments.values():
                s.evict_cache()
