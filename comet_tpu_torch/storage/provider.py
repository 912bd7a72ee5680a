"""Filesystem provider: directory layout, LOCK file, segment files.

Counterpart of comet_tpu/storage/provider.py (the Go reference's
storage_provider.go): an O_EXCL LOCK file holding the pid for
single-process exclusivity, taken over when its holder is dead; segment
files named ``{hybrid,vector,text,metadata}_{id:06d}.bin.gz`` with a
``bloom_{id:06d}.bin`` sidecar; WALs named ``wal_{seq:06d}.log``; the
segment counter re-initialised by scanning the directory.
"""

from __future__ import annotations

import logging
import os
import re
import threading

from comet_tpu_torch.types import CometError

log = logging.getLogger("comet_tpu_torch.storage")

LOCK_FILE = "LOCK"
_SEGMENT_RE = re.compile(r"^hybrid_(\d{6})\.bin\.gz$")
_WAL_RE = re.compile(r"^wal_(\d{6})\.log$")
KINDS = ("hybrid", "vector", "text", "metadata")


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    return True


class StorageLockedError(CometError):
    """Another process holds the directory lock."""


class StorageProvider:
    def __init__(self, base_dir: str):
        self.base_dir = base_dir
        os.makedirs(base_dir, exist_ok=True)
        self._lock_path = os.path.join(base_dir, LOCK_FILE)
        self._acquire_lock()
        self._mu = threading.Lock()
        self._next_id = self._scan_max_id() + 1

    # -- locking -----------------------------------------------------------

    def _acquire_lock(self) -> None:
        for _attempt in range(2):
            try:
                fd = os.open(self._lock_path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            except FileExistsError:
                try:
                    with open(self._lock_path) as f:
                        holder = f.read().strip()
                except OSError:
                    holder = ""
                # stale-lock takeover: a crashed process leaves its LOCK
                # behind; if the holder pid is dead, take the lock so WAL
                # recovery can run
                if _attempt == 0 and holder.isdigit() and not _pid_alive(int(holder)):
                    log.warning(
                        "removing stale LOCK held by dead pid %s in %s",
                        holder, self.base_dir,
                    )
                    try:
                        os.remove(self._lock_path)
                    except FileNotFoundError:
                        pass
                    continue
                raise StorageLockedError(
                    f"storage directory {self.base_dir} is locked by pid {holder or 'unknown'}"
                )
            with os.fdopen(fd, "w") as f:
                f.write(str(os.getpid()))
            return

    def close(self) -> None:
        try:
            os.remove(self._lock_path)
        except FileNotFoundError:
            pass

    # -- segments ----------------------------------------------------------

    def _scan_max_id(self) -> int:
        max_id = -1
        for name in os.listdir(self.base_dir):
            m = _SEGMENT_RE.match(name)
            if m:
                max_id = max(max_id, int(m.group(1)))
        return max_id

    def next_segment_id(self) -> int:
        with self._mu:
            sid = self._next_id
            self._next_id += 1
            return sid

    def segment_paths(self, segment_id: int) -> dict[str, str]:
        return {
            kind: os.path.join(self.base_dir, f"{kind}_{segment_id:06d}.bin.gz")
            for kind in KINDS
        }

    def list_segments(self) -> list[int]:
        """Sorted existing segment IDs (oldest first)."""
        ids = []
        for name in os.listdir(self.base_dir):
            m = _SEGMENT_RE.match(name)
            if m:
                ids.append(int(m.group(1)))
        ids.sort()
        return ids

    def bloom_path(self, segment_id: int) -> str:
        """Doc-ID bloom filter sidecar (storage/bloom.py)."""
        return os.path.join(self.base_dir, f"bloom_{segment_id:06d}.bin")

    def delete_segment(self, segment_id: int) -> None:
        paths = list(self.segment_paths(segment_id).values())
        paths.append(self.bloom_path(segment_id))
        for path in paths:
            try:
                os.remove(path)
            except FileNotFoundError:
                pass

    # -- write-ahead logs ---------------------------------------------------

    def wal_path(self, seq: int) -> str:
        return os.path.join(self.base_dir, f"wal_{seq:06d}.log")

    def list_wals(self) -> list[str]:
        """WAL file paths sorted by sequence (oldest first)."""
        out = []
        for name in os.listdir(self.base_dir):
            m = _WAL_RE.match(name)
            if m:
                out.append((int(m.group(1)), os.path.join(self.base_dir, name)))
        return [p for _, p in sorted(out)]

    def max_wal_seq(self) -> int:
        seqs = [-1]
        for name in os.listdir(self.base_dir):
            m = _WAL_RE.match(name)
            if m:
                seqs.append(int(m.group(1)))
        return max(seqs)
