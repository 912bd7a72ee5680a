"""Per-segment doc-ID bloom filters.

Counterpart of comet_tpu/storage/bloom.py, byte for byte in its sidecar
format. Each flushed or compacted segment gets a small
`bloom_NNNNNN.bin` sidecar built from its doc IDs;
`PersistentHybridIndex.has_document`, `remove` and the tombstone
collection consult it to skip segments that provably hold none of the
requested IDs, without loading the gzip'd index files.

Vectorized splitmix64 double hashing: k probe positions per key, bits in
a packed uint64 word array. ~10 bits a key => ~0.8 % false positives.
"""

from __future__ import annotations

import struct

import numpy as np

MAGIC = b"BLM1"
_MASK = np.uint64(0xFFFFFFFFFFFFFFFF)


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer, vectorized over uint64."""
    with np.errstate(over="ignore"):
        x = (x + np.uint64(0x9E3779B97F4A7C15)) & _MASK
        x = ((x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)) & _MASK
        x = ((x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)) & _MASK
        return x ^ (x >> np.uint64(31))


class BloomFilter:
    """Immutable packed-bit bloom filter over uint64 keys."""

    def __init__(self, words: np.ndarray, k: int):
        self.words = np.ascontiguousarray(words, dtype=np.uint64)
        self.k = int(k)
        self._nbits = np.uint64(len(self.words) * 64)

    @classmethod
    def build(cls, ids, bits_per_key: int = 10, k: int = 7) -> "BloomFilter":
        ids = np.asarray(list(ids) if not isinstance(ids, np.ndarray) else ids,
                         dtype=np.uint64)
        n = max(int(ids.size), 1)
        nwords = max((n * bits_per_key + 63) // 64, 1)
        words = np.zeros(nwords, dtype=np.uint64)
        if ids.size:
            flat = cls._positions(ids, k, np.uint64(nwords * 64)).reshape(-1)
            np.bitwise_or.at(
                words, (flat >> np.uint64(6)).astype(np.int64),
                np.uint64(1) << (flat & np.uint64(63)),
            )
        return cls(words, k)

    @staticmethod
    def _positions(ids: np.ndarray, k: int, nbits: np.uint64) -> np.ndarray:
        """[n, k] probe positions of each key."""
        h1 = _splitmix64(ids)
        h2 = _splitmix64(ids ^ np.uint64(0xA5A5A5A5DEADBEEF)) | np.uint64(1)
        i = np.arange(k, dtype=np.uint64)[None, :]
        with np.errstate(over="ignore"):
            return ((h1[:, None] + i * h2[:, None]) & _MASK) % nbits

    def may_contain(self, doc_id: int) -> bool:
        return self.may_contain_any(np.asarray([doc_id], dtype=np.uint64))

    def may_contain_any(self, ids) -> bool:
        """True unless EVERY id is provably absent."""
        ids = np.asarray(ids, dtype=np.uint64)
        if ids.size == 0:
            return False
        pos = self._positions(ids, self.k, self._nbits)
        bits = (
            self.words[(pos >> np.uint64(6)).astype(np.int64)]
            >> (pos & np.uint64(63))
        ) & np.uint64(1)
        return bool(bits.all(axis=1).any())

    # -- serialization -------------------------------------------------------

    def to_bytes(self) -> bytes:
        return MAGIC + struct.pack("<II", self.k, len(self.words)) + self.words.tobytes()

    @classmethod
    def from_bytes(cls, raw: bytes) -> "BloomFilter":
        if len(raw) < 12 or raw[:4] != MAGIC:
            raise ValueError("not a bloom filter blob")
        k, nwords = struct.unpack_from("<II", raw, 4)
        words = np.frombuffer(raw, dtype=np.uint64, count=nwords, offset=12)
        return cls(words.copy(), k)

    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            f.write(self.to_bytes())

    @classmethod
    def load(cls, path: str) -> "BloomFilter":
        with open(path, "rb") as f:
            return cls.from_bytes(f.read())
