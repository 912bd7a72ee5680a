"""Packed bitsets and the numeric per-field index (BSI).

Counterpart of comet_tpu/ops/bitset.py: dense packed uint64 words in
numpy, every set operation (AND/OR/ANDNOT) one vectorized word-wise op.
Bit i of word w is document 64w + i. The BSI's comparisons take the
reference's numpy path (compare, packbits, AND with the existence words),
which gives the same words as its C kernel (comet_tpu/native), so the port
carries no native library.
"""

from __future__ import annotations

import numpy as np

_WORD = 64
_BIAS = np.uint64(1 << 63)


class Bitset:
    """Growable packed bitset over uint64 words.

    COPY-ON-WRITE: `share()` returns an O(1) second handle on the same
    word array and flips BOTH handles to copy-before-mutate. Query paths
    (single-plane Eq, memo hits) return shared handles instead of eager
    clones — the roaring reference clones every categorical hit
    (metadata_index.go:263), paying a full-plane copy per query that a
    read-only consumer never needed. Popcounts memoize until mutation.
    """

    __slots__ = ("words", "_shared", "_count")

    def __init__(self, words: np.ndarray | None = None):
        self.words = (
            words if words is not None else np.zeros(1, dtype=np.uint64)
        )
        self._shared = False
        self._count: int | None = None

    def share(self) -> "Bitset":
        """O(1) copy-on-write handle: both this bitset and the returned one
        copy their words before the next mutation (reads stay shared)."""
        self._shared = True
        out = Bitset(self.words)
        out._shared = True
        out._count = self._count
        return out

    def _own(self) -> None:
        """Called before every mutation: materialize a private copy if the
        word array is shared, and invalidate the cached popcount."""
        if self._shared:
            self.words = self.words.copy()
            self._shared = False
        self._count = None

    # -- sizing ------------------------------------------------------------

    def _ensure(self, word_idx: int) -> None:
        if word_idx >= len(self.words):
            new_len = max(word_idx + 1, len(self.words) * 2)
            grown = np.zeros(new_len, dtype=np.uint64)
            grown[: len(self.words)] = self.words
            self.words = grown
            self._shared = False

    @staticmethod
    def _align(a: "Bitset", b: "Bitset") -> tuple[np.ndarray, np.ndarray]:
        la, lb = len(a.words), len(b.words)
        if la == lb:
            return a.words, b.words
        n = max(la, lb)
        wa = np.zeros(n, dtype=np.uint64)
        wa[:la] = a.words
        wb = np.zeros(n, dtype=np.uint64)
        wb[:lb] = b.words
        return wa, wb

    # -- single-bit ops ----------------------------------------------------

    def add(self, i: int) -> None:
        self._own()
        w = i >> 6
        self._ensure(w)
        self.words[w] |= np.uint64(1 << (i & 63))

    def discard(self, i: int) -> None:
        self._own()
        w = i >> 6
        if w < len(self.words):
            self.words[w] &= ~np.uint64(1 << (i & 63))

    def contains(self, i: int) -> bool:
        w = i >> 6
        if w >= len(self.words):
            return False
        return bool((self.words[w] >> np.uint64(i & 63)) & np.uint64(1))

    # -- bulk ops ----------------------------------------------------------

    def add_many(self, ids: np.ndarray) -> None:
        ids = np.asarray(ids, dtype=np.uint64)
        if ids.size == 0:
            return
        self._own()
        self._ensure(int(ids.max()) >> 6)
        np.bitwise_or.at(
            self.words, (ids >> np.uint64(6)).astype(np.int64),
            np.uint64(1) << (ids & np.uint64(63)),
        )

    def discard_many(self, ids: np.ndarray) -> None:
        ids = np.asarray(ids, dtype=np.uint64)
        if ids.size == 0:
            return
        self._own()
        w = (ids >> np.uint64(6)).astype(np.int64)
        in_range = w < len(self.words)
        if not in_range.all():
            ids = ids[in_range]
            w = w[in_range]
        np.bitwise_and.at(
            self.words, w, ~(np.uint64(1) << (ids & np.uint64(63)))
        )

    def contains_many(self, ids: np.ndarray) -> np.ndarray:
        """Vectorized membership over an id array -> bool array."""
        ids = np.asarray(ids, dtype=np.uint64)
        w = (ids >> np.uint64(6)).astype(np.int64)
        in_range = w < len(self.words)
        w_safe = np.where(in_range, w, 0)
        bits = (self.words[w_safe] >> (ids & np.uint64(63))) & np.uint64(1)
        return (bits == 1) & in_range

    # -- set algebra (functional) -----------------------------------------

    def clone(self) -> "Bitset":
        return Bitset(self.words.copy())

    def and_(self, other: "Bitset") -> "Bitset":
        wa, wb = self._align(self, other)
        return Bitset(wa & wb)

    def or_(self, other: "Bitset") -> "Bitset":
        wa, wb = self._align(self, other)
        return Bitset(wa | wb)

    def andnot(self, other: "Bitset") -> "Bitset":
        wa, wb = self._align(self, other)
        return Bitset(wa & ~wb)

    def iand(self, other: "Bitset") -> None:
        self.words = self.and_(other).words
        self._shared = False
        self._count = None

    def ior(self, other: "Bitset") -> None:
        self.words = self.or_(other).words
        self._shared = False
        self._count = None

    def iandnot(self, other: "Bitset") -> None:
        self.words = self.andnot(other).words
        self._shared = False
        self._count = None

    # -- inspection --------------------------------------------------------

    def count(self) -> int:
        if self._count is None:
            self._count = int(np.bitwise_count(self.words).sum())
        return self._count

    def is_empty(self) -> bool:
        return not self.words.any()

    def to_array(self) -> np.ndarray:
        """Sorted array of set bit positions (uint32); fully vectorized."""
        bits = np.unpackbits(self.words.view(np.uint8), bitorder="little")
        return np.flatnonzero(bits).astype(np.uint32)

    @staticmethod
    def from_array(ids) -> "Bitset":
        bs = Bitset()
        bs.add_many(np.asarray(list(ids) if not isinstance(ids, np.ndarray) else ids))
        return bs


class BSI:
    """Numeric per-field index over int64 values (fills the role of the
    reference's roaring BitSliceIndexing, metadata_index.go:332-393).

    The engine is a DENSE biased-uint64 value array + an existence bitmap,
    not bit-sliced planes: doc IDs here are small dense auto-increments, so
    a dense array turns every bulk add into one vectorized scatter (the
    bit-sliced layout pays 64 plane updates per batch) and every comparison
    into one vectorized compare + packbits (vs 64 word-ops with carry
    logic). Values stay BIASED (v + 2^63) so unsigned compares handle
    negatives, and the layout would upload to a device as two int32
    half-planes if a device-resident filter were wanted.

    Comparison results are memoized per (op, value) until the next write —
    production filter traffic repeats predicates, and the reference's
    roaring containers get the same effect from container reuse.
    """

    __slots__ = ("vals", "ebm", "_version", "_cache")

    def __init__(self):
        self.vals = np.zeros(1024, dtype=np.uint64)
        self.ebm = Bitset()
        self._version = 0
        self._cache: dict = {}

    # -- mutation ------------------------------------------------------------

    def _ensure(self, max_id: int) -> None:
        if max_id >= len(self.vals):
            new_len = max(_ceil64(max_id + 1), len(self.vals) * 2)
            grown = np.zeros(new_len, dtype=np.uint64)
            grown[: len(self.vals)] = self.vals
            self.vals = grown

    def _dirty(self) -> None:
        self._version += 1
        if self._cache:
            self._cache.clear()

    def set_value(self, doc_id: int, value: int) -> None:
        self._ensure(doc_id)
        self.vals[doc_id] = (int(value) + (1 << 63)) & ((1 << 64) - 1)
        self.ebm.add(doc_id)
        self._dirty()

    def set_values(self, doc_ids: np.ndarray, values: np.ndarray) -> None:
        """Bulk insert/update — one scatter. Duplicate doc_ids within one
        batch keep the LAST occurrence (numpy fancy assignment semantics,
        matching sequential set_value calls)."""
        doc_ids = np.asarray(doc_ids, dtype=np.uint64)
        if doc_ids.size == 0:
            return
        biased = np.asarray(values, dtype=np.int64).astype(np.uint64) + _BIAS
        self._ensure(int(doc_ids.max()))
        self.vals[doc_ids.astype(np.int64)] = biased
        self.ebm.add_many(doc_ids)
        self._dirty()

    def clear_value(self, doc_id: int) -> None:
        if not self.ebm.contains(doc_id):
            return
        self.ebm.discard(doc_id)
        self._dirty()

    # -- inspection ----------------------------------------------------------

    @property
    def values(self) -> dict[int, int]:
        """doc -> biased value mapping (materialized view for callers that
        iterate contents, e.g. serialization/merge)."""
        ids = self.ebm.to_array()
        return {
            int(d): int(v)
            for d, v in zip(ids.tolist(), self.vals[ids.astype(np.int64)].tolist())
        }

    def doc_values(self) -> tuple[np.ndarray, np.ndarray]:
        """(doc_ids uint32 asc, raw int64 values) for all present docs."""
        ids = self.ebm.to_array()
        vals = (self.vals[ids.astype(np.int64)] - _BIAS).astype(np.int64)
        return ids, vals

    # -- comparisons -----------------------------------------------------------

    def _predicate(self, key, fn, ro: bool = False) -> Bitset:
        hit = self._cache.get(key)
        if hit is not None:
            return hit if ro else hit.share()
        mask = fn(self.vals)  # bool [n], n % 64 == 0
        words = np.packbits(mask, bitorder="little").view(np.uint64)
        ew = self.ebm.words
        if len(ew) < len(words):
            words[len(ew):] = 0
            words[: len(ew)] &= ew
        else:
            words &= ew[: len(words)]
        out = Bitset(words)
        if len(self._cache) >= 256:
            self._cache.clear()
        self._cache[key] = out
        return out if ro else out.share()

    def compare_gt(self, value: int, ro: bool = False) -> Bitset:
        b = np.uint64((int(value) + (1 << 63)) & ((1 << 64) - 1))
        return self._predicate(("gt", int(value)), lambda v: v > b, ro)

    def compare_ge(self, value: int, ro: bool = False) -> Bitset:
        b = np.uint64((int(value) + (1 << 63)) & ((1 << 64) - 1))
        return self._predicate(("ge", int(value)), lambda v: v >= b, ro)

    def compare_eq(self, value: int, ro: bool = False) -> Bitset:
        b = np.uint64((int(value) + (1 << 63)) & ((1 << 64) - 1))
        return self._predicate(("eq", int(value)), lambda v: v == b, ro)

    def compare_lt(self, value: int, ro: bool = False) -> Bitset:
        b = np.uint64((int(value) + (1 << 63)) & ((1 << 64) - 1))
        return self._predicate(("lt", int(value)), lambda v: v < b, ro)

    def compare_le(self, value: int, ro: bool = False) -> Bitset:
        b = np.uint64((int(value) + (1 << 63)) & ((1 << 64) - 1))
        return self._predicate(("le", int(value)), lambda v: v <= b, ro)

    def compare_range(self, lo: int, hi: int, ro: bool = False) -> Bitset:
        """Inclusive [lo, hi]; ro=True may return the cached result object
        (callers must not mutate — the metadata fold path never does)."""
        bl = np.uint64((int(lo) + (1 << 63)) & ((1 << 64) - 1))
        bh = np.uint64((int(hi) + (1 << 63)) & ((1 << 64) - 1))
        return self._predicate(
            ("range", int(lo), int(hi)),
            lambda v: (v >= bl) & (v <= bh), ro,
        )


def _ceil64(n: int) -> int:
    return (n + 63) & ~63
