"""Packed bitsets over uint64 words.

Counterpart of the `Bitset` class of comet_tpu/ops/bitset.py, as far as
the document filter needs it; copy-on-write sharing and the bit-sliced
index (BSI) come with the metadata slice. Bit i of word w is document
64w + i.
"""

from __future__ import annotations

import numpy as np


class Bitset:
    """Growable packed bitset over uint64 words."""

    __slots__ = ("words",)

    def __init__(self, words: np.ndarray | None = None):
        self.words = (
            words if words is not None else np.zeros(1, dtype=np.uint64)
        )

    def _ensure(self, word_idx: int) -> None:
        if word_idx >= len(self.words):
            new_len = max(word_idx + 1, len(self.words) * 2)
            grown = np.zeros(new_len, dtype=np.uint64)
            grown[: len(self.words)] = self.words
            self.words = grown

    def add(self, i: int) -> None:
        w = i >> 6
        self._ensure(w)
        self.words[w] |= np.uint64(1 << (i & 63))

    def add_many(self, ids: np.ndarray) -> None:
        ids = np.asarray(ids, dtype=np.uint64)
        if ids.size == 0:
            return
        self._ensure(int(ids.max()) >> 6)
        np.bitwise_or.at(
            self.words, (ids >> np.uint64(6)).astype(np.int64),
            np.uint64(1) << (ids & np.uint64(63)),
        )

    def contains_many(self, ids: np.ndarray) -> np.ndarray:
        """Vectorized membership over an id array -> bool array."""
        ids = np.asarray(ids, dtype=np.uint64)
        w = (ids >> np.uint64(6)).astype(np.int64)
        in_range = w < len(self.words)
        w_safe = np.where(in_range, w, 0)
        bits = (self.words[w_safe] >> (ids & np.uint64(63))) & np.uint64(1)
        return (bits == 1) & in_range

    @staticmethod
    def from_array(ids) -> "Bitset":
        bs = Bitset()
        bs.add_many(np.asarray(list(ids) if not isinstance(ids, np.ndarray) else ids))
        return bs
