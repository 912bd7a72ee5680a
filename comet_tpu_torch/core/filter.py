"""Document-ID pre-filtering.

The reference wraps a pooled roaring bitmap and calls ShouldSkip per vector
inside every scan loop (document_filter.go:27-65). Here a filter compiles to
a mask over index *slots* once per search, folded into the additive mask
of the device scan — no per-row branching. Filters accept either an
iterable of IDs or a packed `Bitset` (the metadata index's native output),
so the hybrid pre-filter path never materializes an ID list.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np

from comet_tpu_torch.ops.bitset import Bitset


class DocumentFilter:
    """Membership filter over document IDs; None/empty = all eligible."""

    def __init__(self, document_ids: "Iterable[int] | Bitset | None" = None):
        self._bitset: Bitset | None = None
        self._ids: np.ndarray | None = None
        if document_ids is None:
            return
        if isinstance(document_ids, Bitset):
            self._bitset = document_ids
            return
        arr = np.asarray(sorted(set(int(i) for i in document_ids)), dtype=np.uint32)
        if arr.size:
            self._ids = arr

    @property
    def enabled(self) -> bool:
        return self._ids is not None or self._bitset is not None

    def word_mask(self, n_words: int) -> np.ndarray | None:
        """Packed allow-words [n_words] uint64 over doc-id space (bit i of
        word w = doc 64w+i); None when the filter is disabled."""
        if self._bitset is not None:
            out = np.zeros(n_words, dtype=np.uint64)
            m = min(len(self._bitset.words), n_words)
            out[:m] = self._bitset.words[:m]
            return out
        if self._ids is None:
            return None
        bs = Bitset()
        bs.add_many(self._ids[self._ids < n_words * 64])
        out = np.zeros(n_words, dtype=np.uint64)
        m = min(len(bs.words), n_words)
        out[:m] = bs.words[:m]
        return out

    def slot_mask(self, slot_ids: np.ndarray) -> np.ndarray | None:
        """Boolean keep-mask over an index's slot->id array; None if disabled.

        Vectorized: packed-word probes (Bitset) or a sorted membership test.
        """
        if self._bitset is not None:
            return self._bitset.contains_many(np.asarray(slot_ids, dtype=np.uint64))
        if self._ids is None:
            return None
        return np.isin(slot_ids, self._ids, assume_unique=False)
