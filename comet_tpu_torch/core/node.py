"""Node model and global ID generation.

Counterpart of comet_tpu/core/node.py: a process-global auto-increment ID
counter (node.go:7,56,166 of the Go reference) and the vector node type.
IDs are uint32; 0 is a valid ID only when explicitly assigned.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

import numpy as np

_id_lock = threading.Lock()
_next_id = 0


def reserve_node_ids(count: int) -> int:
    """Atomically allocate `count` consecutive IDs; returns the first one."""
    global _next_id
    with _id_lock:
        first = _next_id + 1
        _next_id += count
        return first


@dataclass(frozen=True)
class VectorNode:
    """A vector with an ID (node.go:30)."""

    id: int
    vector: np.ndarray

    def ID(self) -> int:  # noqa: N802 — parity alias
        return self.id

    def Vector(self) -> np.ndarray:  # noqa: N802 — parity alias
        return self.vector
