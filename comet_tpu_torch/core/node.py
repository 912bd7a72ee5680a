"""Node model and global ID generation.

Counterpart of comet_tpu/core/node.py: a process-global auto-increment ID
counter shared by vector and metadata nodes (node.go:7,56,166 of the Go
reference) and the two node types. IDs are uint32; 0 is a valid ID only
when explicitly assigned.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any

import numpy as np

_id_lock = threading.Lock()
_next_id = 0


def next_node_id() -> int:
    """Atomically allocate the next auto-increment node ID (node.go:7)."""
    global _next_id
    with _id_lock:
        _next_id += 1
        return _next_id


def reserve_node_ids(count: int) -> int:
    """Atomically allocate `count` consecutive IDs; returns the first one."""
    global _next_id
    with _id_lock:
        first = _next_id + 1
        _next_id += count
        return first


def ensure_node_id_at_least(value: int) -> None:
    """Bump the auto-increment counter past externally observed IDs, so
    that fresh auto-IDs do not collide with loaded or replayed ones."""
    global _next_id
    with _id_lock:
        _next_id = max(_next_id, int(value))


def _reset_node_id_counter() -> None:
    """Test hook: reset the global counter."""
    global _next_id
    with _id_lock:
        _next_id = 0


@dataclass(frozen=True)
class VectorNode:
    """A vector with an ID (node.go:30)."""

    id: int
    vector: np.ndarray

    def ID(self) -> int:  # noqa: N802 — parity alias
        return self.id

    def Vector(self) -> np.ndarray:  # noqa: N802 — parity alias
        return self.vector


@dataclass(frozen=True)
class MetadataNode:
    """A metadata document with an ID (node.go:134)."""

    id: int
    metadata: dict[str, Any] = field(default_factory=dict)

    def ID(self) -> int:  # noqa: N802 — parity alias
        return self.id

    def Metadata(self) -> dict[str, Any]:  # noqa: N802 — parity alias
        return self.metadata


def new_vector_node(vector: np.ndarray) -> VectorNode:
    """Create a VectorNode with an auto-assigned ID (node.go:56)."""
    return VectorNode(next_node_id(), np.asarray(vector, dtype=np.float32))


def new_vector_node_with_id(node_id: int, vector: np.ndarray) -> VectorNode:
    return VectorNode(int(node_id), np.asarray(vector, dtype=np.float32))


def new_metadata_node(metadata: dict[str, Any]) -> MetadataNode:
    """Create a MetadataNode with an auto-assigned ID (node.go:166)."""
    return MetadataNode(next_node_id(), dict(metadata))


def new_metadata_node_with_id(node_id: int, metadata: dict[str, Any]) -> MetadataNode:
    return MetadataNode(int(node_id), dict(metadata))
