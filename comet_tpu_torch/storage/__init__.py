"""LSM-style persistent storage for the hybrid index.

Counterpart of comet_tpu/storage/, with the same on-disk formats: memtables
(fresh in-memory hybrid indexes) rotate when full, flush to immutable
gzip'd 4-file segments with a doc-ID bloom sidecar, load lazily with a
cache on the read path, and compact by merging for real. A WAL makes
memtable writes durable, a TOMBSTONES log makes removals of flushed
documents durable. See engine.py.
"""

from comet_tpu_torch.storage.engine import (
    DEFAULT_COMPACTION_INTERVAL,
    DEFAULT_COMPACTION_THRESHOLD,
    DEFAULT_FLUSH_THRESHOLD,
    DEFAULT_MEMTABLE_SIZE_LIMIT,
    PersistentHybridIndex,
    StorageClosedError,
    StorageConfig,
    default_storage_config,
    open_persistent_hybrid_index,
)
from comet_tpu_torch.storage.provider import StorageLockedError, StorageProvider
from comet_tpu_torch.storage.merge import MergeError, merge_hybrid, merge_results

__all__ = [
    "StorageConfig",
    "default_storage_config",
    "PersistentHybridIndex",
    "open_persistent_hybrid_index",
    "StorageClosedError",
    "StorageLockedError",
    "StorageProvider",
    "MergeError",
    "merge_hybrid",
    "merge_results",
    "DEFAULT_MEMTABLE_SIZE_LIMIT",
    "DEFAULT_FLUSH_THRESHOLD",
    "DEFAULT_COMPACTION_INTERVAL",
    "DEFAULT_COMPACTION_THRESHOLD",
]
