"""comet_tpu_torch — the PyTorch / CUDA port of comet_tpu.

It runs on one NVIDIA Hopper card (or on the CPU, for tests) and covers
exact flat search (`FlatIndex`: float32 storage, and bfloat16, float16 or
int8 storage with an optional float32 rerank), IVF search (`IVFIndex`),
product quantisation (`PQIndex`, `IVFPQIndex`, `calculate_pq_params`;
OPQ, and the IVFPQ exact re-rank `nrefine`), the scalar quantizers
(`new_quantizer`) and HNSW bulk build, incremental insertion and search
(`HNSWIndex`: blocked or packed routing tables, a seeded or classic
start), the hybrid layer (`BM25SearchIndex`, `RoaringMetadataIndex` and
its filters, `Fusion`, `HybridSearchIndex`, the index contracts) and the
LSM store (`PersistentHybridIndex`, `StorageConfig`: WAL, memtables,
segments, bloom sidecars, compaction), with the host layer they need. Its CUDA kernels, written by hand
for sm_90a, replace every Pallas kernel of the reference (ops/sortnet.py:
top-k select; ops/fused_scan.py: fused distance scan, flat mode over a
float32, bf16, float16 or int8 corpus (the last two the reference's XLA
scans) and nprobe mode;
ops/ivf_sparse.py: block-sparse IVF scan, float32 and bf16 modes;
ops/beam_kernel.py: the HNSW beam's merge step, its in-loop scoring, and
the fused expand kernel that scores and merges in one launch), and the
reference's XLA BM25 scorer (ops/bm25.py, whose top-k is the top-k select). Every index
runs on the card unless it is given `device="cpu"`; nothing falls back
from the card to the CPU.

The package imports torch and numpy, never jax and never comet_tpu.
"""
from comet_tpu_torch.types import (
    DistanceKind,
    VectorIndexKind,
    ScoreAggregationKind,
    FusionKind,
    CometError,
    ZeroVectorError,
    DimensionMismatchError,
    NotTrainedError,
    NodeNotFoundError,
    InvalidConfigError,
)
from comet_tpu_torch.core.node import (
    VectorNode,
    MetadataNode,
    new_vector_node,
    new_vector_node_with_id,
    new_metadata_node,
    new_metadata_node_with_id,
)
from comet_tpu_torch.core.results import VectorResult, TextResult, Reranker
from comet_tpu_torch.core.limiter import sanitize_k, limit_results, autocut, autocut_results
from comet_tpu_torch.core.aggregation import (
    aggregate_vector_results,
    aggregate_text_results,
)
from comet_tpu_torch.ops.bitset import BSI, Bitset
from comet_tpu_torch.indexes.flat import FlatIndex
from comet_tpu_torch.indexes.ivf import IVFIndex
from comet_tpu_torch.indexes.hnsw import HNSWConfig, HNSWIndex
from comet_tpu_torch.indexes.pq import PQIndex, calculate_pq_params
from comet_tpu_torch.indexes.ivfpq import IVFPQIndex
from comet_tpu_torch.indexes.bm25 import BM25SearchIndex
from comet_tpu_torch.indexes.metadata import (
    RoaringMetadataIndex,
    Filter,
    FilterGroup,
    MetadataResult,
    eq, ne, gt, gte, lt, lte, range_filter, in_filter, not_in, exists, not_exists,
    not_, between, anyof, noneof, is_null, is_not_null,
)
from comet_tpu_torch.fusion import Fusion, FusionConfig, new_fusion, default_fusion
from comet_tpu_torch.hybrid import (
    HybridSearchIndex,
    HybridSearchResult,
    fuse_batch_rows,
    new_hybrid_search_index,
)
from comet_tpu_torch.indexes.contracts import (
    VectorIndex,
    TextIndex,
    MetadataIndex,
    HybridIndex,
    check_contracts,
)
from comet_tpu_torch.storage import (
    StorageConfig,
    default_storage_config,
    PersistentHybridIndex,
    open_persistent_hybrid_index,
)
from comet_tpu_torch.ops.quantizer import (
    QuantizerType,
    NotTrainedQuantizerError,
    FullPrecisionQuantizer,
    HalfPrecisionQuantizer,
    BFloat16Quantizer,
    Int8Quantizer,
    new_quantizer,
)

__version__ = "0.1.0"

__all__ = [n for n in dir() if not n.startswith("_")]
