"""comet_tpu_torch — the PyTorch / CUDA port of comet_tpu.

It runs on one NVIDIA Hopper card (or on the CPU, for tests) and covers
exact flat search (`FlatIndex`: float32 storage, and bfloat16, float16 or
int8 storage with an optional float32 rerank), IVF search (`IVFIndex`),
product quantisation (`PQIndex`, `IVFPQIndex`, `calculate_pq_params`;
OPQ, and the IVFPQ exact re-rank `nrefine`), the scalar quantizers
(`new_quantizer`) and HNSW bulk build, incremental insertion and search
(`HNSWIndex`: blocked or packed routing tables, a seeded or classic
start), with the host layer they need. Its CUDA kernels, written by hand
for sm_90a, replace every Pallas kernel of the reference (ops/sortnet.py:
top-k select; ops/fused_scan.py: fused distance scan, flat mode over a
float32, bf16, float16 or int8 corpus (the last two the reference's XLA
scans) and nprobe mode;
ops/ivf_sparse.py: block-sparse IVF scan, float32 and bf16 modes;
ops/beam_kernel.py: the HNSW beam's merge step, its in-loop scoring, and
the fused expand kernel that scores and merges in one launch). Every index
runs on the card unless it is given `device="cpu"`; nothing falls back
from the card to the CPU.

The package imports torch and numpy, never jax and never comet_tpu.
"""
from comet_tpu_torch.types import (
    DistanceKind,
    VectorIndexKind,
    ScoreAggregationKind,
    CometError,
    ZeroVectorError,
    DimensionMismatchError,
    NotTrainedError,
    NodeNotFoundError,
    InvalidConfigError,
)
from comet_tpu_torch.core.node import VectorNode
from comet_tpu_torch.core.results import VectorResult, Reranker
from comet_tpu_torch.core.limiter import sanitize_k, limit_results, autocut, autocut_results
from comet_tpu_torch.ops.bitset import Bitset
from comet_tpu_torch.indexes.flat import FlatIndex
from comet_tpu_torch.indexes.ivf import IVFIndex
from comet_tpu_torch.indexes.hnsw import HNSWConfig, HNSWIndex
from comet_tpu_torch.indexes.pq import PQIndex, calculate_pq_params
from comet_tpu_torch.indexes.ivfpq import IVFPQIndex
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
