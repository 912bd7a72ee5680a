"""comet_tpu_torch — the PyTorch / CUDA port of comet_tpu.

It runs on one NVIDIA Hopper card (or on the CPU, for tests) and covers,
so far, exact flat search (`FlatIndex`, float32 storage), IVF search
(`IVFIndex`) and HNSW bulk build and search (`HNSWIndex`), with the host
layer they need. Its CUDA kernels, written by hand for sm_90a, replace the
Pallas kernels of those paths (ops/sortnet.py: top-k select;
ops/fused_scan.py: fused distance scan, flat and nprobe modes;
ops/ivf_sparse.py: block-sparse IVF scan, float32 and bf16 modes;
ops/beam_kernel.py: the HNSW beam's merge step and its in-loop scoring).
Every index runs on the
card unless it is given `device="cpu"`; nothing falls back from the card
to the CPU.

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

__version__ = "0.1.0"

__all__ = [n for n in dir() if not n.startswith("_")]
