"""comet_tpu_torch — the PyTorch / CUDA port of comet_tpu.

It runs on one NVIDIA Hopper card (or on the CPU, for tests) and covers,
so far, the exact flat-search slice: `FlatIndex` with float32 storage and
the host layer it needs. Its two CUDA kernels, written by hand for sm_90a,
replace the two Pallas kernels of that path (ops/sortnet.py: top-k select;
ops/fused_scan.py: fused distance scan). Every index takes an explicit
`device`; nothing falls back from the card to the CPU.

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

__version__ = "0.1.0"

__all__ = [n for n in dir() if not n.startswith("_")]
