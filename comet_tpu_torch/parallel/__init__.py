"""Sharding over a mesh of torch devices: corpus-sharded search and a
distributed k-means step (counterpart of comet_tpu/parallel)."""

from comet_tpu_torch.parallel.sharded import (
    ShardedFlatSearcher,
    ShardedHNSWSearcher,
    ShardedHybridSearcher,
    ShardedIVFPQSearcher,
    ShardedIVFSearcher,
    ShardedPQSearcher,
    ShardedSeededHNSWSearcher,
    make_corpus_mesh,
    make_sharded_ivf_search,
    make_sharded_kmeans_step,
    make_sharded_search,
    shard_rows,
)

__all__ = [
    "ShardedFlatSearcher",
    "ShardedHNSWSearcher",
    "ShardedHybridSearcher",
    "ShardedIVFPQSearcher",
    "ShardedIVFSearcher",
    "ShardedPQSearcher",
    "ShardedSeededHNSWSearcher",
    "make_corpus_mesh",
    "make_sharded_ivf_search",
    "make_sharded_kmeans_step",
    "make_sharded_search",
    "shard_rows",
]
