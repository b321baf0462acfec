from .dygraph_sharding_optimizer import DygraphShardingOptimizer
from .hybrid_parallel_optimizer import (
    HybridParallelClipGrad,
    HybridParallelOptimizer,
    ShardOwner,
    zero_shard_spec,
)

__all__ = ["HybridParallelOptimizer", "HybridParallelClipGrad",
           "DygraphShardingOptimizer", "ShardOwner", "zero_shard_spec"]
