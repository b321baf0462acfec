"""Meta-optimizers (port of ``paddle_tpu/distributed/fleet/
meta_optimizers/``): the hybrid-parallel wrapper and its clip, ZeRO
stage 1, and the strategy wrappers."""

from .dygraph_optimizer import (
    DygraphShardingOptimizer,
    HybridParallelClipGrad,
    HybridParallelOptimizer,
)
from .strategy_optimizers import (
    ASPOptimizer,
    DGCOptimizer,
    FP16AllReduceOptimizer,
    GradientMergeOptimizer,
    LocalSGDOptimizer,
)

__all__ = ["HybridParallelOptimizer", "HybridParallelClipGrad",
           "DygraphShardingOptimizer", "GradientMergeOptimizer",
           "LocalSGDOptimizer", "DGCOptimizer", "ASPOptimizer",
           "FP16AllReduceOptimizer"]
