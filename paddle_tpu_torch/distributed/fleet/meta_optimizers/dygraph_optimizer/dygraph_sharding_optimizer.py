"""DygraphShardingOptimizer: ZeRO stage 1 (optimizer-state sharding).

Port of ``paddle_tpu/distributed/fleet/meta_optimizers/dygraph_optimizer/
dygraph_sharding_optimizer.py``: a ``HybridParallelOptimizer`` whose
sharding stage is at least 1, so each rank of the ZeRO group owns a slice
of every parameter and its optimizer state (``ShardOwner``).
"""

from __future__ import annotations

from .hybrid_parallel_optimizer import HybridParallelOptimizer

__all__ = ["DygraphShardingOptimizer"]


class DygraphShardingOptimizer(HybridParallelOptimizer):
    def __init__(self, optimizer, hcg=None, using_param_groups=False, **kw):
        super().__init__(optimizer, hcg=hcg, strategy=None, min_stage=1)
