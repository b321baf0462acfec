"""meta_parallel: the tensor-parallel layers, ``TensorParallel`` and the
RNG state tracker are ported; the pipeline (``LayerDesc``,
``SharedLayerDesc``, ``PipelineLayer``, ``PipelineParallel``) waits for
ROADMAP Queue A item 5 and raises ``NotImplementedError``."""

from .parallel_layers import (ColumnParallelLinear, ParallelCrossEntropy,
                              RNGStatesTracker, RowParallelLinear,
                              VocabParallelEmbedding, get_rng_state_tracker,
                              model_parallel_random_seed)
from .tensor_parallel import TensorParallel

__all__ = ["VocabParallelEmbedding", "ColumnParallelLinear",
           "RowParallelLinear", "ParallelCrossEntropy", "RNGStatesTracker",
           "get_rng_state_tracker", "model_parallel_random_seed",
           "TensorParallel"]

_WAITING = frozenset(("LayerDesc", "SharedLayerDesc", "PipelineLayer",
                      "PipelineParallel"))


def __getattr__(name):
    if name in _WAITING:
        raise NotImplementedError(
            f"paddle_tpu_torch.distributed.fleet.meta_parallel.{name} is not "
            "ported yet (ROADMAP Queue A item 5: the pipeline)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
