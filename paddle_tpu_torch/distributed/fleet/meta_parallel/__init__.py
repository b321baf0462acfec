"""meta_parallel: the tensor-parallel layers are ported; the pipeline
(``PipelineLayer``, ``PipelineParallel``), ``TensorParallel`` and the RNG
state tracker wait for ROADMAP Queue A item 5."""

from .parallel_layers import (ColumnParallelLinear, ParallelCrossEntropy,
                              RowParallelLinear, VocabParallelEmbedding)

__all__ = ["VocabParallelEmbedding", "ColumnParallelLinear",
           "RowParallelLinear", "ParallelCrossEntropy"]

_WAITING = frozenset(("RNGStatesTracker", "get_rng_state_tracker",
                      "model_parallel_random_seed", "LayerDesc",
                      "SharedLayerDesc", "PipelineLayer", "PipelineParallel",
                      "TensorParallel"))


def __getattr__(name):
    if name in _WAITING:
        raise NotImplementedError(
            f"paddle_tpu_torch.distributed.fleet.meta_parallel.{name} is not "
            "ported yet (ROADMAP Queue A item 5)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
