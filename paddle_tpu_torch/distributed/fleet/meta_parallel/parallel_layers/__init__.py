from .mp_layers import (ColumnParallelLinear, ParallelCrossEntropy,
                        RowParallelLinear, VocabParallelEmbedding)

__all__ = ["VocabParallelEmbedding", "ColumnParallelLinear",
           "RowParallelLinear", "ParallelCrossEntropy"]


def __getattr__(name):
    if name in ("RNGStatesTracker", "get_rng_state_tracker",
                "model_parallel_random_seed"):
        raise NotImplementedError(
            f"{__name__}.{name} is not ported yet (ROADMAP Queue A item 5)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
