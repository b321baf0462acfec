from . import hybrid_parallel_util, sequence_parallel_utils
from .hybrid_parallel_util import fused_allreduce_gradients
# upstream re-exports recompute here as well as at fleet.*
from ..recompute import recompute, recompute_sequential
from .sequence_parallel_utils import (
    AllGatherOp,
    ColumnSequenceParallelLinear,
    GatherOp,
    ReduceScatterOp,
    RowSequenceParallelLinear,
    ScatterOp,
    mark_as_sequence_parallel_parameter,
    register_sequence_parallel_allreduce_hooks,
)

__all__ = ["fused_allreduce_gradients", "recompute", "recompute_sequential",
           "ScatterOp", "GatherOp", "AllGatherOp", "ReduceScatterOp",
           "mark_as_sequence_parallel_parameter",
           "register_sequence_parallel_allreduce_hooks",
           "ColumnSequenceParallelLinear", "RowSequenceParallelLinear"]
