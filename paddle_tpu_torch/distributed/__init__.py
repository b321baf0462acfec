"""``paddle.distributed`` over ``torch.distributed``: what is ported.

The environment (``ParallelEnv``, ``init_parallel_env``, ``get_rank``,
``get_world_size``, ``is_initialized``) and ``fleet``'s tensor-parallel
layers (``fleet.meta_parallel``). The hybrid mesh is
``paddle_tpu_torch.parallel``; the sharded trainers are
``models.llama.make_sharded_train_step`` and
``models.bert.make_sharded_train_step``. Every other public name of the
reference's ``paddle.distributed`` (the collectives, ``DataParallel``,
launch, sharding, auto_parallel, PS, RPC, ...) raises
``NotImplementedError`` citing ROADMAP Queue A item 5.
"""

from . import fleet  # noqa: F401
from .env import (ParallelEnv, get_rank, get_world_size, init_parallel_env,
                  is_initialized, parallel_initialized)

__all__ = ["ParallelEnv", "get_rank", "get_world_size", "init_parallel_env",
           "is_initialized", "parallel_initialized", "fleet"]

# the reference's other public names, until they are ported
_WAITING = frozenset((
    "ReduceOp", "Group", "new_group", "get_group", "get_default_group",
    "all_reduce", "all_gather", "all_gather_object", "reduce",
    "reduce_scatter", "broadcast", "scatter", "alltoall", "all_to_all",
    "send", "recv", "send_next", "recv_prev", "isend", "irecv", "barrier",
    "P2POp", "batch_isend_irecv", "wait", "destroy_process_group",
    "get_backend", "scatter_object_list", "split", "utils", "DataParallel",
    "spawn", "launch", "sharding", "group_sharded_parallel",
    "save_group_sharded_model", "auto_parallel", "ProcessMesh",
    "Placement", "Shard", "Replicate", "Partial", "shard_tensor",
    "dtensor_from_fn", "unshard_dtensor", "alltoall_single", "gather",
    "broadcast_object_list", "reshard", "shard_layer", "TCPStore",
    "checkpoint", "communication", "ps", "rpc", "stream", "collective",
    "parallel", "store"))


def __getattr__(name):
    if name in _WAITING:
        raise NotImplementedError(
            f"paddle_tpu_torch.distributed.{name} is not ported yet (ROADMAP "
            "Queue A item 5: training beyond one device)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
