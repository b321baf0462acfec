"""``paddle.distributed.fleet``: the Fleet facade (``init``,
``distributed_model``, ``distributed_optimizer``, ...), the strategy and
role makers, the topology (``CommunicateTopology``,
``HybridCommunicateGroup``), the meta-optimizers, ``utils`` (the
gradient and parameter sync, sequence parallelism), ``recompute``, and
``meta_parallel``'s tensor-parallel layers, ``TensorParallel`` and RNG
tracker. Still raising ``NotImplementedError`` (ROADMAP Queue A item 5):
``elastic``, and ``meta_parallel``'s pipeline names."""

from . import meta_optimizers, meta_parallel, utils  # noqa: F401
from .base.distributed_strategy import DistributedStrategy
from .base.role_maker import (PaddleCloudRoleMaker, Role,
                              UserDefinedRoleMaker)
from .base.topology import (
    CommunicateTopology,
    HybridCommunicateGroup,
    get_hybrid_communicate_group,
)
from .fleet import (
    Fleet,
    barrier_worker,
    distributed_model,
    distributed_optimizer,
    fleet,
    init,
    is_first_worker,
    worker_index,
    worker_num,
)
from .meta_parallel import get_rng_state_tracker
from .recompute import recompute, recompute_sequential

__all__ = [
    "Fleet", "fleet", "init", "distributed_model", "distributed_optimizer",
    "worker_index", "worker_num", "is_first_worker", "barrier_worker",
    "DistributedStrategy", "CommunicateTopology", "HybridCommunicateGroup",
    "get_hybrid_communicate_group", "get_rng_state_tracker", "recompute",
    "recompute_sequential", "meta_parallel", "meta_optimizers", "utils",
    "PaddleCloudRoleMaker", "UserDefinedRoleMaker", "Role", "UtilBase",
    "util",
]


class UtilBase:
    """Cross-rank helpers (``fleet.UtilBase`` / ``fleet.util``) over the
    eager collectives."""

    def all_reduce(self, input, mode="sum", comm_world="worker"):
        import numpy as np
        import torch

        from .. import collective as C
        from ...enforce import InvalidArgumentError

        ops = {"sum": C.ReduceOp.SUM, "max": C.ReduceOp.MAX,
               "min": C.ReduceOp.MIN}
        if mode not in ops:
            raise InvalidArgumentError(
                f"UtilBase.all_reduce mode must be one of {sorted(ops)}, "
                f"got {mode!r}")
        t = torch.as_tensor(np.asarray(input))
        return C.all_reduce(t, op=ops[mode]).numpy()

    def barrier(self, comm_world="worker"):
        from ..collective import barrier

        barrier()

    def get_file_shard(self, files):
        """Contiguous blocks, the remainder to the lowest ranks."""
        from ..env import get_rank, get_world_size

        rank, world = get_rank(), get_world_size()
        base, rem = divmod(len(files), world)
        start = rank * base + min(rank, rem)
        return files[start: start + base + (1 if rank < rem else 0)]


util = UtilBase()

_WAITING = frozenset(("elastic",))


def __getattr__(name):
    if name in _WAITING:
        raise NotImplementedError(
            f"paddle_tpu_torch.distributed.fleet.{name} is not ported yet "
            "(ROADMAP Queue A item 5)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
