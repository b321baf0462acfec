"""``paddle.distributed.fleet``: the tensor-parallel layers of
``meta_parallel`` are ported (``meta_parallel.parallel_layers``); the
Fleet facade, strategies, role makers, recompute and the rest wait for
ROADMAP Queue A item 5 and raise ``NotImplementedError``."""

from . import meta_parallel  # noqa: F401

_WAITING = frozenset((
    "Fleet", "fleet", "init", "distributed_model", "distributed_optimizer",
    "worker_index", "worker_num", "is_first_worker", "barrier_worker",
    "DistributedStrategy", "CommunicateTopology", "HybridCommunicateGroup",
    "get_hybrid_communicate_group", "get_rng_state_tracker", "recompute",
    "recompute_sequential", "meta_optimizers", "utils",
    "PaddleCloudRoleMaker", "UserDefinedRoleMaker", "Role", "UtilBase",
    "elastic"))


def __getattr__(name):
    if name in _WAITING:
        raise NotImplementedError(
            f"paddle_tpu_torch.distributed.fleet.{name} is not ported yet "
            "(ROADMAP Queue A item 5)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
