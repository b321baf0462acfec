"""``paddle.distributed`` over ``torch.distributed``: what is ported.

- The environment (``ParallelEnv``, ``init_parallel_env``, ``get_rank``,
  ``get_world_size``, ``is_initialized``) and ``spawn``.
- The collectives (``collective.py``: ``ReduceOp``, ``Group``,
  ``new_group``, ``all_reduce`` ... ``split``; ``communication`` and its
  ``stream`` forms), on gloo or NCCL process groups.
- ``DataParallel`` (``parallel.py``), and ``sharding``
  (``group_sharded_parallel``, ZeRO by ownership,
  ``save_group_sharded_model``).
- ``fleet``: the facade, strategy, topology, meta-optimizers, ``utils``
  (gradient sync, sequence parallelism), ``recompute``, and
  ``meta_parallel``'s tensor-parallel layers, ``TensorParallel`` and RNG
  tracker. The hybrid mesh is ``paddle_tpu_torch.parallel``; the sharded
  trainers are ``models.llama`` and ``models.bert``'s
  ``make_sharded_train_step``.

Still raising ``NotImplementedError`` citing ROADMAP Queue A item 5:
``launch``, ``ps``, ``rpc``, ``auto_parallel`` (and its names),
``checkpoint``, ``store`` / ``TCPStore``, ``utils``, ``fleet.elastic``
and the pipeline (``fleet.meta_parallel``'s ``PipelineLayer``, ...).
"""

import os

from . import collective, communication, fleet, parallel, sharding  # noqa
from .collective import (
    Group,
    P2POp,
    ReduceOp,
    all_gather,
    all_gather_object,
    all_reduce,
    all_to_all,
    alltoall,
    alltoall_single,
    barrier,
    batch_isend_irecv,
    broadcast,
    broadcast_object_list,
    destroy_process_group,
    gather,
    get_backend,
    get_default_group,
    get_group,
    irecv,
    isend,
    new_group,
    recv,
    recv_prev,
    reduce,
    reduce_scatter,
    scatter,
    scatter_object_list,
    send,
    send_next,
    split,
    wait,
)
from .communication import stream  # noqa: F401
from .env import (ParallelEnv, get_rank, get_world_size, init_parallel_env,
                  is_initialized, parallel_initialized)
from .parallel import DataParallel
from .sharding import group_sharded_parallel, save_group_sharded_model

__all__ = [
    "ReduceOp", "Group", "new_group", "get_group", "get_default_group",
    "all_reduce", "all_gather", "all_gather_object", "reduce",
    "reduce_scatter", "broadcast", "scatter", "alltoall", "all_to_all",
    "send", "recv", "send_next", "recv_prev", "isend", "irecv", "barrier",
    "P2POp", "batch_isend_irecv", "wait", "destroy_process_group",
    "get_backend", "scatter_object_list", "split", "alltoall_single",
    "gather", "broadcast_object_list", "ParallelEnv", "get_rank",
    "get_world_size", "init_parallel_env", "is_initialized",
    "parallel_initialized", "DataParallel", "spawn", "fleet", "sharding",
    "group_sharded_parallel", "save_group_sharded_model", "communication",
    "stream", "collective", "parallel",
]

# the reference's other public names, until they are ported
_WAITING = frozenset((
    "utils", "launch", "auto_parallel", "ProcessMesh", "Placement", "Shard",
    "Replicate", "Partial", "shard_tensor", "dtensor_from_fn",
    "unshard_dtensor", "reshard", "shard_layer", "TCPStore", "checkpoint",
    "ps", "rpc", "store"))


def __getattr__(name):
    if name in _WAITING:
        raise NotImplementedError(
            f"paddle_tpu_torch.distributed.{name} is not ported yet (ROADMAP "
            "Queue A item 5: training beyond one device)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def _spawned(func, args, env):
    os.environ.update(env)
    func(*args)


def spawn(func, args=(), nprocs=-1, **options):
    """``func(*args)`` in each of ``nprocs`` new processes (default
    ``PADDLE_TRAINERS_NUM``, else 1), started by the ``spawn`` method (so
    ``func`` is a module-level function). Process r gets
    ``PADDLE_TRAINER_ID`` r, ``PADDLE_TRAINERS_NUM``, ``PADDLE_LOCAL_RANK``
    r and ``PADDLE_MASTER``, the address of the world's store, so
    ``init_parallel_env()`` inside ``func`` joins their world. The store
    is served from this process, bound to a port the system picks before
    any rank starts and held until they end, and every rank joins it as a
    client (torch's agent store, ``TORCHELASTIC_USE_AGENT_STORE``): no
    other process can take its port in between. Returns the processes'
    exit codes; one that is not 0 stops the others and raises
    ``RuntimeError``. ``timeout`` (seconds, default none) bounds the
    wait."""
    import multiprocessing
    import time

    import torch.distributed as dist

    if nprocs == -1:
        nprocs = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
    ctx = multiprocessing.get_context("spawn")
    store = dist.TCPStore("127.0.0.1", 0, nprocs, True,
                          wait_for_workers=False)
    master = f"127.0.0.1:{store.port}"
    procs = []
    for rank in range(nprocs):
        env = {"PADDLE_TRAINER_ID": str(rank),
               "PADDLE_TRAINERS_NUM": str(nprocs),
               "PADDLE_LOCAL_RANK": str(rank), "PADDLE_MASTER": master,
               "TORCHELASTIC_USE_AGENT_STORE": "True"}
        p = ctx.Process(target=_spawned, args=(func, tuple(args), env))
        p.start()
        procs.append(p)
    timeout = options.get("timeout")
    deadline = None if timeout is None else time.monotonic() + timeout
    while True:
        codes = [p.exitcode for p in procs]
        if all(c is not None for c in codes) or any(codes):
            break
        if deadline is not None and time.monotonic() > deadline:
            break
        time.sleep(0.05)
    for p in procs:
        if p.is_alive():
            p.terminate()
        p.join()
    del store  # every rank has ended
    codes = [p.exitcode for p in procs]
    if any(codes):
        raise RuntimeError(f"spawned processes exited with {codes}")
    return codes
