"""Distributed environment and rendezvous over ``torch.distributed``.

Port of ``paddle_tpu/distributed/env.py``. The process's rank and world
come from the launcher's environment contract (``PADDLE_TRAINER_ID``,
``PADDLE_TRAINERS_NUM``, ``PADDLE_MASTER``), as in the reference, or from
the arguments of ``init_parallel_env``. Where the reference joins
``jax.distributed``'s coordinator, the port joins a
``torch.distributed`` process group: NCCL on the card, gloo when the
caller asks for the CPU (or names ``backend="gloo"``, as ranks sharing one
card must: NCCL refuses two ranks on one GPU). The store is the
``init_method`` given (the tests pass a ``file://`` path), else
``env://`` (``MASTER_ADDR`` / ``MASTER_PORT``, or ``PADDLE_MASTER`` as
``host:port``); a world of one with neither joins through an in-process
store.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from ..device import resolve_device

__all__ = ["ParallelEnv", "init_parallel_env", "get_rank", "get_world_size",
           "is_initialized", "parallel_initialized"]


class ParallelEnv:
    """Snapshot of the launcher's environment contract."""

    def __init__(self):
        self.rank = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
        self.world_size = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
        self.device_id = int(os.environ.get("PADDLE_LOCAL_RANK", "0"))
        self.master = os.environ.get("PADDLE_MASTER", "")
        endpoints = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
        self.trainer_endpoints = endpoints.split(",") if endpoints else []
        self.current_endpoint = os.environ.get("PADDLE_CURRENT_ENDPOINT", "")

    @property
    def nranks(self):
        return self.world_size

    @property
    def local_rank(self):
        return self.rank

    @property
    def dev_id(self):
        return self.device_id


def get_rank(group=None) -> int:
    """This process's rank in ``group`` (default: the world)."""
    if dist.is_initialized():
        return dist.get_rank(group)
    if group is not None:
        return group.get_group_rank(ParallelEnv().rank)
    return ParallelEnv().rank


def get_world_size(group=None) -> int:
    if dist.is_initialized():
        return dist.get_world_size(group)
    if group is not None:
        return len(group.ranks)
    return ParallelEnv().world_size


def is_initialized() -> bool:
    return dist.is_initialized()


parallel_initialized = is_initialized


def _store_method(env: ParallelEnv) -> Optional[str]:
    if os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
        return "env://"
    master = env.master or (env.trainer_endpoints[0]
                            if env.trainer_endpoints else "")
    if master:
        return f"tcp://{master}"
    return None


def init_parallel_env(strategy=None, *, device="cuda", backend=None,
                      init_method=None, rank=None, world_size=None):
    """Join the process group (once; a second call returns the
    environment). ``device`` is the card unless the caller names the CPU:
    it picks the backend (NCCL for CUDA, gloo for the CPU) unless
    ``backend`` names one, and on CUDA this rank's card
    (``PADDLE_LOCAL_RANK``). ``rank`` and ``world_size`` default to the
    environment's. Returns a ``ParallelEnv`` with the rank and world
    joined."""
    env = ParallelEnv()
    if rank is not None:
        env.rank = int(rank)
    if world_size is not None:
        env.world_size = int(world_size)
    if dist.is_initialized():
        env.rank, env.world_size = dist.get_rank(), dist.get_world_size()
        return env
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(env.device_id if backend == "nccl" else
                              dev.index or 0)
    kw = dict(backend=backend, rank=env.rank, world_size=env.world_size)
    method = init_method or _store_method(env)
    if method is None:
        if env.world_size != 1:
            raise RuntimeError(
                f"a world of {env.world_size} needs a store: pass "
                "init_method, or set MASTER_ADDR/MASTER_PORT or PADDLE_MASTER")
        kw["store"] = dist.HashStore()
    else:
        kw["init_method"] = method
    dist.init_process_group(**kw)
    return env
