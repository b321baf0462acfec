"""The Fleet facade: the user's entry point of collective training.

Port of ``paddle_tpu/distributed/fleet/fleet.py``. ``init`` joins the
process group (``init_parallel_env``: NCCL on the card unless ``device``
or ``backend`` says otherwise), resolves the hybrid degrees from the
strategy (``dp_degree`` -1 takes the world's ranks left by the others, as
the reference takes ``jax.devices()``'s) and builds the
``HybridCommunicateGroup`` (the port's mesh and a group per axis).
``distributed_model`` returns a ``DataParallel`` for the data mode at a
world larger than one, raises for the pipeline mode (not ported yet), and
returns the model itself otherwise: the tensor-parallel layers hold their
own collectives, and ZeRO lives in the optimizer wrapper.
``distributed_optimizer`` composes the strategy's meta-optimizers in the
reference's order (the lamb swap, DGC, LocalSGD, GradientMerge), then
``HybridParallelOptimizer`` outermost.
"""

from __future__ import annotations

from typing import Optional

import torch.distributed as dist

from ..env import ParallelEnv, init_parallel_env
from .base.distributed_strategy import DistributedStrategy
from .base.topology import (
    CommunicateTopology,
    HybridCommunicateGroup,
    get_hybrid_communicate_group,
)

__all__ = ["Fleet", "fleet", "init", "distributed_model",
           "distributed_optimizer", "get_hybrid_communicate_group"]


class Fleet:
    """The singleton facade (the reference's ``Fleet`` object)."""

    def __init__(self):
        self._is_initialized = False
        self._strategy: Optional[DistributedStrategy] = None
        self._hcg: Optional[HybridCommunicateGroup] = None
        self._env: Optional[ParallelEnv] = None
        self._role_maker = None

    # --- lifecycle ---
    def init(self, role_maker=None, is_collective: bool = True,
             strategy: Optional[DistributedStrategy] = None, *,
             device="cuda", backend=None):
        strategy = strategy or DistributedStrategy()
        self._strategy = strategy
        self._role_maker = role_maker
        self._env = init_parallel_env(device=device, backend=backend)
        h = strategy.hybrid_configs
        mp, pp, sharding, sep = (h.mp_degree, h.pp_degree,
                                 h.sharding_degree, h.sep_degree)
        if h.dp_degree == -1:
            h.dp_degree = max(dist.get_world_size() // (mp * pp * sharding
                                                        * sep), 1)
        topo = CommunicateTopology(
            ("data", "pipe", "sharding", "model", "sep"),
            (h.dp_degree, pp, sharding, mp, sep))
        self._hcg = HybridCommunicateGroup(topo, device=device)
        self._is_initialized = True
        return self

    def is_first_worker(self) -> bool:
        if self._role_maker is not None:
            return self._role_maker.is_first_worker()
        return self.worker_index() == 0

    def worker_index(self) -> int:
        if self._role_maker is not None:
            return self._role_maker.worker_index()
        return dist.get_rank() if dist.is_initialized() else \
            ParallelEnv().rank

    def worker_num(self) -> int:
        if self._role_maker is not None:
            return self._role_maker.worker_num()
        return dist.get_world_size() if dist.is_initialized() else \
            ParallelEnv().world_size

    def is_worker(self) -> bool:
        if self._role_maker is not None:
            return self._role_maker.is_worker()
        return True

    def is_server(self) -> bool:
        if self._role_maker is not None:
            return self._role_maker.is_server()
        return False

    def barrier_worker(self):
        from ..collective import barrier

        barrier()

    @property
    def is_initialized(self):
        return self._is_initialized

    def get_hybrid_communicate_group(self
                                     ) -> Optional[HybridCommunicateGroup]:
        return self._hcg or get_hybrid_communicate_group()

    # --- wrapping ---
    def distributed_model(self, model):
        """The model wrapped for the active parallel mode: ``DataParallel``
        over the data-parallel group in the data mode at a world larger
        than one; the model itself in the other ported modes."""
        if not self._is_initialized:
            raise RuntimeError("call fleet.init() before distributed_model()")
        mode = self._hcg.get_parallel_mode()
        if mode == "pipeline":
            raise NotImplementedError(
                "fleet.distributed_model in the pipeline mode is not ported "
                "yet (ROADMAP Queue A item 5: the pipeline)")
        if mode == "data" and self.worker_num() > 1:
            from ..parallel import DataParallel

            return DataParallel(
                model, group=self._hcg.get_data_parallel_group())
        return model

    def distributed_optimizer(self, optimizer, strategy=None):
        """The optimizer wrapped as the strategy's flags say, the
        reference's order: lamb swaps the update rule (keeping the
        parameters, rate, clip and decay), then DGC, LocalSGD and
        GradientMerge around it, then ``HybridParallelOptimizer``."""
        from .meta_optimizers import HybridParallelOptimizer
        from .meta_optimizers.strategy_optimizers import (
            DGCOptimizer,
            GradientMergeOptimizer,
            LocalSGDOptimizer,
        )

        if not self._is_initialized:
            raise RuntimeError(
                "call fleet.init() before distributed_optimizer()")
        strat = strategy or self._strategy
        inner = optimizer
        if getattr(strat, "lamb", False):
            from ...optimizer import Lamb

            if not isinstance(inner, Lamb):
                # decay lives in _wd for the decoupled family and in
                # _l2_coeff for the L2 one; an explicit 0.0 survives
                wd = getattr(inner, "_wd", None)
                if wd is None:
                    wd = getattr(inner, "_l2_coeff", 0.0)
                inner = Lamb(learning_rate=inner._learning_rate,
                             parameters=inner._parameter_list,
                             grad_clip=inner._grad_clip,
                             lamb_weight_decay=float(wd))
        if getattr(strat, "dgc", False):
            cfg = dict(getattr(strat, "dgc_configs", {}) or {})
            inner = DGCOptimizer(
                inner, rampup_begin_step=int(cfg.get("rampup_begin_step", 0)),
                sparsity=float(cfg.get("sparsity", 0.999)))
        if getattr(strat, "localsgd", False):
            cfg = dict(getattr(strat, "localsgd_configs", {}) or {})
            inner = LocalSGDOptimizer(inner,
                                      k_steps=int(cfg.get("k_steps", 1)))
        if getattr(strat, "gradient_merge", False):
            cfg = dict(getattr(strat, "gradient_merge_configs", {}) or {})
            inner = GradientMergeOptimizer(
                inner, k_steps=int(cfg.get("k_steps", 1)),
                avg=bool(cfg.get("avg", True)))
        return HybridParallelOptimizer(inner, self._hcg, strat)

    # --- state ---
    def save(self, *a, **k):
        raise NotImplementedError(
            "use paddle_tpu_torch.save, or sharding.save_group_sharded_model")


fleet = Fleet()

# module-level bindings, so `from paddle_tpu_torch.distributed import
# fleet; fleet.init(...)` works as the reference's package facade
init = fleet.init
distributed_model = fleet.distributed_model
distributed_optimizer = fleet.distributed_optimizer
worker_index = fleet.worker_index
worker_num = fleet.worker_num
is_first_worker = fleet.is_first_worker
barrier_worker = fleet.barrier_worker
