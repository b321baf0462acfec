"""group_sharded_parallel: ZeRO stages 1-3 for an eager model.

Port of ``paddle_tpu/distributed/sharding/group_sharded.py``. The
reference partitions by layout (GSPMD places each state, gradient and
parameter sharded over the ``dp`` and ``sharding`` axes); the port
partitions by ownership over the same ranks (the mesh's ``dp`` and
``sharding`` group, else ``group``, else the world; see ``ShardOwner``):

- ``"os"`` (stage 1): each rank keeps and updates its slice of every
  parameter's optimizer state; the gradients are all-reduced (their mean)
  and the updated slices all-gathered into the parameters;
- ``"os_g"`` (stage 2): the gradients are reduce-scattered, so a rank
  keeps only its slice's mean;
- ``"p_g_os"`` (stage 3): between steps each parameter holds no values,
  only the rank's slice; a forward pre-hook on the model all-gathers them
  before use, and the step frees them again.

The model computes on each rank's own batch: the result equals
unsharded training on the concatenated batch (means of the ranks'
gradients). ``offload=True`` keeps the slices' optimizer state in pinned
host memory between steps (the host's own memory on a machine without a
card). ``GroupShardedScaler`` passes through to the wrapped scaler.
``save_group_sharded_model`` gathers the whole parameters (and the
optimizer's state, in the unsharded optimizer's ``state_dict`` layout)
and saves them from the group's first rank with ``paddle_tpu_torch.save``.
"""

from __future__ import annotations

import os

from ...framework.io import save
from ..collective import Group, from_process_group
from ..fleet.meta_optimizers.dygraph_optimizer.hybrid_parallel_optimizer \
    import ShardOwner, _innermost, zero_group

__all__ = ["group_sharded_parallel", "save_group_sharded_model",
           "GroupShardedScaler"]

_LEVELS = {"os": 1, "os_g": 2, "p_g_os": 3}


class GroupShardedScaler:
    """AMP scaler glue for group-sharded training: bf16 needs no loss
    scale; an fp16 path delegates to the wrapped ``amp.GradScaler``."""

    def __init__(self, scaler):
        self._scaler = scaler

    def __getattr__(self, item):
        return getattr(self._scaler, item)


class _GroupShardedOptimizer:
    """The optimizer of a group-sharded model: its ``step`` syncs the
    gradients, steps the rank's slices and gathers (or, at stage 3,
    frees) the parameters."""

    def __init__(self, optimizer, model, stage: int, group: Group,
                 offload: bool = False):
        self._inner_opt = optimizer
        self._model = model
        self._sharding_stage = stage
        self._owner = ShardOwner(_innermost(optimizer), group, stage,
                                 offload=offload)
        if stage >= 3:
            model.register_forward_pre_hook(
                lambda m, inputs: self._owner.ensure_gathered())

    def __getattr__(self, item):
        return getattr(self._inner_opt, item)

    def step(self):
        self._owner.step(self._inner_opt.step)

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        return None, None

    def clear_grad(self, set_to_zero: bool = False):
        self._inner_opt.clear_grad(set_to_zero)
        self._owner.clear_grads()

    clear_gradients = clear_grad

    def state_dict(self):
        """The unsharded optimizer's state, gathered (every rank of the
        group calls it)."""
        return self._owner.full_state()


def group_sharded_parallel(model, optimizer, level: str = "os_g",
                           scaler=None, group=None, offload: bool = False,
                           sync_buffers: bool = False,
                           buffer_max_size: int = 2 ** 23,
                           segment_size: int = 2 ** 20,
                           sync_comm: bool = False, exclude_layer=None):
    """(model, optimizer[, scaler]) for ZeRO training at ``level``."""
    if level not in _LEVELS:
        raise ValueError(
            f"level must be one of {sorted(_LEVELS)}, got {level!r}")
    if group is None:
        group = zero_group()
    elif not isinstance(group, Group):
        group = from_process_group(group)
    opt = _GroupShardedOptimizer(optimizer, model, _LEVELS[level], group,
                                 offload=offload)
    if scaler is not None:
        return model, opt, GroupShardedScaler(scaler)
    return model, opt


def save_group_sharded_model(model, output, optimizer=None):
    """``output/model.pdparams`` (and ``model.pdopt``) with the whole
    state, written by the group's first rank; every rank calls it."""
    owner = getattr(optimizer, "_owner", None) if optimizer is not None \
        else None
    if owner is not None:
        owner.ensure_gathered()
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    opt_state = None
    if optimizer is not None:
        opt_state = owner.full_state() if owner is not None \
            else optimizer.state_dict()
        opt_state = {k: v.detach().cpu() if hasattr(v, "detach") else v
                     for k, v in opt_state.items()}
    if owner is not None and owner.stage >= 3:
        owner.release_params()
    first = owner is None or owner.r == 0
    if first:
        os.makedirs(output, exist_ok=True)
        save(state, os.path.join(output, "model.pdparams"))
        if opt_state is not None:
            save(opt_state, os.path.join(output, "model.pdopt"))
