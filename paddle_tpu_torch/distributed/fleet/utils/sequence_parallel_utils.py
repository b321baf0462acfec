"""Sequence parallelism (Megatron-SP) over the ``mp`` group.

Port of ``paddle_tpu/distributed/fleet/utils/sequence_parallel_utils.py``.
Activations are [B, S, H], the sequence on axis 1 as in the reference.
The reference's four ops are GSPMD layout changes whose backward falls out
of the transpose rules; the port's ranks hold their own sequence shard,
so each is a ``torch.autograd.Function`` over the ``mp`` group (the HCG's,
else the global mesh's ``mp`` axis; the identity on one rank):

- ``ScatterOp``: this rank's sequence slice; backward all-gathers;
- ``GatherOp``: the sequence all-gathered; backward takes the slice;
- ``AllGatherOp``: all-gathered; backward reduce-scatters (the cotangent
  of each rank's full sequence summed, this rank's slice kept);
- ``ReduceScatterOp``: the partial sums summed and sliced; backward
  all-gathers.

``Op.apply(x)`` and ``Op(x)`` both work. ``ColumnSequenceParallelLinear``
all-gathers the sequence (``AllGatherOp``), then runs the column product
(its output columns stay split unless ``gather_output``);
``RowSequenceParallelLinear`` runs the row product and reduce-scatters
the sequence (``ReduceScatterOp``, not an all-reduce), then adds its
whole bias to the slice, and marks that bias as a sequence-parallel
parameter.

A parameter used on the sequence shards (a LayerNorm's, that bias) gets
on each rank only its shard's share of the gradient, where the reference's
is the global sum already. ``mark_as_sequence_parallel_parameter`` marks
one, and ``register_sequence_parallel_allreduce_hooks`` hooks every marked
parameter of a model to all-reduce (sum) its gradient over ``mp`` as it
is made; a sum of per-backward sums is the sum of the accumulated one, so
``accumulation_steps`` changes nothing.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ... import _comm
from ..base.topology import get_hybrid_communicate_group
from ..meta_parallel.parallel_layers.mp_layers import (
    ColumnParallelLinear,
    RowParallelLinear,
    _group as _mesh_mp_group,
    copy_to,
    gather_from,
)

__all__ = [
    "ScatterOp", "GatherOp", "AllGatherOp", "ReduceScatterOp",
    "mark_as_sequence_parallel_parameter",
    "register_sequence_parallel_allreduce_hooks",
    "ColumnSequenceParallelLinear", "RowSequenceParallelLinear",
]

_SEQ_AXIS = 1


def mp_process_group(group=None):
    """The ``mp`` process group: ``group`` (a ``Group`` or process group),
    else the HCG's, else the global mesh's; None for one rank."""
    if group is None:
        hcg = get_hybrid_communicate_group()
        if hcg is None:
            return _mesh_mp_group(None)
        group = hcg.get_model_parallel_group()
    if hasattr(group, "process_group"):
        return group.process_group if group.nranks > 1 else None
    return group


def _slice(x, group):
    n, r = dist.get_world_size(group), dist.get_rank(group)
    k = x.shape[_SEQ_AXIS] // n
    return x.narrow(_SEQ_AXIS, r * k, k).contiguous()


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _slice(x, group)

    @staticmethod
    def backward(ctx, g):
        return _comm.all_gather(g, ctx.group, _SEQ_AXIS), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _comm.all_gather(x, group, _SEQ_AXIS)

    @staticmethod
    def backward(ctx, g):
        return _slice(g, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _comm.all_gather(x, group, _SEQ_AXIS)

    @staticmethod
    def backward(ctx, g):
        return _comm.reduce_scatter(g.contiguous(), ctx.group,
                                    _SEQ_AXIS), None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _comm.reduce_scatter(x.contiguous(), group, _SEQ_AXIS)

    @staticmethod
    def backward(ctx, g):
        return _comm.all_gather(g, ctx.group, _SEQ_AXIS), None


class _SeqOp:
    """``Op.apply(x, group=None)``, or ``Op(x)``."""

    _fn = None

    @classmethod
    def apply(cls, x, group=None):
        pg = mp_process_group(group)
        return x if pg is None else cls._fn.apply(x, pg)

    def __new__(cls, x, *a, **k):
        return cls.apply(x, *a, **k)


class ScatterOp(_SeqOp):
    """Whole sequence -> this rank's slice; backward all-gather."""
    _fn = _Scatter


class GatherOp(_SeqOp):
    """Sequence slices -> the whole sequence; backward the slice."""
    _fn = _Gather


class AllGatherOp(_SeqOp):
    """Sequence slices -> the whole sequence before a tensor-parallel
    product; backward reduce-scatter."""
    _fn = _AllGather


class ReduceScatterOp(_SeqOp):
    """Partial sums of the whole sequence -> this rank's summed slice;
    backward all-gather."""
    _fn = _ReduceScatter


def mark_as_sequence_parallel_parameter(parameter):
    parameter.sequence_parallel = True
    return parameter


def register_sequence_parallel_allreduce_hooks(model, accumulation_steps=1,
                                               use_main_grad=False,
                                               group=None):
    """A hook on each marked parameter of ``model`` that sums its gradient
    over ``mp`` as it is made; returns the hooks' handles."""
    pg = mp_process_group(group)
    handles = []
    if pg is None:
        return handles
    for p in model.parameters():
        if getattr(p, "sequence_parallel", False):
            handles.append(p.register_hook(
                lambda g, _pg=pg: _comm.all_reduce(g, _pg)))
    return handles


class ColumnSequenceParallelLinear(ColumnParallelLinear):
    """Column-parallel product of a sequence-sharded input: the sequence
    all-gathered first (whose backward reduce-scatters the input's
    cotangent, so no ``copy_to``)."""

    def forward(self, x):
        if self.group is None:
            return super().forward(x)
        y = AllGatherOp.apply(x, self.group) @ self.weight
        if self.bias is not None:
            y = y + self.bias
        return gather_from(y, self.group) if self.gather_output else y


class RowSequenceParallelLinear(RowParallelLinear):
    """Row-parallel product emitting a sequence-sharded output: the
    partial products reduce-scattered over the sequence, then the whole
    bias (marked sequence-parallel)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        if self.bias is not None:
            mark_as_sequence_parallel_parameter(self.bias)

    def forward(self, x):
        if self.group is None:
            return super().forward(x)
        if not self.input_is_parallel:
            k = self.weight.shape[0]
            x = copy_to(x, self.group).narrow(
                -1, dist.get_rank(self.group) * k, k)
        y = ReduceScatterOp.apply(x @ self.weight, self.group)
        return y + self.bias if self.bias is not None else y
