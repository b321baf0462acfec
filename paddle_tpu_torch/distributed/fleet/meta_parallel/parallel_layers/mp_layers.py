"""Megatron tensor-parallel collectives and layers, over explicit shards.

Port of ``paddle_tpu/distributed/fleet/meta_parallel/parallel_layers/
mp_layers.py``. The reference writes two forms: GSPMD layout constraints
under ``jit``, and, inside a manual ``shard_map`` program, local-shard
matmuls with the Megatron ``f`` / ``g`` collectives (``_manual_fns``).
Every rank of the port holds its shard, so the port has the second form
only, as ``torch.autograd.Function``s over a process group:

- ``copy_to``: identity forward, all-reduce backward (the reference's
  ``c_identity``), before a column-parallel product of a replicated input;
- ``reduce_from``: all-reduce forward, identity backward
  (``mp_allreduce_sum``), after a row-parallel product;
- ``gather_from``: all-gather of the last dimension forward, this rank's
  slice backward (``c_allgather``).

Each assumes what the reference's custom VJPs assume: what follows it is
computed alike on every rank of the group, so each rank's cotangent is the
whole one. The layers keep their local shards as parameters
(``VocabParallelEmbedding`` [V / mp, H], ``ColumnParallelLinear`` [in,
out / mp] with a bias [out / mp], ``RowParallelLinear`` [in / mp, out]
with a whole bias added after the reduction), initialised as the
reference initialises the whole weight and then sliced, so a seed gives
every rank its slice of one tensor. ``ParallelCrossEntropy`` takes
vocab-sharded logits: the row max and the sum of exponentials are reduced
over ``mp``, and a label equal to ``ignore_index`` scores 0, as in the
reference. The group is the global mesh's ``mp`` axis unless ``mp_group``
names one; without a mesh (or with ``mp`` of 1) the layers are the dense
ones.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .... import _comm
from .....nn import initializer as I
from .....nn.layer.layers import Layer, ParamAttr, Parameter
from .....parallel.mesh import axis_group, get_mesh

__all__ = ["VocabParallelEmbedding", "ColumnParallelLinear",
           "RowParallelLinear", "ParallelCrossEntropy", "copy_to",
           "reduce_from", "gather_from", "gather_along",
           "parallel_cross_entropy", "vocab_parallel_lookup", "is_mp_shard"]


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _comm.all_reduce(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _comm.all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherAlong(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.n = group, dim, x.shape[dim]
        return _comm.all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        i = dist.get_rank(ctx.group)
        return g.narrow(ctx.dim, i * ctx.n, ctx.n).contiguous(), None, None


def copy_to(x, group):
    return x if group is None else _CopyTo.apply(x, group)


def reduce_from(x, group):
    return x if group is None else _ReduceFrom.apply(x, group)


def gather_along(x, group, dim):
    """All-gather of ``x`` along ``dim`` over ``group``; backward, this
    rank's slice of the cotangent."""
    return x if group is None else _GatherAlong.apply(x, group,
                                                      dim % x.dim())


def gather_from(x, group):
    return gather_along(x, group, -1)


def vocab_parallel_lookup(w, ids, group):
    """Rows ``ids`` of a table whose vocabulary is split over ``group``
    (``w``: this rank's rows): ids outside this rank's range give 0, then
    the sum over the group (the reference's masked lookup and
    all-reduce)."""
    if group is None:
        return w[ids.long()]
    vloc = w.shape[0]
    local = ids.long() - dist.get_rank(group) * vloc
    ok = (local >= 0) & (local < vloc)
    out = w[local.clamp(0, vloc - 1)] * ok[..., None].to(w.dtype)
    return reduce_from(out, group)


def is_mp_shard(p) -> bool:
    """True for a parameter this rank holds a ``mp`` slice of (marked
    ``is_distributed``; torch's ``Tensor.is_distributed`` is a method, so
    only the marked value True counts)."""
    return getattr(p, "is_distributed", False) is True


def _group(mp_group):
    return mp_group if mp_group is not None else axis_group(get_mesh(), "mp")


def _degree(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _sharded_parameter(layer, shape, attr, default, dim, group, is_bias=False):
    """The whole parameter drawn as the reference draws it, then this
    rank's slice along ``dim``."""
    p = layer.create_parameter(shape=shape, attr=attr, is_bias=is_bias,
                               default_initializer=default)
    n = _degree(group)
    if n == 1 or p is None:
        return p
    k = shape[dim] // n
    local = Parameter(p.detach().narrow(dim, _rank(group) * k, k).clone(),
                      requires_grad=p.requires_grad)
    local.name = p.name
    local.is_distributed = True  # each mp rank holds its own slice
    return local


class VocabParallelEmbedding(Layer):
    """Embedding whose vocabulary is split over ``mp``: each rank looks up
    the ids in its range, zeros the others and the results are summed."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 weight_attr=None, mp_group=None, name=None):
        super().__init__(name)
        self.group = _group(mp_group)
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.world_size = _degree(self.group)
        if num_embeddings % max(self.world_size, 1) != 0:
            raise ValueError(
                f"vocab size {num_embeddings} must be divisible by mp degree "
                f"{self.world_size}")
        self.weight = _sharded_parameter(
            self, [num_embeddings, embedding_dim], weight_attr,
            I.XavierNormal(), 0, self.group)

    def forward(self, x):
        return vocab_parallel_lookup(self.weight, x, self.group)

    def extra_repr(self):
        return (f"{self.num_embeddings}, {self.embedding_dim}, "
                f"mp={self.world_size}")


class ColumnParallelLinear(Layer):
    """Linear with its output columns split over ``mp``:
    ``copy_to(x) @ w_local + b_local``, all-gathered when
    ``gather_output``."""

    def __init__(self, in_features: int, out_features: int, weight_attr=None,
                 has_bias: bool = True, gather_output: bool = True,
                 fuse_matmul_bias: bool = False, mp_group=None, name=None):
        super().__init__(name)
        self.group = _group(mp_group)
        self.in_features = in_features
        self.out_features = out_features
        self.gather_output = gather_output
        self.world_size = _degree(self.group)
        if out_features % max(self.world_size, 1) != 0:
            raise ValueError(
                f"out_features {out_features} must be divisible by mp degree "
                f"{self.world_size}")
        self.weight = _sharded_parameter(
            self, [in_features, out_features], weight_attr, I.XavierNormal(),
            1, self.group)
        self.bias = (_sharded_parameter(
            self, [out_features], ParamAttr._to_attr(None), None, 0,
            self.group, is_bias=True) if has_bias else None)

    def forward(self, x):
        y = copy_to(x, self.group) @ self.weight
        if self.bias is not None:
            y = y + self.bias
        return gather_from(y, self.group) if self.gather_output else y

    def extra_repr(self):
        return (f"in={self.in_features}, out={self.out_features}, "
                f"gather_output={self.gather_output}, mp={self.world_size}")


class RowParallelLinear(Layer):
    """Linear with its input rows split over ``mp``: the local product of
    this rank's input slice (sliced here unless ``input_is_parallel``),
    all-reduced, then the whole bias."""

    def __init__(self, in_features: int, out_features: int, weight_attr=None,
                 has_bias: bool = True, input_is_parallel: bool = False,
                 fuse_matmul_bias: bool = False, mp_group=None, name=None):
        super().__init__(name)
        self.group = _group(mp_group)
        self.in_features = in_features
        self.out_features = out_features
        self.input_is_parallel = input_is_parallel
        self.world_size = _degree(self.group)
        if in_features % max(self.world_size, 1) != 0:
            raise ValueError(
                f"in_features {in_features} must be divisible by mp degree "
                f"{self.world_size}")
        self.weight = _sharded_parameter(
            self, [in_features, out_features], weight_attr, I.XavierNormal(),
            0, self.group)
        self.bias = (self.create_parameter(
            shape=[out_features], attr=ParamAttr._to_attr(None), is_bias=True)
            if has_bias else None)

    def forward(self, x):
        if not self.input_is_parallel and self.group is not None:
            # each rank takes its slice of the replicated input; copy_to
            # sums the zero-padded slices' cotangents into the whole dx
            k = self.weight.shape[0]
            x = copy_to(x, self.group).narrow(-1, _rank(self.group) * k, k)
        y = reduce_from(x @ self.weight, self.group)
        return y + self.bias if self.bias is not None else y

    def extra_repr(self):
        return (f"in={self.in_features}, out={self.out_features}, "
                f"input_is_parallel={self.input_is_parallel}, "
                f"mp={self.world_size}")


def parallel_cross_entropy(logits, label, group, ignore_index=-100):
    """Per-position cross entropy of vocab-sharded ``logits`` [..., V /
    mp] (fp32 arithmetic) against whole ``label`` [...]: the row max and
    sum of exponentials reduced over ``group``, the gold logit summed from
    the rank that holds it; 0 where the label is ``ignore_index``."""
    lg = logits.float()
    vloc = lg.shape[-1]
    lb = label.long()
    # the max only shifts the exponentials: no gradient through it
    m = _comm.all_reduce_max(lg.detach().amax(-1), group)
    se = reduce_from(torch.exp(lg - m[..., None]).sum(-1), group)
    local = lb.clamp(0, vloc * _degree(group) - 1) - _rank(group) * vloc
    mine = (local >= 0) & (local < vloc)
    picked = lg.gather(-1, local.clamp(0, vloc - 1)[..., None])[..., 0]
    picked = reduce_from(torch.where(mine, picked, 0.0), group)
    loss = m + torch.log(se) - picked
    return torch.where(lb == ignore_index, 0.0, loss)


class ParallelCrossEntropy(Layer):
    """Cross entropy over vocab-parallel logits, with the reference's
    trailing dimension of 1 on the output."""

    def __init__(self, mp_group=None, name=None, ignore_index: int = -100):
        super().__init__(name)
        self.group = _group(mp_group)
        self.ignore_index = ignore_index

    def forward(self, input, label):
        lb = torch.as_tensor(label, device=input.device)
        if lb.dim() == input.dim():
            lb = lb.squeeze(-1)
        return parallel_cross_entropy(input, lb, self.group,
                                      self.ignore_index)[..., None]

