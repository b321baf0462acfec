"""The collectives the mesh path runs, over ``torch.distributed``.

Each takes a process group, or ``None`` for a group of one (then it is
the identity and touches no backend). NCCL takes CUDA tensors. Gloo takes
CPU tensors, and CUDA tensors only for the operations in
``GLOO_TAKES_CUDA``: for the others a CUDA tensor is copied to the host,
reduced there and copied back. That staging is chosen by the group's
backend and the tensor's device, on every call, never by catching an
error, and each staged call is counted in ``STAGED`` by operation (every
call over a group, staged or not, in ``CALLS``).

Sums of bf16 and fp16 tensors are taken in fp32 and rounded once, as a
single device's fp32-accumulating GEMM rounds its sum once.
"""

from __future__ import annotations

from collections import Counter
from typing import List

import torch
import torch.distributed as dist

__all__ = ["GLOO_TAKES_CUDA", "STAGED", "CALLS", "stage", "all_reduce",
           "all_reduce_max", "all_gather", "reduce_scatter", "all_to_all",
           "ring_shift", "broadcast", "group_ranks"]

# gloo operations that take CUDA tensors as they are, with the right
# numbers: found on the card by ``experiments.mesh_train.probe_gloo_cuda``
# (H100, torch 2.11; send / recv on a CUDA tensor closed the connection)
GLOO_TAKES_CUDA = frozenset(("all_reduce", "all_gather", "reduce_scatter",
                             "all_to_all"))
# calls staged through the host, and all calls over a group, by operation
STAGED: Counter = Counter()
CALLS: Counter = Counter()

_LOW = (torch.bfloat16, torch.float16)
# the names this torch gives the single-tensor forms (older ones have
# only the *_tensor spellings, newer ones deprecate them)
_ALL_GATHER = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


def _staged(t: torch.Tensor, group, op: str) -> bool:
    return (t.is_cuda and dist.get_backend(group) == "gloo"
            and op not in GLOO_TAKES_CUDA)


def stage(t: torch.Tensor, group, op: str):
    """(tensor to hand the backend, device to return to or None): ``t``
    itself, or its host copy where gloo does not take ``op`` on a CUDA
    tensor (counted in ``STAGED``; every call in ``CALLS``)."""
    CALLS[op] += 1
    if _staged(t, group, op):
        STAGED[op] += 1
        return t.detach().cpu(), t.device
    return t, None


def group_ranks(group) -> List[int]:
    """The global ranks of ``group`` in group-rank order."""
    return dist.get_process_group_ranks(group)


def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """A new tensor: ``t`` reduced over ``group`` (sums of bf16 / fp16 in
    fp32)."""
    if group is None:
        return t.clone()
    x = t.detach().float() if t.dtype in _LOW else t.detach().clone()
    x, back = stage(x, group, "all_reduce")
    dist.all_reduce(x, op=op, group=group)
    if back is not None:
        x = x.to(back)
    return x.to(t.dtype)


def all_reduce_max(t: torch.Tensor, group) -> torch.Tensor:
    return all_reduce(t, group, op=dist.ReduceOp.MAX)


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim`` in group-rank
    order."""
    if group is None:
        return t.clone()
    n = dist.get_world_size(group)
    x = t.detach().movedim(dim, 0).contiguous()
    x, back = stage(x, group, "all_gather")
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    _ALL_GATHER(out, x, group=group)
    if back is not None:
        out = out.to(back)
    return out.movedim(0, dim)


def reduce_scatter(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """This rank's piece along ``dim`` of ``t`` summed over ``group``
    (pieces in group-rank order)."""
    if group is None:
        return t.clone()
    n = dist.get_world_size(group)
    if t.shape[dim] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(t.shape)} "
                         f"does not divide by {n}")
    dt = t.dtype
    x = t.detach().float() if dt in _LOW else t.detach()
    x = x.movedim(dim, 0).contiguous()
    x, back = stage(x, group, "reduce_scatter")
    out = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
    _REDUCE_SCATTER(out, x, group=group)
    if back is not None:
        out = out.to(back)
    return out.movedim(0, dim).to(dt)


def all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """Piece j of ``t`` (split along dim 0) to group rank j; returns the
    pieces received, piece j from group rank j."""
    if group is None:
        return t.clone()
    x, back = stage(t.detach().contiguous(), group, "all_to_all")
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out if back is None else out.to(back)


def ring_shift(t: torch.Tensor, group, step: int = 1) -> torch.Tensor:
    """``t`` sent to group rank ``r + step`` and received from ``r -
    step`` (mod the group's size), by ``batch_isend_irecv``."""
    if group is None:
        return t.clone()
    ranks = group_ranks(group)
    n = len(ranks)
    r = ranks.index(dist.get_rank())
    x, back = stage(t.detach().contiguous(), group, "ring_shift")
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, ranks[(r + step) % n], group),
           dist.P2POp(dist.irecv, out, ranks[(r - step) % n], group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out if back is None else out.to(back)


def broadcast(t: torch.Tensor, group, src: int) -> torch.Tensor:
    """A new tensor: global rank ``src``'s ``t`` on every rank of
    ``group``."""
    if group is None:
        return t.clone()
    x, back = stage(t.detach().clone().contiguous(), group, "broadcast")
    dist.broadcast(x, src=src, group=group)
    return x if back is None else x.to(back)
