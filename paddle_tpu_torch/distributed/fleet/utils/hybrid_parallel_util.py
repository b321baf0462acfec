"""Hybrid-parallel gradient and parameter sync.

Port of ``paddle_tpu/distributed/fleet/utils/hybrid_parallel_util.py``.
The reference's are identities or layout moves, because GSPMD's
gradients are global and its parameters one logical array. The port's
ranks hold local copies, so each is a real collective over the HCG's
group (the world's where no HCG is given or set):

- ``fused_allreduce_gradients``: the parameters' gradients averaged over
  the data-parallel group, one fp32 all-reduce a gradient type over their
  concatenation (``sharding_reduce_gradients``: over the sharding group);
- ``broadcast_mp_parameters`` / ``broadcast_dp_parameters`` /
  ``broadcast_sharding_parameters``: the parameters from the group's
  first rank (``mp`` skips the ``is_distributed`` shards);
- ``broadcast_input_data``: each tensor input from the ``mp`` group's
  first rank, in place.
"""

from __future__ import annotations

import torch

from ... import _comm
from ...collective import broadcast, get_default_group
from ..base.topology import get_hybrid_communicate_group
from ..meta_parallel.parallel_layers.mp_layers import is_mp_shard

__all__ = ["fused_allreduce_gradients", "sharding_reduce_gradients",
           "broadcast_input_data", "broadcast_mp_parameters",
           "broadcast_dp_parameters", "broadcast_sharding_parameters"]


def _group(hcg, getter):
    hcg = hcg or get_hybrid_communicate_group()
    return getattr(hcg, getter)() if hcg is not None else get_default_group()


@torch.no_grad()
def _average_grads(parameter_list, group):
    if group.nranks == 1:
        return
    by_type = {}
    for p in parameter_list:
        if getattr(p, "grad", None) is not None:
            by_type.setdefault(p.grad.dtype, []).append(p)
    for ps in by_type.values():
        flat = torch.cat([p.grad.reshape(-1).float() for p in ps])
        flat = _comm.all_reduce(flat, group.process_group) / group.nranks
        off = 0
        for p in ps:
            n = p.numel()
            p.grad = flat[off:off + n].view(p.shape).to(p.grad.dtype)
            off += n


def fused_allreduce_gradients(parameter_list, hcg=None):
    _average_grads(list(parameter_list),
                   _group(hcg, "get_data_parallel_group"))


def sharding_reduce_gradients(parameter_list, hcg=None):
    _average_grads(list(parameter_list),
                   _group(hcg, "get_sharding_parallel_group"))


def broadcast_input_data(hcg, *inputs, **kwargs):
    """Every tensor input as the ``mp`` group's first rank holds it."""
    group = _group(hcg, "get_model_parallel_group")
    for t in list(inputs) + list(kwargs.values()):
        if isinstance(t, torch.Tensor):
            broadcast(t, src=group.ranks[0], group=group)
    return inputs if not kwargs else (inputs, kwargs)


def _broadcast_params(model, group, skip_distributed=False):
    for p in model.parameters():
        if skip_distributed and is_mp_shard(p):
            continue
        broadcast(p, src=group.ranks[0], group=group)


def broadcast_mp_parameters(model, hcg=None):
    _broadcast_params(model, _group(hcg, "get_model_parallel_group"), True)


def broadcast_dp_parameters(model, hcg=None):
    _broadcast_params(model, _group(hcg, "get_data_parallel_group"))


def broadcast_sharding_parameters(model, hcg=None):
    _broadcast_params(model, _group(hcg, "get_sharding_parallel_group"))
