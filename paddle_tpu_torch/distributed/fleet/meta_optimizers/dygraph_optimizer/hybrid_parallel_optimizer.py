"""HybridParallelOptimizer, HybridParallelClipGrad and ZeRO by ownership.

Port of ``paddle_tpu/distributed/fleet/meta_optimizers/dygraph_optimizer/
hybrid_parallel_optimizer.py``. Under the reference's single-controller
GSPMD a gradient is already the global one and ZeRO is a layout of the
optimizer state. The port's ranks hold local tensors, so:

- ``HybridParallelClipGrad`` sums, in fp32, the squared norms of the
  ``mp``-sharded parameters (``is_distributed``) over the ``mp`` group and
  counts each replicated parameter once, then (for ZeRO slices) sums over
  the ZeRO group: the clipped gradients equal the reference's
  ``ClipGradByGlobalNorm`` over the global gradients. It goes on the
  innermost optimizer, which reads it at its step.
- ``ShardOwner`` is ZeRO by ownership over a group of n ranks: each
  parameter's flat values, padded to a multiple of n, are n slices; rank
  r keeps slice r as a parameter of its own, the innermost optimizer
  steps those slices only (so each rank holds the state of its slices
  alone), and the updated slices are all-gathered into the parameters.
  Gradients are all-reduced (stage 1: the parameters' gradients become
  the group's mean) or reduce-scattered (stage 2 and up: only the slice's
  mean is kept), in fp32 and divided by n. The update must be elementwise
  (``Lamb``'s per-parameter trust ratio is refused).
- ``HybridParallelOptimizer.step`` syncs the gradients where nothing else
  has: ZeRO's collectives when the sharding stage is at least 1 and the
  ZeRO group (the mesh's ``dp`` and ``sharding`` axes) spans more than one
  rank; else, on a ``dp`` axis of more than one rank outside the ``data``
  mode (where ``DataParallel`` syncs), ``fused_allreduce_gradients``. Then
  the inner optimizer's ``step``: its flat update (``multi_tensor_update``)
  runs through it.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from .....nn.clip import ClipGradByGlobalNorm, _keeps
from .....nn.layer.layers import Parameter
from .....parallel.mesh import PartitionSpec, axis_group, get_mesh, \
    mesh_axis_size
from ...meta_parallel.parallel_layers.mp_layers import is_mp_shard
from .... import _comm
from ....collective import Group, from_process_group, get_default_group

__all__ = ["HybridParallelOptimizer", "HybridParallelClipGrad",
           "ShardOwner", "zero_shard_spec", "zero_group"]


def zero_group(hcg=None) -> Group:
    """The ZeRO group: the mesh's (``dp``, ``sharding``) axes holding this
    rank (the HCG's mesh, else the global one), else the world."""
    mesh = hcg.mesh if hcg is not None else get_mesh()
    if mesh is not None:
        return from_process_group(axis_group(mesh, ("dp", "sharding")),
                                  "zero")
    return get_default_group()


def zero_shard_spec(shape, mesh=None) -> Optional[PartitionSpec]:
    """The reference's layout of a ZeRO-sharded state: its first dimension
    that divides by |dp| * |sharding| split over ("dp", "sharding"); None
    when nothing divides (or without a mesh)."""
    mesh = mesh or get_mesh()
    if mesh is None:
        return None
    axes = [a for a in ("dp", "sharding") if a in mesh.mesh_dim_names]
    deg = 1
    for a in axes:
        deg *= mesh_axis_size(a, mesh)
    if deg <= 1:
        return None
    for i, d in enumerate(shape):
        if d % deg == 0 and d > 0:
            spec = [None] * len(shape)
            spec[i] = tuple(axes) if len(axes) > 1 else axes[0]
            return PartitionSpec(*spec)
    return None


class HybridParallelClipGrad(ClipGradByGlobalNorm):
    """The global-norm clip over a hybrid mesh's local gradients."""

    def __init__(self, clip, hcg, zero=None):
        clip_norm = clip.clip_norm if isinstance(clip, ClipGradByGlobalNorm) \
            else float(clip)
        super().__init__(clip_norm)
        self._hcg = hcg
        self._zero = zero  # the ZeRO group whose slices the params are

    def _global_norm_sq(self, params_grads):
        sharded = replicated = None
        for p, g in params_grads:
            sq = g.float().square().sum()
            if is_mp_shard(p):
                sharded = sq if sharded is None else sharded + sq
            else:
                replicated = sq if replicated is None else replicated + sq
        dev = params_grads[0][1].device
        if sharded is None:
            sharded = torch.zeros((), device=dev)
        mp = (self._hcg.get_model_parallel_group()
              if self._hcg is not None else None)
        if mp is not None and mp.nranks > 1:
            sharded = _comm.all_reduce(sharded, mp.process_group)
        total = sharded if replicated is None else sharded + replicated
        if self._zero is not None and self._zero.nranks > 1:
            total = _comm.all_reduce(total, self._zero.process_group)
        return total

    def __call__(self, params_grads):
        clippable = [(p, g) for p, g in params_grads
                     if g is not None and not _keeps(p)]
        if not clippable:
            return params_grads
        gnorm = self._global_norm_sq(clippable).sqrt()
        scale = torch.where(gnorm > self.clip_norm,
                            self.clip_norm / (gnorm + 1e-6), 1.0)
        return [(p, g if g is None or _keeps(p)
                 else (g.float() * scale).to(g.dtype))
                for p, g in params_grads]


def _innermost(opt):
    while hasattr(opt, "_inner_opt"):
        opt = opt._inner_opt
    return opt


def _host(t: torch.Tensor) -> torch.Tensor:
    t = t.detach().to("cpu")
    return t.pin_memory() if torch.cuda.is_available() else t


class ShardOwner:
    """ZeRO by ownership of ``opt``'s parameters over ``group`` at
    ``stage`` (1: states; 2: and gradients; 3: and parameters, which
    hold no values between ``release_params`` and ``gather_params``).
    ``offload`` keeps the slices' optimizer state in (pinned) host memory
    between steps."""

    def __init__(self, opt, group: Group, stage: int, offload=False):
        from .....optimizer.adam import Lamb

        if isinstance(opt, Lamb):
            raise NotImplementedError(
                "Lamb under ZeRO: its trust ratio is per parameter, and "
                "each rank holds slices of them")
        if opt._parameter_list is None:
            raise ValueError("the optimizer was created without a "
                             "parameters list")
        self.opt = opt
        self.group = group
        self.n, self.r = group.nranks, group.rank
        self.stage = int(stage)
        self.offload = bool(offload)
        self.params = [p for p in opt._parameter_list if p.requires_grad]
        self.shapes = [tuple(p.shape) for p in self.params]
        self.slices: List[torch.Tensor] = []
        for p in self.params:
            k = -(-p.numel() // self.n)
            flat = self._padded(p.detach().reshape(-1), k)
            s = Parameter(flat[self.r * k:(self.r + 1) * k].clone(),
                          requires_grad=True)
            s.name = p.name
            s.need_clip = getattr(p, "need_clip", True)
            s.is_distributed = is_mp_shard(p)
            self.slices.append(s)
        opt._parameter_list = self.slices
        clip = opt._grad_clip
        if isinstance(clip, ClipGradByGlobalNorm):
            hcg = getattr(clip, "_hcg", None)
            opt._grad_clip = HybridParallelClipGrad(clip, hcg, zero=group)
        self._gathered = True
        self.host_moves = 0  # state tensors moved to the host, all steps
        if self.stage >= 3:
            self.release_params()

    def _padded(self, flat, k):
        pad = self.n * k - flat.numel()
        return torch.cat([flat, flat.new_zeros(pad)]) if pad else flat

    def sync_grads(self):
        """Each slice's gradient: the group's mean of its parameter's."""
        pg = self.group.process_group
        for p, s in zip(self.params, self.slices):
            if p.grad is None:
                s.grad = None
                continue
            k = s.numel()
            flat = self._padded(p.grad.detach().reshape(-1).float(), k)
            if self.stage >= 2:
                mine = _comm.reduce_scatter(flat, pg) / self.n
                p.grad = None
            else:
                full = _comm.all_reduce(flat, pg) / self.n
                p.grad = full[:p.numel()].view(p.shape).to(p.dtype)
                mine = full[self.r * k:(self.r + 1) * k]
            s.grad = mine.to(s.dtype)

    @torch.no_grad()
    def gather_params(self):
        """Every parameter whole again from the ranks' slices."""
        pg = self.group.process_group
        for p, s, shape in zip(self.params, self.slices, self.shapes):
            n = int(torch.Size(shape).numel())
            full = _comm.all_gather(s.detach(), pg)[:n].view(shape)
            p.data = full.to(s.dtype)
        self._gathered = True

    @torch.no_grad()
    def release_params(self):
        for p in self.params:
            p.data = p.data.new_empty(0)
        self._gathered = False

    def ensure_gathered(self):
        if not self._gathered:
            self.gather_params()

    def _move_state(self, to_host: bool):
        for s in self.slices:
            st = self.opt._accumulators.get(id(s))
            if st:
                for k, v in list(st.items()):
                    st[k] = _host(v) if to_host else v.to(s.device)
                    self.host_moves += int(to_host)

    def step(self, inner_step):
        """Sync, ``inner_step()`` on the slices, gather (and release)."""
        self.sync_grads()
        if self.offload:
            self._move_state(False)
        inner_step()
        if self.offload:
            self._move_state(True)
        self.gather_params()
        if self.stage >= 3:
            self.release_params()

    def clear_grads(self):
        for p in self.params:
            p.grad = None
        for s in self.slices:
            s.grad = None

    def state_on_host(self) -> bool:
        return all(v.device.type == "cpu"
                   for s in self.slices
                   for v in self.opt._accumulators.get(id(s), {}).values())

    def full_state(self):
        """The unsharded optimizer's ``state_dict`` layout: each slice's
        state all-gathered into its parameter's shape."""
        pg = self.group.process_group
        out = {}
        for p, s, shape in zip(self.params, self.slices, self.shapes):
            st = self.opt._accumulators.get(id(s))
            if not st:
                continue
            n = int(torch.Size(shape).numel())
            for k, v in self.opt._shaped_state(s, st).items():
                v = v.to(s.device)
                if v.dim() == 0:
                    out[f"{p.name}.{k}"] = v
                    continue
                full = _comm.all_gather(v.reshape(-1).contiguous(), pg)
                out[f"{p.name}.{k}"] = full[:n].view(shape)
        out["@step"] = self.opt._step_count
        return out


class HybridParallelOptimizer:
    def __init__(self, optimizer, hcg=None, strategy=None, min_stage=0):
        from ...base.topology import get_hybrid_communicate_group

        self._inner_opt = optimizer
        self._hcg = hcg or get_hybrid_communicate_group()
        self._strategy = strategy
        self._sharding_stage = min_stage
        if strategy is not None and getattr(strategy, "sharding", False):
            self._sharding_stage = max(min_stage,
                                       strategy.sharding_configs.stage)
        elif self._hcg is not None and \
                self._hcg.get_sharding_parallel_world_size() > 1:
            self._sharding_stage = max(min_stage, 1)
        # only a global-norm clip gets the hybrid treatment (the reference
        # swaps exactly ClipGradByGlobalNorm), on the INNERMOST optimizer:
        # that is the one that reads it at its step
        innermost = _innermost(optimizer)
        if isinstance(innermost._grad_clip, ClipGradByGlobalNorm) and \
                not isinstance(innermost._grad_clip, HybridParallelClipGrad):
            innermost._grad_clip = HybridParallelClipGrad(
                innermost._grad_clip, self._hcg)
        self._owner = None
        if self._sharding_stage >= 1:
            group = zero_group(self._hcg)
            if group.nranks > 1:
                # parameter sharding needs the model (group_sharded_parallel)
                self._owner = ShardOwner(innermost, group,
                                         min(self._sharding_stage, 2))

    # the inner optimizer's API passes through
    def __getattr__(self, item):
        return getattr(self._inner_opt, item)

    def _dp_sync(self) -> bool:
        hcg = self._hcg
        return (self._owner is None and hcg is not None
                and hcg.get_data_parallel_world_size() > 1
                and hcg.get_parallel_mode() != "data")

    def step(self):
        if self._owner is not None:
            self._owner.step(self._inner_opt.step)
            return
        if self._dp_sync():
            from ...utils.hybrid_parallel_util import \
                fused_allreduce_gradients

            fused_allreduce_gradients(_innermost(self)._params(), self._hcg)
        self._inner_opt.step()

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        return None, None

    def clear_grad(self, set_to_zero: bool = False):
        self._inner_opt.clear_grad(set_to_zero=set_to_zero)
        if self._owner is not None:
            self._owner.clear_grads()

    clear_gradients = clear_grad
