"""The sharded trainers' shared half: ZeRO and the global-norm clip on
explicit shards, driven by a model's spec tables.

The reference (``models/llama.py`` ``make_sharded_train_step``, and
BERT's) jits its single-device step over the mesh and lets GSPMD place
every shard: parameters by ``param_specs``, AdamW's moments by
``opt_state_specs``, the batch over ``("dp", "sharding")``. The port runs
the same step on each rank's shards, the tables deciding every slice and
every collective:

- a weight whose spec names ``("dp", "sharding")`` (ZeRO stage 3) is
  stored as its slice and all-gathered before the forward; its gradient
  is reduce-scattered back to the slice;
- a weight replicated over the data axes (stages 0-2) has its gradient
  summed over them: reduce-scattered to the moments' slice where
  ``opt_state_specs`` shards them (stages 1-2), all-reduced otherwise.
  The data axes are ``("dp", "sharding")``, with ``"sep"`` when the model
  splits the sequence over it; ``mp`` never: each ``mp`` rank holds its
  own weight shard (and a weight replicated over ``mp`` gets the whole
  gradient on every ``mp`` rank from the Megatron collectives);
- the global norm sums each gradient slice's squares over exactly the
  axes its moments' spec names, so every element counts once;
- AdamW (``llama.adamw_update``, the reference's arithmetic) updates each
  rank's slices of the parameters and moments in place; a parameter
  stored whole over the data axes is then all-gathered from its slices.

A fused weight whose column blocks (q | k | v, gate | up) are split over
``mp`` is laid out per rank as Megatron's ``[q_r | k_r | v_r]``: the
column permutation ``block_perm`` is applied by ``shard_tree`` and undone
by ``gather_tree``, so gathered parameters equal the reference's.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..distributed import _comm
from .mesh import (_entry_axes, axis_group, axis_index, axis_size,
                   local_shard, local_to_global, spec_axes)

__all__ = ["ZERO_AXES", "block_perm", "shard_tree", "gather_tree",
           "shard_state", "gather_state", "ShardedStep"]

ZERO_AXES = ("dp", "sharding")


def block_perm(blocks: Sequence[int], n: int) -> np.ndarray:
    """Column order that puts rank r's share of every block side by side:
    [b0_r | b1_r | ...] for r in 0..n-1."""
    starts = np.cumsum([0] + list(blocks[:-1]))
    cols = []
    for r in range(n):
        for s, b in zip(starts, blocks):
            k = b // n
            cols.extend(range(s + r * k, s + (r + 1) * k))
    return np.asarray(cols)


def _mp_perm(key, spec, mesh, blocks):
    """The column permutation of ``key`` where its last dimension is split
    over mp (>1) and it has column blocks; else None."""
    b = blocks.get(key)
    n = axis_size(mesh, "mp")
    if b is None or n == 1 or "mp" not in _entry_axes(spec[-1]):
        return None
    return block_perm(b, n)


def shard_tree(tree, specs, mesh, device, blocks=None) -> Dict[str, torch.Tensor]:
    """This rank's shard of every (whole, host or device) tensor of
    ``tree`` under ``specs``, contiguous on ``device``."""
    out = {}
    for k, x in tree.items():
        t = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                            else x)
        perm = _mp_perm(k, specs[k], mesh, blocks or {})
        if perm is not None:
            t = t[..., torch.as_tensor(perm, device=t.device)]
        # a copy: the step updates it in place, and ``x`` is the caller's
        out[k] = local_shard(t, specs[k], mesh).to(
            device=device, copy=True).contiguous()
    return out


def gather_tree(tree, specs, mesh, blocks=None) -> Dict[str, np.ndarray]:
    """Whole host (numpy) arrays from every rank's shards under
    ``specs``."""
    out = {}
    for k, t in tree.items():
        full = local_to_global(t.detach(), specs[k], mesh)
        perm = _mp_perm(k, specs[k], mesh, blocks or {})
        if perm is not None:
            full = full[..., torch.as_tensor(np.argsort(perm),
                                             device=full.device)]
        if full.dtype == torch.bfloat16:
            full = full.float()
        out[k] = full.cpu().numpy()
    return out


def shard_state(mesh, pspecs, ospecs, params, opt_state=None,
                blocks=None):
    """This rank's shards of whole parameters under ``pspecs`` (and of
    AdamW's state under ``ospecs``) on the mesh's device; a model's
    ``shard_state`` passes its tables."""
    dev = resolve_device(mesh.device_type)
    params = shard_tree(params, pspecs, mesh, dev, blocks)
    if opt_state is None:
        return params
    return params, {"step": torch.as_tensor(opt_state["step"], device=dev,
                                            dtype=torch.int32).clone(),
                    "m": shard_tree(opt_state["m"], ospecs, mesh, dev, blocks),
                    "v": shard_tree(opt_state["v"], ospecs, mesh, dev,
                                    blocks)}


def gather_state(mesh, pspecs, ospecs, params, opt_state=None, blocks=None):
    """Whole host arrays (numpy) from every rank's shards, every rank
    taking part: the inverse of ``shard_state``."""
    full = gather_tree(params, pspecs, mesh, blocks)
    if opt_state is None:
        return full
    return full, {"step": int(opt_state["step"]),
                  "m": gather_tree(opt_state["m"], ospecs, mesh, blocks),
                  "v": gather_tree(opt_state["v"], ospecs, mesh, blocks)}


def _zdim(spec) -> Optional[int]:
    """The dimension ``spec`` splits over ZeRO's axes, if any."""
    for d, e in enumerate(spec):
        if _entry_axes(e) == ZERO_AXES:
            return d
    return None


class ShardedStep:
    """One training step on shards. ``batch_fn(tokens, labels)`` slices
    the global batch to this rank's and returns ``(data_axes, batch)``:
    the axes its rows are split over (the gradients' sum). ``loss_fn(
    weights, batch)`` computes this rank's share of the global loss (its
    tokens' sum over the global count) from the weights as the forward
    reads them (whole over the data axes, sharded over mp)."""

    def __init__(self, mesh, pspecs, ospecs, loss_fn: Callable,
                 batch_fn: Callable, lr: float, no_decay_keys, leaf_dtype: Callable = None,
                 clip_in_grad_dtype: bool = True):
        from ..models.llama import adamw_update

        self.mesh, self.pspecs, self.ospecs = mesh, pspecs, ospecs
        self.loss_fn, self.batch_fn = loss_fn, batch_fn
        self.lr = lr
        self.no_decay_keys = no_decay_keys
        self.leaf_dtype = leaf_dtype or (lambda p: p.dtype)
        self.clip_in_grad_dtype = clip_in_grad_dtype
        self._adamw = adamw_update
        for k, ps in pspecs.items():
            zp, zo = _zdim(ps), _zdim(ospecs[k])
            if zp is not None and zp != zo:
                raise ValueError(f"{k}: parameter spec {ps} and moment spec "
                                 f"{ospecs[k]} split different dimensions")
        self.zgroup = axis_group(mesh, ZERO_AXES)
        self.zrank = axis_index(mesh, ZERO_AXES)
        self.zsize = axis_size(mesh, ZERO_AXES)

    def weights(self, params):
        """Leaves the forward reads: each parameter whole over the data
        axes (all-gathered where ZeRO-3 splits it), detached, in its
        leaf dtype, requiring grad."""
        out = {}
        for k, p in params.items():
            zp = _zdim(self.pspecs[k])
            w = p if zp is None else _comm.all_gather(p, self.zgroup, zp)
            out[k] = w.detach().to(self.leaf_dtype(p)).requires_grad_()
        return out

    def loss_and_grads(self, params, tokens, labels):
        """(global loss, gradients summed over the data axes, each in its
        moments' layout)."""
        leaves = self.weights(params)
        keys = list(leaves)
        data_axes, batch = self.batch_fn(tokens, labels)
        data = axis_group(self.mesh, data_axes)
        extra = axis_group(self.mesh, tuple(
            a for a in data_axes if a not in ZERO_AXES))
        with torch.enable_grad():
            loss = self.loss_fn(leaves, batch)
            gs = torch.autograd.grad(loss, [leaves[k] for k in keys])
        grads = {}
        with torch.no_grad():
            for k, g in zip(keys, gs):
                zo = _zdim(self.ospecs[k])
                if zo is None:
                    g = _comm.all_reduce(g, data)
                else:
                    g = _comm.reduce_scatter(g, self.zgroup, zo)
                    g = _comm.all_reduce(g, extra)
                grads[k] = g
            total = _comm.all_reduce(loss.detach(), data)
        return total, grads

    def global_norm(self, grads) -> torch.Tensor:
        """sqrt of the sum of squares, each slice summed over the axes its
        moments' spec names."""
        by_axes: Dict[tuple, list] = {}
        for k, g in grads.items():
            by_axes.setdefault(spec_axes(self.ospecs[k]), []).append(
                g.float().square().sum())
        total = None
        for axes in sorted(by_axes):
            s = _comm.all_reduce(torch.stack(by_axes[axes]).sum(),
                                 axis_group(self.mesh, axes) if axes
                                 else None)
            total = s if total is None else total + s
        return torch.sqrt(total)

    @torch.no_grad()
    def update(self, params, opt_state, grads):
        """Clip, then AdamW on this rank's slices, in place; a parameter
        stored whole over the data axes is refreshed from the slices."""
        gnorm = self.global_norm(grads)
        clip = torch.clamp(1.0 / (gnorm + 1e-6), max=1.0)
        if self.clip_in_grad_dtype:
            grads = {k: g * clip.to(g.dtype) for k, g in grads.items()}
        else:
            grads = {k: g.float() * clip for k, g in grads.items()}
        slices = {}
        for k, p in params.items():
            zp, zo = _zdim(self.pspecs[k]), _zdim(self.ospecs[k])
            if zo is None or zp is not None:
                slices[k] = p
            else:
                n = p.shape[zo] // self.zsize
                slices[k] = p.narrow(zo, self.zrank * n, n)
        self._adamw(slices, grads, opt_state, lr=self.lr,
                    no_decay_keys=self.no_decay_keys)
        for k, p in params.items():
            zp, zo = _zdim(self.pspecs[k]), _zdim(self.ospecs[k])
            if zo is not None and zp is None and self.zgroup is not None:
                p.copy_(_comm.all_gather(slices[k], self.zgroup, zo))
        return params, opt_state

    def __call__(self, params, opt_state, tokens, labels):
        loss, grads = self.loss_and_grads(params, tokens, labels)
        self.update(params, opt_state, grads)
        return params, opt_state, loss
