"""Strategy meta-optimizers: GradientMerge, LocalSGD, DGC, ASP and
FP16AllReduce.

Port of ``paddle_tpu/distributed/fleet/meta_optimizers/
strategy_optimizers.py``: eager wrappers that transform the parameters'
``.grad`` (or the parameters) around the inner optimizer's ``step``, in
the reference's arithmetic. The collectives (LocalSGD's parameter
average, FP16AllReduce's gradient average) run over ``group``, default
the world, and are the identity on one rank.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from ...collective import ReduceOp, all_reduce

__all__ = ["GradientMergeOptimizer", "LocalSGDOptimizer", "DGCOptimizer",
           "ASPOptimizer", "FP16AllReduceOptimizer"]


class _MetaOptimizer:
    """Delegating base: the inner optimizer makes the update."""

    def __init__(self, inner_opt):
        self._inner_opt = inner_opt

    def __getattr__(self, item):
        return getattr(self._inner_opt, item)

    def clear_grad(self, set_to_zero: bool = False):
        self._inner_opt.clear_grad(set_to_zero)

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        # through THIS wrapper's step, so its transform applies
        loss.backward()
        self.step()
        return None, None


class GradientMergeOptimizer(_MetaOptimizer):
    """Accumulate gradients over ``k_steps`` calls, then one real update
    with their mean (``avg``) or sum."""

    def __init__(self, inner_opt, k_steps: int = 1, avg: bool = True):
        super().__init__(inner_opt)
        self.k_steps = k_steps
        self.avg = avg
        self._acc: Dict[int, torch.Tensor] = {}
        self._count = 0

    @torch.no_grad()
    def step(self):
        self._count += 1
        params = self._inner_opt._params()
        for p in params:
            if p.grad is None:
                continue
            a = self._acc.get(id(p))
            self._acc[id(p)] = p.grad.clone() if a is None else a + p.grad
        if self._count < self.k_steps:
            for p in params:  # not a real step yet
                p.grad = None
            return
        scale = 1.0 / self.k_steps if self.avg else 1.0
        for p in params:
            a = self._acc.pop(id(p), None)
            if a is not None:
                p.grad = a * scale
        self._count = 0
        self._inner_opt.step()


class LocalSGDOptimizer(_MetaOptimizer):
    """Step locally; every ``k_steps`` average the parameters over the
    group."""

    def __init__(self, inner_opt, k_steps: int = 1, group=None):
        super().__init__(inner_opt)
        self.k_steps = k_steps
        self._group = group
        self._count = 0

    def step(self):
        self._inner_opt.step()
        self._count += 1
        if self._count % self.k_steps == 0:
            for p in self._inner_opt._params():
                all_reduce(p, op=ReduceOp.AVG, group=self._group)


class DGCOptimizer(_MetaOptimizer):
    """Deep Gradient Compression: local momentum correction, then the
    top (1 - ``sparsity``) share of the accumulated values by magnitude
    sent, the rest kept as a residual; the first ``rampup_begin_step``
    steps are dense."""

    def __init__(self, inner_opt, rampup_begin_step: int = 0,
                 sparsity: float = 0.999, momentum: float = 0.9):
        super().__init__(inner_opt)
        self.rampup_begin_step = rampup_begin_step
        self.sparsity = sparsity
        self.momentum = momentum
        self._u: Dict[int, torch.Tensor] = {}  # momentum buffer
        self._v: Dict[int, torch.Tensor] = {}  # residual accumulator
        self._step = 0

    def _compress(self, pid, g):
        u = self._u.get(pid)
        u = g if u is None else self.momentum * u + g
        v = self._v.get(pid)
        v = u if v is None else v + u
        flat = v.reshape(-1)
        k = max(1, int(flat.numel() * (1.0 - self.sparsity)))
        thresh = torch.topk(flat.abs(), k).values[-1]
        mask = v.abs() >= thresh
        # the residual keeps the suppressed mass; momentum cleared where sent
        self._v[pid] = torch.where(mask, 0.0, v)
        self._u[pid] = torch.where(mask, 0.0, u)
        return torch.where(mask, v, 0.0)

    @torch.no_grad()
    def step(self):
        self._step += 1
        if self._step > self.rampup_begin_step:
            for p in self._inner_opt._params():
                if p.grad is not None:
                    p.grad = self._compress(id(p), p.grad)
        self._inner_opt.step()


class ASPOptimizer(_MetaOptimizer):
    """Automatic SParsity: n:m structured masks (the n largest magnitudes
    of every m consecutive weights on the last dimension) made at the
    first step and applied after each update."""

    def __init__(self, inner_opt, n: int = 2, m: int = 4):
        super().__init__(inner_opt)
        self.n, self.m = n, m
        self._masks: Dict[int, torch.Tensor] = {}

    @staticmethod
    @torch.no_grad()
    def prune_params(params, n: int = 2, m: int = 4):
        """Mask every parameter of 2 or more dimensions to n:m sparsity in
        place; returns {id(param) or name: mask}. ``params``: tensors or
        (name, tensor) pairs."""
        masks = {}
        for item in params:
            name, p = item if isinstance(item, tuple) else (None, item)
            if p.dim() < 2:
                continue  # biases and norms stay dense
            mask = ASPOptimizer._mask_2_4(p.detach(), n, m)
            p.mul_(mask)
            masks[name if name is not None else id(p)] = mask
        return masks

    @staticmethod
    def _mask_2_4(w, n, m):
        flat = w.reshape(-1)
        pad = (-flat.numel()) % m
        if pad:
            flat = torch.cat([flat, flat.new_zeros(pad)])
        groups = flat.reshape(-1, m)
        order = torch.argsort(groups.abs(), dim=1, stable=True)
        ranks = torch.argsort(order, dim=1, stable=True)
        mask = (ranks >= m - n).to(w.dtype)
        return mask.reshape(-1)[:w.numel()].reshape(w.shape)

    def prune_model(self, params: Optional[List[torch.Tensor]] = None):
        """Masks from the current magnitudes; zero the pruned weights."""
        plist = list(params or self._inner_opt._params())
        self._masks.update(self.prune_params(plist, self.n, self.m))

    def step(self):
        if not self._masks:
            self.prune_model()
        self._inner_opt.step()
        with torch.no_grad():
            for p in self._inner_opt._params():
                mask = self._masks.get(id(p))
                if mask is not None:
                    p.mul_(mask)


class FP16AllReduceOptimizer(_MetaOptimizer):
    """Average the gradients over the group in a 16-bit type (bf16 by
    default) before the update, casting each back to its type."""

    def __init__(self, inner_opt, dtype=torch.bfloat16, group=None):
        super().__init__(inner_opt)
        self.dtype = dtype
        self._group = group

    @torch.no_grad()
    def step(self):
        for p in self._inner_opt._params():
            if p.grad is None:
                continue
            g16 = p.grad.to(self.dtype)
            all_reduce(g16, op=ReduceOp.AVG, group=self._group)
            p.grad = g16.to(p.grad.dtype)
        self._inner_opt.step()
