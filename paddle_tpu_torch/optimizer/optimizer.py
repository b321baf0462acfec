"""Optimizer base, ``SGD`` and ``Momentum``: the eager optimizer over
``.grad``, with the multi-tensor flat update.

Counterpart of ``paddle_tpu/optimizer/optimizer.py``. ``apply_updates``
dispatches as the JAX package's does on its kernel path: an optimizer with
an update kind and more than 8 parameters updates each group of at least
two (same param dtype, state keys and dtypes, static extras) with one
``multi_tensor_update`` launch over a flat ``FlatPlan`` buffer (on the
CPU, the kernel's plain version); every other parameter takes
``_update_one``. State persists between steps as flat ``[rows, 128]`` row
segments; ``state_dict`` exports it in the parameters' shapes.

Updated params are rebound, not copied (``p.data``, the JAX package's
``_inplace_set``): after a flat update each parameter is a view into its
group's updated buffer. The ``_update_one`` arithmetic follows the JAX
package's types: a Python scalar meeting a bf16 tensor is rounded to bf16
first, as a JAX weak type is.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..ops.kernels import multi_tensor_update as mtu

__all__ = ["Optimizer", "SGD", "Momentum"]


class Optimizer:
    """Base optimizer over the parameters' ``.grad``."""

    # the multi_tensor_update kind; None keeps every param on _update_one
    _FUSED_KIND: Optional[str] = None

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        if parameters is not None:
            parameters = list(parameters)
            if parameters and isinstance(parameters[0], dict):
                raise TypeError("param groups are not supported; pass a "
                                "flat list")
        if not isinstance(learning_rate, (int, float)):
            raise NotImplementedError(
                "learning_rate must be a number: LR schedulers wait for the "
                "port of optimizer/lr.py")
        if grad_clip is not None:
            raise NotImplementedError(
                "grad_clip waits for the port of nn/clip.py")
        if weight_decay is not None and not isinstance(weight_decay,
                                                       (int, float)):
            raise NotImplementedError(
                "weight_decay must be a number (L2 decay folded into the "
                "gradient): regularizer objects are not ported")
        self._parameter_list = parameters
        self._learning_rate = float(learning_rate)
        self._l2_coeff = float(weight_decay or 0.0)
        self._accumulators: Dict[int, Dict[str, torch.Tensor]] = {}
        self._step_count = 0
        self._plans: Dict[Any, mtu.FlatPlan] = {}

    # -- lr ------------------------------------------------------------------
    def get_lr(self) -> float:
        return self._learning_rate

    def set_lr(self, value: float):
        self._learning_rate = float(value)

    # -- state ---------------------------------------------------------------
    def _state_names(self) -> List[str]:
        return []

    def _init_state(self, p) -> Dict[str, torch.Tensor]:
        return {}

    def _ensure_state(self, p) -> Dict[str, torch.Tensor]:
        st = self._accumulators.get(id(p))
        if st is None:
            st = self._accumulators[id(p)] = self._init_state(p)
        return st

    def state_dict(self) -> Dict[str, Any]:
        """``{"<param name>.<state key>": shaped tensor, ..., "@step": n}``."""
        out: Dict[str, Any] = {"LR_Scheduler": {}, "master_weights": {}}
        for p in self._params():
            st = self._accumulators.get(id(p))
            if st is None:
                continue
            for k, v in self._shaped_state(p, st).items():
                out[f"{p.name}.{k}"] = v
        out["@step"] = self._step_count
        return out

    def set_state_dict(self, state: Dict[str, Any]):
        """Load the state of every parameter whose name the dict holds,
        ignoring names no parameter has; when no name matches, map the
        state onto the parameters by position (the dict's order against
        the parameters')."""
        self._step_count = int(state.get("@step", 0))
        params = {p.name: p for p in self._params()}
        grouped: Dict[str, Dict[str, Any]] = {}
        for key, val in state.items():
            if key in ("LR_Scheduler", "master_weights", "@step"):
                continue
            pname, _, sname = key.rpartition(".")
            grouped.setdefault(pname, {})[sname] = val
        matched = [n for n in grouped if n in params]
        if grouped and not matched:
            # parameter names are process-global (nn/layer/layers.py), so
            # a rebuilt model's names have shifted: map the state onto the
            # parameters by position, as the JAX package does
            pairs = zip(grouped.values(), self._params())
        else:
            pairs = ((grouped[n], params[n]) for n in matched)
        for vals, p in pairs:
            st = self._ensure_state(p)
            for k, v in vals.items():
                st[k] = torch.as_tensor(
                    v if isinstance(v, torch.Tensor) else np.asarray(v)
                ).to(p.device)

    def _shaped_state(self, p, sv: Dict[str, torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
        """State in the parameter's shape (the flat update keeps it as
        ``[rows, 128]`` row segments)."""
        n = p.numel()
        rows = -(-n // mtu.FlatPlan.LANES)
        out = {}
        for k, v in sv.items():
            if (v.dim() == 2 and tuple(v.shape) == (rows, mtu.FlatPlan.LANES)
                    and tuple(p.shape) != tuple(v.shape)):
                v = v.reshape(-1)[:n].view(p.shape)
            out[k] = v
        return out

    # -- grads ---------------------------------------------------------------
    def _params(self) -> List[torch.Tensor]:
        if self._parameter_list is None:
            raise ValueError("the optimizer was created without a "
                             "parameters list")
        return [p for p in self._parameter_list if p.requires_grad]

    def clear_grad(self, set_to_zero: bool = False):
        for p in self._params():
            p.grad = None

    # -- the update ----------------------------------------------------------
    def _update_one(self, p, g, state, lr, step, extras=None):
        """One parameter's update: returns (new p, new state)."""
        raise NotImplementedError

    def _per_param_extras(self, p) -> Dict[str, Any]:
        """Per-parameter static scalars (AdamW's decay); they split groups."""
        return {}

    def _apply_weight_decay_to_grad(self) -> bool:
        """L2 decay folded into the gradient (all but AdamW and Lamb)."""
        return True

    def _fused_hyper(self, extras: Dict[str, Any]) -> Dict[str, Any]:
        """A group's static scalars for ``multi_tensor_update``."""
        return {}

    def apply_updates(self, pvals, gvals, svals, evals, lr, step):
        """New (params, states) for ``pvals`` with grads ``gvals`` (in the
        params' types, decay folded in), states ``svals`` and per-param
        extras ``evals``."""
        n = len(pvals)
        kind = self._FUSED_KIND
        if kind is not None and n > 8 and mtu.fused_update_active(n, kind):
            return self._apply_updates_flat(kind, pvals, gvals, svals, evals,
                                            lr, step)
        out = [self._update_one(p, g, self._shaped_state(p, s), lr, step, e)
               for p, g, s, e in zip(pvals, gvals, svals, evals)]
        return [o[0] for o in out], [o[1] for o in out]

    def _apply_updates_flat(self, kind, pvals, gvals, svals, evals, lr,
                            step):
        groups: Dict[Any, List[int]] = {}
        for i, pv in enumerate(pvals):
            skey = tuple(sorted((k, str(v.dtype))
                                for k, v in svals[i].items()))
            ekey = tuple(sorted((k, float(v)) for k, v in evals[i].items()))
            groups.setdefault((str(pv.dtype), skey, ekey), []).append(i)
        new_p: list = [None] * len(pvals)
        new_s: list = [None] * len(pvals)
        for key, idxs in groups.items():
            if len(idxs) == 1:
                i = idxs[0]
                new_p[i], new_s[i] = self._update_one(
                    pvals[i], gvals[i], self._shaped_state(pvals[i], svals[i]),
                    lr, step, evals[i])
                continue
            shapes = tuple(tuple(pvals[i].shape) for i in idxs)
            plan = self._plans.get((key, shapes))
            if plan is None:
                plan = self._plans[(key, shapes)] = mtu.FlatPlan(shapes)
            hyper = self._fused_hyper(evals[idxs[0]])
            npl, nsl = mtu.apply_flat_update(
                kind, plan, [pvals[i] for i in idxs],
                [gvals[i] for i in idxs], [svals[i] for i in idxs], hyper,
                lr, step)
            for j, i in enumerate(idxs):
                new_p[i], new_s[i] = npl[j], nsl[j]
        return new_p, new_s

    def _update(self, params, grads, lr, step):
        """Cast the grads to the params' types, fold in L2 decay, update,
        and rebind each parameter to its new value."""
        grads = [g.to(p.dtype) for p, g in zip(params, grads)]
        if self._l2_coeff and self._apply_weight_decay_to_grad():
            l2 = {dt: mtu.weak_scalar(self._l2_coeff, dt) for dt in {p.dtype
                                                        for p in params}}
            grads = [g + l2[p.dtype] * p.detach()
                     for p, g in zip(params, grads)]
        keys = self._state_names()
        svals = [{k: self._ensure_state(p)[k] for k in keys} for p in params]
        evals = [self._per_param_extras(p) for p in params]
        new_p, new_s = self.apply_updates([p.detach() for p in params],
                                          grads, svals, evals, lr, step)
        for p, np_, ns in zip(params, new_p, new_s):
            p.data = np_
            self._accumulators[id(p)] = ns

    @torch.no_grad()
    def step(self):
        pgs = [(p, p.grad) for p in self._params() if p.grad is not None]
        if not pgs:
            return
        self._step_count += 1
        self._update([p for p, _ in pgs], [g for _, g in pgs], self.get_lr(),
                     self._step_count)


class SGD(Optimizer):
    _FUSED_KIND = "sgd"

    def _update_one(self, p, g, state, lr, step, extras=None):
        return p - mtu.weak_scalar(lr, p.dtype) * g, state


class Momentum(Optimizer):
    _FUSED_KIND = "momentum"

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def _fused_hyper(self, extras):
        return {"momentum": self._momentum, "nesterov": self._nesterov}

    def _state_names(self):
        return ["velocity"]

    def _init_state(self, p):
        return {"velocity": torch.zeros_like(p.detach())}

    def _update_one(self, p, g, state, lr, step, extras=None):
        mu = mtu.weak_scalar(self._momentum, state["velocity"].dtype)
        v = mu * state["velocity"] + g
        upd = g + mu * v if self._nesterov else v
        return (p - mtu.weak_scalar(lr, p.dtype) * upd.to(p.dtype),
                {"velocity": v})
