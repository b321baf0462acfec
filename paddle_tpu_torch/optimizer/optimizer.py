"""Optimizer base, ``SGD`` and ``Momentum``: the eager optimizer over
``.grad``, with the multi-tensor flat update; ``Adagrad``, ``Adadelta``,
``RMSProp``, ``ASGD`` and ``Rprop``, which have no flat kind in either
package and step each parameter on its own; and the regularizers
``L2Decay`` and ``L1Decay``.

Counterpart of ``paddle_tpu/optimizer/optimizer.py``. ``apply_updates``
dispatches as the JAX package's does on its kernel path: an optimizer with
an update kind and more than 8 parameters updates each group of at least
two (same param dtype, state keys and dtypes, static extras) with one
``multi_tensor_update`` launch over a flat ``FlatPlan`` buffer (on the
CPU, the kernel's plain version); every other parameter takes
``_update_one``. State persists between steps as flat ``[rows, 128]`` row
segments; ``state_dict`` exports it in the parameters' shapes.

A step runs in the reference's order: clip the gradients (``grad_clip``),
cast them to the parameters' types, fold in L2 decay, update. The learning
rate is a number or an ``lr.LRScheduler``, whose ``get_lr()`` is read at
every step; ``state_dict()["LR_Scheduler"]`` carries the scheduler.

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
from .lr import LRScheduler

__all__ = ["Optimizer", "SGD", "Momentum", "Adagrad", "Adadelta", "RMSProp",
           "ASGD", "Rprop", "L2Decay", "L1Decay"]


class L2Decay:
    """L2 weight decay ``coeff * p`` folded into the gradient."""

    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)


class L1Decay:
    """L1 weight decay. The reference accepts it and decays nothing (its
    L2 coefficient stays 0.0), so the port takes only ``coeff`` 0."""

    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)


def _l2_coeff(weight_decay) -> float:
    """The L2 coefficient of ``weight_decay``, as the reference reads it
    from a float or an ``L2Decay``; what the reference silently ignores
    (a nonzero int, a nonzero ``L1Decay``, any other object) is refused."""
    if weight_decay is None or isinstance(weight_decay, float):
        return float(weight_decay or 0.0)
    if isinstance(weight_decay, L2Decay):
        return weight_decay.coeff
    if isinstance(weight_decay, int) and not isinstance(weight_decay, bool):
        if weight_decay:
            # the reference takes the L2 coefficient from a float (or an
            # L2Decay) only and leaves it at 0.0 for an int: refuse the
            # int instead of decaying where the reference does not
            raise TypeError(
                f"weight_decay={weight_decay!r} is an int: the reference "
                f"optimizer ignores an integer weight_decay (its L2 "
                f"coefficient stays 0.0); pass a float such as "
                f"{float(weight_decay)!r}")
        return 0.0
    if isinstance(weight_decay, L1Decay):
        if weight_decay.coeff:
            raise TypeError(
                f"L1Decay({weight_decay.coeff!r}): the reference optimizer "
                f"accepts an L1Decay and decays nothing (its L2 coefficient "
                f"stays 0.0); pass L1Decay(0.0), or L2Decay for decay")
        return 0.0
    raise TypeError(f"weight_decay must be a float, an L2Decay or None, got "
                    f"{weight_decay!r}")


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
        if not isinstance(learning_rate, (int, float, LRScheduler)):
            raise TypeError(f"learning_rate must be a number or an "
                            f"LRScheduler, got {learning_rate!r}")
        if grad_clip is not None and not callable(grad_clip):
            raise TypeError(f"grad_clip must be a clip object (nn.clip), "
                            f"got {grad_clip!r}")
        self._parameter_list = parameters
        self._learning_rate = (learning_rate if isinstance(
            learning_rate, LRScheduler) else float(learning_rate))
        self._grad_clip = grad_clip
        self._l2_coeff = _l2_coeff(weight_decay)
        self._accumulators: Dict[int, Dict[str, torch.Tensor]] = {}
        self._step_count = 0
        self._plans: Dict[Any, mtu.FlatPlan] = {}

    # -- lr ------------------------------------------------------------------
    def get_lr(self) -> float:
        if isinstance(self._learning_rate, LRScheduler):
            return float(self._learning_rate.get_lr())
        return self._learning_rate

    def set_lr(self, value: float):
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError("set_lr is not allowed when the learning "
                               "rate is an LRScheduler")
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
        if isinstance(self._learning_rate, LRScheduler):
            out["LR_Scheduler"] = self._learning_rate.state_dict()
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
        the parameters'); an ``LR_Scheduler`` entry loads into the
        optimizer's scheduler."""
        if isinstance(self._learning_rate, LRScheduler) \
                and state.get("LR_Scheduler"):
            self._learning_rate.set_state_dict(dict(state["LR_Scheduler"]))
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
        ``[rows, 128]`` row segments; an optimizer without a flat kind
        never does)."""
        if self._FUSED_KIND is None or not sv:
            return sv
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

    clear_gradients = clear_grad

    def _clip(self, params, grads):
        """``grad_clip`` over the (param, grad) pairs (grads unchanged
        without one)."""
        if self._grad_clip is None:
            return grads
        return [g for _, g in self._grad_clip(list(zip(params, grads)))]

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
        params = [p for p, _ in pgs]
        grads = self._clip(params, [g for _, g in pgs])
        self._step_count += 1
        self._update(params, grads, self.get_lr(), self._step_count)

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        """Backward from ``loss``, then ``step``."""
        loss.backward()
        self.step()
        return None, None


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


class Adagrad(Optimizer):
    """``m += g^2``; ``p -= lr g / (sqrt(m) + epsilon)``."""

    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._epsilon = epsilon
        self._init_val = initial_accumulator_value

    def _state_names(self):
        return ["moment"]

    def _init_state(self, p):
        return {"moment": torch.full_like(p.detach(), self._init_val)}

    def _update_one(self, p, g, state, lr, step, extras=None):
        m = state["moment"] + g * g
        return (p - mtu.weak_scalar(lr, p.dtype) * g / (m.sqrt()
                                                        + self._epsilon),
                {"moment": m})


class Adadelta(Optimizer):
    """Step ``g sqrt(E[u^2] + eps) / sqrt(E[g^2] + eps)`` times ``lr``,
    both averages decayed by ``rho``."""

    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._epsilon = epsilon
        self._rho = rho

    def _state_names(self):
        return ["avg_squared_grad", "avg_squared_update"]

    def _init_state(self, p):
        return {"avg_squared_grad": torch.zeros_like(p.detach()),
                "avg_squared_update": torch.zeros_like(p.detach())}

    def _update_one(self, p, g, state, lr, step, extras=None):
        rho, eps = self._rho, self._epsilon
        ag = rho * state["avg_squared_grad"] + (1 - rho) * g * g
        upd = g * (state["avg_squared_update"] + eps).sqrt() / (ag
                                                                 + eps).sqrt()
        au = rho * state["avg_squared_update"] + (1 - rho) * upd * upd
        return p - mtu.weak_scalar(lr, p.dtype) * upd, {
            "avg_squared_grad": ag, "avg_squared_update": au}


class RMSProp(Optimizer):
    """``E[g^2]`` decayed by ``rho`` (``centered`` subtracts ``E[g]^2``),
    and a momentum buffer ``mu v + lr g / sqrt(. + eps)`` subtracted from
    the parameter."""

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._rho = rho
        self._epsilon = epsilon
        self._momentum = momentum
        self._centered = centered

    def _state_names(self):
        return ["mean_square", "mean_grad", "momentum"]

    def _init_state(self, p):
        return {k: torch.zeros_like(p.detach()) for k in self._state_names()}

    def _update_one(self, p, g, state, lr, step, extras=None):
        rho, eps, mu = self._rho, self._epsilon, self._momentum
        ms = rho * state["mean_square"] + (1 - rho) * g * g
        mg = state["mean_grad"]
        if self._centered:
            mg = rho * mg + (1 - rho) * g
            denom = (ms - mg * mg + eps).sqrt()
        else:
            denom = (ms + eps).sqrt()
        mom = mu * state["momentum"] + mtu.weak_scalar(lr, p.dtype) * g / denom
        return p - mom, {"mean_square": ms, "mean_grad": mg, "momentum": mom}


class ASGD(Optimizer):
    """Averaged SGD: ``d``, the sum of the last ``batch_num`` gradients
    (each kept in the cyclic buffer ``ys``, ``[batch_num, *p.shape]`` on the
    parameter's device), stepped as ``p -= lr d / min(step, batch_num)``."""

    def __init__(self, learning_rate=0.001, batch_num=1, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._batch_num = int(batch_num)

    def _state_names(self):
        return ["d", "ys"]

    def _init_state(self, p):
        p = p.detach()
        return {"d": torch.zeros_like(p),
                "ys": torch.zeros((self._batch_num,) + tuple(p.shape),
                                  dtype=p.dtype, device=p.device)}

    def _update_one(self, p, g, state, lr, step, extras=None):
        idx = (step - 1) % self._batch_num
        d = state["d"] - state["ys"][idx] + g
        ys = state["ys"].clone()
        ys[idx] = g
        rate = np.float32(lr) / np.float32(min(step, self._batch_num))
        return p - mtu.weak_scalar(rate, p.dtype) * d, {"d": d, "ys": ys}


class Rprop(Optimizer):
    """Resilient backprop: a step size per element, grown by ``etas[1]``
    while the gradient keeps its sign and shrunk by ``etas[0]`` when it
    flips (within ``learning_rate_range``); the step is its sign times the
    size, and a flipped gradient steps 0 and is forgotten.
    ``weight_decay`` is not taken, as in the reference."""

    def __init__(self, learning_rate=0.001, learning_rate_range=(1e-5, 50),
                 parameters=None, etas=(0.5, 1.2), grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, name)
        self._lr_min, self._lr_max = (float(learning_rate_range[0]),
                                      float(learning_rate_range[1]))
        self._eta_n, self._eta_p = float(etas[0]), float(etas[1])
        self._init_lr = float(learning_rate)

    def _state_names(self):
        return ["prev_grad", "learning_rate"]

    def _init_state(self, p):
        return {"prev_grad": torch.zeros_like(p.detach()),
                "learning_rate": torch.full_like(p.detach(), self._init_lr)}

    def _update_one(self, p, g, state, lr, step, extras=None):
        sign = g * state["prev_grad"]
        rate = state["learning_rate"]
        lr_e = torch.where(
            sign > 0, torch.clamp(rate * self._eta_p, max=self._lr_max),
            torch.where(sign < 0,
                        torch.clamp(rate * self._eta_n, min=self._lr_min),
                        rate))
        g_eff = torch.where(sign < 0, 0.0, g)
        return p - g_eff.sign() * lr_e.to(p.dtype), {
            "prev_grad": g_eff, "learning_rate": lr_e}
