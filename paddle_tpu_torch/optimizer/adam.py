"""``Adam``, ``AdamW``, ``Lamb``, ``Lion``, ``Adamax``, ``NAdam`` and
``RAdam`` (counterpart of ``paddle_tpu/optimizer/adam.py``). ``Adam``,
``AdamW`` and ``Lamb`` take the ``multi_tensor_update`` flat path (kinds
``adam`` and ``lamb``); ``multi_precision`` keeps fp32 moments and an fp32
master copy of each low-precision parameter. The other four have no flat
kind in either package: ``Adamax``, ``NAdam`` and ``RAdam`` reset the
``adam`` kind they would inherit (their arithmetic is not Adam's), so each
parameter steps on its own. Their step-dependent scalars (bias
corrections, NAdam's momentum schedule, RAdam's rectification) are fp32,
as the reference's traced scalars are."""

from __future__ import annotations

import numpy as np
import torch

from ..ops.kernels.multi_tensor_update import bias_corrections, weak_scalar
from .optimizer import Optimizer

__all__ = ["Adam", "AdamW", "Lamb", "Lion", "Adamax", "NAdam", "RAdam"]


class Adam(Optimizer):
    _FUSED_KIND = "adam"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        self._multi_precision = multi_precision

    def _fused_hyper(self, extras):
        return {"beta1": self._beta1, "beta2": self._beta2,
                "epsilon": self._epsilon}

    def _state_names(self):
        if self._multi_precision:
            return ["moment1", "moment2", "master"]
        return ["moment1", "moment2"]

    def _init_state(self, p):
        dt = torch.float32 if self._multi_precision else p.dtype
        st = {"moment1": torch.zeros(p.shape, dtype=dt, device=p.device),
              "moment2": torch.zeros(p.shape, dtype=dt, device=p.device)}
        if self._multi_precision:
            st["master"] = p.detach().float().clone()
        return st

    def _update_one(self, p, g, state, lr, step, extras=None):
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        dt = state["moment1"].dtype
        gf = g.to(dt)
        m = (weak_scalar(b1, dt) * state["moment1"]
             + weak_scalar(1 - b1, dt) * gf)
        v = (weak_scalar(b2, dt) * state["moment2"]
             + weak_scalar(1 - b2, dt) * gf * gf)
        bc1, bc2 = bias_corrections(b1, b2, step)
        lr = float(np.float32(lr))
        upd = lr * (m.float() / bc1) / ((v.float() / bc2).sqrt()
                                        + float(np.float32(eps)))
        new_state = {"moment1": m, "moment2": v}
        if self._multi_precision:
            master = state["master"] - upd
            new_state["master"] = master
            return master.to(p.dtype), new_state
        return p - upd.to(p.dtype), new_state


class AdamW(Adam):
    """Adam with decoupled weight decay; ``apply_decay_param_fun(name)``
    False exempts a parameter (its own group on the flat path)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, multi_precision, name)
        self._wd = float(weight_decay)
        self._apply_decay_param_fun = apply_decay_param_fun

    def _apply_weight_decay_to_grad(self):
        return False

    def _per_param_extras(self, p):
        decay = self._wd
        if self._apply_decay_param_fun is not None \
                and not self._apply_decay_param_fun(p.name):
            decay = 0.0
        return {"decay": np.float32(decay)}

    def _fused_hyper(self, extras):
        h = super()._fused_hyper(extras)
        h["decay"] = float(extras.get("decay", self._wd))
        h["decoupled"] = True
        return h

    def _update_one(self, p, g, state, lr, step, extras=None):
        new_p, new_state = super()._update_one(p, g, state, lr, step)
        lrwd = float(np.float32(lr) * extras["decay"])
        if self._multi_precision:
            master = new_state["master"] - lrwd * state["master"]
            new_state["master"] = master
            return master.to(p.dtype), new_state
        return new_p - weak_scalar(lrwd, p.dtype) * p, new_state


class Lamb(Optimizer):
    """Layer-wise adaptive moments: Adam's update plus decay, scaled per
    tensor by the trust ratio ||w|| / ||r||. Moments are fp32;
    ``exclude_from_weight_decay_fn(name)`` True exempts a parameter."""

    _FUSED_KIND = "lamb"

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, name)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        self._wd = lamb_weight_decay
        self._exclude_fn = exclude_from_weight_decay_fn
        self._multi_precision = multi_precision

    def _state_names(self):
        if self._multi_precision:
            return ["moment1", "moment2", "master"]
        return ["moment1", "moment2"]

    def _init_state(self, p):
        st = {"moment1": torch.zeros(p.shape, device=p.device),
              "moment2": torch.zeros(p.shape, device=p.device)}
        if self._multi_precision:
            st["master"] = p.detach().float().clone()
        return st

    def _fused_hyper(self, extras):
        return {"beta1": self._beta1, "beta2": self._beta2,
                "epsilon": self._epsilon,
                "decay": float(extras.get("decay", self._wd))}

    def _per_param_extras(self, p):
        decay = self._wd
        if self._exclude_fn is not None and self._exclude_fn(p.name):
            decay = 0.0
        return {"decay": np.float32(decay)}

    def _update_one(self, p, g, state, lr, step, extras=None):
        b1, b2 = float(np.float32(self._beta1)), float(np.float32(self._beta2))
        wd = float(extras["decay"]) if extras else float(np.float32(self._wd))
        pf = state["master"] if self._multi_precision else p.float()
        gf = g.float()
        omb1 = float(np.float32(1 - self._beta1))
        omb2 = float(np.float32(1 - self._beta2))
        m = b1 * state["moment1"] + omb1 * gf
        v = b2 * state["moment2"] + omb2 * gf * gf
        bc1, bc2 = bias_corrections(b1, b2, step)
        r = (m / bc1) / ((v / bc2).sqrt() + float(np.float32(self._epsilon))) \
            + wd * pf
        w_norm = pf.pow(2).sum().sqrt()
        r_norm = r.pow(2).sum().sqrt()
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm, 1.0)
        new_pf = pf - (float(np.float32(lr)) * trust) * r
        new_state = {"moment1": m, "moment2": v}
        if self._multi_precision:
            new_state["master"] = new_pf
        return new_pf.to(p.dtype), new_state


def _f32(x) -> torch.Tensor:
    return torch.tensor(float(x), dtype=torch.float32)


class Lion(Optimizer):
    """Sign momentum: ``p -= lr (sign(b1 m + (1 - b1) g) + wd p)``, then
    ``m = b2 m + (1 - b2) g``; the decay is decoupled."""

    def __init__(self, learning_rate=1e-4, beta1=0.9, beta2=0.99,
                 parameters=None, weight_decay=0.0, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, name)
        self._beta1 = beta1
        self._beta2 = beta2
        self._wd = float(weight_decay or 0.0)
        self._multi_precision = multi_precision

    def _state_names(self):
        return ["moment", "master"] if self._multi_precision else ["moment"]

    def _init_state(self, p):
        dt = torch.float32 if self._multi_precision else p.dtype
        st = {"moment": torch.zeros(p.shape, dtype=dt, device=p.device)}
        if self._multi_precision:
            st["master"] = p.detach().float().clone()
        return st

    def _update_one(self, p, g, state, lr, step, extras=None):
        b1, b2 = self._beta1, self._beta2
        m = state["moment"]
        gf = g.to(m.dtype)
        update = torch.sign(b1 * m + (1 - b1) * gf)
        m_new = b2 * m + (1 - b2) * gf
        pf = state["master"] if self._multi_precision else p
        new_pf = pf - float(np.float32(lr)) * (update.to(pf.dtype)
                                               + self._wd * pf)
        new_state = {"moment": m_new}
        if self._multi_precision:
            new_state["master"] = new_pf
        return new_pf.to(p.dtype), new_state


class _NoMaster(Adam):
    """An Adam subclass with other arithmetic: no flat kind, and no
    ``multi_precision`` (the reference raises on it)."""

    _FUSED_KIND = None

    def __init__(self, *args, **kwargs):
        if kwargs.pop("multi_precision", False):
            raise NotImplementedError(
                f"{type(self).__name__}(multi_precision=True) is not "
                f"implemented")
        super().__init__(*args, **kwargs)


class Adamax(_NoMaster):
    """Adam with an infinity-norm second moment: ``u = max(b2 u, |g|)``,
    ``p -= lr / (1 - b1^t) m / (u + eps)``."""

    def _state_names(self):
        return ["moment", "inf_norm"]

    def _init_state(self, p):
        return {"moment": torch.zeros_like(p.detach()),
                "inf_norm": torch.zeros_like(p.detach())}

    def _update_one(self, p, g, state, lr, step, extras=None):
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        m = b1 * state["moment"] + (1 - b1) * g
        u = torch.maximum(b2 * state["inf_norm"], g.abs())
        rate = float(np.float32(lr) / np.float32(
            bias_corrections(b1, b2, step)[0]))
        return p - (rate * m / (u + eps)).to(p.dtype), {"moment": m,
                                                        "inf_norm": u}


class NAdam(_NoMaster):
    """Nesterov-momentum Adam with the momentum schedule ``mu_t = b1 (1 -
    0.96^(t psi) / 2)`` and its running product ``mu_product`` (a scalar
    on the parameter's device)."""

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, momentum_decay=0.004, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, name=name)
        self._psi = momentum_decay

    def _state_names(self):
        return ["moment1", "moment2", "mu_product"]

    def _init_state(self, p):
        return {"moment1": torch.zeros_like(p.detach()),
                "moment2": torch.zeros_like(p.detach()),
                "mu_product": torch.ones((), device=p.device)}

    def _update_one(self, p, g, state, lr, step, extras=None):
        b1, b2, eps, psi = self._beta1, self._beta2, self._epsilon, self._psi
        s = _f32(step)
        mu_t = (b1 * (1 - 0.5 * 0.96 ** (s * psi))).item()
        mu_t1 = (b1 * (1 - 0.5 * 0.96 ** ((s + 1) * psi))).item()
        mu_prod = state["mu_product"] * mu_t
        m = b1 * state["moment1"] + (1 - b1) * g
        v = b2 * state["moment2"] + (1 - b2) * g * g
        mhat = (mu_t1 * m / (1 - mu_prod * mu_t1)
                + (1 - mu_t) * g / (1 - mu_prod))
        vhat = v / bias_corrections(b1, b2, step)[1]
        upd = float(np.float32(lr)) * mhat / (vhat.sqrt() + eps)
        return p - upd.to(p.dtype), {"moment1": m, "moment2": v,
                                     "mu_product": mu_prod}


class RAdam(_NoMaster):
    """Rectified Adam: Adam's step times the rectification term while the
    variance estimate's length ``rho_t`` exceeds 5, else momentum SGD's
    ``lr m / (1 - b1^t)``."""

    def _state_names(self):
        return ["moment1", "moment2"]

    def _init_state(self, p):
        return {"moment1": torch.zeros_like(p.detach()),
                "moment2": torch.zeros_like(p.detach())}

    def _update_one(self, p, g, state, lr, step, extras=None):
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        s = _f32(step)
        m = b1 * state["moment1"] + (1 - b1) * g
        v = b2 * state["moment2"] + (1 - b2) * g * g
        bc1, bc2 = bias_corrections(b1, b2, step)
        mhat = m / bc1
        rho_inf = 2.0 / (1 - b2) - 1
        rho_t = rho_inf - 2.0 * s * b2 ** s / (1 - b2 ** s)
        lr32 = _f32(lr)
        if rho_t.item() > 5.0:
            r_num = (rho_t - 4) * (rho_t - 2) * rho_inf
            r_den = (rho_inf - 4) * (rho_inf - 2) * rho_t
            rect = torch.sqrt(torch.clamp(r_num, min=1e-12)
                              / torch.clamp(r_den, min=1e-12))
            vhat = (v / bc2).sqrt() + eps
            upd = (lr32 * rect).item() * mhat / vhat
        else:
            upd = lr32.item() * mhat
        return p - upd.to(p.dtype), {"moment1": m, "moment2": v}
