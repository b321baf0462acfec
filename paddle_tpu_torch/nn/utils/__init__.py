"""``nn.utils`` (counterpart of ``paddle_tpu/nn/utils/__init__.py``):
gradient clipping in place, parameters to and from one vector, and the
weight and spectral norm reparametrizations.

``weight_norm`` and ``spectral_norm`` replace a layer's parameter by
auxiliary ones (``<name>_g`` and ``<name>_v``, or ``<name>_orig``, added
after the layer's other parameters, as in the reference) and recompute the
weight in a forward pre-hook at every call, and once when they are
applied. ``spectral_norm`` seeds its power-iteration vectors ``u`` and
``v`` from ``np.random.RandomState(0)``; each call's weight divides by the
sigma of the vectors from before the call, then one power iteration
refreshes them outside autograd.
"""

from __future__ import annotations

import numpy as np
import torch

from ..layer.layers import Parameter

__all__ = ["clip_grad_norm_", "clip_grad_value_", "parameters_to_vector",
           "vector_to_parameters", "weight_norm", "remove_weight_norm",
           "spectral_norm"]


def _as_list(parameters):
    return (list(parameters) if isinstance(parameters, (list, tuple))
            else [parameters])


@torch.no_grad()
def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    """Scale the gradients by ``min(max_norm / (norm + 1e-6), 1)``, the
    norm over all of them (the largest magnitude at ``inf``); returns the
    norm."""
    params = [p for p in _as_list(parameters) if p.grad is not None]
    if not params:
        return torch.tensor(0.0)
    if norm_type == float("inf"):
        total = torch.stack([p.grad.abs().max() for p in params]).max()
    else:
        total = torch.stack([(p.grad.abs() ** norm_type).sum()
                             for p in params]).sum() ** (1.0 / norm_type)
    coef = torch.clamp(max_norm / (total + 1e-6), max=1.0)
    for p in params:
        p.grad.mul_(coef.to(p.grad.dtype))
    return total


@torch.no_grad()
def clip_grad_value_(parameters, clip_value):
    for p in _as_list(parameters):
        if p.grad is not None:
            p.grad.clamp_(-clip_value, clip_value)


def parameters_to_vector(parameters, name=None):
    return torch.cat([p.detach().reshape(-1) for p in parameters])


@torch.no_grad()
def vector_to_parameters(vec, parameters, name=None):
    offset = 0
    for p in parameters:
        n = p.numel()
        p.copy_(vec[offset:offset + n].reshape(p.shape))
        offset += n


def _parameter(value, name):
    p = Parameter(value.detach().clone(), requires_grad=True)
    p.name = name
    return p


def _norm_except_dim(v, dim):
    axes = tuple(i for i in range(v.dim()) if i != dim % v.dim())
    return torch.sqrt(torch.sum(v * v, dim=axes, keepdim=True))


def weight_norm(layer, name: str = "weight", dim: int = 0):
    """``w = g * v / ||v||``, the norm over every axis but ``dim``."""
    w = getattr(layer, name)
    dim = dim % w.dim()
    weight_g = layer.add_parameter(f"{name}_g", _parameter(
        _norm_except_dim(w.detach(), dim), f"{name}_g"))
    weight_v = layer.add_parameter(f"{name}_v", _parameter(w, f"{name}_v"))
    del layer._parameters[name]

    def recompute(lyr, inputs):
        object.__setattr__(lyr, name, weight_g * weight_v / torch.clamp(
            _norm_except_dim(weight_v, dim), min=1e-12))

    layer._weight_norm_hook = layer.register_forward_pre_hook(recompute)
    recompute(layer, None)
    return layer


def remove_weight_norm(layer, name: str = "weight"):
    """Fold the current weight back into a parameter ``name`` and drop
    ``<name>_g`` and ``<name>_v``."""
    if hasattr(layer, "_weight_norm_hook"):
        layer._weight_norm_hook.remove()
        del layer._weight_norm_hook
    w = getattr(layer, name)
    layer.__dict__.pop(name, None)
    layer.add_parameter(name, _parameter(w, name))
    for aux in (f"{name}_g", f"{name}_v"):
        layer._parameters.pop(aux, None)
    return layer


def spectral_norm(layer, name: str = "weight", n_power_iterations: int = 1,
                  eps: float = 1e-12, dim: int = 0):
    """``w = w / sigma_max(w)`` by power iteration on ``w`` as a ``[w.shape
    [dim], -1]`` matrix."""
    w = getattr(layer, name)
    dim = dim % w.dim()

    def matrix(wv):
        return wv.movedim(dim, 0).reshape(wv.shape[dim], -1)

    rows, cols = matrix(w).shape
    rng = np.random.RandomState(0)
    state = {"u": torch.tensor(rng.randn(rows), dtype=torch.float32,
                               device=w.device),
             "v": torch.tensor(rng.randn(cols), dtype=torch.float32,
                               device=w.device)}
    weight_orig = layer.add_parameter(f"{name}_orig",
                                      _parameter(w, f"{name}_orig"))
    del layer._parameters[name]

    def normalized(t):
        return t / torch.clamp(torch.linalg.norm(t), min=eps)

    def recompute(lyr, inputs):
        m = matrix(weight_orig)
        uu, vv = state["u"], state["v"]
        for _ in range(n_power_iterations):
            vv = normalized(m.t() @ uu)
            uu = normalized(m @ vv)
        sigma = uu @ (m @ vv)
        new_w = weight_orig / torch.clamp(sigma, min=eps)
        with torch.no_grad():
            md = m.detach()
            vv = normalized(md.t() @ state["u"])
            state["u"], state["v"] = normalized(md @ vv), vv
        object.__setattr__(lyr, name, new_w)

    layer._spectral_norm_hook = layer.register_forward_pre_hook(recompute)
    recompute(layer, None)
    return layer
