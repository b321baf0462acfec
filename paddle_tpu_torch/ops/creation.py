"""Tensor creation ops (port of ``paddle_tpu/ops/creation.py``).

Every op returns a port ``Tensor`` on the current device (the card unless
``set_device`` named the CPU; without a card the card raises) or, for the
``*_like`` and triangle ops, on its input's device. Integer results are
int64 where the reference's are int32 (it runs without 64-bit types). The
random ops draw from the generator of the device they run on
(``framework.random``), so ``seed`` makes them repeat; their bits are not
``jax.random``'s, and tests hold them by distribution.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from .. import device as _device
from ..core.dtype import convert_dtype
from ..core.tensor import Tensor, as_port_tensor, inplace_set, to_tensor
from .dispatch import run_op
from .registry import register_op

__all__ = [
    "zeros", "ones", "full", "empty", "zeros_like", "ones_like", "full_like",
    "empty_like", "arange", "linspace", "logspace", "eye", "diag", "diagflat",
    "tril", "triu", "meshgrid", "rand", "randn", "randint", "randperm",
    "uniform", "normal", "standard_normal", "bernoulli", "multinomial",
    "one_hot", "assign", "clone", "clone_",
]


def _shape(shape) -> tuple:
    if isinstance(shape, torch.Tensor):
        shape = shape.tolist()
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(int(s) for s in shape)


def _dt(dtype, default=torch.float32):
    return convert_dtype(dtype) if dtype is not None else default


def _dev() -> torch.device:
    return _device.resolve_device(_device.get_device())


def _scalar(v):
    return v.item() if isinstance(v, torch.Tensor) else v


def _gen(dev):
    from ..framework.random import generator

    return generator(dev)


@register_op()
def zeros(shape, dtype=None, name=None) -> Tensor:
    return as_port_tensor(torch.zeros(_shape(shape), dtype=_dt(dtype),
                                      device=_dev()))


@register_op()
def ones(shape, dtype=None, name=None) -> Tensor:
    return as_port_tensor(torch.ones(_shape(shape), dtype=_dt(dtype),
                                     device=_dev()))


def _fill_dtype(fill_value):
    if isinstance(fill_value, (bool, np.bool_)):
        return torch.bool
    if isinstance(fill_value, (int, np.integer)):
        return torch.int64
    if isinstance(fill_value, complex):
        return torch.complex64
    return torch.float32


@register_op()
def full(shape, fill_value, dtype=None, name=None) -> Tensor:
    fill_value = _scalar(fill_value)
    dt = _dt(dtype, _fill_dtype(fill_value))
    return as_port_tensor(torch.full(_shape(shape), fill_value, dtype=dt,
                                     device=_dev()))


@register_op()
def empty(shape, dtype=None, name=None) -> Tensor:
    return zeros(shape, dtype)


@register_op()
def zeros_like(x, dtype=None, name=None) -> Tensor:
    return as_port_tensor(torch.zeros_like(x, dtype=_dt(dtype, x.dtype)))


@register_op()
def ones_like(x, dtype=None, name=None) -> Tensor:
    return as_port_tensor(torch.ones_like(x, dtype=_dt(dtype, x.dtype)))


@register_op()
def full_like(x, fill_value, dtype=None, name=None) -> Tensor:
    return as_port_tensor(torch.full_like(x, _scalar(fill_value),
                                          dtype=_dt(dtype, x.dtype)))


@register_op()
def empty_like(x, dtype=None, name=None) -> Tensor:
    return zeros_like(x, dtype)


@register_op()
def arange(start=0, end=None, step=1, dtype=None, name=None) -> Tensor:
    start, end, step = _scalar(start), _scalar(end), _scalar(step)
    if end is None:
        start, end = 0, start
    if dtype is None and any(isinstance(v, float) for v in (start, end, step)):
        dtype = "float32"
    return as_port_tensor(torch.arange(start, end, step,
                                       dtype=_dt(dtype, torch.int64),
                                       device=_dev()))


@register_op()
def linspace(start, stop, num, dtype=None, name=None) -> Tensor:
    return as_port_tensor(torch.linspace(
        _scalar(start), _scalar(stop), int(_scalar(num)), dtype=_dt(dtype),
        device=_dev()))


@register_op()
def logspace(start, stop, num, base=10.0, dtype=None, name=None) -> Tensor:
    return as_port_tensor(torch.logspace(
        _scalar(start), _scalar(stop), int(_scalar(num)), base=base,
        dtype=_dt(dtype), device=_dev()))


@register_op()
def eye(num_rows, num_columns=None, dtype=None, name=None) -> Tensor:
    cols = num_rows if num_columns is None else num_columns
    return as_port_tensor(torch.eye(int(num_rows), int(cols),
                                    dtype=_dt(dtype), device=_dev()))


@register_op()
def diag(x, offset=0, padding_value=0, name=None) -> Tensor:
    def f(a):
        d = torch.diag(a, offset)
        if a.ndim == 1 and padding_value != 0:
            mask = torch.ones(d.shape, dtype=torch.bool,
                              device=d.device).diagonal(offset)
            eye = torch.zeros(d.shape, dtype=torch.bool, device=d.device)
            eye.diagonal(offset).copy_(mask)
            d = torch.where(eye, d, torch.as_tensor(padding_value,
                                                    dtype=d.dtype,
                                                    device=d.device))
        return d

    return run_op("diag", f, x)


@register_op()
def diagflat(x, offset=0, name=None) -> Tensor:
    return run_op("diagflat", lambda a: torch.diagflat(a, offset), x)


@register_op()
def tril(x, diagonal=0, name=None) -> Tensor:
    return run_op("tril", lambda a: torch.tril(a, diagonal), x)


@register_op()
def triu(x, diagonal=0, name=None) -> Tensor:
    return run_op("triu", lambda a: torch.triu(a, diagonal), x)


@register_op()
def meshgrid(*args, name=None) -> List[Tensor]:
    if len(args) == 1 and isinstance(args[0], (list, tuple)):
        args = args[0]
    return list(torch.meshgrid(*args, indexing="ij"))


# -- random ------------------------------------------------------------------

@register_op(differentiable=False)
def rand(shape, dtype=None, name=None) -> Tensor:
    dev = _dev()
    return as_port_tensor(torch.rand(_shape(shape), dtype=_dt(dtype),
                                     device=dev, generator=_gen(dev)))


@register_op(differentiable=False)
def randn(shape, dtype=None, name=None) -> Tensor:
    dev = _dev()
    return as_port_tensor(torch.randn(_shape(shape), dtype=_dt(dtype),
                                      device=dev, generator=_gen(dev)))


standard_normal = randn


@register_op(differentiable=False)
def randint(low=0, high=None, shape=(1,), dtype=None, name=None) -> Tensor:
    if high is None:
        low, high = 0, low
    dev = _dev()
    return as_port_tensor(torch.randint(
        int(low), int(high), _shape(shape), dtype=_dt(dtype, torch.int64),
        device=dev, generator=_gen(dev)))


@register_op(differentiable=False)
def randperm(n, dtype=None, name=None) -> Tensor:
    dev = _dev()
    return as_port_tensor(torch.randperm(
        int(n), dtype=_dt(dtype, torch.int64), device=dev,
        generator=_gen(dev)))


@register_op(differentiable=False)
def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0,
            name=None) -> Tensor:
    dev = _dev()
    gen = (torch.Generator(device=dev).manual_seed(int(seed)) if seed
           else _gen(dev))
    out = torch.empty(_shape(shape), dtype=_dt(dtype), device=dev)
    return as_port_tensor(out.uniform_(float(min), float(max),
                                       generator=gen))


@register_op(differentiable=False)
def normal(mean=0.0, std=1.0, shape=None, name=None) -> Tensor:
    if isinstance(mean, torch.Tensor) or isinstance(std, torch.Tensor):
        ref = mean if isinstance(mean, torch.Tensor) else std
        m = torch.as_tensor(mean, dtype=torch.float32, device=ref.device)
        s = torch.as_tensor(std, dtype=torch.float32, device=ref.device)
        shp = torch.broadcast_shapes(m.shape, s.shape)
        z = torch.randn(shp, device=ref.device, generator=_gen(ref.device))
        return as_port_tensor(z * s + m)
    dev = _dev()
    z = torch.randn(_shape(shape or (1,)), device=dev, generator=_gen(dev))
    return as_port_tensor(z * std + mean)


@register_op(differentiable=False)
def bernoulli(x, name=None) -> Tensor:
    return as_port_tensor(torch.bernoulli(x.detach(),
                                          generator=_gen(x.device)))


@register_op(differentiable=False)
def multinomial(x, num_samples=1, replacement=False, name=None) -> Tensor:
    p = torch.clamp(x.detach().float(), min=1e-30)
    return as_port_tensor(torch.multinomial(p, int(num_samples),
                                            replacement=replacement,
                                            generator=_gen(x.device)))


@register_op(differentiable=False)
def one_hot(x, num_classes, name=None) -> Tensor:
    """fp32 one-hot rows (``nn.functional.one_hot``: one implementation)."""
    from ..nn.functional import one_hot as _one_hot

    return _one_hot(x, num_classes)


@register_op()
def assign(x, output=None, name=None) -> Tensor:
    if isinstance(x, torch.Tensor):
        val = x.detach()
    else:
        val = to_tensor(x)
    if output is not None:
        return inplace_set(output, val.to(output.device))
    return to_tensor(val, place=val.device)


def clone(x, name=None) -> Tensor:
    """Differentiable copy (reference: ``paddle.clone``)."""
    return x.clone()


def clone_(x) -> Tensor:
    return x.clone()
