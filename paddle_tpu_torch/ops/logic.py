"""Comparison and logical ops (port of ``paddle_tpu/ops/logic.py``)."""

from __future__ import annotations

import torch

from ..core.tensor import to_tensor
from .dispatch import run_op
from .math import _coerce
from .registry import register_op

__all__ = [
    "equal", "not_equal", "greater_than", "greater_equal", "less_than",
    "less_equal", "logical_and", "logical_or", "logical_not", "logical_xor",
    "bitwise_and", "bitwise_or", "bitwise_not", "bitwise_xor", "isclose",
    "allclose", "equal_all", "is_empty", "is_tensor",
]


def _cmp(op_name, fn):
    def op(x, y, name=None):
        x = _coerce(x, y)
        y = _coerce(y, x)
        return run_op(op_name, fn, x, y)

    op.__name__ = op_name
    return register_op(op_name, differentiable=False)(op)


equal = _cmp("equal", torch.eq)
not_equal = _cmp("not_equal", torch.ne)
greater_than = _cmp("greater_than", torch.gt)
greater_equal = _cmp("greater_equal", torch.ge)
less_than = _cmp("less_than", torch.lt)
less_equal = _cmp("less_equal", torch.le)
logical_and = _cmp("logical_and", torch.logical_and)
logical_or = _cmp("logical_or", torch.logical_or)
logical_xor = _cmp("logical_xor", torch.logical_xor)
bitwise_and = _cmp("bitwise_and", torch.bitwise_and)
bitwise_or = _cmp("bitwise_or", torch.bitwise_or)
bitwise_xor = _cmp("bitwise_xor", torch.bitwise_xor)


@register_op(differentiable=False)
def logical_not(x, name=None):
    return run_op("logical_not", torch.logical_not, _coerce(x))


@register_op(differentiable=False)
def bitwise_not(x, name=None):
    return run_op("bitwise_not", torch.bitwise_not, _coerce(x))


@register_op(differentiable=False)
def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    x = _coerce(x, y)
    y = _coerce(y, x)
    return run_op("isclose", lambda a, b: torch.isclose(
        a, b.to(a.dtype), rtol=rtol, atol=atol, equal_nan=equal_nan), x, y)


@register_op(differentiable=False)
def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    x = _coerce(x, y)
    y = _coerce(y, x)
    return run_op("allclose", lambda a, b: torch.isclose(
        a, b.to(a.dtype), rtol=rtol, atol=atol, equal_nan=equal_nan).all(),
        x, y)


@register_op(differentiable=False)
def equal_all(x, y, name=None):
    def f(a, b):
        if a.shape != b.shape:
            return torch.zeros((), dtype=torch.bool, device=a.device)
        return torch.eq(a, b).all()

    return run_op("equal_all", f, x, y)


def is_empty(x, name=None):
    return to_tensor(x.numel() == 0, place=x.device)


def is_tensor(x):
    return isinstance(x, torch.Tensor)
