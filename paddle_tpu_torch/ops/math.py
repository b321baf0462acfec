"""Elementwise and matmul math ops (port of ``paddle_tpu/ops/math.py``).

Each op is a registered function over torch tensors with the reference's
signature; python scalars and numpy arrays are taken where the reference
takes them (``_coerce``: a scalar beside a tensor takes the tensor's dtype).
The matrix products stay ``torch.matmul``: they are plain products in the
reference too (``jnp.matmul``, outside any Pallas kernel), and nothing here
turns TF32 on, so fp32 stays fp32 on the card.

Where the reference's semantics and torch's defaults differ, the
reference's win: ``cumsum`` / ``cumprod`` flatten when no axis is given,
``cummax`` / ``cummin`` return the values only (over the last axis by
default), ``float_power`` keeps float32 for float32 inputs, ``outer``
flattens its inputs, and ``lerp`` is ``x + w * (y - x)``. ``gammainc`` /
``gammaincc`` differentiate with respect to ``y`` only: torch has no
derivative with respect to ``x`` (the JAX package differentiates both).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.tensor import inplace_set, to_tensor
from .dispatch import run_op
from .registry import register_op

__all__ = [
    "add", "subtract", "multiply", "divide", "floor_divide", "mod", "remainder",
    "pow", "float_power", "matmul", "mm", "bmm", "dot", "inner", "outer",
    "addmm", "neg", "abs", "sign", "exp", "expm1", "log", "log2", "log10",
    "log1p", "sqrt", "rsqrt", "square", "reciprocal", "sin", "cos", "tan",
    "asin", "acos", "atan", "atan2", "sinh", "cosh", "tanh", "asinh", "acosh",
    "atanh", "floor", "ceil", "round", "trunc", "frac", "clip", "maximum",
    "minimum", "fmax", "fmin", "erf", "erfinv", "lerp", "lgamma", "digamma",
    "gammaln", "gammainc", "gammaincc",
    "logit", "logaddexp", "logaddexp2", "exp2", "hypot", "nan_to_num",
    "deg2rad", "rad2deg",
    "cumsum", "cumprod", "cummax", "cummin", "diff", "trace", "kron",
    "isnan", "isinf", "isposinf", "isneginf", "isfinite", "scale", "stanh",
    "rsqrt_",
    "increment", "multiplex", "gcd", "lcm",
]


def _coerce(x, other=None):
    """A python scalar / ndarray as a tensor: with ``other``'s dtype and
    device when ``other`` is a tensor."""
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(other, torch.Tensor):
        return torch.as_tensor(np.asarray(x), device=other.device).to(
            other.dtype)
    return to_tensor(x)


def _float(a):
    """``a`` in a floating type (ints and bools promote to float32, as
    ``jnp``'s float functions do)."""
    return a if (a.is_floating_point() or a.is_complex()) else a.float()


def _binary(op_name, fn):
    def op(x, y, name=None):
        x = _coerce(x, y)
        y = _coerce(y, x)
        return run_op(op_name, fn, x, y)

    op.__name__ = op_name
    return register_op(op_name)(op)


def _unary(op_name, fn, differentiable=True):
    def op(x, name=None):
        return run_op(op_name, fn, _coerce(x))

    op.__name__ = op_name
    return register_op(op_name, differentiable=differentiable)(op)


def _float_power(a, b):
    out_t = torch.promote_types(_float(a).dtype, _float(b).dtype)
    return torch.float_power(a, b).to(out_t)


add = _binary("add", torch.add)
subtract = _binary("subtract", torch.subtract)
multiply = _binary("multiply", torch.multiply)
divide = _binary("divide", torch.true_divide)
# a step function: its gradient is 0 (torch defines none)
floor_divide = _binary("floor_divide", lambda a, b: torch.floor_divide(
    a.detach(), b.detach()))
mod = _binary("mod", torch.remainder)
remainder = mod
pow = _binary("pow", torch.pow)
float_power = _binary("float_power", _float_power)
maximum = _binary("maximum", torch.maximum)
minimum = _binary("minimum", torch.minimum)
fmax = _binary("fmax", torch.fmax)
fmin = _binary("fmin", torch.fmin)
atan2 = _binary("atan2", lambda a, b: torch.atan2(_float(a), _float(b)))
logaddexp = _binary("logaddexp",
                    lambda a, b: torch.logaddexp(_float(a), _float(b)))
logaddexp2 = _binary("logaddexp2",
                     lambda a, b: torch.logaddexp2(_float(a), _float(b)))
exp2 = _unary("exp2", lambda a: torch.exp2(_float(a)))
hypot = _binary("hypot", lambda a, b: torch.hypot(_float(a), _float(b)))
gcd = _binary("gcd", torch.gcd)
lcm = _binary("lcm", torch.lcm)

neg = _unary("neg", torch.neg)
abs = _unary("abs", torch.abs)
sign = _unary("sign", torch.sign)
exp = _unary("exp", lambda a: torch.exp(_float(a)))
expm1 = _unary("expm1", lambda a: torch.expm1(_float(a)))
log = _unary("log", lambda a: torch.log(_float(a)))
log2 = _unary("log2", lambda a: torch.log2(_float(a)))
log10 = _unary("log10", lambda a: torch.log10(_float(a)))
log1p = _unary("log1p", lambda a: torch.log1p(_float(a)))
sqrt = _unary("sqrt", lambda a: torch.sqrt(_float(a)))
rsqrt = _unary("rsqrt", lambda a: torch.rsqrt(_float(a)))
square = _unary("square", torch.square)
reciprocal = _unary("reciprocal", lambda a: torch.reciprocal(_float(a)))
sin = _unary("sin", lambda a: torch.sin(_float(a)))
cos = _unary("cos", lambda a: torch.cos(_float(a)))
tan = _unary("tan", lambda a: torch.tan(_float(a)))
asin = _unary("asin", lambda a: torch.asin(_float(a)))
acos = _unary("acos", lambda a: torch.acos(_float(a)))
atan = _unary("atan", lambda a: torch.atan(_float(a)))
sinh = _unary("sinh", lambda a: torch.sinh(_float(a)))
cosh = _unary("cosh", lambda a: torch.cosh(_float(a)))
tanh = _unary("tanh", lambda a: torch.tanh(_float(a)))
asinh = _unary("asinh", lambda a: torch.asinh(_float(a)))
acosh = _unary("acosh", lambda a: torch.acosh(_float(a)))
atanh = _unary("atanh", lambda a: torch.atanh(_float(a)))
floor = _unary("floor", torch.floor)
ceil = _unary("ceil", torch.ceil)
round = _unary("round", torch.round)
trunc = _unary("trunc", torch.trunc)
frac = _unary("frac", lambda a: a - torch.trunc(a))
erf = _unary("erf", lambda a: torch.erf(_float(a)))
erfinv = _unary("erfinv", lambda a: torch.erfinv(_float(a)))
lgamma = _unary("lgamma", lambda a: torch.lgamma(_float(a)))
digamma = _unary("digamma", lambda a: torch.digamma(_float(a)))
gammaln = _unary("gammaln", lambda a: torch.lgamma(_float(a)))
# regularized lower/upper incomplete gamma: paddle's (x, y) argument order
# is (a, x) of P(a, x)
gammainc = _binary("gammainc", lambda a, x: torch.special.gammainc(
    _float(a).detach(), _float(x)))
gammaincc = _binary("gammaincc", lambda a, x: torch.special.gammaincc(
    _float(a).detach(), _float(x)))
deg2rad = _unary("deg2rad", lambda a: torch.deg2rad(_float(a)))
rad2deg = _unary("rad2deg", lambda a: torch.rad2deg(_float(a)))
isnan = _unary("isnan", torch.isnan, differentiable=False)
isinf = _unary("isinf", torch.isinf, differentiable=False)
isposinf = _unary("isposinf", torch.isposinf, differentiable=False)
isneginf = _unary("isneginf", torch.isneginf, differentiable=False)
isfinite = _unary("isfinite", torch.isfinite, differentiable=False)
stanh = _unary("stanh", lambda a: 1.7159 * torch.tanh(_float(a) * 2.0 / 3.0))


@register_op()
def logit(x, eps=None, name=None):
    def f(a):
        b = torch.clamp(a, eps, 1 - eps) if eps else a
        return torch.log(b / (1 - b))

    return run_op("logit", f, _coerce(x))


@register_op()
def clip(x, min=None, max=None, name=None):
    lo = min.item() if isinstance(min, torch.Tensor) else min
    hi = max.item() if isinstance(max, torch.Tensor) else max
    if lo is None and hi is None:
        return run_op("clip", lambda a: a.clone(), _coerce(x))
    return run_op("clip", lambda a: torch.clamp(a, lo, hi), _coerce(x))


@register_op()
def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None, name=None):
    s = scale.item() if isinstance(scale, torch.Tensor) else scale

    def f(a):
        return a * s + bias if bias_after_scale else (a + bias) * s

    return run_op("scale", f, _coerce(x))


@register_op()
def lerp(x, y, weight, name=None):
    if isinstance(weight, torch.Tensor):
        return run_op("lerp", lambda a, b, w: a + w * (b - a), x, y, weight)
    return run_op("lerp", lambda a, b: a + weight * (b - a), x, y)


@register_op()
def nan_to_num(x, nan=0.0, posinf=None, neginf=None, name=None):
    return run_op("nan_to_num", lambda a: torch.nan_to_num(
        a, nan=nan, posinf=posinf, neginf=neginf), x)


# -- matmul family -----------------------------------------------------------

@register_op()
def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    def f(a, b):
        if transpose_x and a.ndim > 1:
            a = a.transpose(-1, -2)
        if transpose_y and b.ndim > 1:
            b = b.transpose(-1, -2)
        return torch.matmul(a, b)

    return run_op("matmul", f, x, y)


@register_op()
def mm(x, y, name=None):
    return run_op("mm", torch.matmul, x, y)


@register_op()
def bmm(x, y, name=None):
    return run_op("bmm", torch.bmm, x, y)


@register_op()
def dot(x, y, name=None):
    return run_op("dot", lambda a, b: torch.sum(a * b, dim=-1), x, y)


@register_op()
def inner(x, y, name=None):
    return run_op("inner", torch.inner, x, y)


@register_op()
def outer(x, y, name=None):
    return run_op("outer", lambda a, b: torch.outer(a.reshape(-1),
                                                    b.reshape(-1)), x, y)


@register_op()
def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):
    return run_op("addmm", lambda i, a, b: beta * i + alpha * torch.matmul(
        a, b), input, x, y)


@register_op()
def trace(x, offset=0, axis1=0, axis2=1, name=None):
    return run_op("trace", lambda a: torch.diagonal(
        a, offset, axis1, axis2).sum(-1), x)


@register_op()
def kron(x, y, name=None):
    return run_op("kron", torch.kron, x, y)


# -- scans -------------------------------------------------------------------

def _scan_axis(a, axis):
    return (a.reshape(-1), 0) if axis is None else (a, axis)


@register_op()
def cumsum(x, axis=None, dtype=None, name=None):
    return run_op("cumsum", lambda a: torch.cumsum(*_scan_axis(a, axis)), x)


@register_op()
def cumprod(x, dim=None, dtype=None, name=None):
    return run_op("cumprod", lambda a: torch.cumprod(*_scan_axis(a, dim)), x)


@register_op()
def cummax(x, axis=None, name=None):
    ax = -1 if axis is None else axis
    return run_op("cummax", lambda a: torch.cummax(a, ax).values, x)


@register_op()
def cummin(x, axis=None, name=None):
    ax = -1 if axis is None else axis
    return run_op("cummin", lambda a: torch.cummin(a, ax).values, x)


@register_op()
def diff(x, n=1, axis=-1, name=None):
    return run_op("diff", lambda a: torch.diff(a, n, axis), x)


@register_op()
def increment(x, value=1.0, name=None):
    return inplace_set(x, x.detach() + value)


@register_op()
def multiplex(inputs, index, name=None):
    stacked = torch.stack(list(inputs), dim=0)
    idx = index.reshape(-1).long()
    rows = torch.arange(stacked.shape[1], device=stacked.device)
    return stacked[idx, rows]


def rsqrt_(x):
    return inplace_set(x, torch.rsqrt(x.detach()))
