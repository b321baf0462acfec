"""Long-tail tensor ops completing the corpus (port of
``paddle_tpu/ops/tail.py``)."""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.tensor import to_tensor
from ..enforce import InvalidArgumentError
from .dispatch import run_op
from .math import _binary as _math_binary
from .manipulation import _wrapped
from .math import _float, _sign
from .math import _unary as _u
from .registry import OPS as _OPS
from .registry import register_op

__all__ = [
    "vander", "frexp", "ldexp", "copysign", "nextafter", "heaviside",
    "trapezoid", "cumulative_trapezoid", "logcumsumexp", "index_fill",
    "masked_scatter", "diag_embed", "take", "select_scatter",
    "diagonal_scatter", "unfold",
    "slice_scatter", "column_stack", "row_stack", "dstack", "hstack",
    "vstack", "tensor_split", "as_strided", "nanquantile", "msort",
    "aminmax", "positive", "negative", "signbit", "sinc", "fix", "sgn",
    "conj", "real", "imag", "angle", "polar", "complex", "is_complex",
    "is_integer", "isreal", "bitwise_left_shift", "bitwise_right_shift",
    "bitwise_invert", "is_floating_point", "shard_index",
    "triu_indices", "tril_indices",
]


def _b(name, fn, differentiable=True):
    op = _math_binary(name, fn)
    if not differentiable:
        _OPS[name].differentiable = False
    return op


def _ldexp(a, b):
    # two half-sized exp2 factors keep every representable result finite
    # (a * 2**b with |b| >= 128 overflows float32 in one step)
    b = b.to(torch.int32)
    f = _float(a)
    h = torch.div(b, 2, rounding_mode="floor")
    return f * torch.exp2(h.to(f.dtype)) * torch.exp2((b - h).to(f.dtype))


def _heaviside(a, b):
    one = torch.ones((), dtype=a.dtype, device=a.device)
    zero = torch.zeros((), dtype=a.dtype, device=a.device)
    out = torch.where(a > 0, one, torch.where(a < 0, zero, b.to(a.dtype)))
    return torch.where(torch.isnan(a), torch.nan, out).to(a.dtype)


positive = _u("positive", lambda a: a.clone())
negative = _u("negative", torch.neg)
signbit = _u("signbit", torch.signbit, differentiable=False)
sinc = _u("sinc", lambda a: torch.sinc(_float(a)))
fix = _u("fix", torch.trunc)
msort = _u("msort", lambda a: torch.sort(a, dim=0, stable=True).values)
conj = _u("conj", lambda a: torch.conj(a).resolve_conj())
real = _u("real", lambda a: torch.real(a).clone() if a.is_complex() else a)
imag = _u("imag", lambda a: torch.imag(a) if a.is_complex()
          else torch.zeros_like(a))
angle = _u("angle", lambda a: torch.angle(a) if a.is_complex() else
           torch.where(torch.signbit(a) & (a == 0), math.pi, torch.angle(a)))

copysign = _b("copysign", lambda a, b: torch.copysign(_float(a), b))
nextafter = _b("nextafter", lambda a, b: torch.nextafter(a, b.to(a.dtype)),
               differentiable=False)
heaviside = _b("heaviside", _heaviside)
ldexp = _b("ldexp", _ldexp)
bitwise_left_shift = _b("bitwise_left_shift", torch.bitwise_left_shift,
                        differentiable=False)
bitwise_right_shift = _b("bitwise_right_shift", torch.bitwise_right_shift,
                         differentiable=False)
polar = _b("polar", lambda r, t: torch.complex(r * torch.cos(t),
                                               r * torch.sin(t)))
complex = _b("complex", lambda r, i: torch.complex(
    *torch.broadcast_tensors(_float(r), _float(i))))


@register_op(differentiable=False)
def is_floating_point(x, name=None) -> bool:
    return bool(x.is_floating_point())


def bitwise_invert(x, name=None):
    """Alias of bitwise_not (reference paddle.bitwise_invert)."""
    from .logic import bitwise_not

    return bitwise_not(x)


@register_op(differentiable=False)
def shard_index(input, index_num, nshards, shard_id, ignore_value=-1,
                name=None):
    """Map global ids to shard-local ids: ids inside this shard's
    ``[shard_id * size, (shard_id + 1) * size)`` become ``id - base``,
    every other id ``ignore_value``; ``size = ceil(index_num / nshards)``."""
    if not (0 <= shard_id < nshards):
        raise InvalidArgumentError(
            f"shard_id {shard_id} out of range for nshards {nshards}")
    size = (index_num + nshards - 1) // nshards
    base = shard_id * size

    def f(a):
        inside = (a >= base) & (a < base + size)
        return torch.where(inside, a - base, torch.as_tensor(
            ignore_value, dtype=a.dtype, device=a.device))

    return run_op("shard_index", f, input)


def _indices(fn, row, col, offset, dtype):
    col = row if col is None else col
    r, c = fn(row, k=offset, m=col)
    return to_tensor(np.stack([r, c]).astype(np.dtype(dtype)))


@register_op(differentiable=False)
def triu_indices(row, col=None, offset=0, dtype="int64", name=None):
    """[2, n] indices of the upper triangle."""
    return _indices(np.triu_indices, row, col, offset, dtype)


@register_op(differentiable=False)
def tril_indices(row, col=None, offset=0, dtype="int64", name=None):
    """[2, n] indices of the lower triangle."""
    return _indices(np.tril_indices, row, col, offset, dtype)


@register_op("sgn")
def sgn(x, name=None):
    """sign for real, unit phasor for complex."""
    return run_op("sgn", _sign, x)


@register_op(differentiable=False)
def is_complex(x, name=None) -> bool:
    return bool(x.is_complex())


@register_op(differentiable=False)
def is_integer(x, name=None) -> bool:
    return not (x.is_floating_point() or x.is_complex()
                or x.dtype == torch.bool)


@register_op("isreal", differentiable=False)
def isreal(x, name=None):
    return run_op("isreal", torch.isreal, x)


@register_op(differentiable=False)
def frexp(x, name=None):
    return run_op("frexp", lambda a: tuple(torch.frexp(_float(a).detach())),
                  x)


@register_op(differentiable=False)
def vander(x, n=None, increasing=False, name=None):
    return run_op("vander", lambda a: torch.vander(a, N=n,
                                                   increasing=increasing), x)


@register_op()
def trapezoid(y, x=None, dx=None, axis=-1, name=None):
    if x is not None:
        return run_op("trapezoid", lambda yy, xx: torch.trapezoid(
            yy, xx, dim=axis), y, x)
    spacing = 1.0 if dx is None else dx
    return run_op("trapezoid", lambda yy: torch.trapezoid(
        yy, dx=spacing, dim=axis), y)


@register_op()
def cumulative_trapezoid(y, x=None, dx=None, axis=-1, name=None):
    def f(yy, *maybe_x):
        yy_m = yy.movedim(axis, -1)
        if maybe_x:
            d = torch.diff(maybe_x[0].movedim(axis, -1), dim=-1)
        else:
            d = 1.0 if dx is None else dx
        avg = (yy_m[..., 1:] + yy_m[..., :-1]) / 2.0
        return torch.cumsum(avg * d, dim=-1).movedim(-1, axis)

    args = (y,) if x is None else (y, x)
    return run_op("cumulative_trapezoid", f, *args)


@register_op()
def logcumsumexp(x, axis=None, name=None):
    def f(a):
        if axis is None:
            return torch.logcumsumexp(_float(a).reshape(-1), 0)
        return torch.logcumsumexp(_float(a), axis)

    return run_op("logcumsumexp", f, x)


@register_op()
def index_fill(x, index, axis, value, name=None):
    iv = index if isinstance(index, torch.Tensor) else torch.as_tensor(index)

    def f(a):
        i = iv.to(a.device).long().reshape(-1)
        i = torch.where(i < 0, i + a.shape[axis], i)
        return torch.index_fill(a, axis, i, value)

    return run_op("index_fill", f, x)


@register_op()
def masked_scatter(x, mask, value, name=None):
    """True positions of ``mask`` filled with consecutive elements of
    ``value``."""
    need = int(mask.sum())
    if value.numel() < need:
        raise InvalidArgumentError(
            f"masked_scatter: value has {value.numel()} elements but mask "
            f"selects {need}")

    def f(a, m, v):
        return torch.masked_scatter(a, m.bool().expand(a.shape),
                                    v.to(a.dtype))

    return run_op("masked_scatter", f, x, mask, value)


@register_op()
def diag_embed(x, offset=0, dim1=-2, dim2=-1, name=None):
    return run_op("diag_embed", lambda a: torch.diag_embed(
        a, offset, dim1, dim2), x)


@register_op()
def take(x, index, mode="raise", name=None):
    n = x.numel()
    iv = index if isinstance(index, torch.Tensor) else torch.as_tensor(index)
    iv = iv.to(x.device).long()
    if mode == "raise" and iv.numel() and bool(
            (iv.min() < -n) | (iv.max() >= n)):
        raise InvalidArgumentError(
            f"take: index out of range for tensor of {n} elements")

    def f(a):
        if mode == "wrap":
            idx = torch.remainder(iv, n)
        else:  # "raise" and "clip": python-style negatives, then clip
            idx = _wrapped(iv, n).clamp(0, n - 1)
        return torch.take(a, idx)

    return run_op("take", f, x)


@register_op()
def select_scatter(x, values, axis, index, name=None):
    return run_op("select_scatter", lambda a, v: torch.select_scatter(
        a, v.to(a.dtype), axis, index), x, values)


@register_op()
def diagonal_scatter(x, y, offset=0, axis1=0, axis2=1, name=None):
    """``y`` written onto the (offset) diagonal of the (axis1, axis2)
    planes; ``y``'s diagonal axis is last (``paddle.diagonal``'s layout)."""
    return run_op("diagonal_scatter", lambda a, v: torch.diagonal_scatter(
        a, v.to(a.dtype), offset, axis1, axis2), x, y)


@register_op()
def unfold(x, axis, size, step, name=None):
    """Sliding windows along ``axis``: ``(n - size) // step + 1`` windows
    at ``axis``, the window's elements on a new last axis."""
    def f(a):
        ax = axis % a.ndim
        if size > a.shape[ax]:
            raise ValueError(
                f"unfold size {size} exceeds dim {ax} length {a.shape[ax]}")
        return a.unfold(ax, size, step)

    return run_op("unfold", f, x)


@register_op()
def slice_scatter(x, value, axes, starts, ends, strides, name=None):
    def f(a, v):
        idx = [slice(None)] * a.ndim
        for ax, st, en, sr in zip(axes, starts, ends, strides):
            idx[ax] = slice(st, en, sr)
        out = a.clone()
        out[tuple(idx)] = v.to(a.dtype)
        return out

    return run_op("slice_scatter", f, x, value)


def _stack_family(name, tfn):
    def op(x, name_=None):
        return run_op(name, lambda *vs: tfn(list(vs)),
                      *[t if isinstance(t, torch.Tensor) else to_tensor(t)
                        for t in x])

    op.__name__ = name
    return register_op(name)(op)


column_stack = _stack_family("column_stack", torch.column_stack)
row_stack = _stack_family("row_stack", torch.vstack)
dstack = _stack_family("dstack", torch.dstack)
hstack = _stack_family("hstack", torch.hstack)
vstack = _stack_family("vstack", torch.vstack)


@register_op()
def tensor_split(x, num_or_indices, axis=0, name=None):
    return run_op("tensor_split", lambda a: tuple(torch.tensor_split(
        a, num_or_indices if isinstance(num_or_indices, int)
        else list(num_or_indices), dim=axis)), x)


@register_op()
def as_strided(x, shape, stride, offset=0, name=None):
    """A strided view, materialised by a gather of the flat elements."""
    def f(a):
        idx = torch.full(tuple(shape), offset, dtype=torch.long,
                         device=a.device)
        for dim, (s, st) in enumerate(zip(shape, stride)):
            r = torch.arange(s, device=a.device) * st
            idx = idx + r.reshape((1,) * dim + (s,)
                                  + (1,) * (len(shape) - dim - 1))
        return torch.take(a.reshape(-1), idx)

    return run_op("as_strided", f, x)


@register_op()
def nanquantile(x, q, axis=None, keepdim=False, name=None):
    from .reduction import _quantile

    return run_op("nanquantile", lambda a: _quantile(a, q, axis, keepdim,
                                                     True), x)


@register_op()
def aminmax(x, axis=None, keepdim=False, name=None):
    from .reduction import _red

    return run_op("aminmax", lambda a: (_red(torch.amin, a, axis, keepdim),
                                        _red(torch.amax, a, axis, keepdim)),
                  x)
