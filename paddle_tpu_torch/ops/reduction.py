"""Reduction ops (port of ``paddle_tpu/ops/reduction.py``).

``axis`` takes an int, a list or a tuple (``None`` reduces every axis).
The reference's semantics, where torch's defaults differ:

* ``max`` / ``min`` return the values only (``torch.amax``: the gradient of
  tied maxima is split evenly, as ``jnp.max``'s);
* ``median`` averages the two middle values (``torch.median`` returns the
  lower one), and so do ``nanmedian`` (over the values that are not NaN) and
  ``quantile`` (linear interpolation); a NaN makes ``median`` / ``quantile``
  NaN;
* ``mode`` takes the first-occurring value among the most frequent ones,
  and the first index of that value;
* ``kthvalue`` takes the k-th of a stable ascending sort;
* ``mean``, ``median`` and ``quantile`` of integers compute in float32.
"""

from __future__ import annotations

import torch

from .dispatch import run_op
from .math import _float
from .registry import register_op

__all__ = [
    "sum", "mean", "max", "min", "amax", "amin", "prod", "std", "var",
    "argmax", "argmin", "all", "any", "count_nonzero", "logsumexp", "median",
    "nanmedian", "nansum", "nanmean", "norm", "quantile", "mode", "kthvalue",
]


def _axis(axis):
    if isinstance(axis, torch.Tensor):
        axis = axis.tolist()
    if isinstance(axis, list):
        axis = tuple(axis)
    return axis


def _dims(a, axis):
    """``axis`` as a tuple of dims (every dim for ``None``)."""
    ax = _axis(axis)
    if ax is None:
        return tuple(range(a.ndim))
    return (ax,) if isinstance(ax, int) else tuple(ax)


def _keep_all(out, a, axis, keepdim):
    """A full reduction's result shaped as ``keepdims=True`` gives it."""
    if keepdim and _axis(axis) is None:
        return out.reshape((1,) * a.ndim)
    return out


def _red(fn, a, axis, keepdim):
    return fn(a, dim=_dims(a, axis), keepdim=keepdim)


@register_op()
def sum(x, axis=None, dtype=None, keepdim=False, name=None):
    return run_op("sum", lambda a: _red(torch.sum, a, axis, keepdim), x)


@register_op()
def mean(x, axis=None, keepdim=False, name=None):
    return run_op("mean", lambda a: _red(torch.mean, _float(a), axis,
                                         keepdim), x)


@register_op()
def max(x, axis=None, keepdim=False, name=None):
    return run_op("max", lambda a: _red(torch.amax, a, axis, keepdim), x)


@register_op()
def min(x, axis=None, keepdim=False, name=None):
    return run_op("min", lambda a: _red(torch.amin, a, axis, keepdim), x)


amax = max
amin = min


@register_op()
def prod(x, axis=None, keepdim=False, dtype=None, name=None):
    def f(a):
        if _axis(axis) is None:
            return _keep_all(torch.prod(a), a, axis, keepdim)
        out = a
        for d in sorted((d % a.ndim for d in _dims(a, axis)), reverse=True):
            out = torch.prod(out, d, keepdim=keepdim)
        return out

    return run_op("prod", f, x)


@register_op()
def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    ddof = 1 if unbiased else 0
    return run_op("std", lambda a: torch.std(
        _float(a), dim=_dims(a, axis), correction=ddof, keepdim=keepdim), x)


@register_op()
def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    ddof = 1 if unbiased else 0
    return run_op("var", lambda a: torch.var(
        _float(a), dim=_dims(a, axis), correction=ddof, keepdim=keepdim), x)


@register_op(differentiable=False)
def argmax(x, axis=None, keepdim=False, dtype="int64", name=None):
    ax = _axis(axis)
    return run_op("argmax", lambda a: torch.argmax(
        a, dim=ax, keepdim=keepdim if ax is not None else False), x)


@register_op(differentiable=False)
def argmin(x, axis=None, keepdim=False, dtype="int64", name=None):
    ax = _axis(axis)
    return run_op("argmin", lambda a: torch.argmin(
        a, dim=ax, keepdim=keepdim if ax is not None else False), x)


@register_op(differentiable=False)
def all(x, axis=None, keepdim=False, name=None):
    return run_op("all", lambda a: _red(torch.all, a.bool(), axis, keepdim),
                  x)


@register_op(differentiable=False)
def any(x, axis=None, keepdim=False, name=None):
    return run_op("any", lambda a: _red(torch.any, a.bool(), axis, keepdim),
                  x)


@register_op(differentiable=False)
def count_nonzero(x, axis=None, keepdim=False, name=None):
    return run_op("count_nonzero", lambda a: _red(
        torch.sum, (a != 0).long(), axis, keepdim), x)


@register_op()
def logsumexp(x, axis=None, keepdim=False, name=None):
    return run_op("logsumexp", lambda a: torch.logsumexp(
        _float(a), _dims(a, axis), keepdim=keepdim), x)


def _along_last(a, axis):
    """``a`` with the reduced axis last (flattened when ``axis`` is None),
    and that axis' index in ``a``."""
    ax = _axis(axis)
    if ax is None:
        return a.reshape(-1), None
    if isinstance(ax, tuple):
        if len(ax) != 1:
            raise ValueError("median/quantile take one axis or None")
        ax = ax[0]
    ax = ax % a.ndim
    return a.movedim(ax, -1), ax


def _restore(out, a, ax, keepdim):
    """A last-axis reduction's result put back as ``keepdims`` wants it."""
    if not keepdim:
        return out
    if ax is None:
        return out.reshape((1,) * a.ndim)
    return out.unsqueeze(ax)


def _interp(s, cnt, q):
    """Linear-interpolated quantiles ``q`` (1-D) of the last axis of the
    sorted ``s`` over its first ``cnt`` entries (``jnp.quantile``'s
    arithmetic): leading axis over ``q``."""
    pos = q.reshape((-1,) + (1,) * s.ndim) * (cnt - 1).to(s.dtype)
    low = torch.floor(pos)
    high = torch.ceil(pos)
    w_high = pos - low
    w_low = 1 - w_high
    n = s.shape[-1]
    lo_i = low.long().clamp(0, n - 1)
    hi_i = high.long().clamp(0, n - 1)
    sb = s.expand((q.numel(),) + s.shape)
    lo_v = torch.gather(sb, -1, lo_i.expand(sb.shape[:-1] + (1,)))[..., 0]
    hi_v = torch.gather(sb, -1, hi_i.expand(sb.shape[:-1] + (1,)))[..., 0]
    return lo_v * w_low[..., 0] + hi_v * w_high[..., 0]


def _quantile(a, q, axis, keepdim, ignore_nan):
    a = _float(a)
    v, ax = _along_last(a, axis)
    qt = torch.as_tensor(q, dtype=a.dtype, device=a.device)
    s = torch.sort(v, dim=-1, stable=True).values  # NaN sorts last
    nan = torch.isnan(v)
    if ignore_nan:
        cnt = (~nan).sum(-1, keepdim=True)
        out = _interp(s, cnt.clamp(min=1), qt.reshape(-1))
        out = torch.where((cnt == 0)[..., 0], torch.nan, out)
    else:
        cnt = torch.full(v.shape[:-1] + (1,), v.shape[-1], device=a.device)
        out = _interp(s, cnt, qt.reshape(-1))
        out = torch.where(nan.any(-1), torch.nan, out)
    if qt.ndim == 0:
        return _restore(out[0], a, ax, keepdim)
    return torch.stack([_restore(o, a, ax, keepdim) for o in out])


@register_op()
def median(x, axis=None, keepdim=False, name=None):
    return run_op("median", lambda a: _quantile(a, 0.5, axis, keepdim,
                                                False), x)


@register_op()
def nanmedian(x, axis=None, keepdim=False, name=None):
    return run_op("nanmedian", lambda a: _quantile(a, 0.5, axis, keepdim,
                                                   True), x)


@register_op()
def nansum(x, axis=None, dtype=None, keepdim=False, name=None):
    return run_op("nansum", lambda a: _red(torch.nansum, a, axis, keepdim), x)


@register_op()
def nanmean(x, axis=None, keepdim=False, name=None):
    return run_op("nanmean", lambda a: _red(torch.nanmean, _float(a), axis,
                                            keepdim), x)


@register_op()
def norm(x, p=2, axis=None, keepdim=False, name=None):
    def f(a):
        dims = _dims(a, axis)
        if p == "fro" or (p == 2 and axis is None):
            return torch.sqrt(torch.sum(a * a, dim=dims, keepdim=keepdim))
        if p == float("inf"):
            return torch.amax(torch.abs(a), dim=dims, keepdim=keepdim)
        if p == float("-inf"):
            return torch.amin(torch.abs(a), dim=dims, keepdim=keepdim)
        return torch.sum(torch.abs(a) ** p, dim=dims,
                         keepdim=keepdim) ** (1.0 / p)

    return run_op("norm", f, x)


@register_op()
def quantile(x, q, axis=None, keepdim=False, name=None):
    return run_op("quantile", lambda a: _quantile(a, q, axis, keepdim,
                                                  False), x)


@register_op(differentiable=False)
def mode(x, axis=-1, keepdim=False, name=None):
    def f(a):
        moved = a.movedim(axis, -1)
        counts = (moved[..., :, None] == moved[..., None, :]).sum(-1)
        best = torch.argmax(counts, dim=-1)
        vals = torch.gather(moved, -1, best[..., None])[..., 0]
        idx = torch.argmax((moved == vals[..., None]).to(torch.uint8),
                           dim=-1)
        if keepdim:
            vals = vals.unsqueeze(axis)
            idx = idx.unsqueeze(axis)
        return vals, idx

    return run_op("mode", f, x)


@register_op()
def kthvalue(x, k, axis=-1, keepdim=False, name=None):
    def f(a):
        order = torch.argsort(a, dim=axis, stable=True)
        i = order.select(axis, k - 1)
        v = torch.gather(a, axis, i.unsqueeze(axis))
        if not keepdim:
            return v.squeeze(axis), i
        return v, i.unsqueeze(axis)

    return run_op("kthvalue", f, x)
