"""Special-function and statistics ops (port of
``paddle_tpu/ops/special.py``).

The reference's semantics kept: ``histogram`` bins as ``jnp.histogram``
does (edges by ``linspace``, the last bin closed, a range with ``min ==
max`` widened by ±0.5, float32 counts); ``cdist`` with p = 2 uses
``a² + b² − 2ab`` clamped at 0 (the matmul form) unless
``compute_mode="donot_use_mm_for_euclid_dist"``; ``cross`` with the
default axis takes the first axis of size 3.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.tensor import as_port_tensor
from .dispatch import run_op
from .math import _float
from .registry import register_op

__all__ = [
    "bincount", "histogram", "histogramdd", "cross", "cdist", "dist",
    "pdist", "renorm", "i0", "i0e", "i1", "i1e", "polygamma", "poisson",
]


@register_op(differentiable=False)
def bincount(x, weights=None, minlength=0, name=None):
    w = None if weights is None else weights.reshape(-1)
    return as_port_tensor(torch.bincount(x.reshape(-1).long(), weights=w,
                                         minlength=int(minlength)))


def _linspace(lo, hi, num):
    """``jnp.linspace``'s arithmetic: ``lo + i * (hi - lo) / (num - 1)``,
    the last edge exactly ``hi``."""
    i = torch.arange(num, dtype=lo.dtype, device=lo.device)
    out = lo + i * ((hi - lo) / (num - 1))
    return torch.cat([out[:-1], hi.reshape(1)])


def _edges(v, bins, rng):
    """Bin edges of ``jnp.histogram_bin_edges`` for values ``v``."""
    if isinstance(bins, torch.Tensor):
        return bins.to(v.dtype)
    if rng is None:
        lo, hi = v.min(), v.max()
    else:
        lo = torch.as_tensor(rng[0], dtype=v.dtype, device=v.device)
        hi = torch.as_tensor(rng[1], dtype=v.dtype, device=v.device)
    same = lo == hi
    lo, hi = torch.where(same, lo - 0.5, lo), torch.where(same, hi + 0.5, hi)
    return _linspace(lo, hi, int(bins) + 1)


def _bin_index(v, edges):
    """Each value's bin as ``jnp.histogram`` finds it: 0 below the first
    edge, ``len(edges)`` above the last, the last edge in the last bin."""
    idx = torch.searchsorted(edges, v.contiguous(), right=True)
    return torch.where(v == edges[-1], len(edges) - 1, idx)


@register_op(differentiable=False)
def histogram(input, bins=100, min=0, max=0, weight=None, density=False,
              name=None):
    xv = input.reshape(-1).float()
    rng = None if (min == 0 and max == 0) else (float(min), float(max))
    edges = _edges(xv, int(bins), rng)
    idx = _bin_index(xv, edges)
    w = (torch.ones_like(xv) if weight is None
         else weight.reshape(-1).to(xv.dtype))
    inside = (idx >= 1) & (idx <= int(bins))
    hist = torch.zeros(int(bins) + 1, dtype=w.dtype, device=xv.device)
    hist = hist.index_add(0, torch.where(inside, idx, 0), w * inside)[1:]
    if density:
        hist = hist / (hist.sum() * torch.diff(edges))
    return as_port_tensor(hist)


@register_op(differentiable=False)
def histogramdd(x, bins=10, ranges=None, density=False, weights=None,
                name=None):
    xv = x.float()
    n, d = xv.shape
    bins_d = list(bins) if isinstance(bins, (list, tuple)) else [bins] * d
    if ranges is not None and len(ranges) == 2 * d and not isinstance(
            ranges[0], (list, tuple)):
        ranges = [ranges[2 * i:2 * i + 2] for i in range(d)]
    edges, idxs = [], []
    for i in range(d):
        e = _edges(xv[:, i], bins_d[i], None if ranges is None else ranges[i])
        ix = torch.searchsorted(e, xv[:, i].contiguous(), right=True)
        idxs.append(torch.where(xv[:, i] == e[-1], ix - 1, ix))
        edges.append(e)
    nbins = [len(e) + 1 for e in edges]
    flat = torch.zeros(n, dtype=torch.long, device=xv.device)
    for ix, nb in zip(idxs, nbins):
        flat = flat * nb + ix.clamp(0, nb - 1)
    w = None if weights is None else weights.reshape(-1).float()
    hist = torch.bincount(flat, weights=w, minlength=math.prod(nbins))
    hist = hist.reshape(nbins)[(slice(1, -1),) * d]
    if density:
        hist = hist.float() / hist.sum()
        for i, e in enumerate(edges):
            shape = [1] * d
            shape[i] = -1
            hist = hist / torch.diff(e).reshape(shape)
    return as_port_tensor(hist), [as_port_tensor(e) for e in edges]


@register_op()
def cross(x, y, axis=9, name=None):
    def f(a, b):
        ax = axis
        if ax == 9:  # paddle default: first axis of size 3
            ax = next(i for i, d in enumerate(a.shape) if d == 3)
        return torch.linalg.cross(a, b, dim=ax)

    return run_op("cross", f, x, y)


@register_op()
def cdist(x, y, p=2.0, compute_mode="use_mm_for_euclid_dist_if_necessary",
          name=None):
    """Pairwise p-norm distance [..., P, M] x [..., R, M] -> [..., P, R]."""
    def f(a, b):
        if p == 2.0 and compute_mode != "donot_use_mm_for_euclid_dist":
            a2 = torch.sum(a * a, -1)[..., :, None]
            b2 = torch.sum(b * b, -1)[..., None, :]
            sq = a2 + b2 - 2.0 * (a @ b.transpose(-1, -2))
            return torch.sqrt(torch.clamp(sq, min=0.0))
        diff = torch.abs(a[..., :, None, :] - b[..., None, :, :])
        if p == 0:
            return torch.sum(diff != 0, -1).to(a.dtype)
        if math.isinf(p):
            return torch.amax(diff, -1)
        return torch.sum(diff ** p, -1) ** (1.0 / p)

    return run_op("cdist", f, x, y)


@register_op()
def pdist(x, p=2.0, name=None):
    """Condensed pairwise distance of the rows of a [N, M] matrix: the
    upper-triangle entries of ``cdist(x, x, p)`` in row-major (i < j)
    order."""
    def f(a):
        iu, ju = np.triu_indices(a.shape[0], k=1)
        iu = torch.as_tensor(iu, device=a.device)
        ju = torch.as_tensor(ju, device=a.device)
        diff = torch.abs(a[iu] - a[ju])
        pf = float(p)
        if pf == 2.0:
            return torch.sqrt(torch.sum(diff * diff, -1))
        if pf == 0:
            return torch.sum(diff != 0, -1).to(a.dtype)
        if math.isinf(pf):
            return torch.amax(diff, -1)
        return torch.sum(diff ** pf, -1) ** (1.0 / pf)

    return run_op("pdist", f, x)


@register_op()
def dist(x, y, p=2, name=None):
    def f(a, b):
        d = torch.abs(a - b).reshape(-1)
        pf = float(p)
        if pf == 0:
            return torch.sum(d != 0).to(a.dtype)
        if math.isinf(pf):
            return torch.amax(d)
        return torch.sum(d ** pf) ** (1.0 / pf)

    return run_op("dist", f, x, y)


@register_op()
def renorm(x, p, axis, max_norm, name=None):
    """Sub-tensors along ``axis`` whose p-norm exceeds ``max_norm`` scaled
    down to it."""
    def f(a):
        moved = a.movedim(axis, 0)
        flat = moved.reshape(moved.shape[0], -1)
        norms = torch.sum(torch.abs(flat) ** p, dim=1) ** (1.0 / p)
        scale = torch.where(norms > max_norm, max_norm / (norms + 1e-7), 1.0)
        out = flat * scale[:, None]
        return out.reshape(moved.shape).movedim(0, axis)

    return run_op("renorm", f, x)


@register_op()
def i0(x, name=None):
    return run_op("i0", lambda a: torch.special.i0(_float(a)), x)


@register_op()
def i0e(x, name=None):
    return run_op("i0e", lambda a: torch.special.i0e(_float(a)), x)


@register_op()
def i1(x, name=None):
    return run_op("i1", lambda a: torch.special.i1(_float(a)), x)


@register_op()
def i1e(x, name=None):
    return run_op("i1e", lambda a: torch.special.i1e(_float(a)), x)


@register_op()
def polygamma(x, n, name=None):
    return run_op("polygamma", lambda a: torch.polygamma(int(n), _float(a)),
                  x)


@register_op(differentiable=False)
def poisson(x, name=None):
    from ..framework.random import generator

    return as_port_tensor(torch.poisson(x.detach(),
                                        generator=generator(x.device)))
