"""Shape, layout and indexing ops (port of
``paddle_tpu/ops/manipulation.py``).

The reference's semantics, where torch's defaults differ:

* ``split(x, n)`` cuts ``n`` pieces (torch's ``split`` cuts pieces of size
  ``n``) and a ``-1`` section takes the rest; ``transpose`` takes a
  permutation; ``gather`` / ``index_select`` take rows by a 1-D index;
* ``sort`` returns the values only; ``argsort(descending=True)`` flips a
  stable ascending sort, so among ties the later index comes first;
* ``topk`` is ``lax.top_k``: among ties the lower index comes first, for
  ``largest=False`` too (it ranks ``-x``);
* ``scatter(overwrite=True)`` with a repeated index has no defined winner
  (none on XLA, none in torch on CUDA); ``overwrite=False`` adds the
  updates of a repeated index;
* ``unique`` is sorted; ``nonzero`` and ``masked_select`` read the mask on
  the host (their output shape depends on it), as the reference does.
"""

from __future__ import annotations

import builtins
import itertools
from typing import Sequence

import numpy as np
import torch

from ..core.tensor import as_port_tensor, inplace_set, to_tensor
from ..enforce import InvalidArgumentError
from .dispatch import run_op
from .registry import register_op

__all__ = [
    "reshape", "reshape_", "flatten", "unflatten", "transpose", "moveaxis",
    "swapaxes", "numel", "rank", "block_diag", "combinations",
    "cartesian_prod",
    "squeeze", "squeeze_", "unsqueeze", "unsqueeze_", "concat", "stack",
    "split", "chunk", "unbind", "tile", "expand", "expand_as", "broadcast_to",
    "broadcast_tensors", "flip", "rot90", "roll", "gather", "gather_nd",
    "scatter", "scatter_nd_add", "index_select", "index_sample", "index_add",
    "index_put", "masked_select", "masked_fill", "where", "nonzero",
    "take_along_axis", "put_along_axis", "sort", "argsort", "topk", "unique",
    "unique_consecutive", "searchsorted", "bucketize", "pad", "repeat_interleave",
    "diagonal", "tensordot", "einsum", "unstack", "strided_slice", "crop",
    "tolist", "chunk", "dsplit", "hsplit", "vsplit", "as_real", "as_complex",
    "view", "view_as", "atleast_1d", "atleast_2d", "atleast_3d",
]


def _shape_arg(shape):
    if isinstance(shape, torch.Tensor):
        return tuple(int(s) for s in shape.tolist())
    if isinstance(shape, int):
        return (shape,)
    return tuple(int(s.item()) if isinstance(s, torch.Tensor) else int(s)
                 for s in shape)


def _int(v):
    return int(v.item()) if isinstance(v, torch.Tensor) else v


def _index(i):
    return i.long() if i.dtype != torch.long else i


def _wrapped(i, n):
    """Index ``i`` into an axis of ``n`` with negatives counted from the
    end, as ``jnp.take`` reads them."""
    i = _index(i)
    return torch.where(i < 0, i + n, i)


@register_op()
def reshape(x, shape, name=None):
    shp = _shape_arg(shape)
    return run_op("reshape", lambda a: torch.reshape(a, shp), x)


def reshape_(x, shape, name=None):
    return inplace_set(x, torch.reshape(x.detach(), _shape_arg(shape)))


def view(x, shape_or_dtype, name=None):
    if isinstance(shape_or_dtype, (list, tuple)):
        return reshape(x, shape_or_dtype)
    from ..core.dtype import convert_dtype

    dt = convert_dtype(shape_or_dtype)
    return run_op("view_dtype", lambda a: a.view(dt), x)


def view_as(x, other, name=None):
    return reshape(x, other.shape)


@register_op()
def flatten(x, start_axis=0, stop_axis=-1, name=None):
    def f(a):
        if a.ndim == 0:
            return a.reshape(1)
        return torch.flatten(a, start_axis, stop_axis)

    return run_op("flatten", f, x)


def numel(x, name=None):
    """0-D int64 tensor holding the element count."""
    n = x.numel() if isinstance(x, torch.Tensor) else np.asarray(x).size
    return to_tensor(np.asarray(n, np.int64), place=getattr(x, "device", None))


def rank(x, name=None):
    """0-D int32 tensor holding the number of dimensions."""
    nd = x.ndim if isinstance(x, torch.Tensor) else np.asarray(x).ndim
    return to_tensor(np.asarray(int(nd), np.int32),
                     place=getattr(x, "device", None))


@register_op()
def unflatten(x, axis, shape, name=None):
    shape = tuple(_int(s) for s in shape)

    def f(a):
        ax = axis if axis >= 0 else axis + a.ndim
        return torch.reshape(a, a.shape[:ax] + shape + a.shape[ax + 1:])

    return run_op("unflatten", f, x)


@register_op()
def transpose(x, perm=None, name=None):
    if perm is None:
        return run_op("transpose", lambda a: a.permute(
            *reversed(range(a.ndim))), x)
    p = tuple(perm)
    return run_op("transpose", lambda a: a.permute(*p), x)


@register_op()
def moveaxis(x, source, destination, name=None):
    return run_op("moveaxis", lambda a: torch.movedim(a, source,
                                                      destination), x)


@register_op()
def swapaxes(x, axis0, axis1, name=None):
    return run_op("swapaxes", lambda a: torch.swapaxes(a, axis0, axis1), x)


@register_op()
def squeeze(x, axis=None, name=None):
    def f(a):
        if axis is None:
            return torch.squeeze(a)
        axes = (axis,) if isinstance(axis, int) else tuple(axis)
        axes = tuple(ax for ax in axes if a.shape[ax] == 1)
        return torch.squeeze(a, axes) if axes else a

    return run_op("squeeze", f, x)


def squeeze_(x, axis=None, name=None):
    return inplace_set(x, squeeze(x.detach(), axis))


@register_op()
def unsqueeze(x, axis, name=None):
    axes = (axis,) if isinstance(axis, int) else tuple(_int(a) for a in axis)

    def f(a):
        nd = a.ndim + len(axes)
        for ax in sorted(ax % nd for ax in axes):
            a = torch.unsqueeze(a, ax)
        return a

    return run_op("unsqueeze", f, x)


def unsqueeze_(x, axis, name=None):
    return inplace_set(x, unsqueeze(x.detach(), axis))


@register_op()
def concat(x: Sequence[torch.Tensor], axis=0, name=None):
    axis = _int(axis)
    return run_op("concat", lambda *arrs: torch.cat(arrs, dim=axis), *list(x))


@register_op()
def stack(x: Sequence[torch.Tensor], axis=0, name=None):
    return run_op("stack", lambda *arrs: torch.stack(arrs, dim=axis),
                  *list(x))


@register_op()
def split(x, num_or_sections, axis=0, name=None):
    axis = _int(axis)
    dim = x.shape[axis]
    if isinstance(num_or_sections, int):
        if dim % num_or_sections != 0:
            raise InvalidArgumentError(
                f"split: dimension {axis} (size {dim}) is not divisible by "
                f"num_or_sections={num_or_sections}")
        sizes = [dim // num_or_sections] * num_or_sections
    else:
        sizes = [_int(s) for s in num_or_sections]
        known = builtins.sum(s for s in sizes if s != -1)
        sizes = [s if s != -1 else dim - known for s in sizes]
    return list(run_op("split", lambda a: torch.split(a, sizes, dim=axis),
                       x))


@register_op()
def chunk(x, chunks, axis=0, name=None):
    return split(x, chunks, axis)


def dsplit(x, num_or_sections, name=None):
    return split(x, num_or_sections, axis=2)


def hsplit(x, num_or_sections, name=None):
    return split(x, num_or_sections, axis=1 if x.ndim > 1 else 0)


def vsplit(x, num_or_sections, name=None):
    return split(x, num_or_sections, axis=0)


@register_op()
def unbind(x, axis=0, name=None):
    return list(run_op("unbind", lambda a: torch.unbind(a, dim=axis), x))


unstack = unbind


@register_op()
def tile(x, repeat_times, name=None):
    rt = _shape_arg(repeat_times)
    return run_op("tile", lambda a: torch.tile(a, rt), x)


@register_op()
def expand(x, shape, name=None):
    shp = _shape_arg(shape)

    def f(a):
        lead = len(shp) - a.ndim
        target = tuple(a.shape[i - lead] if s == -1 else s
                       for i, s in enumerate(shp))
        return a.expand(target)

    return run_op("expand", f, x)


@register_op()
def expand_as(x, y, name=None):
    return run_op("expand_as", lambda a, b: a.expand(b.shape), x, y)


@register_op()
def broadcast_to(x, shape, name=None):
    return expand(x, shape)


def broadcast_tensors(inputs, name=None):
    shp = torch.broadcast_shapes(*[t.shape for t in inputs])
    return [expand(t, shp) for t in inputs]


@register_op()
def flip(x, axis, name=None):
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    return run_op("flip", lambda a: torch.flip(a, axes), x)


@register_op()
def rot90(x, k=1, axes=(0, 1), name=None):
    return run_op("rot90", lambda a: torch.rot90(a, k, tuple(axes)), x)


@register_op()
def roll(x, shifts, axis=None, name=None):
    def f(a):
        if axis is None:
            return torch.roll(a, shifts)
        return torch.roll(a, shifts, axis)

    return run_op("roll", f, x)


# -- gather / scatter --------------------------------------------------------

@register_op()
def gather(x, index, axis=0, name=None):
    axis = _int(axis)

    def f(a, i):
        i = _wrapped(i, a.shape[axis])
        return torch.index_select(a, axis, i.reshape(-1)).reshape(
            a.shape[:axis % a.ndim] + i.shape + a.shape[axis % a.ndim + 1:])

    return run_op("gather", f, x, index)


@register_op()
def gather_nd(x, index, name=None):
    def f(a, idx):
        idx = _index(idx)
        return a[tuple(idx[..., j] for j in range(idx.shape[-1]))]

    return run_op("gather_nd", f, x, index)


@register_op()
def scatter(x, index, updates, overwrite=True, name=None):
    """Rows of ``x`` at ``index`` set to (``overwrite``) or increased by
    ``updates``. With ``overwrite=True`` and a repeated index, which
    update lands is not defined: not on XLA, not in torch on CUDA."""
    def f(a, i, u):
        i = _index(i).reshape(-1)
        u = u.to(a.dtype)
        if overwrite:
            return a.index_put((i,), u)
        return a.index_put((i,), u, accumulate=True)

    return run_op("scatter", f, x, index, updates)


@register_op()
def scatter_nd_add(x, index, updates, name=None):
    def f(a, idx, u):
        idx = _index(idx)
        flat = tuple(idx[..., j] for j in range(idx.shape[-1]))
        return a.index_put(flat, u.to(a.dtype), accumulate=True)

    return run_op("scatter_nd_add", f, x, index, updates)


@register_op()
def index_select(x, index, axis=0, name=None):
    return run_op("index_select", lambda a, i: torch.index_select(
        a, axis, _wrapped(i, a.shape[axis])), x, index)


@register_op()
def index_sample(x, index, name=None):
    return run_op("index_sample", lambda a, i: torch.gather(
        a, 1, _index(i)), x, index)


@register_op()
def index_add(x, index, axis, value, name=None):
    return run_op("index_add", lambda a, i, v: torch.index_add(
        a, axis, _index(i), v.to(a.dtype)), x, index, value)


@register_op()
def index_put(x, indices, value, accumulate=False, name=None):
    def f(a, v, *idx):
        idx = tuple(_index(i) if i.dtype != torch.bool else i for i in idx)
        return a.index_put(idx, v.to(a.dtype), accumulate=accumulate)

    return run_op("index_put", f, x, value, *indices)


@register_op()
def masked_select(x, mask, name=None):
    # dynamic-shaped output: the mask is read on the host, the gather is
    # differentiable in x
    flat_idx = torch.nonzero(mask.reshape(-1)).reshape(-1).to(x.device)
    return run_op("masked_select", lambda a: torch.take(a, flat_idx), x)


@register_op()
def masked_fill(x, mask, value, name=None):
    def f(a, m):
        v = value.to(a.dtype) if isinstance(value, torch.Tensor) else \
            torch.as_tensor(value, dtype=a.dtype, device=a.device)
        return torch.where(m, v, a)

    return run_op("masked_fill", f, x, mask)


@register_op()
def where(condition, x=None, y=None, name=None):
    if x is None and y is None:
        return nonzero(condition, as_tuple=True)
    from .math import _coerce

    x = _coerce(x, y if isinstance(y, torch.Tensor) else None)
    y = _coerce(y, x)
    return run_op("where", lambda c, a, b: torch.where(c.bool(), a, b),
                  condition, x, y)


@register_op(differentiable=False)
def nonzero(x, as_tuple=False, name=None):
    idx = torch.nonzero(x)  # host sync; dynamic shape like the reference
    if as_tuple:
        return tuple(as_port_tensor(idx[:, j]) for j in range(x.ndim))
    return as_port_tensor(idx)


@register_op()
def take_along_axis(arr, indices, axis, broadcast=True, name=None):
    return run_op("take_along_axis", lambda a, i: torch.take_along_dim(
        a, _index(i), axis), arr, indices)


@register_op()
def put_along_axis(arr, indices, values, axis, reduce="assign", name=None):
    def f(a, i, v):
        i = _index(i)
        v = v.to(a.dtype).expand(i.shape) if v.ndim else \
            torch.full(i.shape, v.item(), dtype=a.dtype, device=a.device)
        if reduce == "add":
            return a.scatter_add(axis, i, v)
        if reduce == "multiply":
            return a.scatter_reduce(axis, i, v, "prod")
        return a.scatter(axis, i, v)

    if not isinstance(values, torch.Tensor):
        values = torch.as_tensor(values, device=arr.device)
    return run_op("put_along_axis", f, arr, indices, values)


# -- sort / search -----------------------------------------------------------

@register_op()
def sort(x, axis=-1, descending=False, name=None):
    def f(a):
        s = torch.sort(a, dim=axis, stable=True).values
        return torch.flip(s, (axis,)) if descending else s

    return run_op("sort", f, x)


@register_op(differentiable=False)
def argsort(x, axis=-1, descending=False, name=None):
    def f(a):
        i = torch.argsort(a, dim=axis, stable=True)
        return torch.flip(i, (axis,)) if descending else i

    return run_op("argsort", f, x)


def _top_k(a, k):
    """``lax.top_k`` over the last axis: the k largest, ties to the lower
    index (a stable sort of ``-a``)."""
    i = torch.argsort(-a if a.dtype != torch.bool else ~a, dim=-1,
                      stable=True)[..., :k]
    return torch.gather(a, -1, i), i


@register_op()
def topk(x, k, axis=-1, largest=True, sorted=True, name=None):
    k = _int(k)

    def f(a):
        moved = a.movedim(axis, -1)
        src = moved if largest else -moved
        v, i = _top_k(src, k)
        if not largest:
            v = -v
        return v.movedim(-1, axis), i.movedim(-1, axis)

    return run_op("topk", f, x)


@register_op(differentiable=False)
def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None, name=None):
    if axis is None:
        vals, inv, cnt = torch.unique(x.reshape(-1), sorted=True,
                                      return_inverse=True,
                                      return_counts=True)
        flat_n = x.numel()
    else:
        vals, inv, cnt = torch.unique(x, sorted=True, return_inverse=True,
                                      return_counts=True, dim=axis)
        flat_n = x.shape[axis]
    res = [as_port_tensor(vals)]
    if return_index:
        # the first position of each unique value
        pos = torch.arange(flat_n, device=x.device)
        first = torch.full((vals.shape[0] if axis is None else
                            vals.shape[axis],), flat_n, device=x.device,
                           dtype=torch.long)
        first = first.scatter_reduce(0, inv.reshape(-1), pos, "amin")
        res.append(as_port_tensor(first))
    if return_inverse:
        res.append(as_port_tensor(inv.reshape(-1) if axis is None else inv))
    if return_counts:
        res.append(as_port_tensor(cnt))
    return res[0] if len(res) == 1 else tuple(res)


@register_op(differentiable=False)
def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None, name=None):
    a = x.reshape(-1) if axis is None else x.movedim(axis, 0)
    n = a.shape[0]
    keep = torch.ones(n, dtype=torch.bool, device=x.device)
    if n > 1:
        neq = a[1:] != a[:-1]
        keep[1:] = neq.reshape(n - 1, -1).any(-1) if a.ndim > 1 else neq
    out = a[keep]
    results = [as_port_tensor(out if axis is None else out.movedim(0, axis))]
    if return_inverse:
        results.append(as_port_tensor(torch.cumsum(keep.long(), 0) - 1))
    if return_counts:
        idx = torch.nonzero(keep).reshape(-1)
        ends = torch.cat([idx[1:], torch.tensor([n], device=x.device)])
        results.append(as_port_tensor(ends - idx))
    return results[0] if len(results) == 1 else tuple(results)


@register_op(differentiable=False)
def searchsorted(sorted_sequence, values, out_int32=False, right=False,
                 name=None):
    return run_op("searchsorted", lambda s, v: torch.searchsorted(
        s, v.to(s.dtype), right=right).to(torch.int32),
        sorted_sequence, values)


@register_op(differentiable=False)
def bucketize(x, sorted_sequence, out_int32=False, right=False, name=None):
    return searchsorted(sorted_sequence, x, out_int32=out_int32, right=right)


# -- padding / misc ----------------------------------------------------------

@register_op()
def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    """``nn.functional.pad`` (one implementation)."""
    from ..nn.functional import pad as _pad

    return _pad(x, pad, mode=mode, value=value, data_format=data_format)


@register_op()
def repeat_interleave(x, repeats, axis=None, name=None):
    if isinstance(repeats, torch.Tensor):
        # repeats shape the output: read on the host
        repeats = repeats.to(x.device)

    def f(a):
        if axis is None:
            return torch.repeat_interleave(a.reshape(-1), repeats)
        return torch.repeat_interleave(a, repeats, dim=axis)

    return run_op("repeat_interleave", f, x)


@register_op()
def diagonal(x, offset=0, axis1=0, axis2=1, name=None):
    return run_op("diagonal", lambda a: torch.diagonal(a, offset, axis1,
                                                       axis2), x)


@register_op()
def tensordot(x, y, axes=2, name=None):
    def f(a, b):
        ax = axes
        if isinstance(ax, (list, tuple)) and len(ax) == 2 and all(
                isinstance(v, int) for v in ax):
            ax = ([ax[0]], [ax[1]])
        return torch.tensordot(a, b, dims=ax)

    return run_op("tensordot", f, x, y)


@register_op()
def einsum(equation, *operands, name=None):
    ops = (list(operands[0]) if len(operands) == 1 and isinstance(
        operands[0], (list, tuple)) else list(operands))
    return run_op("einsum", lambda *arrs: torch.einsum(equation, *arrs), *ops)


@register_op()
def strided_slice(x, axes, starts, ends, strides, name=None):
    def f(a):
        idx = [slice(None)] * a.ndim
        for ax, s, e, st in zip(axes, starts, ends, strides):
            idx[ax] = slice(s, e, st)
        if builtins.any(st < 0 for st in strides):
            return _neg_stride_slice(a, idx)
        return a[tuple(idx)]

    return run_op("strided_slice", f, x)


def _neg_stride_slice(a, idx):
    """``a[idx]`` for slices with negative steps (torch takes none): an
    index_select with numpy's arithmetic of the indices."""
    for ax, sl in enumerate(idx):
        if sl.step is not None and sl.step < 0:
            pos = np.ascontiguousarray(np.arange(a.shape[ax])[sl])
            a = torch.index_select(a, ax, torch.as_tensor(pos,
                                                          device=a.device))
        elif sl != slice(None):
            a = a[(slice(None),) * ax + (sl,)]
    return a


@register_op()
def crop(x, shape=None, offsets=None, name=None):
    shp = _shape_arg(shape)
    offs = _shape_arg(offsets) if offsets is not None else (0,) * len(shp)

    def f(a):
        idx = tuple(slice(o, o + (s if s != -1 else a.shape[i] - o))
                    for i, (o, s) in enumerate(zip(offs, shp)))
        return a[idx]

    return run_op("crop", f, x)


def as_real(x, name=None):
    return run_op("as_real", torch.view_as_real, x)


def as_complex(x, name=None):
    return run_op("as_complex", lambda a: torch.complex(a[..., 0],
                                                        a[..., 1]), x)


def atleast_1d(*xs, name=None):
    outs = [reshape(x, [-1]) if x.ndim == 0 else x for x in xs]
    return outs[0] if len(outs) == 1 else outs


def atleast_2d(*xs, name=None):
    outs = []
    for x in xs:
        while x.ndim < 2:
            x = unsqueeze(x, 0)
        outs.append(x)
    return outs[0] if len(outs) == 1 else outs


def atleast_3d(*xs, name=None):
    outs = []
    for x in xs:
        while x.ndim < 3:
            x = unsqueeze(x, -1) if x.ndim >= 2 else unsqueeze(x, 0)
        outs.append(x)
    return outs[0] if len(outs) == 1 else outs


def tolist(x):
    return x.tolist()


def block_diag(inputs, name=None):
    """Block-diagonal matrix from blocks of rank <= 2 (higher ranks are
    rejected, as in the reference)."""
    tensors = [x if isinstance(x, torch.Tensor) else to_tensor(x)
               for x in inputs]
    for i, t in enumerate(tensors):
        if t.ndim > 2:
            raise InvalidArgumentError(
                f"block_diag inputs must have ndim <= 2; input {i} has "
                f"shape {list(t.shape)}")
    return run_op("block_diag", lambda *vs: torch.block_diag(
        *[v if v.ndim == 2 else v.reshape(1, -1) for v in vs]), *tensors)


def combinations(x, r=2, with_replacement=False, name=None):
    """r-length combinations of a 1-D tensor's elements."""
    if x.ndim != 1:
        raise InvalidArgumentError(
            f"combinations expects a 1-D tensor, got shape {list(x.shape)}")
    n = int(x.shape[0])
    it = (itertools.combinations_with_replacement if with_replacement
          else itertools.combinations)
    idx = torch.as_tensor(np.asarray(list(it(range(n), r)), np.int64)
                          .reshape(-1, r), device=x.device)
    return run_op("combinations", lambda a: a[idx], x)


def cartesian_prod(xs, name=None):
    """Cartesian product of 1-D tensors: [prod(n_i), len(xs)]."""
    def f(*vs):
        grids = torch.meshgrid(*vs, indexing="ij")
        return torch.stack([g.reshape(-1) for g in grids], dim=-1)

    return run_op("cartesian_prod", f, *xs)
