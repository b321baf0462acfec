"""The op corpus as ``Tensor`` methods (port of
``paddle_tpu/ops/_tensor_methods.py``).

As in the reference, every public op becomes a method of
``paddle_tpu_torch.Tensor`` (the earlier modules win a name clash), except
the names the reference's ``Tensor`` class defines itself
(``core.tensor``). Arithmetic and comparison dunders are torch's, which
compute what the reference's do.

**Names torch's ``Tensor`` also has.** Many op names are torch methods
too, some with other call forms or results: ``transpose``, ``reshape``,
``flatten``, ``sum`` / ``mean`` / ``max`` / ``min`` / ``prod`` / ``std`` /
``var`` with ``axis``, ``split``, ``squeeze``, ``unsqueeze``, ``expand``,
``tile``, ``gather``, ``scatter``, ``topk``, ``sort``, ``cumsum``,
``flip``, ``roll``, ``where``, ... A port tensor flows into the port's
layers, into torch's own Python code (``torch.split(x, 2, 1)`` calls
``x.split(2, 1)``) and into other torch libraries, which call these
methods in torch's form. So each such method decides, in this order:

1. a keyword that is not one of the op's (``dim=``, ``stable=``, ...), or
   positional arguments that fit only torch's signature
   (``x.transpose(0, 1)``, ``x.gather(1, index)``, ``x.reshape(2, 3)``;
   ``_POSITIONAL``): torch's method;
2. otherwise the calling code decides (``_paddle_code``). Code in
   ``torch`` or in this package is written against ``torch.Tensor``: torch's
   method. Other code is Paddle code when its module's globals hold this
   package, one of its modules, or a function or class imported from it
   (a script that ran ``import paddle_tpu_torch as paddle``): the
   reference's op. Code whose module does not (``torchvision``,
   ``einops``, any torch library) gets torch's method.

The limits of rule 2: a module that imports this package and means
torch's form of a call that fits both (``x.split(2, 1)``, ``x.max(1)``,
``x.sort(1)``, ``x.median()``) gets the reference's, and must say
``dim=`` or call ``torch.split(x, 2, 1)``; a module that means the
reference's form without importing this package gets torch's; code run
by ``exec`` decides by the globals it is given. Each call from outside
torch and this package scans its caller's globals (a few microseconds).
``real`` and ``imag`` stay torch's attributes (a property cannot tell its
callers apart); ``paddle_tpu_torch.real(x)`` is the op.
"""

from __future__ import annotations

import inspect
import sys
from types import FunctionType, ModuleType

import torch

from ..core.tensor import Tensor, inplace_set
from . import (creation, linalg, logic, manipulation, math, reduction,
               special, tail)

# what the reference's Tensor class defines itself: the op table never
# replaces these
_CLASS_NAMES = frozenset({
    "numel", "dim", "is_floating_point", "numpy", "item", "tolist",
    "backward", "clear_grad", "clear_gradient", "register_hook", "detach",
    "element_size", "pin_memory", "coalesce", "contiguous", "is_contiguous",
    "clone", "to", "cpu", "cuda", "tpu", "astype", "cast", "copy_",
    "set_value", "zero_", "fill_", "scale_", "add_", "subtract_",
    "multiply_", "clip_", "exp_", "sqrt_", "floor_", "ceil_", "round_",
    "reciprocal_", "tanh_", "scatter_", "flatten_", "squeeze_",
    "unsqueeze_", "reshape_", "size", "shape", "ndim", "dtype", "place",
    "strides", "get_strides", "is_leaf", "stop_gradient", "grad", "name",
})

_TORCH_FORMS = ("torch", "paddle_tpu_torch")
_PACKAGE = "paddle_tpu_torch"


def _int_first(self, args) -> bool:
    return bool(args) and isinstance(args[0], int)


def _varargs(self, args) -> bool:
    return len(args) > 1


# positional forms only torch's signature takes (the reference's methods
# take an index tensor first, or one shape list, or a dtype second)
_POSITIONAL = {
    "transpose": lambda self, args: len(args) == 2,
    "gather": _int_first, "scatter": _int_first, "index_select": _int_first,
    "index_add": _int_first, "index_fill": _int_first,
    "expand": _varargs, "reshape": _varargs, "tile": _varargs,
    "flip": _varargs, "view": lambda self, args: len(args) > 1 or (
        bool(args) and isinstance(args[0], int)),
    "sum": lambda self, args: len(args) > 1 and isinstance(args[1], bool),
    "where": lambda self, args: self.dtype != torch.bool,
}


def _from_package(v) -> bool:
    if isinstance(v, ModuleType):
        mod = v.__name__
    elif isinstance(v, (FunctionType, type)):
        mod = v.__module__ or ""
    else:
        return False
    return mod.split(".", 1)[0] == _PACKAGE


def _paddle_code(frame) -> bool:
    """Rule 2 of the module docstring: whether the code of ``frame`` is
    Paddle code."""
    g = frame.f_globals
    if g.get("__name__", "").split(".", 1)[0] in _TORCH_FORMS:
        return False
    return any(_from_package(v) for v in tuple(g.values()))


def _dual(name, fn):
    """The method ``name``: the op ``fn`` or torch's method, by the rules
    of the module docstring."""
    tmeth = getattr(torch.Tensor, name)
    pnames = frozenset(inspect.signature(fn).parameters)
    positional = _POSITIONAL.get(name, lambda self, args: False)

    def method(self, *args, **kwargs):
        if ((kwargs and not pnames.issuperset(kwargs))
                or positional(self, args)
                or not _paddle_code(sys._getframe(1))):
            return tmeth(self, *args, **kwargs)
        return fn(self, *args, **kwargs)

    method.__name__ = name
    method.__qualname__ = f"Tensor.{name}"
    method.__doc__ = fn.__doc__
    return method


# the reference's in-place methods that torch's Tensor has too: for Paddle
# code (rule 2), each rebinds the tensor's value (``inplace_set``: a
# leaf's, even one that requires grad; a tensor inside a graph raises), as
# the reference's ``_inplace_set`` does; other code gets torch's in-place op
_INPLACE = ("copy_", "zero_", "fill_", "add_", "subtract_", "multiply_",
            "clip_", "exp_", "sqrt_", "floor_", "ceil_", "round_",
            "reciprocal_", "tanh_")


def _inplace(name):
    tmeth = getattr(torch.Tensor, name)

    def method(self, *args, **kwargs):
        if not _paddle_code(sys._getframe(1)):
            return tmeth(self, *args, **kwargs)
        args = [a.detach() if isinstance(a, torch.Tensor) else a
                for a in args]
        with torch.no_grad():
            new = tmeth(self.detach().clone(), *args, **kwargs)
        return inplace_set(self, new)

    method.__name__ = name
    method.__qualname__ = f"Tensor.{name}"
    return method


def _where(self, x=None, y=None, name=None):
    return manipulation.where(self, x, y)


def _is_attribute(name) -> bool:
    return not callable(inspect.getattr_static(torch.Tensor, name))


def attach():
    table = {}
    for mod in (math, reduction, manipulation, logic, creation, linalg,
                special, tail):
        for name in mod.__all__:
            fn = getattr(mod, name)
            if callable(fn) and name not in table:
                table[name] = fn
    table["where"] = _where
    for name, fn in table.items():
        if name in _CLASS_NAMES:
            continue
        if hasattr(torch.Tensor, name):
            if _is_attribute(name):
                continue
            setattr(Tensor, name, _dual(name, fn))
        else:
            setattr(Tensor, name, fn)
    for name in _INPLACE:
        setattr(Tensor, name, _inplace(name))
