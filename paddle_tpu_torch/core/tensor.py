"""The Tensor: ``paddle_tpu_torch.Tensor``, a subclass of ``torch.Tensor``.

Port of ``paddle_tpu/core/tensor.py``. **The decision.** The JAX package's
``Tensor`` is a mutable wrapper over an immutable ``jax.Array``. The port's
tensor is a ``torch.Tensor`` subclass instead of a wrapper: ``to_tensor``
and the creation ops return it (``as_subclass``), torch's default
``__torch_function__`` keeps the type through every torch operation, and so
the port's layers, optimizers and kernels take it as they take any torch
tensor, with no unwrapping or rewrapping. A wrapper would have made every
port layer unwrap its inputs and rewrap its outputs. Models, serving and
the trainers keep computing on plain ``torch.Tensor``: nothing on those
paths makes a subclass, and a layer given a plain tensor returns a plain
tensor.

The subclass adds the reference's methods that torch lacks: ``astype`` /
``cast``, ``stop_gradient`` (``not requires_grad``), ``numpy()`` (which
detaches and copies to the host, from the card too), ``place``,
``clear_grad`` / ``clear_gradient``, ``set_value``, ``strides``, ``to`` with
Paddle's device and dtype names, ``backward`` with the reference's leaf
rules (``core.autograd``), and the in-place forms torch lacks (``scale_``,
``flatten_``, ``reshape_``, ``scatter_(index, updates, overwrite)``, list
axes in ``squeeze_`` / ``unsqueeze_``). ``ops._tensor_methods`` attaches the
op corpus as methods, as the reference does; a method whose name torch's
``Tensor`` also has takes torch's own form when its arguments fit only
torch's, or when the calling code is torch's, this package's or another
library's that does not import this package, and the reference's form
from Paddle code (see ``ops._tensor_methods`` for the rule and its
limits).

Divergences from the reference, each with a test
(``tests/test_torch_tensor.py``):

* ``size`` is torch's method (``x.size()`` is a ``torch.Size``; the
  reference's is an int property, here ``x.numel()``), and ``shape`` is a
  ``torch.Size`` (the reference's is a list; both compare equal to a
  tuple, and ``list(x.shape)`` is the reference's value);
* integer data keeps int64 (the JAX package, running without 64-bit
  types, stores int32); float64 data given with no dtype becomes float32
  (and complex128 complex64), as in the reference;
* complex tensors live on the card (the reference keeps them on the host:
  a workaround for its TPU transport);
* ``numpy()`` of a bfloat16 tensor is float32 (numpy has no bfloat16);
* ``.grad`` of a subclass leaf is a subclass tensor, of a plain parameter a
  plain tensor.

The in-place methods (``add_``, ``zero_``, ``copy_``, ...) rebind the
value as the reference's do (``inplace_set``): on a leaf, also one that
requires grad, and never on a tensor inside an autograd graph, which
raises. Code that is not Paddle code gets torch's in-place ops
(``ops._tensor_methods``).
"""

from __future__ import annotations

from typing import Any, Optional, Union

import numpy as np
import torch

from .. import device as _device
from ..enforce import InvalidArgumentError
from . import autograd
from .dtype import convert_dtype

__all__ = ["Tensor", "to_tensor", "inplace_set", "as_port_tensor"]


def _to_arg(a):
    """A positional argument of ``Tensor.to`` in torch's spelling: dtype
    names become dtypes, Paddle's device names and places devices."""
    if isinstance(a, _device.Place):
        return a.torch_device()
    if isinstance(a, str):
        try:
            return convert_dtype(a)
        except ValueError:
            return _device._torch_spelling(a)
    if isinstance(a, (np.dtype, type)) and not isinstance(a, torch.dtype):
        return convert_dtype(a)
    return a


class Tensor(torch.Tensor):
    """A ``torch.Tensor`` with the reference's tensor API on top."""

    # -- metadata ----------------------------------------------------------
    @property
    def stop_gradient(self) -> bool:
        return not self.requires_grad

    @stop_gradient.setter
    def stop_gradient(self, value: bool) -> None:
        self.requires_grad_(not bool(value))

    @property
    def place(self) -> "_device.Place":
        return _device.place_of(self.device)

    @property
    def strides(self):
        """Element strides (``torch.Tensor.stride()`` as a list)."""
        return list(self.stride())

    def get_strides(self):
        return self.strides

    # -- conversion --------------------------------------------------------
    def numpy(self, force: bool = False) -> np.ndarray:
        t = self.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return torch.Tensor.numpy(t.as_subclass(torch.Tensor), force=True)

    def astype(self, dtype) -> "Tensor":
        return torch.Tensor.to(self, convert_dtype(dtype))

    def cast(self, dtype) -> "Tensor":
        return self.astype(dtype)

    def to(self, *args, **kwargs) -> "Tensor":
        """torch's ``to``, also taking Paddle's spellings: ``"gpu:0"``, a
        ``Place``, dtype names, and ``blocking``."""
        args = [_to_arg(a) for a in args]
        if "device" in kwargs and kwargs["device"] is not None:
            kwargs["device"] = _to_arg(kwargs["device"])
        if "dtype" in kwargs and kwargs["dtype"] is not None:
            kwargs["dtype"] = convert_dtype(kwargs["dtype"])
        if "blocking" in kwargs:
            kwargs["non_blocking"] = not kwargs.pop("blocking")
        return torch.Tensor.to(self, *args, **kwargs)

    def tpu(self, device_id: int = 0):
        raise InvalidArgumentError(
            "Tensor.tpu(): this port runs on CUDA GPUs and the CPU")

    # -- autograd ----------------------------------------------------------
    def backward(self, grad_tensor=None, retain_graph: bool = False,
                 create_graph: bool = False, inputs=None) -> None:
        if create_graph or inputs is not None:
            torch.Tensor.backward(self, grad_tensor, retain_graph,
                                  create_graph, inputs)
            return
        autograd.backward([self], [grad_tensor], retain_graph=retain_graph)

    @property
    def grad(self):
        """The accumulated gradient, as a port ``Tensor`` (so ``.numpy()``
        works on the card's too)."""
        g = torch.Tensor.grad.__get__(self)
        return None if g is None else as_port_tensor(g)

    @grad.setter
    def grad(self, value) -> None:
        torch.Tensor.grad.__set__(self, value)

    def clear_grad(self) -> None:
        self.grad = None

    def clear_gradient(self) -> None:  # paddle spelling
        self.grad = None

    # -- in-place forms torch lacks ----------------------------------------
    def set_value(self, value) -> "Tensor":
        v = value if isinstance(value, torch.Tensor) else torch.as_tensor(
            np.asarray(value))
        return inplace_set(self, v.to(self.dtype).to(self.device))

    def scale_(self, s) -> "Tensor":
        return inplace_set(self, self.detach() * s)

    def flatten_(self, start_axis: int = 0, stop_axis: int = -1) -> "Tensor":
        return inplace_set(self, torch.flatten(self.detach(), start_axis,
                                               stop_axis))

    def reshape_(self, shape) -> "Tensor":
        return inplace_set(self, self.detach().reshape(
            tuple(int(s) for s in shape)))

    def squeeze_(self, axis=None, *args, **kwargs) -> "Tensor":
        if isinstance(axis, (list, tuple)):
            from ..ops.manipulation import squeeze

            return inplace_set(self, squeeze(self.detach(), axis))
        if axis is None and not args and not kwargs:
            return torch.Tensor.squeeze_(self)
        return torch.Tensor.squeeze_(self, axis, *args, **kwargs)

    def unsqueeze_(self, axis=None, *args, **kwargs) -> "Tensor":
        if isinstance(axis, (list, tuple)):
            from ..ops.manipulation import unsqueeze

            return inplace_set(self, unsqueeze(self.detach(), axis))
        if axis is None:
            return torch.Tensor.unsqueeze_(self, *args, **kwargs)
        return torch.Tensor.unsqueeze_(self, axis, *args, **kwargs)

    def scatter_(self, index, updates, *args, **kwargs) -> "Tensor":
        """Paddle's ``scatter_(index, updates, overwrite=True)`` (rows of
        ``index``), or torch's ``scatter_(dim, index, src)`` when the first
        argument is an int."""
        if isinstance(index, int):
            return torch.Tensor.scatter_(self, index, updates, *args,
                                         **kwargs)
        from ..ops.manipulation import scatter

        return inplace_set(self, scatter(self.detach(), index, updates,
                                         *args, **kwargs))


def inplace_set(t: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """Rebind ``t``'s value to ``new`` (Paddle's dygraph in-place
    discipline; shapes may change). On a tensor inside an autograd graph it
    raises, as the reference's does: the graph saved its old value."""
    if t.grad_fn is not None:
        raise InvalidArgumentError(
            "In-place update on a non-leaf tensor would invalidate its "
            "autograd graph.")
    torch.Tensor.data.__set__(t, new.detach())
    return t


def _host_array(data, dtype) -> np.ndarray:
    arr = np.asarray(data)
    if arr.dtype == object:
        raise InvalidArgumentError(
            f"to_tensor: cannot make a tensor of {type(data).__name__} "
            "elements")
    if dtype is None:
        # Paddle's default float type is float32 (the reference converts
        # float64 data the same way)
        if arr.dtype == np.float64:
            arr = arr.astype(np.float32)
        elif arr.dtype == np.complex128:
            arr = arr.astype(np.complex64)
    if arr.dtype.name == "bfloat16":  # ml_dtypes arrays cross as float32
        arr = arr.astype(np.float32)
    return arr


def to_tensor(data: Any, dtype: Optional[Any] = None,
              place: Optional[Union[str, "_device.Place"]] = None,
              stop_gradient: bool = True) -> Tensor:
    """``paddle.to_tensor``: a new leaf ``Tensor`` holding a copy of
    ``data`` (a tensor, an array, a scalar or a nested list), on ``place``
    (default the current device: the card, which raises without one,
    unless ``set_device`` or ``place`` names the CPU)."""
    dev = _device.resolve_device(_device.get_device() if place is None
                                 else place)
    dt = convert_dtype(dtype)
    if isinstance(data, torch.Tensor):
        t = data.detach()
    elif (isinstance(data, (list, tuple)) and data
          and all(isinstance(d, torch.Tensor) for d in data)):
        t = torch.stack([d.detach().to(dev) for d in data])
    else:
        t = torch.tensor(_host_array(data, dtype))
    t = t.to(device=dev, dtype=dt, copy=True).as_subclass(Tensor)
    if not stop_gradient:
        t.requires_grad_(True)
    return t


def as_port_tensor(t: torch.Tensor) -> Tensor:
    """``t`` viewed as a port ``Tensor`` (no copy; the creation ops' last
    step)."""
    return t if isinstance(t, Tensor) else t.as_subclass(Tensor)
