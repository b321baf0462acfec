"""``Layer``: the Paddle-style base layer as a ``torch.nn.Module``.

Counterpart of ``paddle_tpu/nn/layer/layers.py``. Parameters are
``torch.nn.Parameter``s with a ``.name`` (``requires_grad`` stands for
``not stop_gradient``); ``parameters()`` lists them in the JAX package's
order (each layer's own, then its sublayers', depth first), so both
packages build the same optimizer groups and ``FlatPlan``s;
``state_dict()`` holds the parameters, then the persistable buffers, under
the JAX package's keys (``conv1.weight``, ``bn1._mean``, ...).
Parameters are built on ``device.get_device()`` (CUDA unless
``set_device`` named another), from ``nn.initializer``'s generator.
"""

from __future__ import annotations

import collections
import itertools
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ...device import get_device, resolve_device
from .. import initializer as I

__all__ = ["Layer", "Parameter", "ParamAttr"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}
_names = itertools.count()


class Parameter(torch.nn.Parameter):
    """A ``torch.nn.Parameter`` that holds Paddle's ``.name`` (torch's own
    ``Tensor.name`` is read-only: this class attribute shadows it, so each
    parameter keeps its name in its instance dict)."""

    name = None

    def __deepcopy__(self, memo):
        """A fresh copy that keeps the name, as the JAX package's
        ``copy.deepcopy`` of a layer does (``TransformerEncoder``'s
        layers)."""
        if id(self) in memo:
            return memo[id(self)]
        out = type(self)(self.data.clone(memory_format=torch.preserve_format),
                         self.requires_grad)
        out.name = self.name
        memo[id(self)] = out
        return out


class ParamAttr:
    """Parameter attribute bundle (``paddle.ParamAttr``): the fields the
    ported layers read (per-parameter learning rates, regularizers and
    clipping wait for the optimizer and clip ports)."""

    def __init__(self, name=None, initializer=None, trainable=True):
        self.name = name
        self.initializer = initializer
        self.trainable = trainable

    @staticmethod
    def _to_attr(attr):
        if attr is None:
            return ParamAttr()
        if isinstance(attr, ParamAttr) or attr is False:
            return attr
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        if isinstance(attr, I.Initializer):
            return ParamAttr(initializer=attr)
        raise TypeError(f"cannot convert {attr!r} to ParamAttr")


# the handle ``register_forward_pre_hook`` / ``_post_hook`` return
HookRemoveHelper = torch.utils.hooks.RemovableHandle


class Layer(torch.nn.Module):
    """Base class of the ported layers."""

    def __init__(self, name_scope: Optional[str] = None,
                 dtype: str = "float32"):
        super().__init__()
        self._dtype = dtype
        self._name_scope = name_scope or type(self).__name__.lower()

    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None):
        """A new parameter of ``shape`` on the layer device, initialized by
        ``attr``'s initializer, else ``default_initializer``, else zeros
        (a bias) or Xavier-uniform; None for ``attr=False``."""
        attr = ParamAttr._to_attr(attr)
        if attr is False:
            return None
        init = attr.initializer or default_initializer or (
            I.Constant(0.0) if is_bias else I.XavierUniform())
        dt = dtype or self._dtype
        value = init(shape, _DTYPES[dt] if isinstance(dt, str) else dt,
                     resolve_device(get_device()))
        p = Parameter(value, requires_grad=attr.trainable)
        p.name = attr.name or f"{self._name_scope}_{next(_names)}"
        return p

    def add_parameter(self, name: str, parameter: Optional[torch.Tensor]):
        """Register ``parameter`` under ``name`` (after the layer's other
        parameters, so it keeps the reference's order and key)."""
        if parameter is not None and not isinstance(parameter,
                                                    torch.nn.Parameter):
            raise TypeError(f"add_parameter expects a Parameter, got "
                            f"{type(parameter)}")
        self.register_parameter(name, parameter)
        return parameter

    def register_forward_post_hook(self, hook) -> HookRemoveHelper:
        """``hook(layer, inputs, outputs)`` after each forward; a value it
        returns replaces the outputs. (torch's ``register_forward_pre_hook``
        already has the reference's ``hook(layer, inputs)`` form.)"""
        return self.register_forward_hook(hook)

    def add_sublayer(self, name: str, sublayer: "Layer"):
        self.add_module(str(name), sublayer)
        return sublayer

    def register_buffer(self, name: str, tensor: Optional[torch.Tensor],
                        persistable: bool = True):
        super().register_buffer(name, tensor, persistent=persistable)
        return tensor

    def parameters(self, include_sublayers: bool = True) -> List[torch.Tensor]:
        return list(super().parameters(recurse=include_sublayers))

    def buffers(self, include_sublayers: bool = True) -> List[torch.Tensor]:
        return list(super().buffers(recurse=include_sublayers))

    def state_dict(self, destination=None, include_sublayers: bool = True,
                   structured_name_prefix: str = "", use_hook: bool = True
                   ) -> Dict[str, torch.Tensor]:
        """The parameters (in ``parameters()`` order), then each layer's
        persistable buffers; the values are the live tensors."""
        dest = destination if destination is not None \
            else collections.OrderedDict()
        for name, p in self.named_parameters(recurse=include_sublayers):
            dest[structured_name_prefix + name] = p
        for lname, layer in self.named_modules():
            if lname and not include_sublayers:
                break
            for bname, b in layer._buffers.items():
                if b is None or bname in layer._non_persistent_buffers_set:
                    continue
                key = f"{lname}.{bname}" if lname else bname
                dest[structured_name_prefix + key] = b
        return dest

    def set_state_dict(self, state_dict: Dict[str, Any],
                       use_structured_name: bool = True):
        """Copy values into the existing parameters and buffers, each cast
        to its type; raises on a shape mismatch. Returns (missing keys,
        unexpected keys)."""
        own = self.state_dict()
        unexpected = [k for k in state_dict if k not in own]
        with torch.no_grad():
            for key, value in state_dict.items():
                if key not in own:
                    continue
                target = own[key]
                val = torch.as_tensor(np.asarray(value) if not isinstance(
                    value, torch.Tensor) else value)
                if tuple(val.shape) != tuple(target.shape):
                    raise ValueError(f"shape mismatch for {key}: checkpoint "
                                     f"{tuple(val.shape)} against the model's "
                                     f"{tuple(target.shape)}")
                target.copy_(val)
        missing = [k for k in own if k not in state_dict]
        return missing, unexpected

    load_dict = set_state_dict

    def clear_gradients(self):
        for p in self.parameters():
            p.grad = None
