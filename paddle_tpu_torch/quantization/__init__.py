"""Quantization: QAT and PTQ (counterpart of
``paddle_tpu/quantization/__init__.py``); the serving recipe is
``quantization.serving``.

- ``fake_quant`` is a ``torch.autograd.Function``: the forward snaps ``x``
  to the symmetric ``bits``-bit grid, ``round(x / s * qmax)`` in that
  order with ``s = max(scale, 1e-9)``, clipped to [-qmax, qmax] and scaled
  back; the backward is the straight-through estimator, the gradient
  passed where ``|x| <= s`` and none to the scale.
- The observers (PTQ) and ``FakeQuanterWithAbsMax`` (QAT) read
  ``float(max|x|)`` on every call, which is one device read each, and keep
  their running scale as a Python float (the moving average too).
- ``QuantConfig.config_for`` matches a child's attribute name, not its
  dotted path; ``QAT`` / ``PTQ`` wrap each configured ``Linear`` in a
  ``QuantedLinear`` holding the same parameters.
- ``convert`` replaces each ``QuantedLinear`` by an ``Int8Linear``: int8
  weights with one scale per output column of the ``[in, out]`` weight
  (recomputed from the weights on the host), the activation quanter's
  scale (1.0 where it is 0 or ``None``), and the original bias. Its
  forward quantizes the input, multiplies int8 by int8 into int32 with
  ``torch._int_mm`` and computes ``acc * (w_scales * a_s / qmax^2)`` in
  that order, then adds the bias.

``torch._int_mm`` on the card wants more than 16 rows and K and N
multiples of 8, and cuBLASLt refuses some shapes that pass those checks;
``int8_matmul`` pads every dimension to a multiple of 16 (M to at least
32) with zeros (exact: the padded products are 0) wherever it runs, and
never falls back to a float matmul.
"""

from __future__ import annotations

import copy
from typing import Dict, Type

import numpy as np
import torch

from ..device import get_device, resolve_device
from ..nn import functional as F
from ..nn.functional import _div
from ..nn.layer.common import Linear
from ..nn.layer.layers import Layer

__all__ = [
    "QuantConfig", "BaseQuanter", "BaseObserver",
    "FakeQuanterWithAbsMax", "MovingAverageAbsmaxQuanter",
    "AbsmaxObserver", "MovingAverageAbsmaxObserver",
    "QAT", "PTQ", "QuantedLinear", "Int8Linear", "quanter",
]


# ---------------------------------------------------------------------------
# fake quantization (straight-through estimator)
# ---------------------------------------------------------------------------

class _FakeQuant(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bits):
        qmax = float(2 ** (bits - 1) - 1)
        s = torch.clamp(scale, min=1e-9)
        ctx.save_for_backward(torch.abs(x) <= s)
        q = torch.clamp(torch.round(x / s * qmax), -qmax, qmax)
        return _div(q * s, qmax)

    @staticmethod
    def backward(ctx, g):
        (mask,) = ctx.saved_tensors
        return g * mask.to(g.dtype), None, None


def fake_quant(x, scale, bits: int = 8):
    """Differentiable (STE) fake quantization of ``x`` to ``bits`` bits
    against ``scale`` (a number or a tensor that broadcasts with ``x``)."""
    s = (scale.to(x.device) if isinstance(scale, torch.Tensor)
         else torch.full((), scale, dtype=torch.float32, device=x.device))
    return _FakeQuant.apply(x, s, bits)


def _absmax(x) -> float:
    return float(x.detach().abs().max())


# ---------------------------------------------------------------------------
# observers and quanters
# ---------------------------------------------------------------------------

class BaseObserver(Layer):
    """Collects activation statistics during PTQ calibration; the forward
    returns its input unchanged."""

    def __init__(self, quant_bits: int = 8):
        super().__init__()
        self.quant_bits = quant_bits
        self._scale = None

    def scales(self):
        return self._scale

    def forward(self, x):
        self._observe(x)
        return x

    def _observe(self, x):  # pragma: no cover - abstract
        raise NotImplementedError


class AbsmaxObserver(BaseObserver):
    """The running max of ``|x|``."""

    def _observe(self, x):
        m = _absmax(x)
        self._scale = m if self._scale is None else max(self._scale, m)


class MovingAverageAbsmaxObserver(BaseObserver):
    """A moving average of each call's ``max|x|`` (rate ``moving_rate``)."""

    def __init__(self, quant_bits: int = 8, moving_rate: float = 0.9):
        super().__init__(quant_bits)
        self.moving_rate = moving_rate

    def _observe(self, x):
        m = _absmax(x)
        self._scale = (m if self._scale is None
                       else self.moving_rate * self._scale
                       + (1 - self.moving_rate) * m)


class BaseQuanter(Layer):
    """Applies fake quantization in the forward pass (QAT)."""

    def __init__(self, quant_bits: int = 8):
        super().__init__()
        self.quant_bits = quant_bits
        self._scale = None

    def scales(self):
        return self._scale


class FakeQuanterWithAbsMax(BaseQuanter):
    """Per-tensor fake quanter: the scale is a moving average of each
    call's ``max|x|``, and the forward is ``fake_quant`` at that scale."""

    def __init__(self, quant_bits: int = 8, moving_rate: float = 0.9):
        super().__init__(quant_bits)
        self.moving_rate = moving_rate

    def forward(self, x):
        m = _absmax(x)
        self._scale = (m if self._scale is None
                       else self.moving_rate * self._scale
                       + (1 - self.moving_rate) * m)
        return fake_quant(x, self._scale, self.quant_bits)


MovingAverageAbsmaxQuanter = FakeQuanterWithAbsMax


class _QuanterFactory:
    def __init__(self, cls: Type, **kw):
        self.cls = cls
        self.kw = kw

    def instance(self):
        return self.cls(**self.kw)


def quanter(cls_or_name, **kw) -> _QuanterFactory:
    """A factory of quanters or observers for ``QuantConfig``:
    ``QuantConfig(activation=quanter(FakeQuanterWithAbsMax))``."""
    return _QuanterFactory(cls_or_name, **kw)


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------

class QuantConfig:
    """Which layers get which activation and weight quanters: per name,
    then per type, then the default."""

    def __init__(self, activation=None, weight=None):
        self.default = (activation, weight)
        self._by_type: Dict[type, tuple] = {}
        self._by_name: Dict[str, tuple] = {}

    def add_type_config(self, layer_type, activation=None, weight=None):
        for t in (layer_type if isinstance(layer_type, (list, tuple))
                  else [layer_type]):
            self._by_type[t] = (activation, weight)

    def add_name_config(self, names, activation=None, weight=None):
        for n in (names if isinstance(names, (list, tuple)) else [names]):
            self._by_name[n] = (activation, weight)

    def config_for(self, name: str, layer: Layer):
        if name in self._by_name:
            return self._by_name[name]
        for t, cfg in self._by_type.items():
            if isinstance(layer, t):
                return cfg
        return self.default


# ---------------------------------------------------------------------------
# quantized layers
# ---------------------------------------------------------------------------

class QuantedLinear(Layer):
    """``Linear`` under QAT/PTQ: ``quant(x) @ quant(weight) + bias``, with
    the wrapped layer's own parameters."""

    def __init__(self, linear, act_quanter=None, weight_quanter=None):
        super().__init__()
        self.weight = linear.weight
        self.bias = linear.bias
        self.activation_quanter = act_quanter
        self.weight_quanter = weight_quanter

    def forward(self, x):
        if self.activation_quanter is not None:
            x = self.activation_quanter(x)
        w = self.weight
        if self.weight_quanter is not None:
            w = self.weight_quanter(w)
        return F.linear(x, w, self.bias)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``[M, K]`` int8 @ ``[K, N]`` int8 -> int32 through ``torch._int_mm``,
    zero-padded where the shape breaks its rules on the card: M > 16 and
    K, N multiples of 8 are its checks, and cuBLASLt refuses some shapes
    that pass them (M 17, K 120, N 88 on an H100), so every dimension is
    padded to a multiple of 16 and M to at least 32."""
    M, K = a.shape
    N = b.shape[1]
    Mp, Kp, Np = (max(_round_up(M, 16), 32), _round_up(K, 16),
                  _round_up(N, 16))
    if (Mp, Kp) != (M, K):
        a = torch.nn.functional.pad(a, (0, Kp - K, 0, Mp - M))
    if (Kp, Np) != (K, N):
        b = torch.nn.functional.pad(b, (0, Np - N, 0, Kp - K))
    out = torch._int_mm(a.contiguous(), b.contiguous())
    return out if (Mp, Np) == (M, N) else out[:M, :N]


class Int8Linear(Layer):
    """The deployed int8 linear: per-output-column int8 weights (buffer
    ``weight_i8`` ``[in, out]``, scales ``w_scales``), the input quantized
    at ``act_scale``, int32 accumulation, an fp32 rescale and the bias.

    The rescale vector ``w_scales * act_scale / qmax**2`` is computed once
    and kept until ``w_scales`` changes (a new tensor, as ``to()`` makes,
    or an in-place write, as ``set_state_dict`` makes), with the same fp32
    operations in the same order as the reference's forward."""

    def __init__(self, weight_i8: np.ndarray, w_scales: np.ndarray,
                 act_scale: float, bias=None, bits: int = 8):
        super().__init__()
        dev = (bias.device if bias is not None
               else resolve_device(get_device()))
        self.register_buffer("weight_i8", torch.as_tensor(
            np.asarray(weight_i8, np.int8), device=dev))
        self.register_buffer("w_scales", torch.as_tensor(
            np.asarray(w_scales, np.float32), device=dev))
        self.act_scale = float(act_scale)
        self.bias = bias
        self.qmax = float(2 ** (bits - 1) - 1)
        self._rescale_of = None  # (w_scales, its version, the rescale)

    def _rescale(self):
        w = self.w_scales
        if (self._rescale_of is None or self._rescale_of[0] is not w
                or self._rescale_of[1] != w._version):
            self._rescale_of = (w, w._version, _div(
                w * self.act_scale, self.qmax * self.qmax))
        return self._rescale_of[2]

    def forward(self, x):
        a_s, qmax = self.act_scale, self.qmax
        xi8 = torch.clamp(torch.round(_div(x, a_s) * qmax), -qmax,
                          qmax).to(torch.int8)
        acc = int8_matmul(xi8.reshape(-1, xi8.shape[-1]), self.weight_i8)
        out = acc.to(torch.float32) * self._rescale()
        if self.bias is not None:
            out = out + self.bias
        return out.reshape(*x.shape[:-1], out.shape[-1]).to(x.dtype)


# ---------------------------------------------------------------------------
# workflows
# ---------------------------------------------------------------------------

class _QuantizeWorkflow:
    def __init__(self, config: QuantConfig):
        self.config = config

    @staticmethod
    def _maybe_copy(model: Layer, inplace: bool) -> Layer:
        return model if inplace else copy.deepcopy(model)

    def _wrap(self, model: Layer) -> Layer:
        for name, child in list(model.named_children()):
            act_f, w_f = self.config.config_for(name, child)
            if isinstance(child, Linear) and (act_f or w_f):
                aq = act_f.instance() if act_f else None
                wq = w_f.instance() if w_f else None
                setattr(model, name, QuantedLinear(child, aq, wq))
            else:
                self._wrap(child)
        return model

    def quantize(self, model: Layer, inplace: bool = True) -> Layer:
        return self._wrap(self._maybe_copy(model, inplace))

    def convert(self, model: Layer, inplace: bool = True) -> Layer:
        return _convert(self._maybe_copy(model, inplace))


class QAT(_QuantizeWorkflow):
    """Quantization-aware training: fake quanters (STE) in each configured
    ``Linear``, then ``convert``."""


class PTQ(_QuantizeWorkflow):
    """Post-training quantization: observers in each configured
    ``Linear``, calibrated by forward passes, then ``convert``."""


def _convert(model: Layer) -> Layer:
    """Each ``QuantedLinear`` replaced by an ``Int8Linear`` on its
    device."""
    for name, child in list(model.named_children()):
        if isinstance(child, QuantedLinear):
            w = child.weight.detach().cpu().numpy().astype(np.float32)
            bits = (child.weight_quanter.quant_bits
                    if child.weight_quanter else 8)
            qmax = 2 ** (bits - 1) - 1
            w_scales = np.maximum(np.abs(w).max(axis=0), 1e-9)
            wi8 = np.clip(np.round(w / w_scales * qmax), -qmax, qmax
                          ).astype(np.int8)
            aq = child.activation_quanter
            act_scale = (aq.scales() if aq is not None and aq.scales()
                         else 1.0)
            setattr(model, name, Int8Linear(
                wi8, w_scales, act_scale, bias=child.bias, bits=bits).to(
                    child.weight.device))
        else:
            _convert(child)
    return model
