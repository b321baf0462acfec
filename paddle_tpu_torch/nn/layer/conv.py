"""``Conv2D`` (counterpart of ``paddle_tpu/nn/layer/conv.py``): Paddle's
``[out, in/groups, kh, kw]`` weight, which is torch's OIHW; an NHWC layer
takes and returns NHWC activations, run by cuDNN as channels-last views."""

from __future__ import annotations

import numpy as np

from .. import functional as F
from .. import initializer as I
from .layers import Layer

__all__ = ["Conv2D"]


def _ntuple(v, n):
    return tuple(v) if isinstance(v, (list, tuple)) else (v,) * n


class Conv2D(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW"):
        super().__init__()
        if padding_mode != "zeros":
            raise NotImplementedError("Conv2D ports padding_mode='zeros'")
        self._in_channels = in_channels
        self._out_channels = out_channels
        self._kernel_size = _ntuple(kernel_size, 2)
        self._stride = stride
        self._padding = padding
        self._dilation = dilation
        self._groups = groups
        self._data_format = data_format
        fan_in = (in_channels // groups) * int(np.prod(self._kernel_size))
        k = 1.0 / np.sqrt(fan_in) if fan_in else 1.0
        self.weight = self.create_parameter(
            [out_channels, in_channels // groups, *self._kernel_size],
            attr=weight_attr, default_initializer=I.Uniform(-k, k))
        self.bias = self.create_parameter(
            [out_channels], attr=bias_attr, is_bias=True,
            default_initializer=I.Uniform(-k, k))

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups,
                        self._data_format)
