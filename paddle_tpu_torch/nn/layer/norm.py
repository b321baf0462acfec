"""``BatchNorm2D`` and ``LayerNorm`` (counterpart of
``paddle_tpu/nn/layer/norm.py``). BatchNorm: weight 1, bias 0, running
mean 0 and variance 1 in fp32 buffers ``_mean`` / ``_variance``, Paddle's
momentum convention (0.9 keeps 90 % of the running value);
``nn.functional.batch_norm`` updates them while training. LayerNorm:
``weight`` 1 and ``bias`` 0 over the trailing ``normalized_shape`` (either
left out with ``False`` as its attr), through ``nn.functional.layer_norm``
(the population variance)."""

from __future__ import annotations

import torch

from ...device import get_device, resolve_device
from .. import functional as F
from .. import initializer as I
from .layers import Layer

__all__ = ["BatchNorm2D", "LayerNorm"]


class _BatchNormBase(Layer):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None):
        super().__init__()
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        self.weight = self.create_parameter(
            [num_features], attr=weight_attr,
            default_initializer=I.Constant(1.0))
        self.bias = self.create_parameter([num_features], attr=bias_attr,
                                          is_bias=True)
        dev = resolve_device(get_device())
        self.register_buffer("_mean", torch.zeros(num_features, device=dev))
        self.register_buffer("_variance",
                             torch.ones(num_features, device=dev))

    def forward(self, x):
        return F.batch_norm(
            x, self._mean, self._variance, self.weight, self.bias,
            training=self.training, momentum=self._momentum,
            epsilon=self._epsilon, data_format=self._data_format,
            use_global_stats=self._use_global_stats)


class BatchNorm2D(_BatchNormBase):
    pass


class LayerNorm(Layer):
    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        self.weight = None if weight_attr is False else self.create_parameter(
            self._normalized_shape, attr=weight_attr,
            default_initializer=I.Constant(1.0))
        self.bias = None if bias_attr is False else self.create_parameter(
            self._normalized_shape, attr=bias_attr, is_bias=True)

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight, self.bias,
                            self._epsilon)
