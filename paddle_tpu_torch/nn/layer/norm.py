"""The normalization layers (counterpart of
``paddle_tpu/nn/layer/norm.py``). BatchNorm (``BatchNorm``,
``BatchNorm1D/2D/3D``, ``SyncBatchNorm``): weight 1, bias 0, running
mean 0 and variance 1 in fp32 buffers ``_mean`` / ``_variance``, Paddle's
momentum convention (0.9 keeps 90 % of the running value);
``nn.functional.batch_norm`` updates them while training.
``SyncBatchNorm`` normalizes with the whole batch's statistics while
training on data-parallel ranks (the reference's, where the batch axis is
sharded over ``dp`` under SPMD): each channel's sum and count, then its
sum of squared deviations from the whole batch's mean, are all-reduced
in fp32 over the data-parallel group (the one a ``DataParallel``
over the layer hands it, else the world), and so are the backward's two
per-channel sums; the running mean and (biased) variance follow the whole
batch's. On one rank, in eval mode and with ``use_global_stats`` it is
``BatchNorm``, bit for bit. ``convert_sync_batchnorm`` swaps it in,
sharing the parameters and buffers. LayerNorm: ``weight`` 1 and
``bias`` 0 over the trailing ``normalized_shape`` (either left out with
``False`` as its attr), the population variance. ``RMSNorm``,
``GroupNorm`` (gain and bias per channel, either left out with
``False``), ``InstanceNorm1D/2D/3D``
(``weight_attr=False`` leaves out both; no running statistics),
``LocalResponseNorm``; ``SpectralNorm`` raises, as in the JAX
package."""

from __future__ import annotations

import torch
import torch.distributed as dist

from ...device import get_device, resolve_device, set_device
from .. import functional as F
from .. import initializer as I
from .layers import Layer

__all__ = [
    "BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D",
    "SyncBatchNorm", "LayerNorm", "GroupNorm", "InstanceNorm1D",
    "InstanceNorm2D", "InstanceNorm3D", "LocalResponseNorm", "RMSNorm",
    "SpectralNorm",
]


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


class BatchNorm(_BatchNormBase):
    pass


class BatchNorm1D(_BatchNormBase):
    pass


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    pass


class _SyncBatchNormFn(torch.autograd.Function):
    """Batch normalization of ``x`` [N, C, ...] over the whole batch of
    the ranks of ``group``, in fp32; returns (y in x's type, mean, biased
    variance)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, group):
        from ...distributed import _comm

        dims = [0] + list(range(2, x.dim()))
        shape = [1, -1] + [1] * (x.dim() - 2)
        xf = x.float()
        local = torch.cat([xf.sum(dims),
                           xf.new_full((1,), xf.numel() // xf.shape[1])])
        total = _comm.all_reduce(local, group)
        count = total[-1]
        mean = total[:-1] / count
        xm = xf - mean.view(shape)
        var = _comm.all_reduce((xm * xm).sum(dims), group) / count
        invstd = torch.rsqrt(var + eps)
        y = xm * invstd.view(shape)
        if weight is not None:
            y = y * weight.float().view(shape)
        if bias is not None:
            y = y + bias.float().view(shape)
        ctx.save_for_backward(x, weight, mean, invstd, count)
        ctx.group = group
        ctx.bias_dtype = None if bias is None else bias.dtype
        ctx.mark_non_differentiable(mean, var)
        return y.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        from ...distributed import _comm

        x, weight, mean, invstd, count = ctx.saved_tensors
        dims = [0] + list(range(2, x.dim()))
        shape = [1, -1] + [1] * (x.dim() - 2)
        xhat = (x.float() - mean.view(shape)) * invstd.view(shape)
        dyf = dy.float()
        sum_dy = dyf.sum(dims)
        sum_dy_xhat = (dyf * xhat).sum(dims)
        c = mean.numel()
        # the whole batch's means of the cotangent and of its product
        # with the normalized input
        g = _comm.all_reduce(torch.cat([sum_dy, sum_dy_xhat]),
                             ctx.group) / count
        scale = invstd if weight is None else invstd * weight.float()
        dx = (dyf - g[:c].view(shape) - xhat * g[c:].view(shape)) \
            * scale.view(shape)
        dw = sum_dy_xhat.to(weight.dtype) if weight is not None else None
        db = None if ctx.bias_dtype is None else sum_dy.to(ctx.bias_dtype)
        return dx.to(x.dtype), dw, db, None, None


class SyncBatchNorm(_BatchNormBase):
    # the process group whose ranks share the batch: the one a
    # ``DataParallel`` over this layer hands it, else the world
    _group = None

    def _sync_group(self):
        if not self.training or self._use_global_stats:
            return None
        if self._group is not None:
            return self._group
        if dist.is_initialized() and dist.get_world_size() > 1:
            return dist.group.WORLD
        return None

    def forward(self, x):
        group = self._sync_group()
        if group is None:
            return super().forward(x)
        channel_axis = (1 if self._data_format.startswith("NC")
                        and x.dim() > 1 else x.dim() - 1)
        xc = x.movedim(channel_axis, 1) if channel_axis != 1 else x
        y, mean, var = _SyncBatchNormFn.apply(xc, self.weight, self.bias,
                                              self._epsilon, group)
        m = self._momentum
        with torch.no_grad():
            self._mean.copy_(m * self._mean + (1 - m) * mean)
            self._variance.copy_(m * self._variance + (1 - m) * var)
        return y.movedim(1, channel_axis) if channel_axis != 1 else y

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        """``layer`` with every BatchNorm below it (itself included)
        replaced by a ``SyncBatchNorm`` that holds the same parameters and
        buffers."""
        if isinstance(layer, _BatchNormBase) and not isinstance(
                layer, SyncBatchNorm):
            prev = get_device()
            try:  # build where the layer lives: its tensors are taken over
                set_device(str(layer._mean.device))
                new = SyncBatchNorm(layer._num_features, layer._momentum,
                                    layer._epsilon,
                                    data_format=layer._data_format)
            finally:
                set_device(prev)
            new.weight = layer.weight
            new.bias = layer.bias
            new.register_buffer("_mean", layer._mean)
            new.register_buffer("_variance", layer._variance)
            return new
        for name, sub in list(layer._modules.items()):
            layer._modules[name] = cls.convert_sync_batchnorm(sub)
        return layer


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


class RMSNorm(Layer):
    def __init__(self, hidden_size, epsilon=1e-6, weight_attr=None,
                 name=None):
        super().__init__()
        self._epsilon = epsilon
        self.weight = self.create_parameter(
            [hidden_size], attr=weight_attr,
            default_initializer=I.Constant(1.0))

    def forward(self, x):
        return F.rms_norm(x, self.weight, self._epsilon)


class GroupNorm(Layer):
    def __init__(self, num_groups, num_channels, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self._num_groups = num_groups
        self._epsilon = epsilon
        self.weight = None if weight_attr is False else self.create_parameter(
            [num_channels], attr=weight_attr,
            default_initializer=I.Constant(1.0))
        self.bias = None if bias_attr is False else self.create_parameter(
            [num_channels], attr=bias_attr, is_bias=True)

    def forward(self, x):
        return F.group_norm(x, self._num_groups, self._epsilon, self.weight,
                            self.bias)


class _InstanceNormBase(Layer):
    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self._epsilon = epsilon
        if weight_attr is False:
            self.weight = None
            self.bias = None
        else:
            self.weight = self.create_parameter(
                [num_features], attr=weight_attr,
                default_initializer=I.Constant(1.0))
            self.bias = self.create_parameter([num_features], attr=bias_attr,
                                              is_bias=True)

    def forward(self, x):
        return F.instance_norm(x, weight=self.weight, bias=self.bias,
                               eps=self._epsilon)


class InstanceNorm1D(_InstanceNormBase):
    pass


class InstanceNorm2D(_InstanceNormBase):
    pass


class InstanceNorm3D(_InstanceNormBase):
    pass


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.size, self.alpha, self.beta, self.k = size, alpha, beta, k

    def forward(self, x):
        return F.local_response_norm(x, self.size, self.alpha, self.beta,
                                     self.k)


class SpectralNorm(Layer):
    def __init__(self, weight_shape, dim=0, power_iters=1, eps=1e-12,
                 name=None):
        super().__init__()
        raise NotImplementedError(
            "SpectralNorm is not implemented, as in the JAX package")
