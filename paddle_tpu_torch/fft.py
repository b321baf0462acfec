"""``paddle.fft``: discrete Fourier transforms (port of
``paddle_tpu/fft.py``) on ``torch.fft`` (cuFFT on the card).

The JAX package runs its transforms on the host (its TPU transport moves
no complex buffers); the port runs them on the tensor's device. Each
transform is a registered op, so ``all_ops()`` lists the reference's
names.
"""

from __future__ import annotations

import torch

from . import device as _device
from .core.tensor import as_port_tensor
from .ops.dispatch import run_op
from .ops.registry import register_op

__all__ = [
    "fft", "ifft", "fft2", "ifft2", "fftn", "ifftn",
    "rfft", "irfft", "rfft2", "irfft2", "rfftn", "irfftn",
    "hfft", "ihfft", "fftfreq", "rfftfreq", "fftshift", "ifftshift",
]


def _norm(norm):
    return norm or "backward"


def _wrap1(op_name, tfn):
    def op(x, n=None, axis=-1, norm="backward", name=None):
        return run_op(op_name, lambda a: tfn(a, n=n, dim=axis,
                                             norm=_norm(norm)), x)

    op.__name__ = op_name
    return register_op(op_name)(op)


def _wrapn(op_name, tfn, default_axes=None):
    def op(x, s=None, axes=default_axes, norm="backward", name=None):
        dims = None if axes is None else tuple(axes)
        return run_op(op_name, lambda a: tfn(
            a, s=None if s is None else tuple(s), dim=dims,
            norm=_norm(norm)), x)

    op.__name__ = op_name
    return register_op(op_name)(op)


fft = _wrap1("fft", torch.fft.fft)
ifft = _wrap1("ifft", torch.fft.ifft)
rfft = _wrap1("rfft", torch.fft.rfft)
irfft = _wrap1("irfft", torch.fft.irfft)
hfft = _wrap1("hfft", torch.fft.hfft)
ihfft = _wrap1("ihfft", torch.fft.ihfft)

fftn = _wrapn("fftn", torch.fft.fftn)
ifftn = _wrapn("ifftn", torch.fft.ifftn)
rfftn = _wrapn("rfftn", torch.fft.rfftn)
irfftn = _wrapn("irfftn", torch.fft.irfftn)

fft2 = _wrapn("fft2", torch.fft.fftn, (-2, -1))
ifft2 = _wrapn("ifft2", torch.fft.ifftn, (-2, -1))
rfft2 = _wrapn("rfft2", torch.fft.rfftn, (-2, -1))
irfft2 = _wrapn("irfft2", torch.fft.irfftn, (-2, -1))


@register_op("fftshift")
def fftshift(x, axes=None, name=None):
    return run_op("fftshift", lambda a: torch.fft.fftshift(a, dim=axes), x)


@register_op("ifftshift")
def ifftshift(x, axes=None, name=None):
    return run_op("ifftshift", lambda a: torch.fft.ifftshift(a, dim=axes), x)


def _dev():
    return _device.resolve_device(_device.get_device())


@register_op("fftfreq", differentiable=False)
def fftfreq(n, d=1.0, dtype=None, name=None):
    from .core.dtype import convert_dtype

    return as_port_tensor(torch.fft.fftfreq(
        n, d=d, dtype=convert_dtype(dtype) or torch.float32, device=_dev()))


@register_op("rfftfreq", differentiable=False)
def rfftfreq(n, d=1.0, dtype=None, name=None):
    from .core.dtype import convert_dtype

    return as_port_tensor(torch.fft.rfftfreq(
        n, d=d, dtype=convert_dtype(dtype) or torch.float32, device=_dev()))
