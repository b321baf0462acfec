"""The functional ops of the ported layers (counterpart of
``paddle_tpu/nn/functional/__init__.py``, and of
``paddle_tpu/ops/manipulation.py``'s ``flatten`` and ``pad``): the
activations, ``linear`` and ``bilinear``, the 1-D, 2-D and 3-D
convolutions and their transposes, every pool (max, average, adaptive,
unpool, Lp and fractional), ``unfold``, ``interpolate``, ``pixel_shuffle``
and ``pad``, the norms (batch, layer, RMS, instance, group, local
response, ``normalize``), the dropouts, ``embedding``,
``cosine_similarity``, ``sequence_mask`` and
``scaled_dot_product_attention``, and the ``flash_attention`` module
(``flash_attention``, ``flash_attn_unpadded``); the losses (``loss.py``:
``cross_entropy`` with its whole signature and every other loss of the
reference) and the sampling, pixel and random ops (``extras.py``:
``affine_grid``, ``grid_sample``, ``gumbel_softmax``, ``fold``, ...).

Each op keeps the JAX package's op name, which ``amp.cast_inputs`` keys
the AMP casts on, its signature, defaults and layouts at the public
function: Paddle's ``[out, in/groups, k...]`` conv weight (torch's OIHW),
the transposes' ``[in, out/groups, k...]``, the ``[in, out]`` linear
weight, and channel-last activations (``NLC``, ``NHWC``, ``NDHWC``),
which reach cuDNN as a channel-first view of the same memory (no copy).
Where the JAX package's arithmetic is not PyTorch's default, the port
computes the JAX package's: average pools divide by the count of real
elements (``exclusive``) or by the window, ``interpolate`` is
``jax.image.resize`` (half-pixel centres, antialiased when it shrinks,
Keys cubic with a = -0.5, ``align_corners`` ignored, ``"area"`` linear),
``pad`` pairs run from the last axis back and ``pixel_shuffle`` and
``group_norm`` read channel-first layouts whatever ``data_format`` says.
None of these ops is a TPU kernel of the JAX package (XLA computed them),
so they run on PyTorch's own operators, as the JAX package left them to
XLA. Attention is the exception: without a mask or dropout it runs the
flash kernels of ``ops/kernels/flash_attention`` (the JAX package's
Pallas kernels).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ...amp import cast_inputs
from ...ops.kernels import flash_attention as _fa
from .. import initializer as _init

__all__ = [
    # activations
    "relu", "relu6", "gelu", "silu", "swish", "sigmoid", "log_sigmoid",
    "tanh", "softmax", "log_softmax", "leaky_relu", "elu", "selu", "celu",
    "prelu", "hardtanh", "hardshrink", "hardsigmoid", "hardswish", "mish",
    "softplus", "softshrink", "softsign", "tanhshrink", "thresholded_relu",
    "glu", "maxout",
    # linear / conv / pool
    "linear", "bilinear", "conv1d", "conv2d", "conv3d", "conv1d_transpose",
    "conv2d_transpose", "conv3d_transpose", "max_pool1d", "max_pool2d",
    "max_pool3d", "avg_pool1d", "avg_pool2d", "avg_pool3d",
    "adaptive_avg_pool1d", "adaptive_avg_pool2d", "adaptive_avg_pool3d",
    "adaptive_max_pool1d", "adaptive_max_pool2d", "adaptive_max_pool3d",
    "max_unpool1d", "max_unpool2d", "max_unpool3d", "lp_pool1d",
    "lp_pool2d", "fractional_max_pool2d", "fractional_max_pool3d",
    "unfold", "interpolate", "upsample", "pixel_shuffle", "pad", "flatten",
    # norm / dropout / embedding
    "batch_norm", "layer_norm", "rms_norm", "instance_norm", "group_norm",
    "local_response_norm", "normalize", "dropout", "dropout2d",
    "dropout3d", "alpha_dropout", "feature_alpha_dropout", "embedding",
    "cosine_similarity",
    # attention
    "sequence_mask", "scaled_dot_product_attention", "flash_attention"]

_CHANNEL_LAST = ("NHWC", "NLC", "NDHWC")


def _div(a, k):
    """``a / k`` for a Python number ``k`` as a true division on every
    device, as XLA divides: CUDA divides a tensor by a host number through
    its reciprocal, one ulp off the quotient at times. The divisor is
    filled on the device (a tensor made from a host number would copy it
    there and wait)."""
    return a / torch.full((), k, dtype=a.dtype, device=a.device)


def _pair(v, n=2):
    """The JAX package's rule: a sequence of ``n`` as it is, another
    sequence repeated ``n`` times, a scalar ``n`` times."""
    if isinstance(v, (list, tuple)):
        return tuple(v) if len(v) == n else tuple(v) * n
    return (v,) * n


def _first(x, channel_last):
    """A channel-last tensor as a channel-first view (channels-last
    memory); a channel-first one as it is."""
    return x.movedim(-1, 1) if channel_last else x


def _last(y, channel_last):
    return y.movedim(1, -1) if channel_last else y


def _reshape_at(t, ndim, axis):
    """A 1-D ``t`` shaped to broadcast along ``axis`` of an ``ndim``
    tensor."""
    shape = [1] * ndim
    shape[axis] = t.shape[0]
    return t.reshape(shape)


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------

def relu(x, name=None):
    (x,) = cast_inputs("relu", x)
    return torch.relu(x)


def relu6(x, name=None):
    (x,) = cast_inputs("relu6", x)
    return F.relu6(x)


def sigmoid(x, name=None):
    (x,) = cast_inputs("sigmoid", x)
    return torch.sigmoid(x)


def log_sigmoid(x, name=None):
    (x,) = cast_inputs("log_sigmoid", x)
    return F.logsigmoid(x)


def tanh(x, name=None):
    (x,) = cast_inputs("tanh", x)
    return torch.tanh(x)


def hardsigmoid(x, name=None):
    """``clip(x / 6 + 1/2, 0, 1)``."""
    (x,) = cast_inputs("hardsigmoid", x)
    return F.hardsigmoid(x)


def hardswish(x, name=None):
    """``x * clip(x + 3, 0, 6) / 6``."""
    (x,) = cast_inputs("hardswish", x)
    return F.hardswish(x)


def mish(x, name=None):
    (x,) = cast_inputs("mish", x)
    return x * torch.tanh(F.softplus(x))


def softsign(x, name=None):
    (x,) = cast_inputs("softsign", x)
    return x / (1 + x.abs())


def tanhshrink(x, name=None):
    (x,) = cast_inputs("tanhshrink", x)
    return x - torch.tanh(x)


def log_softmax(x, axis=-1, dtype=None, name=None):
    """Log-softmax over ``axis``; ``dtype`` casts the input first.
    Black-listed under AMP: low-precision inputs go to fp32."""
    (x,) = cast_inputs("log_softmax", x)
    if dtype is not None:
        x = x.to(_DTYPES[dtype] if isinstance(dtype, str) else dtype)
    return torch.log_softmax(x, dim=axis)


def leaky_relu(x, negative_slope=0.01, name=None):
    (x,) = cast_inputs("leaky_relu", x)
    return torch.where(x >= 0, x, negative_slope * x)


def elu(x, alpha=1.0, name=None):
    (x,) = cast_inputs("elu", x)
    return torch.where(x > 0, x, alpha * torch.expm1(x))


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    (x,) = cast_inputs("selu", x)
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


def celu(x, alpha=1.0, name=None):
    (x,) = cast_inputs("celu", x)
    return torch.where(x > 0, x, alpha * torch.expm1(x / alpha))


def prelu(x, weight, data_format="NCHW", name=None):
    """``x`` where positive, else ``weight * x``: one weight for every
    element, or one per channel (axis 1, or the last axis when
    ``data_format`` is channel-last)."""
    x, weight = cast_inputs("prelu", x, weight)
    if weight.numel() == 1:
        return torch.where(x > 0, x, weight.reshape(()) * x)
    axis = 1 if data_format.startswith("NC") else x.dim() - 1
    return torch.where(x > 0, x, _reshape_at(weight.reshape(-1), x.dim(),
                                             axis) * x)


def hardtanh(x, min=-1.0, max=1.0, name=None):
    (x,) = cast_inputs("hardtanh", x)
    return torch.clamp(x, min, max)


def hardshrink(x, threshold=0.5, name=None):
    (x,) = cast_inputs("hardshrink", x)
    return torch.where(x.abs() > threshold, x, 0.0)


def softplus(x, beta=1.0, threshold=20.0, name=None):
    """``x`` where ``beta * x > threshold``, else ``log(1 + exp(beta *
    x)) / beta``."""
    (x,) = cast_inputs("softplus", x)
    return F.softplus(x, beta, threshold)


def softshrink(x, threshold=0.5, name=None):
    (x,) = cast_inputs("softshrink", x)
    return torch.where(x > threshold, x - threshold,
                       torch.where(x < -threshold, x + threshold, 0.0))


def thresholded_relu(x, threshold=1.0, value=0.0, name=None):
    (x,) = cast_inputs("thresholded_relu", x)
    return torch.where(x > threshold, x, value)


def glu(x, axis=-1, name=None):
    """The first half along ``axis`` times the sigmoid of the second."""
    (x,) = cast_inputs("glu", x)
    a, b = torch.chunk(x, 2, dim=axis)
    return a * torch.sigmoid(b)


def maxout(x, groups, axis=1, name=None):
    """The largest of each run of ``groups`` channels along ``axis``."""
    (x,) = cast_inputs("maxout", x)
    shape = list(x.shape)
    shape[axis] = shape[axis] // groups
    shape.insert(axis + 1, groups)
    return x.reshape(shape).amax(dim=axis + 1)


# ---------------------------------------------------------------------------
# linear / conv
# ---------------------------------------------------------------------------

def linear(x, weight, bias=None, name=None):
    """``x @ weight + bias`` with ``weight`` ``[in, out]``."""
    x, weight, bias = cast_inputs("linear", x, weight, bias)
    out = x @ weight
    return out if bias is None else out + bias


def bilinear(x1, x2, weight, bias=None, name=None):
    """``out[b, o] = x1[b] @ weight[o] @ x2[b] (+ bias[o])``, weight
    ``[out, in1, in2]``."""
    x1, x2, weight, bias = cast_inputs("bilinear", x1, x2, weight, bias)
    out = torch.einsum("bm,omn,bn->bo", x1, weight, x2)
    return out if bias is None else out + bias


def _conv_pads(padding, nd, in_sz, ks, st, dl):
    """Per-axis (low, high) padding by the JAX package's rule:
    ``"SAME"`` (XLA's: the output ``ceil(in / stride)``, the odd pixel
    high) or ``"VALID"``; ``2 * nd`` numbers as (low, high) pairs, axis by
    axis; else one or ``nd`` symmetric values."""
    if isinstance(padding, str):
        mode = padding.upper()
        if mode == "VALID":
            return [(0, 0)] * nd
        if mode != "SAME":
            raise ValueError(f"padding must be SAME or VALID, got "
                             f"{padding!r}")
        pads = []
        for i, k, s, d in zip(in_sz, ks, st, dl):
            total = max((-(-i // s) - 1) * s + (k - 1) * d + 1 - i, 0)
            pads.append((total // 2, total - total // 2))
        return pads
    if isinstance(padding, (list, tuple)) and len(padding) == 2 * nd:
        return [(int(padding[2 * i]), int(padding[2 * i + 1]))
                for i in range(nd)]
    return [(int(p), int(p)) for p in _pair(padding, nd)]


def _torch_pad(pads):
    """Per-axis (low, high) pairs in ``torch.nn.functional.pad``'s order
    (the last axis first)."""
    return [v for lo_hi in reversed(pads) for v in lo_hi]


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


def _conv_nd(x, weight, bias, stride, padding, dilation, groups, nd,
             data_format, op_name):
    x, weight, bias = cast_inputs(op_name, x, weight, bias)
    cl = data_format in _CHANNEL_LAST
    xc = _first(x, cl)
    st, dl = _pair(stride, nd), _pair(dilation, nd)
    pads = _conv_pads(padding, nd, xc.shape[2:], weight.shape[2:], st, dl)
    if all(lo == hi for lo, hi in pads):
        out = _CONV[nd](xc, weight, bias, st, [lo for lo, _ in pads], dl,
                        groups)
    else:
        out = _CONV[nd](F.pad(xc, _torch_pad(pads)), weight, bias, st, 0,
                        dl, groups)
    return _last(out, cl)


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None):
    """1-D convolution, weight ``[out, in/groups, k]``."""
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 1,
                    "NLC" if data_format == "NLC" else "NCL", "conv1d")


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    """2-D convolution, weight ``[out, in/groups, kh, kw]``."""
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 2,
                    data_format, "conv2d")


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW", name=None):
    """3-D convolution, weight ``[out, in/groups, kd, kh, kw]``."""
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 3,
                    data_format, "conv3d")


def _conv_transpose_nd(x, weight, bias, stride, padding, output_padding,
                       dilation, groups, nd, data_format, output_size,
                       op_name):
    """The gradient of a convolution with weight ``[in, out/groups,
    k...]``: output ``(I - 1) * stride - 2 * padding + dilation * (k - 1)
    + 1 + output_padding`` (``output_size`` sets ``output_padding`` to
    reach it). PyTorch's operator refuses an ``output_padding`` not below
    the stride or the dilation, which the JAX package takes: then the
    unpadded full output is cropped and zero-extended."""
    x, weight, bias = cast_inputs(op_name, x, weight, bias)
    cl = data_format in _CHANNEL_LAST
    xc = _first(x, cl)
    st, dl, p = _pair(stride, nd), _pair(dilation, nd), _pair(padding, nd)
    ks, in_sz = weight.shape[2:], xc.shape[2:]
    base = [(i - 1) * s - 2 * pp + d * (k - 1) + 1
            for i, s, pp, d, k in zip(in_sz, st, p, dl, ks)]
    if output_size is not None:
        want = _pair(output_size, nd)[-nd:]
        op = tuple(int(w) - b for w, b in zip(want, base))
    else:
        op = _pair(output_padding, nd)
    if all(0 <= o < max(s, d) for o, s, d in zip(op, st, dl)):
        out = _CONV_T[nd](xc, weight, bias, st, p, op, groups, dl)
    else:
        full = _CONV_T[nd](xc, weight, None, st, 0, 0, groups, dl)
        for a, (pp, b, o) in enumerate(zip(p, base, op)):
            full = full.narrow(2 + a, pp, min(b + o, full.shape[2 + a] - pp))
            extra = b + o - full.shape[2 + a]
            if extra > 0:
                pads = [(0, 0)] * nd
                pads[a] = (0, extra)
                full = F.pad(full, _torch_pad(pads))
        out = full if bias is None else full + _reshape_at(bias, full.dim(),
                                                           1)
    return _last(out, cl)


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     data_format="NCL", output_size=None, name=None):
    return _conv_transpose_nd(x, weight, bias, stride, padding,
                              output_padding, dilation, groups, 1,
                              data_format, output_size, "conv1d_transpose")


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     data_format="NCHW", output_size=None, name=None):
    return _conv_transpose_nd(x, weight, bias, stride, padding,
                              output_padding, dilation, groups, 2,
                              data_format, output_size, "conv2d_transpose")


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     data_format="NCDHW", output_size=None, name=None):
    return _conv_transpose_nd(x, weight, bias, stride, padding,
                              output_padding, dilation, groups, 3,
                              data_format, output_size, "conv3d_transpose")


# ---------------------------------------------------------------------------
# pools
# ---------------------------------------------------------------------------

_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_ADAPTIVE = {("avg", 1): F.adaptive_avg_pool1d,
             ("avg", 2): F.adaptive_avg_pool2d,
             ("avg", 3): F.adaptive_avg_pool3d,
             ("max", 1): F.adaptive_max_pool1d,
             ("max", 2): F.adaptive_max_pool2d,
             ("max", 3): F.adaptive_max_pool3d}


def _ceil_extra(i, k, s, p):
    """``ceil_mode``'s extra high padding and output count: the last
    window may overhang the input but must start inside input plus
    padding."""
    of = (i + 2 * p - k) // s + 1
    oc = -((-(i + 2 * p - k)) // s) + 1
    if oc > of and (oc - 1) * s >= i + p:
        oc = of
    return max(0, (oc - 1) * s + k - i - 2 * p), oc


def _avg_pool(xc, nd, ks, st, pd, ceil_mode, count_include_pad, divisor):
    if nd == 1:  # avg_pool1d takes no divisor_override
        return F.avg_pool2d(xc.unsqueeze(-2), (1, ks[0]), (1, st[0]),
                            (0, pd[0]), ceil_mode, count_include_pad,
                            divisor).squeeze(-2)
    fn = F.avg_pool2d if nd == 2 else F.avg_pool3d
    return fn(xc, ks, st, pd, ceil_mode, count_include_pad, divisor)


def _pool_nd(x, kernel, stride, padding, nd, kind, ceil_mode, exclusive,
             data_format, op_name):
    """Max or average pooling by the JAX package's rule: padding reads
    -inf (max) or 0 (average); ``ceil_mode`` pads the high side by
    ``_ceil_extra``; an average divides by the count of real elements
    where ``exclusive`` and any padding, else by the window. PyTorch's
    operators give exactly that while the padding is at most half the
    window; beyond, the padding is made explicit."""
    (x,) = cast_inputs(op_name, x)
    ks = _pair(kernel, nd)
    st = _pair(stride if stride is not None else kernel, nd)
    pd = _pair(padding, nd)[:nd]
    cl = data_format in _CHANNEL_LAST
    xc = _first(x, cl)
    window = int(np.prod(ks))
    if all(p <= k // 2 for p, k in zip(pd, ks)):
        if kind == "max":
            out = _MAX_POOL[nd](xc, ks, st, pd, ceil_mode=ceil_mode)
        elif exclusive:
            out = _avg_pool(xc, nd, ks, st, pd, ceil_mode, False, None)
        else:
            out = _avg_pool(xc, nd, ks, st, pd, ceil_mode, True, window)
        return _last(out, cl)
    up = [_ceil_extra(i, k, s, p)[0] if ceil_mode else 0
          for i, k, s, p in zip(xc.shape[2:], ks, st, pd)]
    pads = _torch_pad([(p, p + u) for p, u in zip(pd, up)])
    if kind == "max":
        out = _MAX_POOL[nd](F.pad(xc, pads, value=-math.inf), ks, st)
    else:
        out = _avg_pool(F.pad(xc, pads), nd, ks, st, 0, False, True, window)
        if exclusive:
            ones = F.pad(torch.ones_like(xc[:1, :1]), pads)
            out = out * window / (_avg_pool(ones, nd, ks, st, 0, False,
                                            True, window) * window)
    return _last(out, cl)


def _window_axes(in_sz, adaptive=None, ks=None, st=None, pd=None,
                 ceil_mode=False):
    """Per-axis (starts, K, ends) of the pooling windows: strided
    (optionally ceil-counted) or adaptive (output cell i pools
    ``[floor(i*I/O), ceil((i+1)*I/O))``)."""
    axes = []
    for a, i in enumerate(in_sz):
        if adaptive is not None:
            o = adaptive[a]
            starts = np.floor(np.arange(o) * i / o).astype(np.int64)
            ends = np.ceil((np.arange(o) + 1) * i / o).astype(np.int64)
            k = int((ends - starts).max())
        else:
            o = (_ceil_extra(i, ks[a], st[a], pd[a])[1] if ceil_mode
                 else (i + 2 * pd[a] - ks[a]) // st[a] + 1)
            starts = np.arange(o) * st[a] - pd[a]
            k = ks[a]
            ends = starts + k
        axes.append((starts, k, ends))
    return axes


def _max_pool_gather(x, axes):
    """(max, mask) over explicit windows of a channel-first ``x``: the
    values of every window gathered, the padding at -inf, the largest and
    its index, flat over the input's spatial axes (the JAX package's mask
    path, for windows PyTorch's operators do not make)."""
    nd = len(axes)
    in_sz = tuple(x.shape[2:])
    w = x
    valid = None
    for d, (starts, k, ends) in enumerate(axes):
        idx = starts[:, None] + np.arange(k)[None, :]
        ok = (idx >= 0) & (idx < ends[:, None]) & (idx < in_sz[d])
        flat = torch.as_tensor(np.clip(idx, 0, in_sz[d] - 1).reshape(-1),
                               device=x.device)
        w = w.index_select(2 + 2 * d, flat)
        w = w.reshape(w.shape[:2 + 2 * d] + idx.shape + w.shape[3 + 2 * d:])
        shape = ([1] * d + [ok.shape[0]] + [1] * (nd - 1 - d)
                 + [1] * d + [ok.shape[1]] + [1] * (nd - 1 - d))
        ok = torch.as_tensor(ok.reshape(shape), device=x.device)
        valid = ok if valid is None else valid & ok
    perm = [0, 1] + [2 + 2 * d for d in range(nd)] + [3 + 2 * d
                                                       for d in range(nd)]
    w = w.permute(perm)
    w = w.reshape(w.shape[:2 + nd] + (-1,))
    valid = valid.reshape(valid.shape[:nd] + (-1,))
    w = torch.where(valid, w, -math.inf)
    out, loc = w.max(dim=-1)
    gflat = torch.zeros_like(loc)
    ks = [a[1] for a in axes]
    for d in range(nd - 1, -1, -1):
        ld = loc % ks[d]
        loc = loc // ks[d]
        starts = torch.as_tensor(axes[d][0], device=x.device).reshape(
            (1, 1) + (1,) * d + (-1,) + (1,) * (nd - 1 - d))
        gflat = gflat + (starts + ld) * int(np.prod(in_sz[d + 1:],
                                                    dtype=np.int64))
    return out, gflat.to(torch.int32)


def _max_pool_mask(x, nd, kernel_size, stride, padding, ceil_mode,
                   data_format):
    """``max_poolNd(return_mask=True)``: the output and the flat index of
    each maximum over the input's spatial axes (int32), channel-first
    layouts only, as in the JAX package."""
    if data_format in _CHANNEL_LAST:
        raise ValueError(
            f"return_mask pooling supports channel-first layouts only (got "
            f"data_format={data_format!r})")
    (x,) = cast_inputs("max_pool_with_mask", x)
    ks = _pair(kernel_size, nd)
    st = _pair(stride or kernel_size, nd)
    pd = _pair(padding, nd)[:nd]
    if all(p <= k // 2 for p, k in zip(pd, ks)):
        out, idx = _MAX_POOL[nd](x, ks, st, pd, ceil_mode=ceil_mode,
                                 return_indices=True)
        return out, idx.to(torch.int32)
    return _max_pool_gather(x, _window_axes(tuple(x.shape[2:]), ks=ks,
                                            st=st, pd=pd,
                                            ceil_mode=ceil_mode))


def max_pool1d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False, data_format="NCL", name=None):
    if return_mask:
        return _max_pool_mask(x, 1, kernel_size, stride, padding, ceil_mode,
                              data_format)
    return _pool_nd(x, kernel_size, stride, padding, 1, "max", ceil_mode,
                    True, data_format, "max_pool1d")


def max_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False, data_format="NCHW", name=None):
    if return_mask:
        return _max_pool_mask(x, 2, kernel_size, stride, padding, ceil_mode,
                              data_format)
    return _pool_nd(x, kernel_size, stride, padding, 2, "max", ceil_mode,
                    True, data_format, "max_pool2d")


def max_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False, data_format="NCDHW", name=None):
    if return_mask:
        return _max_pool_mask(x, 3, kernel_size, stride, padding, ceil_mode,
                              data_format)
    return _pool_nd(x, kernel_size, stride, padding, 3, "max", ceil_mode,
                    True, data_format, "max_pool3d")


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, data_format="NCL", name=None):
    return _pool_nd(x, kernel_size, stride, padding, 1, "avg", ceil_mode,
                    exclusive, data_format, "avg_pool1d")


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    """``divisor_override`` is taken and ignored, as in the JAX
    package."""
    return _pool_nd(x, kernel_size, stride, padding, 2, "avg", ceil_mode,
                    exclusive, data_format, "avg_pool2d")


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW",
               name=None):
    return _pool_nd(x, kernel_size, stride, padding, 3, "avg", ceil_mode,
                    exclusive, data_format, "avg_pool3d")


def _adaptive_pool(x, output_size, nd, kind, data_format="NCHW"):
    """Output cell i pools ``[floor(i*I/O), ceil((i+1)*I/O))`` on each
    axis (PyTorch's adaptive windows are the same)."""
    (x,) = cast_inputs(f"adaptive_{kind}_pool", x)
    cl = data_format in _CHANNEL_LAST
    out = _ADAPTIVE[(kind, nd)](_first(x, cl), _pair(output_size, nd))
    return _last(out, cl)


def _adaptive_max_mask(x, output_size, nd):
    (x,) = cast_inputs("max_pool_with_mask", x)
    out, idx = _ADAPTIVE[("max", nd)](x, _pair(output_size, nd),
                                      return_indices=True)
    return out, idx.to(torch.int32)


def adaptive_avg_pool1d(x, output_size, name=None):
    return _adaptive_pool(x, output_size, 1, "avg", "NCL")


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    return _adaptive_pool(x, output_size, 2, "avg", data_format)


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    return _adaptive_pool(x, output_size, 3, "avg", data_format)


def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    if return_mask:
        return _adaptive_max_mask(x, output_size, 1)
    return _adaptive_pool(x, output_size, 1, "max", "NCL")


def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    if return_mask:
        return _adaptive_max_mask(x, output_size, 2)
    return _adaptive_pool(x, output_size, 2, "max", "NCHW")


def adaptive_max_pool3d(x, output_size, return_mask=False, name=None):
    if return_mask:
        return _adaptive_max_mask(x, output_size, 3)
    return _adaptive_pool(x, output_size, 3, "max", "NCDHW")


def _max_unpool(x, indices, kernel, stride, padding, nd, output_size,
                op_name):
    """Each pooled value written back at its mask index (flat over the
    output's spatial axes), zeros elsewhere. The output is ``(I - 1) *
    stride - 2 * padding + kernel`` unless ``output_size`` names it (its
    last ``nd`` entries); an index past it raises, as in the JAX package
    (one read of the largest index)."""
    ks = _pair(kernel, nd)
    st = _pair(stride if stride is not None else kernel, nd)
    pd = _pair(padding, nd)
    in_sz = tuple(x.shape[2:])
    if output_size is None:
        out_sz = tuple((in_sz[d] - 1) * st[d] - 2 * pd[d] + ks[d]
                       for d in range(nd))
    else:
        out_sz = tuple(int(s) for s in tuple(output_size)[-nd:])
    bound = int(np.prod(out_sz, dtype=np.int64))
    hi = int(indices.max().item()) if indices.numel() else -1
    if hi >= bound:
        raise ValueError(
            f"{op_name}: index {hi} is out of range for output size "
            f"{out_sz} ({bound} positions) — pass the pooled input's "
            "original spatial dims as output_size (required when the pool "
            "used ceil_mode, whose extent the default floor-mode formula "
            "cannot reconstruct)")
    (x,) = cast_inputs(op_name, x)
    n, c = x.shape[:2]
    idx = indices.reshape(n * c, -1).long()
    # overlapping windows may name one position twice: the last value
    # written wins and takes the gradient, as in XLA's scatter
    pos = torch.arange(idx.shape[1], device=x.device).expand_as(idx)
    last = torch.full((n * c, bound), -1, dtype=torch.long,
                      device=x.device).scatter_reduce(1, idx, pos, "amax")
    vals = torch.where(last.gather(1, idx) == pos, x.reshape(n * c, -1), 0)
    out = x.new_zeros((n * c, bound)).scatter_add(1, idx, vals)
    return out.reshape((n, c) + out_sz)


def max_unpool1d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCL", output_size=None, name=None):
    return _max_unpool(x, indices, kernel_size, stride, padding, 1,
                       output_size, "max_unpool1d")


def max_unpool2d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCHW", output_size=None, name=None):
    return _max_unpool(x, indices, kernel_size, stride, padding, 2,
                       output_size, "max_unpool2d")


def max_unpool3d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCDHW", output_size=None, name=None):
    return _max_unpool(x, indices, kernel_size, stride, padding, 3,
                       output_size, "max_unpool3d")


def _lp_pool(x, p, kernel, stride, padding, nd, ceil_mode, data_format,
             op_name):
    """``(sum over the window of x ** p) ** (1 / p)``, ``p = inf`` the
    max, in the JAX package's three steps (each its own op name under
    AMP)."""
    if np.isinf(p):
        return _pool_nd(x, kernel, stride, padding, nd, "max", ceil_mode,
                        True, data_format, op_name)
    window = float(np.prod(_pair(kernel, nd)))
    (x,) = cast_inputs(op_name + "_pow", x)
    s = _pool_nd(x ** p, kernel, stride, padding, nd, "avg", ceil_mode,
                 False, data_format, op_name + "_sum")
    (s,) = cast_inputs(op_name + "_root", s)
    return (s * window) ** (1.0 / p)


def lp_pool1d(x, norm_type, kernel_size, stride=None, padding=0,
              ceil_mode=False, data_format="NCL", name=None):
    return _lp_pool(x, norm_type, kernel_size, stride, padding, 1,
                    ceil_mode, data_format, "lp_pool1d")


def lp_pool2d(x, norm_type, kernel_size, stride=None, padding=0,
              ceil_mode=False, data_format="NCHW", name=None):
    return _lp_pool(x, norm_type, kernel_size, stride, padding, 2,
                    ceil_mode, data_format, "lp_pool2d")


def _fractional_axes(in_sz, out_sz, kernel_size, u):
    """Per-axis (starts, K, ends) of fractional max pooling (Graham):
    edges ``ceil(alpha * (i + u)) - ceil(alpha * u)`` with ``alpha = I /
    O``, which tile the input; a ``kernel_size`` makes the windows
    ``[start, start + k)``."""
    axes = []
    nd = len(in_sz)
    ks = _pair(kernel_size, nd) if kernel_size is not None else None
    for d in range(nd):
        i, o = in_sz[d], out_sz[d]
        alpha = i / o
        base = int(np.ceil(alpha * u))
        edges = np.minimum(np.ceil(alpha * (np.arange(o + 1) + u)).astype(
            np.int64) - base, i)
        starts = edges[:-1]
        if ks is not None:
            k = ks[d]
            ends = np.minimum(starts + k, i)
        else:
            ends = edges[1:]
            k = int((ends - starts).max())
        axes.append((starts, k, ends))
    return axes


def _fractional_max_pool(x, nd, output_size, kernel_size, random_u,
                         return_mask, op_name):
    """The windows' shift ``u`` is ``random_u``, or a draw from the
    weights' ``torch.Generator`` (``nn.initializer.seed``)."""
    if random_u is None:
        u = float(torch.empty((), dtype=torch.float64).uniform_(
            1e-6, 1 - 1e-6, generator=_init.default_generator()))
    else:
        u = float(random_u)
    if not 0 < u < 1:
        raise ValueError(f"{op_name}: random_u must be in (0, 1), got {u}")
    (x,) = cast_inputs("max_pool_with_mask" if return_mask else op_name, x)
    out, mask = _max_pool_gather(
        x, _fractional_axes(tuple(x.shape[2:]), _pair(output_size, nd),
                            kernel_size, u))
    return (out, mask) if return_mask else out


def fractional_max_pool2d(x, output_size, kernel_size=None, random_u=None,
                          return_mask=False, name=None):
    return _fractional_max_pool(x, 2, output_size, kernel_size, random_u,
                                return_mask, "fractional_max_pool2d")


def fractional_max_pool3d(x, output_size, kernel_size=None, random_u=None,
                          return_mask=False, name=None):
    return _fractional_max_pool(x, 3, output_size, kernel_size, random_u,
                                return_mask, "fractional_max_pool3d")


# ---------------------------------------------------------------------------
# patches, resizing, padding
# ---------------------------------------------------------------------------

def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """``[N, C * kh * kw, L]`` patches of an NCHW input (symmetric
    padding: the first two entries of ``paddings``)."""
    (x,) = cast_inputs("unfold", x)
    return F.unfold(x, _pair(kernel_sizes), _pair(dilations),
                    _pair(paddings)[:2], _pair(strides))


def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def _resize_weights(m, n, cubic):
    """``jax.image.resize``'s ``[m, n]`` weights from input to output
    pixels (float32): the kernel at half-pixel centres, widened by the
    shrink factor when shrinking (antialiasing), each column normalized
    to sum 1."""
    f32 = np.float32
    inv = f32(1.0 / (n / m))
    kscale = max(inv, f32(1.0))
    sample = (np.arange(n, dtype=f32) + f32(0.5)) * inv - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(m, dtype=f32)[:, None]) / kscale
    w = (_keys_cubic(x) if cubic else np.maximum(0, 1 - np.abs(x))).astype(
        f32)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(f32).eps),
                 w / np.where(total != 0, total, 1), 0).astype(f32)
    inside = (sample >= -0.5) & (sample <= m - 0.5)
    return np.where(inside[None, :], w, 0).astype(f32)


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, data_format="NCHW", name=None):
    """``jax.image.resize``, as the JAX package computes it: nearest picks
    the pixel whose centre covers the output centre; linear (``"linear"``,
    ``"bilinear"``, ``"trilinear"`` and ``"area"``) and cubic (Keys, a =
    -0.5) weigh half-pixel centres and antialias when shrinking;
    ``align_corners`` is ignored. An axis whose size does not change is
    left as it is."""
    nd = x.dim() - 2
    cf = data_format.startswith("NC")
    in_sz = tuple(x.shape[2:] if cf else x.shape[1:-1])
    if size is None:
        size = tuple(int(i * s) for i, s in zip(in_sz,
                                                _pair(scale_factor, nd)))
    else:
        size = tuple(int(s) for s in _pair(size, nd))
    method = {"nearest": "nearest", "bilinear": "linear",
              "bicubic": "cubic", "trilinear": "linear", "linear": "linear",
              "area": "linear"}[mode]
    (x,) = cast_inputs("interpolate", x)
    first = 2 if cf else 1
    out = x
    for d, (m, n) in enumerate(zip(in_sz, size)):
        if m == n:
            continue
        axis = first + d
        if method == "nearest":
            offs = np.floor(((np.arange(n, dtype=np.float32) + 0.5) * m)
                            / np.float32(n)).astype(np.int64)
            out = out.index_select(axis, torch.as_tensor(offs,
                                                         device=x.device))
        else:
            w = torch.as_tensor(_resize_weights(m, n, method == "cubic"),
                                device=x.device, dtype=out.dtype)
            out = torch.tensordot(out, w, dims=([axis], [0])).movedim(-1,
                                                                      axis)
    return out


upsample = interpolate


def pixel_shuffle(x, upscale_factor, data_format="NCHW", name=None):
    """``[N, C*r*r, H, W]`` to ``[N, C, H*r, W*r]`` (channel-first, as in
    the JAX package, whatever ``data_format`` says)."""
    (x,) = cast_inputs("pixel_shuffle", x)
    r = upscale_factor
    n, c, h, w = x.shape
    x = x.reshape(n, c // (r * r), r, r, h, w).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(n, c // (r * r), h * r, w * r)


def _pad_index(n, lo, hi, mode):
    """The source index of each position of an axis padded by (lo, hi):
    numpy's ``edge``, ``wrap`` and ``reflect`` rules."""
    idx = np.arange(-lo, n + hi)
    if mode == "replicate":
        return np.clip(idx, 0, n - 1)
    if mode == "circular":
        return np.mod(idx, n)
    if n == 1:
        return np.zeros_like(idx)
    period = 2 * (n - 1)
    idx = np.mod(idx, period)
    return np.where(idx >= n, period - idx, idx)


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    """Pad ``x``: ``2 * ndim`` numbers are (low, high) pairs from axis 0
    on, fewer pairs run from the last axis back (Paddle's and PyTorch's
    rule); ``mode`` constant (``value``), reflect, replicate or circular.
    ``data_format`` is taken and ignored, as in the JAX package."""
    (x,) = cast_inputs("pad", x)
    pad = [int(p) for p in (pad.tolist() if isinstance(pad, torch.Tensor)
                            else pad)]
    nd = x.dim()
    if len(pad) == 2 * nd:
        pairs = [(pad[2 * i], pad[2 * i + 1]) for i in range(nd)]
    else:
        pairs = [(0, 0)] * nd
        for i in range(len(pad) // 2):
            pairs[nd - 1 - i] = (pad[2 * i], pad[2 * i + 1])
    if mode == "constant":
        return F.pad(x, _torch_pad(pairs), value=value)
    if mode not in ("reflect", "replicate", "circular"):
        raise KeyError(mode)
    for axis, (lo, hi) in enumerate(pairs):
        if lo or hi:
            idx = _pad_index(x.shape[axis], lo, hi, mode)
            x = x.index_select(axis, torch.as_tensor(idx, device=x.device))
    return x


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    (x,) = cast_inputs("flatten", x)
    return torch.flatten(x, start_axis, stop_axis)


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5,
               data_format="NCHW", use_global_stats=None, name=None):
    """Batch normalization with Paddle's running update, in place on the
    buffers while training: ``running = momentum * running + (1 -
    momentum) * batch``, over the biased batch variance. Mixed I/O: the
    statistics and the affine parameters are fp32 inside, the output has
    the input's type (no fp32 activation is stored).

    The normalization is ``torch.nn.functional.batch_norm`` (cuDNN on the
    card). Its own running update uses the unbiased variance and the
    opposite momentum, so it only fills scratch statistics (momentum 1:
    the batch's mean and unbiased variance), from which Paddle's update is
    made."""
    channel_axis = 1 if data_format.startswith("NC") and x.dim() > 1 \
        else x.dim() - 1
    xc = x.movedim(channel_axis, 1) if channel_axis != 1 else x
    ct = torch.promote_types(x.dtype, torch.float32)  # the compute type
    w = weight.to(ct) if weight is not None else None
    b = bias.to(ct) if bias is not None else None
    if training and not use_global_stats:
        mean = torch.zeros_like(running_mean, dtype=ct)
        var = torch.zeros_like(running_var, dtype=ct)
        out = F.batch_norm(xc, mean, var, w, b, training=True, momentum=1.0,
                           eps=epsilon)
        n = xc.numel() // xc.shape[1]
        with torch.no_grad():
            biased = var * ((n - 1) / n)
            running_mean.copy_(momentum * running_mean
                               + (1 - momentum) * mean)
            running_var.copy_(momentum * running_var
                              + (1 - momentum) * biased)
    else:
        out = F.batch_norm(xc, running_mean.to(ct), running_var.to(ct), w,
                           b, training=False, eps=epsilon)
    return out.movedim(1, channel_axis) if channel_axis != 1 else out


# ---------------------------------------------------------------------------
# the transformer stack
# ---------------------------------------------------------------------------

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "int64": torch.int64,
           "int32": torch.int32, "bool": torch.bool}


def gelu(x, approximate=False, name=None):
    """GELU: erf by default, the tanh approximation with
    ``approximate=True`` (``jax.nn.gelu``'s two forms)."""
    (x,) = cast_inputs("gelu", x)
    return F.gelu(x, approximate="tanh" if approximate else "none")


def silu(x, name=None):
    (x,) = cast_inputs("silu", x)
    return F.silu(x)


swish = silu


def softmax(x, axis=-1, dtype=None, name=None):
    """Softmax over ``axis``; ``dtype`` casts the input first.
    Black-listed under AMP: low-precision inputs go to fp32."""
    (x,) = cast_inputs("softmax", x)
    if dtype is not None:
        x = x.to(_DTYPES[dtype] if isinstance(dtype, str) else dtype)
    return torch.softmax(x, dim=axis)


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5,
               name=None):
    """Normalization over the trailing ``normalized_shape`` axes with the
    population variance (the JAX package's ``jnp.var``; torch's default
    ``var`` is the unbiased one), computed in the input's type; then the
    gain and the bias. Black-listed under AMP: low-precision inputs go to
    fp32."""
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    x, weight, bias = cast_inputs("layer_norm", x, weight, bias)
    axes = tuple(range(x.dim() - len(normalized_shape), x.dim()))
    v, m = torch.var_mean(x, dim=axes, correction=0, keepdim=True)
    out = (x - m) / torch.sqrt(v + epsilon)
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out


def rms_norm(x, weight=None, epsilon=1e-6, name=None):
    """RMSNorm: the normalization in fp32, rounded to the input's type,
    then times the gain (in the promoted type, as the JAX package's)."""
    x, weight = cast_inputs("rms_norm", x, weight)
    xf = x.float()
    out = (xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + epsilon)
           ).to(x.dtype)
    return out if weight is None else out * weight


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None):
    """Dropout: each element (or each slice along ``axis``) kept with
    probability ``1 - p``, the keep mask drawn from
    ``nn.initializer.generator(x.device)``. ``upscale_in_train`` scales the
    kept values by ``1 / (1 - p)`` while training; ``downscale_in_infer``
    keeps them as they are. Outside training (or at p 0) the input comes
    back unchanged in both modes, as in the JAX package."""
    if not training or p == 0.0:
        return x
    if p == 1.0:
        return torch.zeros_like(x)
    if mode not in ("upscale_in_train", "downscale_in_infer"):
        raise ValueError(f"mode must be upscale_in_train or "
                         f"downscale_in_infer, got {mode!r}")
    (x,) = cast_inputs("dropout", x)
    shape = tuple(x.shape)
    if axis is not None:
        axes = (axis,) if isinstance(axis, int) else tuple(axis)
        shape = tuple(s if i in axes else 1 for i, s in enumerate(shape))
    keep = torch.rand(shape, generator=_init.generator(x.device),
                      device=x.device) < 1.0 - p
    if mode == "upscale_in_train":
        return torch.where(keep, x / (1.0 - p), 0.0)
    return torch.where(keep, x, 0.0)


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Rows of ``weight`` at the ids ``x``; positions holding
    ``padding_idx`` read zeros (so that row gets no gradient). The
    gradient is dense: the JAX package's ``sparse=True`` (a SelectedRows
    gradient) is not ported."""
    if sparse:
        raise NotImplementedError("embedding(sparse=True): the SelectedRows "
                                  "gradient is not ported")
    (weight,) = cast_inputs("embedding", weight)
    ids = x.long()
    out = F.embedding(ids, weight)
    if padding_idx is not None:
        out = torch.where((ids == padding_idx)[..., None], 0.0, out)
    return out


def sequence_mask(lengths, maxlen=None, dtype="int64", name=None):
    """``[..., maxlen]``: position j < lengths[...] (``maxlen`` defaults to
    the largest length, one device read)."""
    ml = int(maxlen) if maxlen is not None else int(lengths.max().item())
    dt = _DTYPES[dtype] if isinstance(dtype, str) else dtype
    pos = torch.arange(ml, device=lengths.device)
    return (pos < lengths[..., None]).to(dt)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, name=None):
    """Attention over ``[batch, seq, heads, head_dim]``, with the JAX
    package's dispatch:

    - ``dropout_p > 0`` while training: the dense probabilities
      (``attention_probs``, fp32) with dropout applied to them, then their
      product with ``value``: the reference's probability-level dropout,
      which the flash kernels (no random numbers inside) cannot give;
    - a mask (boolean, False hides a key, or additive): the dense path,
      as the JAX entry's ``flash_path_active`` decides;
    - everything else: ``ops.kernels.flash_attention.dot_product_attention``,
      the flash kernels on a card (bf16 or fp32), their plain versions on
      the CPU.

    The two dense paths mirror the reference: they are not a fallback, and
    they launch no flash kernel. White-listed under AMP: fp32 inputs (an
    additive mask included) run in the low-precision type."""
    if dropout_p > 0.0 and training:
        q, k, mask = cast_inputs("sdpa_probs", query, key, attn_mask)
        probs = _fa.attention_probs(q, k, mask=mask, is_causal=is_causal)
        probs = dropout(probs, dropout_p, training=training)
        probs, v = cast_inputs("sdpa_out", probs, value)
        return _fa.attention_apply(probs, v)
    q, k, v, mask = cast_inputs("scaled_dot_product_attention", query, key,
                                value, attn_mask)
    return _fa.dot_product_attention(q, k, v, mask=mask, is_causal=is_causal)


# ---------------------------------------------------------------------------
# the other norms, dropouts and distances
# ---------------------------------------------------------------------------

def _affine(out, weight, bias):
    """``out * weight + bias`` per channel (axis 1), either left out."""
    if weight is not None:
        out = out * _reshape_at(weight, out.dim(), 1)
    if bias is not None:
        out = out + _reshape_at(bias, out.dim(), 1)
    return out


def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats=True, momentum=0.9, eps=1e-5,
                  data_format="NCHW", name=None):
    """Each sample's channels normalized over their spatial axes
    (population variance), then the per-channel gain and bias. The
    running statistics, ``use_input_stats`` and ``momentum`` are taken and
    ignored, as in the JAX package. Black-listed under AMP."""
    x, weight, bias = cast_inputs("instance_norm", x, weight, bias)
    axes = tuple(range(2, x.dim()))
    v, m = torch.var_mean(x, dim=axes, correction=0, keepdim=True)
    return _affine((x - m) / torch.sqrt(v + eps), weight, bias)


def group_norm(x, num_groups, epsilon=1e-5, weight=None, bias=None,
               data_format="NCHW", name=None):
    """Channels (axis 1) in ``num_groups`` groups, each normalized over
    its channels and the spatial axes, then the per-channel gain and bias
    (channel-first whatever ``data_format`` says, as in the JAX package).
    Black-listed under AMP."""
    x, weight, bias = cast_inputs("group_norm", x, weight, bias)
    n, c = x.shape[:2]
    g = x.reshape((n, num_groups, c // num_groups) + tuple(x.shape[2:]))
    v, m = torch.var_mean(g, dim=tuple(range(2, g.dim())), correction=0,
                          keepdim=True)
    return _affine(((g - m) / torch.sqrt(v + epsilon)).reshape(x.shape),
                   weight, bias)


def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0,
                        data_format="NCHW", name=None):
    """``x / (k + alpha * s) ** beta``, ``s`` the sum of squares over
    ``size`` neighbouring channels (``size // 2`` below; ``alpha`` is not
    divided by ``size``, as in the JAX package)."""
    (x,) = cast_inputs("local_response_norm", x)
    half = size // 2
    pads = [(0, 0)] * x.dim()
    pads[1] = (half, size - 1 - half)
    sq = F.pad(x * x, _torch_pad(pads))
    c = x.shape[1]
    s = sum(sq.narrow(1, i, c) for i in range(size))
    return x / torch.pow(k + alpha * s, beta)


def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    """``x / max(||x||_p, epsilon)`` along ``axis``."""
    (x,) = cast_inputs("normalize", x)
    n = (x.abs() ** p).sum(dim=axis, keepdim=True) ** (1.0 / p)
    return x / torch.clamp(n, min=epsilon)


def cosine_similarity(x1, x2, axis=1, eps=1e-8, name=None):
    """``sum(x1 * x2) / max(||x1|| * ||x2||, eps)`` along ``axis``."""
    x1, x2 = cast_inputs("cosine_similarity", x1, x2)
    n1 = torch.sqrt((x1 * x1).sum(dim=axis))
    n2 = torch.sqrt((x2 * x2).sum(dim=axis))
    return (x1 * x2).sum(dim=axis) / torch.clamp(n1 * n2, min=eps)


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None):
    """Whole channels dropped: ``dropout`` over (N, C)."""
    return dropout(x, p, axis=[0, 1] if data_format == "NCHW" else [0, 3],
                   training=training)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None):
    return dropout(x, p, axis=[0, 1] if data_format == "NCDHW" else [0, 4],
                   training=training)


_ALPHA_P = -1.7580993408473766  # -scale * alpha of SELU


def _alpha_mix(x, p, mask_shape, op_name):
    """SELU-preserving dropout: dropped values set to ``alpha_p``, then
    the affine map that keeps the mean and variance; the keep mask of
    ``mask_shape`` drawn from ``nn.initializer.generator(x.device)``."""
    (x,) = cast_inputs(op_name, x)
    keep = torch.rand(mask_shape, generator=_init.generator(x.device),
                      device=x.device) < 1.0 - p
    a = (1.0 - p + p * _ALPHA_P ** 2 * (1.0 - p)) ** -0.5
    b = -a * p * _ALPHA_P
    return a * torch.where(keep, x, _ALPHA_P) + b


def alpha_dropout(x, p=0.5, training=True, name=None):
    if not training or p == 0.0:
        return x
    return _alpha_mix(x, p, tuple(x.shape), "alpha_dropout")


def feature_alpha_dropout(x, p=0.5, training=True, name=None):
    """Alpha dropout of whole channels: the mask is ``[N, C, 1, ...]``;
    at ``p >= 1`` every channel is dropped to 0."""
    if not training or p == 0.0:
        return x
    if p >= 1.0:
        (x,) = cast_inputs("feature_alpha_dropout", x)
        return torch.zeros_like(x)
    return _alpha_mix(x, p, tuple(x.shape[:2]) + (1,) * (x.dim() - 2),
                      "feature_alpha_dropout")


from . import flash_attention  # noqa: E402  (the module, as in Paddle)
from .extras import *  # noqa: E402,F401,F403
from .extras import __all__ as _extras
from .loss import *  # noqa: E402,F401,F403
from .loss import __all__ as _losses

__all__ += [*_losses, *_extras]
