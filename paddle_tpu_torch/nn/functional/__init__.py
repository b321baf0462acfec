"""The functional ops the ported layers run: ``conv2d``, ``linear``,
``relu``, ``max_pool2d``, ``adaptive_avg_pool2d``, ``flatten``,
``batch_norm`` and ``cross_entropy``; for the transformer stack ``gelu``,
``silu``, ``softmax``, ``layer_norm``, ``rms_norm``, ``dropout``,
``embedding``, ``sequence_mask`` and ``scaled_dot_product_attention``,
and the ``flash_attention`` module (``flash_attention``,
``flash_attn_unpadded``).

Counterpart of ``paddle_tpu/nn/functional/__init__.py`` (and of
``paddle_tpu/ops/manipulation.py``'s ``flatten``). Each op keeps the JAX
package's op name, which ``amp.cast_inputs`` keys the AMP casts on, and
its layouts at the public function: Paddle's ``[out, in/groups, kh, kw]``
conv weight (torch's OIHW) and ``[in, out]`` linear weight, and
``data_format="NHWC"`` activations, which reach cuDNN as a channels-last
view of the same memory (no copy). None of these ops is a TPU kernel of
the JAX package (XLA computed them), so they run on PyTorch's own
operators, as the JAX package left them to XLA. Attention is the exception: without a mask
or dropout it runs the flash kernels of ``ops/kernels/flash_attention``
(the JAX package's Pallas kernels).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ...amp import cast_inputs
from ...ops.kernels import flash_attention as _fa
from .. import initializer as _init

__all__ = ["conv2d", "linear", "relu", "max_pool2d", "adaptive_avg_pool2d",
           "flatten", "batch_norm", "cross_entropy", "gelu", "silu",
           "softmax", "layer_norm", "rms_norm", "dropout", "embedding",
           "sequence_mask", "scaled_dot_product_attention",
           "flash_attention"]


def _pair(v):
    if isinstance(v, (list, tuple)):
        if len(v) != 2:
            raise NotImplementedError(f"only symmetric 2-D padding, strides "
                                      f"and sizes are ported, got {v!r}")
        return tuple(int(x) for x in v)
    return (int(v), int(v))


def _nchw(x, data_format):
    """An NHWC tensor as an NCHW-shaped view (channels-last memory)."""
    if data_format == "NHWC":
        return x.permute(0, 3, 1, 2)
    if data_format != "NCHW":
        raise ValueError(f"data_format must be NCHW or NHWC, got "
                         f"{data_format!r}")
    return x


def _back(y, data_format):
    return y.permute(0, 2, 3, 1) if data_format == "NHWC" else y


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    """2-D convolution, weight ``[out, in/groups, kh, kw]``."""
    if isinstance(padding, str):
        raise NotImplementedError("string padding is not ported")
    x, weight, bias = cast_inputs("conv2d", x, weight, bias)
    out = F.conv2d(_nchw(x, data_format), weight, bias, _pair(stride),
                   _pair(padding), _pair(dilation), groups)
    return _back(out, data_format)


def linear(x, weight, bias=None, name=None):
    """``x @ weight + bias`` with ``weight`` ``[in, out]``."""
    x, weight, bias = cast_inputs("linear", x, weight, bias)
    out = x @ weight
    return out if bias is None else out + bias


def relu(x, name=None):
    (x,) = cast_inputs("relu", x)
    return torch.relu(x)


def max_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False, data_format="NCHW", name=None):
    if return_mask:
        raise NotImplementedError("max_pool2d(return_mask=True) is not ported")
    (x,) = cast_inputs("max_pool2d", x)
    out = F.max_pool2d(_nchw(x, data_format), _pair(kernel_size),
                       _pair(stride if stride is not None else kernel_size),
                       _pair(padding), ceil_mode=ceil_mode)
    return _back(out, data_format)


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    """Output cell i averages ``[floor(i*I/O), ceil((i+1)*I/O))`` (the JAX
    package's op name is ``adaptive_avg_pool``)."""
    (x,) = cast_inputs("adaptive_avg_pool", x)
    out = F.adaptive_avg_pool2d(_nchw(x, data_format), _pair(output_size))
    return _back(out, data_format)


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


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    """Softmax cross-entropy over hard labels (``label`` with or without a
    trailing 1 axis); a label equal to ``ignore_index`` scores 0 and is
    left out of the mean. Black-listed under AMP: the logits go to fp32."""
    if weight is not None or soft_label or not use_softmax \
            or label_smoothing > 0:
        raise NotImplementedError("cross_entropy ports hard labels without "
                                  "class weights or smoothing")
    (logits,) = cast_inputs("cross_entropy", input)
    logp = torch.log_softmax(logits, dim=axis)
    lab = label.squeeze(axis) if label.dim() == logp.dim() else label
    lab = lab.long()
    mask = lab != ignore_index
    picked = logp.gather(axis, torch.where(mask, lab, 0).unsqueeze(axis))
    loss = torch.where(mask, -picked.squeeze(axis), 0.0)
    if reduction == "mean":
        return loss.sum() / mask.sum().clamp(min=1)
    if reduction == "sum":
        return loss.sum()
    if reduction == "none":
        return loss
    raise ValueError(f"reduction must be mean, sum or none, got "
                     f"{reduction!r}")


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


from . import flash_attention  # noqa: E402  (the module, as in Paddle)
