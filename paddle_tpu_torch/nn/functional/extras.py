"""The rest of ``nn.functional`` (counterpart of the sampling, pixel and
extras ops of ``paddle_tpu/nn/functional/__init__.py``): ``affine_grid``,
``grid_sample``, ``gumbel_softmax``, ``temperature_scaled_softmax``,
``class_center_sample``, ``fold``, ``pixel_unshuffle``,
``channel_shuffle``, ``zeropad2d`` and ``rrelu``.

The random ops draw from ``nn.initializer.generator`` (the port never
reproduces ``jax.random``: tests hold them by statistics or by their
deterministic mode). Where the JAX package's arithmetic is not PyTorch's
default, the port computes the JAX package's: ``grid_sample`` gathers the
four corners with validity masking (``"zeros"``) or clamping
(``"border"``) and rounds ``"nearest"`` half to even; ``gumbel_softmax``'s
``hard`` mode runs the reference's two straight-through lines, whose
gradients cancel, so it passes no gradient to ``x``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ...amp import cast_inputs
from .. import initializer as _init

__all__ = ["affine_grid", "grid_sample", "gumbel_softmax",
           "temperature_scaled_softmax", "class_center_sample", "fold",
           "pixel_unshuffle", "channel_shuffle", "zeropad2d", "rrelu"]


def _pair(v, n=2):
    if isinstance(v, (list, tuple)):
        return tuple(v) if len(v) == n else tuple(v) * n
    return (v,) * n


def affine_grid(theta, out_shape, align_corners=True, name=None):
    """``[N, H, W, 2]`` xy sampling grid: ``theta[n] @ [x, y, 1]`` over the
    output's pixel centres, computed in fp32."""
    n, _, h, w = [int(s) for s in out_shape]
    if tuple(theta.shape) != (n, 2, 3):
        raise ValueError(
            f"affine_grid: theta must be [{n}, 2, 3] to match "
            f"out_shape {list(out_shape)}, got {list(theta.shape)}")
    (th,) = cast_inputs("affine_grid", theta)
    dev = th.device
    if align_corners:
        xs = torch.linspace(-1.0, 1.0, w, device=dev)
        ys = torch.linspace(-1.0, 1.0, h, device=dev)
    else:
        xs = (2.0 * torch.arange(w, device=dev) + 1.0) / w - 1.0
        ys = (2.0 * torch.arange(h, device=dev) + 1.0) / h - 1.0
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)
    return torch.einsum("nij,hwj->nhwi", th.float(), base).to(th.dtype)


def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True, name=None):
    """Sample ``x`` ``[N, C, H, W]`` at ``grid`` ``[N, Hg, Wg, 2]`` (xy in
    [-1, 1]): bilinear or nearest, with zeros or border padding."""
    if mode not in ("bilinear", "nearest"):
        raise ValueError(f"grid_sample mode {mode!r} unsupported")
    if padding_mode not in ("zeros", "border"):
        raise ValueError(
            f"grid_sample padding_mode {padding_mode!r} unsupported")
    xa, ga = cast_inputs("grid_sample", x, grid)
    n, _, h, w = xa.shape
    gx, gy = ga[..., 0].float(), ga[..., 1].float()
    if align_corners:
        ix = (gx + 1.0) * (w - 1) / 2.0
        iy = (gy + 1.0) * (h - 1) / 2.0
    else:
        ix = ((gx + 1.0) * w - 1.0) / 2.0
        iy = ((gy + 1.0) * h - 1.0) / 2.0
    rows = torch.arange(n, device=xa.device)[:, None, None]

    def gather(yy, xx):
        valid = (xx >= 0) & (xx <= w - 1) & (yy >= 0) & (yy <= h - 1)
        xc = xx.clamp(0, w - 1).long()
        yc = yy.clamp(0, h - 1).long()
        vals = xa[rows, :, yc, xc].movedim(-1, 1)      # [N, C, Hg, Wg]
        if padding_mode == "zeros":
            vals = vals * valid[:, None].to(vals.dtype)
        return vals

    if mode == "nearest":
        return gather(torch.round(iy), torch.round(ix)).to(xa.dtype)
    x0, y0 = torch.floor(ix), torch.floor(iy)
    x1, y1 = x0 + 1, y0 + 1
    wx = (ix - x0)[:, None]
    wy = (iy - y0)[:, None]
    out = (gather(y0, x0) * (1 - wx) * (1 - wy)
           + gather(y0, x1) * wx * (1 - wy)
           + gather(y1, x0) * (1 - wx) * wy
           + gather(y1, x1) * wx * wy)
    return out.to(xa.dtype)


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None):
    """``softmax((x + g) / temperature)`` with Gumbel noise ``g``; ``hard``
    returns the one-hot of its argmax through the reference's
    straight-through lines (no gradient reaches ``x``)."""
    (a,) = cast_inputs("gumbel_softmax", x)
    u = torch.rand(a.shape, generator=_init.generator(a.device),
                   device=a.device, dtype=a.dtype)
    tiny = torch.finfo(a.dtype).tiny
    g = -torch.log(-torch.log(u.clamp(min=tiny)))
    y = torch.softmax((a + g) / temperature, dim=axis)
    if hard:
        idx = y.argmax(dim=axis, keepdim=True)
        y_hard = torch.zeros_like(y).scatter(axis, idx, 1.0)
        y = y_hard + y.detach() - y + y
        y = y_hard - y.detach() + y
    return y


def temperature_scaled_softmax(x, temperature=1.0, axis=-1, name=None):
    """``softmax(x / temperature)``."""
    if temperature <= 0:
        raise ValueError("temperature must be positive")
    (a,) = cast_inputs("temperature_scaled_softmax", x)
    return torch.softmax(a / temperature, dim=axis)


def class_center_sample(label, num_classes, num_samples, group=None,
                        name=None):
    """Partial-FC sampling on the host: every class in ``label``, padded
    with random negatives (``nn.initializer``'s CPU generator) up to
    ``num_samples``; returns (the labels remapped into the sampled set,
    the sorted sampled classes), int64 on ``label``'s device."""
    if group is not None and torch.distributed.is_available() \
            and torch.distributed.is_initialized() \
            and torch.distributed.get_world_size() > 1:
        raise NotImplementedError(
            "class_center_sample: sampling coordinated over a group of "
            "ranks is not implemented; run it on one rank and broadcast, "
            "or pass group=None")
    lab = label.detach().cpu().numpy().reshape(-1).astype(np.int64)
    pos = np.unique(lab)
    if len(pos) >= num_samples:
        sampled = pos
    else:
        neg_pool = np.setdiff1d(np.arange(num_classes), pos,
                                assume_unique=True)
        perm = torch.randperm(len(neg_pool),
                              generator=_init.generator(torch.device("cpu")))
        extra = neg_pool[perm.numpy()][:num_samples - len(pos)]
        sampled = np.sort(np.concatenate([pos, extra]))
    remap = {int(c): i for i, c in enumerate(sampled)}
    remapped = np.array([remap[int(v)] for v in lab], np.int64)
    return (torch.from_numpy(remapped.reshape(tuple(label.shape))).to(
        label.device), torch.from_numpy(sampled).to(label.device))


def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1,
         name=None):
    """col2im, the inverse of ``unfold``: ``[N, C*kh*kw, L]`` ->
    ``[N, C, H, W]``, overlapping patches summed."""
    (a,) = cast_inputs("fold", x)
    return F.fold(a, _pair(output_sizes), _pair(kernel_sizes),
                  dilation=_pair(dilations), padding=_pair(paddings),
                  stride=_pair(strides))


def pixel_unshuffle(x, downscale_factor, data_format="NCHW", name=None):
    """``[N, C, H, W]`` -> ``[N, C r^2, H / r, W / r]`` (channel ``c r^2 +
    i r + j`` holds pixel ``(h r + i, w r + j)``)."""
    r = downscale_factor
    nhwc = data_format == "NHWC"
    (a,) = cast_inputs("pixel_unshuffle", x)
    if nhwc:
        a = a.permute(0, 3, 1, 2)
    n, c, h, w = a.shape
    a = a.reshape(n, c, h // r, r, w // r, r).permute(0, 1, 3, 5, 2, 4)
    a = a.reshape(n, c * r * r, h // r, w // r)
    return a.permute(0, 2, 3, 1) if nhwc else a


def channel_shuffle(x, groups, data_format="NCHW", name=None):
    nhwc = data_format == "NHWC"
    (a,) = cast_inputs("channel_shuffle", x)
    if nhwc:
        a = a.permute(0, 3, 1, 2)
    n, c, h, w = a.shape
    a = a.reshape(n, groups, c // groups, h, w).transpose(1, 2).reshape(
        n, c, h, w)
    return a.permute(0, 2, 3, 1) if nhwc else a


def zeropad2d(x, padding, data_format="NCHW", name=None):
    """Zero-pad H and W: ``padding = [left, right, top, bottom]``."""
    from . import pad

    l, r, t, b = _pair(padding, 4)
    if data_format == "NHWC":
        return pad(x, [0, 0, l, r, t, b], mode="constant", value=0.0)
    return pad(x, [l, r, t, b], mode="constant", value=0.0)


def rrelu(x, lower=1.0 / 8.0, upper=1.0 / 3.0, training=False, name=None):
    """Leaky ReLU with the slope ``(lower + upper) / 2``, or, in training,
    a slope drawn uniformly from ``[lower, upper)`` for each element."""
    (a,) = cast_inputs("rrelu", x)
    if not training:
        return torch.where(a >= 0, a, a * ((lower + upper) / 2.0))
    slope = torch.rand(a.shape, generator=_init.generator(a.device),
                       device=a.device, dtype=a.dtype)
    slope = lower + (upper - lower) * slope
    return torch.where(a >= 0, a, a * slope)
