"""``vision.transforms.functional``: numpy image ops on the host.

Counterpart of ``paddle_tpu/vision/transforms/functional.py``, with the
same arithmetic: images are CHW (a 2-D array gains a channel axis; a 3-D
array whose first dimension is not 1, 3 or 4 is read as HWC and
transposed), float32 on the way in. ``to_tensor`` is the one function
that leaves the host: it returns a torch tensor on the port's current
device (``device.get_device()``), as the port's creation functions do.

The reference's behaviours, kept:

- ``resize`` is a half-pixel bilinear without antialiasing, computed with
  float64 weights (its result is float64, as the reference's); an int
  ``size`` sets the shorter side (``transforms.Resize(int)`` makes a
  square instead).
- ``rotate`` turns multiples of 90 degrees exactly and samples other
  angles at the nearest pixel, ``fill`` outside the image.
- ``adjust_brightness`` and ``adjust_contrast`` clip to [0, 1].
"""

from __future__ import annotations

import numpy as np
import torch

from ...device import get_device, resolve_device

__all__ = ["to_tensor", "normalize", "resize", "crop", "center_crop",
           "hflip", "vflip", "pad", "adjust_brightness", "adjust_contrast",
           "rotate", "to_grayscale"]


def _chw(img):
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[None]
    elif img.ndim == 3 and img.shape[0] not in (1, 3, 4):
        img = img.transpose(2, 0, 1)  # HWC -> CHW
    return img.astype(np.float32)


def to_tensor(pic, data_format="CHW"):
    """CHW float32 on the current device; a uint8 image is divided by 255
    (the type decides, not the values: a dark image stays dark)."""
    src_dtype = np.asarray(pic).dtype
    img = _chw(pic)
    if src_dtype == np.uint8:
        img = img / 255.0
    return torch.as_tensor(np.ascontiguousarray(img, np.float32),
                           device=resolve_device(get_device()))


def normalize(img, mean, std, data_format="CHW", to_rgb=False):
    a = np.asarray(img, np.float32)
    if data_format == "CHW":
        mean = np.asarray(mean, np.float32).reshape(-1, 1, 1)
        std = np.asarray(std, np.float32).reshape(-1, 1, 1)
    else:  # HWC: the trailing channel axis, layout kept
        mean = np.asarray(mean, np.float32).reshape(1, 1, -1)
        std = np.asarray(std, np.float32).reshape(1, 1, -1)
    return (a - mean) / std


def resize(img, size, interpolation="bilinear"):
    a = _chw(img)
    if isinstance(size, int):
        c, h, w = a.shape
        if h < w:
            oh, ow = size, int(size * w / h)
        else:
            oh, ow = int(size * h / w), size
    else:
        oh, ow = size
    c, h, w = a.shape
    ys = np.clip((np.arange(oh) + 0.5) * h / oh - 0.5, 0, h - 1)
    xs = np.clip((np.arange(ow) + 0.5) * w / ow - 0.5, 0, w - 1)
    if interpolation == "nearest":
        return a[:, np.round(ys).astype(int)][:, :, np.round(xs).astype(int)]
    y0 = np.floor(ys).astype(int)
    x0 = np.floor(xs).astype(int)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = (ys - y0)[None, :, None]
    wx = (xs - x0)[None, None, :]

    def g(yi, xi):
        return a[:, yi][:, :, xi]
    return (g(y0, x0) * (1 - wy) * (1 - wx) + g(y1, x0) * wy * (1 - wx)
            + g(y0, x1) * (1 - wy) * wx + g(y1, x1) * wy * wx)


def crop(img, top, left, height, width):
    return _chw(img)[:, top:top + height, left:left + width]


def center_crop(img, output_size):
    a = _chw(img)
    oh, ow = ((output_size, output_size) if isinstance(output_size, int)
              else output_size)
    c, h, w = a.shape
    top = max(0, (h - oh) // 2)
    left = max(0, (w - ow) // 2)
    return a[:, top:top + oh, left:left + ow]


def hflip(img):
    return _chw(img)[:, :, ::-1].copy()


def vflip(img):
    return _chw(img)[:, ::-1, :].copy()


def pad(img, padding, fill=0, padding_mode="constant"):
    """``padding`` an int (all sides), a pair (left/right, top/bottom) or
    (left, top, right, bottom)."""
    a = _chw(img)
    if isinstance(padding, int):
        l = r = t = b = padding
    elif len(padding) == 2:
        l, t = padding
        r, b = padding
    else:
        l, t, r, b = padding
    mode = {"constant": "constant", "edge": "edge",
            "reflect": "reflect", "symmetric": "symmetric"}[padding_mode]
    kw = {"constant_values": fill} if mode == "constant" else {}
    return np.pad(a, ((0, 0), (t, b), (l, r)), mode=mode, **kw)


def adjust_brightness(img, brightness_factor):
    return np.clip(_chw(img) * brightness_factor, 0, 1)


def adjust_contrast(img, contrast_factor):
    a = _chw(img)
    mean = a.mean()
    return np.clip((a - mean) * contrast_factor + mean, 0, 1)


def rotate(img, angle, interpolation="nearest", expand=False, center=None,
           fill=0):
    """Multiples of 90 degrees exactly; other angles by inverse mapping to
    the nearest pixel about ``center`` ((x, y); the image's centre by
    default), ``fill`` outside the image."""
    a = _chw(img)
    k = round(angle / 90.0)
    if abs(angle - 90.0 * k) < 1e-6:
        return np.rot90(a, k % 4, axes=(1, 2)).copy()
    c, h, w = a.shape
    cy, cx = ((h - 1) / 2, (w - 1) / 2) if center is None else center[::-1]
    th = np.deg2rad(angle)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    ys = cy + (yy - cy) * np.cos(th) - (xx - cx) * np.sin(th)
    xs = cx + (yy - cy) * np.sin(th) + (xx - cx) * np.cos(th)
    yi = np.clip(np.round(ys), 0, h - 1).astype(int)
    xi = np.clip(np.round(xs), 0, w - 1).astype(int)
    out = a[:, yi, xi]
    inside = (ys >= 0) & (ys <= h - 1) & (xs >= 0) & (xs <= w - 1)
    return np.where(inside[None], out, fill).astype(np.float32)


def to_grayscale(img, num_output_channels=1):
    """ITU-R 601 luminance of an RGB image (the first channel of any
    other), repeated ``num_output_channels`` times."""
    a = _chw(img)
    if a.shape[0] == 3:
        g = (0.299 * a[0] + 0.587 * a[1] + 0.114 * a[2])[None]
    else:
        g = a[:1]
    return np.repeat(g, num_output_channels, axis=0)
