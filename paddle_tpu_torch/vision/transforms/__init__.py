"""Vision transforms: numpy on the host, before ``io.DataLoader`` collates
and places a batch (counterpart of ``paddle_tpu/vision/transforms``).

Each transform takes a CHW or HWC array (a 3-D array whose first
dimension is 1, 3 or 4 is read as CHW) and returns a numpy array, so the
input pipeline costs the card nothing; ``ToTensor`` returns numpy too, as
the reference's does (``functional.to_tensor`` is the one that returns a
tensor).

The random transforms draw from numpy's global state
(``np.random.rand``, ``uniform``, ``randint``), in the reference's order
of draws, so ``np.random.seed(s)`` gives the same crops, flips and
jitters here as in the JAX package. There is no generator argument: the
reference has none. A loader with worker threads interleaves the
workers' draws, so only a serial loader (``num_workers=0``) replays a
seed's batches.

``Resize`` (and ``RandomResizedCrop``, which calls it) is
``jax.image.resize(..., "linear")`` as the reference calls it: half-pixel
centres, antialiased when shrinking, computed with the weights of
``nn.functional.interpolate`` (``_resize_weights``); an int ``size``
gives a square. The reference's other behaviours, kept: ``RandomCrop``
ignores ``pad_if_needed``; ``ColorJitter``'s hue is an approximation
(each channel moved toward its neighbour by the drawn shift) and it clips
at 255 when the image's maximum is above 1.5, else at 1.
"""

from __future__ import annotations

from typing import Callable, List

import numpy as np

from ...nn.functional import _resize_weights
from . import functional  # noqa: F401

__all__ = [
    "Compose", "ToTensor", "Normalize", "Resize", "RandomCrop", "CenterCrop",
    "RandomHorizontalFlip", "RandomVerticalFlip", "Transpose",
    "BrightnessTransform", "Pad", "Grayscale", "ColorJitter",
    "RandomRotation", "RandomResizedCrop",
]


class Compose:
    def __init__(self, transforms: List[Callable]):
        self.transforms = transforms

    def __call__(self, data):
        for t in self.transforms:
            data = t(data)
        return data


class ToTensor:
    """HWC (or CHW) uint8/float -> CHW float32 in [0, 1], as numpy."""

    def __init__(self, data_format="CHW"):
        self.data_format = data_format

    def __call__(self, img):
        img = np.asarray(img)
        if img.dtype == np.uint8:
            img = img.astype("float32") / 255.0
        img = img.astype("float32")
        if img.ndim == 2:
            img = img[None]
        elif (img.ndim == 3 and self.data_format == "CHW"
              and img.shape[-1] in (1, 3, 4)):
            img = img.transpose(2, 0, 1)
        return img


class Normalize:
    def __init__(self, mean=0.0, std=1.0, data_format="CHW", to_rgb=False):
        self.mean = np.asarray(mean, "float32")
        self.std = np.asarray(std, "float32")
        self.data_format = data_format

    def __call__(self, img):
        img = np.asarray(img, "float32")
        if self.data_format == "CHW":
            m = self.mean.reshape(-1, 1, 1)
            s = self.std.reshape(-1, 1, 1)
        else:
            m, s = self.mean, self.std
        return (img - m) / s


class Transpose:
    def __init__(self, order=(2, 0, 1)):
        self.order = order

    def __call__(self, img):
        return np.asarray(img).transpose(self.order)


def _chw(img):
    return img.ndim == 3 and img.shape[0] in (1, 3, 4)


def _resize_linear(img, shape):
    """``jax.image.resize(img, shape, "linear")`` for float32 ``img``: one
    contraction with ``_resize_weights`` per axis whose size changes."""
    out = img
    for axis, (m, n) in enumerate(zip(img.shape, shape)):
        if m != n:
            w = _resize_weights(m, n, cubic=False)
            out = np.moveaxis(np.tensordot(out, w, axes=([axis], [0])), -1,
                              axis)
    return np.ascontiguousarray(out, np.float32)


class Resize:
    def __init__(self, size, interpolation="bilinear"):
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def __call__(self, img):
        img = np.asarray(img, "float32")
        if _chw(img):
            shape = (img.shape[0],) + self.size
        else:
            shape = self.size + (img.shape[-1],) if img.ndim == 3 \
                else self.size
        return _resize_linear(img, shape)


class CenterCrop:
    def __init__(self, size):
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def __call__(self, img):
        img = np.asarray(img)
        h_axis, w_axis = (1, 2) if _chw(img) else (0, 1)
        h, w = img.shape[h_axis], img.shape[w_axis]
        th, tw = self.size
        i, j = (h - th) // 2, (w - tw) // 2
        sl = [slice(None)] * img.ndim
        sl[h_axis] = slice(i, i + th)
        sl[w_axis] = slice(j, j + tw)
        return img[tuple(sl)]


class RandomCrop:
    def __init__(self, size, padding=None, pad_if_needed=False):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.padding = padding

    def __call__(self, img):
        img = np.asarray(img)
        h_axis, w_axis = (1, 2) if _chw(img) else (0, 1)
        if self.padding:
            p = self.padding
            pads = [(0, 0)] * img.ndim
            pads[h_axis] = (p, p)
            pads[w_axis] = (p, p)
            img = np.pad(img, pads)
        h, w = img.shape[h_axis], img.shape[w_axis]
        th, tw = self.size
        i = np.random.randint(0, h - th + 1)
        j = np.random.randint(0, w - tw + 1)
        sl = [slice(None)] * img.ndim
        sl[h_axis] = slice(i, i + th)
        sl[w_axis] = slice(j, j + tw)
        return img[tuple(sl)]


class RandomHorizontalFlip:
    def __init__(self, prob=0.5):
        self.prob = prob

    def __call__(self, img):
        img = np.asarray(img)
        if np.random.rand() < self.prob:
            return np.flip(img, axis=2 if _chw(img) else 1).copy()
        return img


class RandomVerticalFlip:
    def __init__(self, prob=0.5):
        self.prob = prob

    def __call__(self, img):
        img = np.asarray(img)
        if np.random.rand() < self.prob:
            return np.flip(img, axis=1 if _chw(img) else 0).copy()
        return img


class BrightnessTransform:
    def __init__(self, value):
        self.value = value

    def __call__(self, img):
        img = np.asarray(img, "float32")
        factor = 1.0 + np.random.uniform(-self.value, self.value)
        return np.clip(img * factor, 0, 1)


class Pad:
    """Pad all sides (int), (left/right, top/bottom) or (left, top,
    right, bottom)."""

    def __init__(self, padding, fill=0, padding_mode="constant"):
        if isinstance(padding, int):
            padding = (padding,) * 4
        elif len(padding) == 2:
            padding = (padding[0], padding[1], padding[0], padding[1])
        self.padding = tuple(padding)  # (left, top, right, bottom)
        self.fill = fill
        self.mode = {"constant": "constant", "edge": "edge",
                     "reflect": "reflect",
                     "symmetric": "symmetric"}[padding_mode]

    def __call__(self, img):
        img = np.asarray(img)
        l, t, r, b = self.padding
        h_axis, w_axis = (1, 2) if _chw(img) else (0, 1)
        pads = [(0, 0)] * img.ndim
        pads[h_axis] = (t, b)
        pads[w_axis] = (l, r)
        if self.mode == "constant":
            return np.pad(img, pads, mode="constant",
                          constant_values=self.fill)
        return np.pad(img, pads, mode=self.mode)


class Grayscale:
    """RGB -> luminance (ITU-R 601), repeated to ``num_output_channels``."""

    def __init__(self, num_output_channels=1):
        self.n = int(num_output_channels)

    def __call__(self, img):
        img = np.asarray(img)
        w = np.array([0.299, 0.587, 0.114], img.dtype
                     if np.issubdtype(img.dtype, np.floating)
                     else np.float32)
        if _chw(img):
            g = np.tensordot(w, img.astype(w.dtype), axes=([0], [0]))[None]
            out = np.repeat(g, self.n, axis=0)
        else:
            g = np.tensordot(img.astype(w.dtype), w,
                             axes=([-1], [0]))[..., None]
            out = np.repeat(g, self.n, axis=-1)
        return out.astype(img.dtype) if np.issubdtype(
            img.dtype, np.integer) else out


class ColorJitter:
    """Brightness, contrast, saturation and hue factors drawn per call, in
    that order, each from [max(0, 1 - v), 1 + v] (hue's shift from [-v,
    v])."""

    def __init__(self, brightness=0.0, contrast=0.0, saturation=0.0,
                 hue=0.0):
        self.b, self.c, self.s, self.h = brightness, contrast, saturation, hue

    @staticmethod
    def _rand(v):
        return float(np.random.uniform(max(0.0, 1 - v), 1 + v))

    def __call__(self, img):
        img = np.asarray(img).astype(np.float32)
        caxis = 0 if _chw(img) else -1
        if self.b:
            img = img * self._rand(self.b)
        if self.c:
            mean = img.mean()
            img = (img - mean) * self._rand(self.c) + mean
        if self.s:
            w = np.array([0.299, 0.587, 0.114], np.float32)
            gray = np.expand_dims(np.tensordot(w, img, axes=([0], [caxis])),
                                  caxis)
            img = (img - gray) * self._rand(self.s) + gray
        if self.h:
            shift = float(np.random.uniform(-self.h, self.h))
            mean = img.mean(axis=caxis, keepdims=True)
            img = img + shift * (np.roll(img, 1, axis=caxis) - mean)
        return np.clip(img, 0.0, 255.0 if img.max() > 1.5 else 1.0)


class RandomRotation:
    """A uniform random angle in ``degrees``, nearest-pixel resampling
    about ``center`` ((x, y)); ``expand`` enlarges the canvas to hold the
    whole turned image."""

    def __init__(self, degrees, expand=False, center=None, fill=0):
        if isinstance(degrees, (int, float)):
            degrees = (-abs(degrees), abs(degrees))
        self.degrees = tuple(degrees)
        self.expand = expand
        self.center = center
        self.fill = fill

    def __call__(self, img):
        img = np.asarray(img)
        ang = np.deg2rad(np.random.uniform(*self.degrees))
        chw = _chw(img)
        h_axis, w_axis = (1, 2) if chw else (0, 1)
        H, W = img.shape[h_axis], img.shape[w_axis]
        if self.center is not None:
            cx, cy = self.center
        else:
            cy, cx = (H - 1) / 2.0, (W - 1) / 2.0
        if self.expand:
            Ho = int(np.ceil(abs(H * np.cos(ang)) + abs(W * np.sin(ang))))
            Wo = int(np.ceil(abs(H * np.sin(ang)) + abs(W * np.cos(ang))))
        else:
            Ho, Wo = H, W
        oy, ox = (Ho - 1) / 2.0, (Wo - 1) / 2.0
        yy, xx = np.mgrid[0:Ho, 0:Wo]
        if self.expand:  # centred on its own canvas, sampled about (cy, cx)
            yy = yy - oy + cy
            xx = xx - ox + cx
        ys = cy + (yy - cy) * np.cos(ang) - (xx - cx) * np.sin(ang)
        xs = cx + (yy - cy) * np.sin(ang) + (xx - cx) * np.cos(ang)
        yi = np.clip(np.rint(ys).astype(np.int64), 0, H - 1)
        xi = np.clip(np.rint(xs).astype(np.int64), 0, W - 1)
        valid = (ys >= 0) & (ys <= H - 1) & (xs >= 0) & (xs <= W - 1)
        if chw:
            out = np.where(valid[None], img[:, yi, xi], self.fill)
        else:
            out = np.where(valid[..., None] if img.ndim == 3 else valid,
                           img[yi, xi], self.fill)
        return out.astype(img.dtype)


class RandomResizedCrop:
    """A crop of random area (``scale``) and aspect (``ratio``, drawn in
    log space), up to ten tries before the centred square, resized to
    ``size`` by ``Resize``."""

    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation="bilinear"):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.scale = scale
        self.ratio = ratio

    def __call__(self, img):
        img = np.asarray(img)
        h_axis, w_axis = (1, 2) if _chw(img) else (0, 1)
        H, W = img.shape[h_axis], img.shape[w_axis]
        area = H * W
        for _ in range(10):
            target = area * np.random.uniform(*self.scale)
            ar = np.exp(np.random.uniform(np.log(self.ratio[0]),
                                          np.log(self.ratio[1])))
            w = int(round(np.sqrt(target * ar)))
            h = int(round(np.sqrt(target / ar)))
            if 0 < w <= W and 0 < h <= H:
                top = np.random.randint(0, H - h + 1)
                left = np.random.randint(0, W - w + 1)
                break
        else:
            h, w = min(H, W), min(H, W)
            top, left = (H - h) // 2, (W - w) // 2
        sl = [slice(None)] * img.ndim
        sl[h_axis] = slice(top, top + h)
        sl[w_axis] = slice(left, left + w)
        return Resize(self.size)(img[tuple(sl)])
