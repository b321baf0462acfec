"""Parameter initializers: the ones the ported layers use, each drawing
from an explicit ``torch.Generator``.

Counterpart of ``paddle_tpu/nn/initializer``. The JAX package draws from
``jax.random``; the port cannot reproduce those bits, so a test that needs
both packages to hold the same weights carries them across as numpy
(``models.convert.layer_state_from_numpy``). Layers draw from the
generator ``seed`` sets (the counterpart of ``paddle.seed``), on the CPU,
then move the values to their device, so one seed gives the same weights
on every device. ``generator(device)`` is the generator random ops
(``nn.functional.dropout``) draw from: that CPU generator on the CPU, and
on a card one generator of its own, seeded by the same ``seed`` value, so
masks are drawn where they are used.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch

__all__ = ["Initializer", "Constant", "Uniform", "Normal", "XavierNormal",
           "XavierUniform",
           "seed", "default_generator", "generator"]

_GENERATOR = torch.Generator().manual_seed(0)
_SEED = [0]
_DEVICE_GENERATORS = {}  # torch.device -> its generator, since the seed


def seed(value: int) -> torch.Generator:
    """Reseed the generator layers draw their initial weights from, and
    the cards' generators of random ops."""
    _SEED[0] = int(value)
    _DEVICE_GENERATORS.clear()
    return _GENERATOR.manual_seed(int(value))


def default_generator() -> torch.Generator:
    return _GENERATOR


def generator(device) -> torch.Generator:
    """The generator a random op on ``device`` draws from: the CPU
    generator of the weights, or the card's own, made at its first use
    from the last ``seed`` value."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return _GENERATOR
    g = _DEVICE_GENERATORS.get(dev)
    if g is None:
        g = _DEVICE_GENERATORS[dev] = torch.Generator(
            device=dev).manual_seed(_SEED[0])
    return g


def _fans(shape: Sequence[int]) -> Tuple[int, int]:
    shape = tuple(shape)
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:  # paddle's linear weight [in, out]
        return shape[0], shape[1]
    receptive = int(np.prod(shape[2:]))
    return shape[1] * receptive, shape[0] * receptive


class Initializer:
    def __call__(self, shape, dtype=torch.float32, device="cpu",
                 generator=None) -> torch.Tensor:
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value: float = 0.0):
        self.value = value

    def __call__(self, shape, dtype=torch.float32, device="cpu",
                 generator=None):
        return torch.full(tuple(shape), float(self.value), dtype=dtype,
                          device=device)


class Uniform(Initializer):
    def __init__(self, low: float = -1.0, high: float = 1.0):
        self.low, self.high = low, high

    def __call__(self, shape, dtype=torch.float32, device="cpu",
                 generator=None):
        out = torch.empty(tuple(shape), dtype=torch.float32).uniform_(
            self.low, self.high, generator=generator or _GENERATOR)
        return out.to(device=device, dtype=dtype)


class Normal(Initializer):
    def __init__(self, mean: float = 0.0, std: float = 1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype=torch.float32, device="cpu",
                 generator=None):
        out = torch.empty(tuple(shape), dtype=torch.float32).normal_(
            self.mean, self.std, generator=generator or _GENERATOR)
        return out.to(device=device, dtype=dtype)


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain: float = 1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype=torch.float32, device="cpu",
                 generator=None):
        fi, fo = _fans(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        std = self.gain * math.sqrt(2.0 / (fi + fo))
        return Normal(0.0, std)(shape, dtype, device, generator)


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain: float = 1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype=torch.float32, device="cpu",
                 generator=None):
        fi, fo = _fans(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        limit = self.gain * math.sqrt(6.0 / (fi + fo))
        return Uniform(-limit, limit)(shape, dtype, device, generator)
