"""``ReLU``, ``GELU`` and ``Softmax`` (counterpart of
``paddle_tpu/nn/layer/activation.py``)."""

from __future__ import annotations

from .. import functional as F
from .layers import Layer

__all__ = ["ReLU", "GELU", "Softmax"]


class ReLU(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.relu(x)


class GELU(Layer):
    def __init__(self, approximate=False, name=None):
        super().__init__()
        self._approximate = approximate

    def forward(self, x):
        return F.gelu(x, self._approximate)


class Softmax(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self._axis = axis

    def forward(self, x):
        return F.softmax(x, self._axis)
