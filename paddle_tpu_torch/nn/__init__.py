"""The layers of the ported training paths (counterpart of
``paddle_tpu/nn``): what ResNet and LeNet need, under the JAX package's
names, and gradient clipping (``clip``)."""

from . import clip, functional, initializer
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .layer import (AdaptiveAvgPool2D, BatchNorm2D, Conv2D, CrossEntropyLoss,
                    Layer, Linear, MaxPool2D, Parameter, ParamAttr, ReLU,
                    Sequential)

__all__ = ["clip", "functional", "initializer", "ClipGradByValue",
           "ClipGradByNorm", "ClipGradByGlobalNorm", "Layer", "Parameter",
           "ParamAttr", "Conv2D", "BatchNorm2D", "MaxPool2D", "AdaptiveAvgPool2D", "ReLU", "Linear",
           "Sequential", "CrossEntropyLoss"]
