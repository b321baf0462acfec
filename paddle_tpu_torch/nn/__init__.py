"""The layers of the ported training paths (counterpart of
``paddle_tpu/nn``): what ResNet needs, under the JAX package's names."""

from . import functional, initializer
from .layer import (AdaptiveAvgPool2D, BatchNorm2D, Conv2D, CrossEntropyLoss,
                    Layer, Linear, MaxPool2D, Parameter, ParamAttr, ReLU,
                    Sequential)

__all__ = ["functional", "initializer", "Layer", "Parameter", "ParamAttr",
           "Conv2D", "BatchNorm2D", "MaxPool2D", "AdaptiveAvgPool2D", "ReLU", "Linear",
           "Sequential", "CrossEntropyLoss"]
