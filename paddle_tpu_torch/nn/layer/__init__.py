from .activation import ReLU
from .common import Linear
from .container import Sequential
from .conv import Conv2D
from .layers import Layer, Parameter, ParamAttr
from .loss import CrossEntropyLoss
from .norm import BatchNorm2D
from .pooling import AdaptiveAvgPool2D, MaxPool2D

__all__ = ["Layer", "Parameter", "ParamAttr", "Conv2D", "BatchNorm2D",
           "MaxPool2D",
           "AdaptiveAvgPool2D", "ReLU", "Linear", "Sequential",
           "CrossEntropyLoss"]
