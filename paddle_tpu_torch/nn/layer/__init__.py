from .activation import GELU, ReLU, Softmax
from .common import Dropout, Embedding, Linear
from .container import LayerList, Sequential
from .conv import Conv2D
from .layers import Layer, Parameter, ParamAttr
from .loss import CrossEntropyLoss
from .norm import BatchNorm2D, LayerNorm
from .pooling import AdaptiveAvgPool2D, MaxPool2D
from .transformer import (MultiHeadAttention, Transformer,
                          TransformerDecoder, TransformerDecoderLayer,
                          TransformerEncoder, TransformerEncoderLayer)

__all__ = ["Layer", "Parameter", "ParamAttr", "Conv2D", "BatchNorm2D",
           "MaxPool2D",
           "AdaptiveAvgPool2D", "ReLU", "Linear", "Sequential",
           "CrossEntropyLoss", "LayerNorm", "Dropout", "Embedding", "GELU",
           "Softmax", "LayerList", "MultiHeadAttention",
           "TransformerEncoderLayer", "TransformerEncoder",
           "TransformerDecoderLayer", "TransformerDecoder", "Transformer"]
