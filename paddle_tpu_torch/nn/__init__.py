"""The layers of the ported training paths (counterpart of
``paddle_tpu/nn``): what ResNet, LeNet and the transformer stack
(PaddleNLP's BERT/ERNIE layers) need, under the JAX package's names, and
gradient clipping (``clip``)."""

from . import clip, functional, initializer
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .layer import (GELU, AdaptiveAvgPool2D, BatchNorm2D, Conv2D,
                    CrossEntropyLoss, Dropout, Embedding, Layer, LayerList,
                    LayerNorm, Linear, MaxPool2D, MultiHeadAttention,
                    Parameter, ParamAttr, ReLU, Sequential, Softmax,
                    Transformer, TransformerDecoder, TransformerDecoderLayer,
                    TransformerEncoder, TransformerEncoderLayer)

__all__ = ["clip", "functional", "initializer", "ClipGradByValue",
           "ClipGradByNorm", "ClipGradByGlobalNorm", "Layer", "Parameter",
           "ParamAttr", "Conv2D", "BatchNorm2D", "MaxPool2D", "AdaptiveAvgPool2D", "ReLU", "Linear",
           "Sequential", "CrossEntropyLoss", "LayerNorm", "Dropout",
           "Embedding", "GELU", "Softmax", "LayerList",
           "MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder", "TransformerDecoderLayer",
           "TransformerDecoder", "Transformer"]
