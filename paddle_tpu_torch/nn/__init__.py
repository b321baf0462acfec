"""The layers of the ported paths (counterpart of ``paddle_tpu/nn``):
every class of the reference's layer files (activation, common,
container, conv, norm, pooling, loss, rnn, extras and the transformer
stack) under the JAX package's names, their functional ops,
initializers, gradient clipping (``clip``) and ``utils`` (gradient
clipping in place, parameter vectors, weight and spectral norm)."""

from . import clip, functional, initializer, utils
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .layer import *  # noqa: F401,F403
from .layer import __all__ as _layers
from .utils import (clip_grad_norm_, clip_grad_value_, parameters_to_vector,
                    vector_to_parameters)

__all__ = ["clip", "functional", "initializer", "utils", "ClipGradByValue",
           "ClipGradByNorm", "ClipGradByGlobalNorm", "clip_grad_norm_",
           "clip_grad_value_", "parameters_to_vector",
           "vector_to_parameters", *_layers]
