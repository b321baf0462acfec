"""The eager core (port of ``paddle_tpu/core``): dtypes, places, the
``Tensor`` subclass and autograd on torch's engine."""

from . import autograd, dtype, tensor
from ..device import (CPUPlace, CUDAPlace, CustomPlace, Place, TPUPlace,
                      get_device, is_compiled_with_tpu, set_device)
from .autograd import enable_grad, is_grad_enabled, no_grad, set_grad_enabled
from .dtype import *  # noqa: F401,F403
from .tensor import Tensor, to_tensor
