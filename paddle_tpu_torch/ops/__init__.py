"""Operators of the port: the op corpus (port of ``paddle_tpu/ops``: every
op a registered function over torch tensors) and, in ``kernels``, the
hand-written Hopper kernels."""

from . import creation, linalg, logic, manipulation, math, reduction, special, tail
from .creation import *  # noqa: F401,F403
from .dispatch import run_op  # noqa: F401
from .linalg import *  # noqa: F401,F403
from .logic import *  # noqa: F401,F403
from .manipulation import *  # noqa: F401,F403
from .math import *  # noqa: F401,F403
from .reduction import *  # noqa: F401,F403
from .special import *  # noqa: F401,F403
from .tail import *  # noqa: F401,F403
from .registry import OPS, all_ops, get_op, register_op  # noqa: F401

from . import _tensor_methods

_tensor_methods.attach()

__all__ = list(
    dict.fromkeys(
        creation.__all__
        + math.__all__
        + reduction.__all__
        + manipulation.__all__
        + logic.__all__
        + linalg.__all__
        + special.__all__
        + tail.__all__
    )
)
