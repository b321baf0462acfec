"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu for NVIDIA Hopper.

The JAX package ``paddle_tpu`` stays the reference; this package mirrors
its layout module by module. Plain tensor code is PyTorch; every Pallas
kernel on a ported path is a hand-written Hopper kernel (CUDA C++ under
``csrc/``, wrapped under ``ops/kernels/``), each with a plain PyTorch
version that CPU tensors take.

Ported so far: the continuous-batching LLaMA serving engine
(``inference.serving.ServingEngine``) on the slot-contiguous KV cache or
on a paged pool (``inference.paged_kv``, with ``inference.prefix_cache``'s
page-sharing prefix cache), the online scheduler over it
(``inference.scheduler``), and the KV-cache decoder under them
(``models.llama``); the LLaMA training step; and the eager framework's
training path for ResNet (``vision.models``, ``nn``, ``amp``,
``optimizer``, ``jit.fused_train_step``) with the multi-tensor optimizer
update; and the high-level API that BASELINE config 0 (MNIST LeNet through
``Model.fit``) runs: ``Model`` with its ``callbacks``, ``io``
(``DataLoader``), ``metric``, ``vision.datasets``, ``save`` / ``load``,
``optimizer.lr``, gradient clipping (``nn.clip``) and ``L2Decay``; and
BASELINE config 2: the BERT/ERNIE MLM trainer (``models.bert``) and the
eager transformer stack (``nn``'s transformer layers,
``nn.functional.flash_attention``, ``incubate.nn``'s fused entry points)
on the flash kernels, bf16 and fp32; and the PaddleClas model zoo
(``vision.models``: AlexNet, VGG, SqueezeNet, MobileNet V1/V2/V3,
ShuffleNetV2, DenseNet, GoogLeNet, InceptionV3) on every layer of ``nn``'s
activation, common, container, conv, norm and pooling files; and the rest
of ``nn`` (the losses, the recurrent layers, the extras, ``nn.utils``), the
other optimizers with ``LBFGS``, and ``text`` (the Imdb, Imikolov and
UCIHousing datasets, Viterbi decoding); and the eager core and the op
corpus (``core``: dtypes, places, the ``Tensor`` subclass of
``torch.Tensor``, autograd; ``ops``: the reference's 303 registered ops,
``fft`` among them; ``_C_ops``; ``autograd``; ``flags``;
``framework.random``), so an ``import paddle`` script runs with
``import paddle_tpu_torch as paddle``; and the runtime modules
(``device``: counts, memory statistics, streams and events; ``utils``
with ``cpp_extension`` and ``dlpack``; ``amp.debugging``; ``version``;
``sysconfig``); and training on a mesh over ``torch.distributed``
(``distributed``: the environment and ``fleet``'s tensor-parallel layers;
``parallel``: the hybrid mesh; ``ops.ring_attention``; LLaMA's and BERT's
``make_sharded_train_step`` with Megatron TP, sequence parallelism and
ZeRO 1-3).
"""

from __future__ import annotations

__version__ = "0.1.0"

from . import flags as _flags_mod  # noqa: F401
from .flags import get_flags, set_flags

from .core import (CPUPlace, CUDAPlace, CustomPlace, Place, TPUPlace, Tensor,
                   enable_grad, get_device, is_compiled_with_tpu, no_grad,
                   set_device, set_grad_enabled, to_tensor)
from .core.dtype import (bfloat16, bool_, complex64, complex128, dtype,
                         finfo, float16, float32, float64, iinfo, int8, int16,
                         int32, int64, uint8)
from .core.autograd import is_grad_enabled
from .device import is_compiled_with_cuda, resolve_device

# the op corpus onto the top-level namespace (paddle.add, paddle.matmul, ...)
from .ops import *  # noqa: F401,F403
from .ops import creation, linalg, logic, manipulation, math, reduction  # noqa: F401
from .ops.registry import all_ops

from .framework.random import (get_cuda_rng_state, get_rng_state, seed,
                               set_cuda_rng_state, set_rng_state)
from .framework.io import load, save

from . import _C_ops  # noqa: F401
from . import amp  # noqa: F401
from . import autograd  # noqa: F401
from . import fft  # noqa: F401
from . import incubate, io, jit, metric, nn, optimizer, text, vision  # noqa: F401
from . import profiler  # noqa: F401
from . import device, sysconfig, utils, version  # noqa: F401
from . import distributed, parallel  # noqa: F401
from .distributed.parallel import DataParallel  # noqa: F401
from .hapi import callbacks  # noqa: F401  (paddle.callbacks alias)
from .hapi.model import Model  # noqa: F401
from .hapi.model_summary import flops, summary  # noqa: F401
from .nn.layer.layers import ParamAttr  # noqa: F401

# modules that wait for a later slice, by their ROADMAP Queue A item
_WAITING = {"static": 8}


def __getattr__(name):
    if name in _WAITING:
        raise NotImplementedError(
            f"paddle_tpu_torch.{name} is not ported yet (ROADMAP Queue A "
            f"item {_WAITING[name]})")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def is_compiled_with_xpu() -> bool:
    return False


def in_dynamic_mode() -> bool:
    """Eager mode is the only mode until ``static`` is ported."""
    return True


def disable_static():
    """Eager mode is already on: nothing to do."""


def enable_static():
    raise NotImplementedError(
        "paddle_tpu_torch.enable_static is not ported yet (ROADMAP Queue A "
        "item 8: compile, analysis and profiler paths)")


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, only_inputs=True, allow_unused=False):
    """``paddle.grad`` (see ``autograd.grad``)."""
    return autograd.grad(outputs, inputs, grad_outputs, retain_graph,
                         create_graph, only_inputs, allow_unused)


def set_printoptions(precision=None, threshold=None, edgeitems=None,
                     sci_mode=None, linewidth=None):
    """Tensor print formatting (``paddle.set_printoptions``): tensors
    render through torch, so this maps onto ``torch.set_printoptions``."""
    import torch as _torch

    _torch.set_printoptions(precision=precision, threshold=threshold,
                            edgeitems=edgeitems, linewidth=linewidth,
                            sci_mode=sci_mode)


class LazyGuard:
    """API parity with the reference's deferred-parameter-init guard:
    parameters are made when a layer is built, so there is nothing to
    defer; it exists so reference scripts run unchanged."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def batch(reader, batch_size, drop_last=False):
    """Old-style reader decorator (``paddle.batch``): wraps an
    item-yielding reader into a batch-yielding one."""

    def batched():
        buf = []
        for item in reader():
            buf.append(item)
            if len(buf) == batch_size:
                yield buf
                buf = []
        if buf and not drop_last:
            yield buf

    return batched


def disable_signal_handler():
    """API parity: the reference uninstalls its C++ crash handlers; this
    runtime installs none, so there is nothing to disable."""
