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
UCIHousing datasets, Viterbi decoding).
"""

from . import incubate, io, metric, nn, optimizer, text, vision
from .device import get_device, resolve_device, set_device
from .framework.io import load, save
from .hapi import callbacks
from .hapi.model import Model
from .hapi.model_summary import flops, summary
from .nn.initializer import seed

__all__ = ["resolve_device", "set_device", "get_device", "seed", "Model",
           "summary", "flops", "save", "load", "io", "metric", "callbacks",
           "nn", "optimizer", "vision", "incubate", "text"]
