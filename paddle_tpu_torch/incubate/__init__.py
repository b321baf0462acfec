"""``incubate``: the fused-op entry points that PaddleNLP's ERNIE code
calls (``incubate.nn``). Counterpart of ``paddle_tpu/incubate``; its MoE,
ASP, segment and autograd APIs are not ported."""

from . import nn

__all__ = ["nn"]
