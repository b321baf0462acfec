"""The high-level API (counterpart of ``paddle_tpu/hapi``): ``Model``,
its callbacks, ``summary`` and ``flops``."""

from . import callbacks
from .model import Model
from .model_summary import flops, summary

__all__ = ["Model", "callbacks", "summary", "flops"]
