"""Framework utilities (counterpart of ``paddle_tpu/framework``):
``save`` and ``load``."""

from .io import load, save

__all__ = ["save", "load"]
