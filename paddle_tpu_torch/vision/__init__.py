"""Vision models and datasets of the ported training paths (counterpart
of ``paddle_tpu/vision``)."""

from . import datasets, models

__all__ = ["datasets", "models"]
