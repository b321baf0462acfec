"""Vision models of the ported training paths (counterpart of
``paddle_tpu/vision``)."""

from . import models

__all__ = ["models"]
