"""The eager optimizers (counterpart of ``paddle_tpu/optimizer``), with
the multi-tensor flat update: ``SGD``, ``Momentum``, ``Adam``, ``AdamW``,
``Lamb``."""

from .adam import Adam, AdamW, Lamb
from .optimizer import SGD, Momentum, Optimizer

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Lamb"]
