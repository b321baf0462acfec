"""The eager optimizers (counterpart of ``paddle_tpu/optimizer``), with
the multi-tensor flat update: ``SGD``, ``Momentum``, ``Adam``, ``AdamW``,
``Lamb``; the LR schedulers (``lr``) and the regularizers ``L2Decay`` and
``L1Decay``."""

from . import lr
from .adam import Adam, AdamW, Lamb
from .optimizer import SGD, L1Decay, L2Decay, Momentum, Optimizer

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Lamb", "lr",
           "L2Decay", "L1Decay"]
