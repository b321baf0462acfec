"""The eager optimizers (counterpart of ``paddle_tpu/optimizer``), with
the multi-tensor flat update for ``SGD``, ``Momentum``, ``Adam``,
``AdamW`` and ``Lamb``; ``Adagrad``, ``Adadelta``, ``RMSProp``, ``ASGD``,
``Rprop``, ``Lion``, ``Adamax``, ``NAdam``, ``RAdam`` and ``LBFGS``, which
step each parameter on its own; the LR schedulers (``lr``) and the
regularizers ``L2Decay`` and ``L1Decay``."""

from . import lr
from .adam import Adam, Adamax, AdamW, Lamb, Lion, NAdam, RAdam
from .lbfgs import LBFGS
from .optimizer import (ASGD, SGD, Adadelta, Adagrad, L1Decay, L2Decay,
                        Momentum, Optimizer, RMSProp, Rprop)

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Lamb",
           "Adagrad", "Adadelta", "RMSProp", "Adamax", "NAdam", "RAdam",
           "Lion", "LBFGS", "ASGD", "Rprop", "lr", "L2Decay", "L1Decay"]
