"""The PaddleClas recipe the vision slice runs: Flowers-102 fine-tuning
as PaddleClas's quick start sets it up (``ppcls/configs/quick_start``):
ResNet-50 with 102 classes, batches of 32, ``Momentum(0.9)`` at a
learning rate of 0.0125 with L2 decay 1e-4, and the ImageNet input
pipeline.

- ``flowers_transforms(train)``: ``RandomResizedCrop(224)``,
  ``RandomHorizontalFlip()`` and ``Normalize`` (ImageNet mean and
  standard deviation) for training; ``Resize(256)``, ``CenterCrop(224)``
  and the same ``Normalize`` for evaluation. Numpy on the host, drawing
  from numpy's global state (``transforms``' docstring).
- ``flowers_model()``: the ``Model`` over
  ``resnet50(num_classes=FLOWERS_CLASSES)``
  trained as phase 6 of ``chip_smoke.py`` trains ResNet-50: parameters
  in bf16 by ``amp.decorate`` (O2), the forward under ``auto_cast`` O2
  (``O2Classifier``, which hands the loss fp32 logits), the update the
  flat ``multi_tensor_update``; prepared with ``CrossEntropyLoss`` and
  ``Accuracy``.
"""

from __future__ import annotations

from .. import amp, metric, nn, optimizer
from ..hapi.model import Model
from . import transforms as T
from .models import resnet50

__all__ = ["FLOWERS_CLASSES", "FLOWERS_MEAN", "FLOWERS_STD", "FLOWERS_LR",
           "FLOWERS_MOMENTUM", "FLOWERS_L2", "FLOWERS_BATCH",
           "flowers_transforms", "O2Classifier", "flowers_model"]

FLOWERS_CLASSES = 102
FLOWERS_MEAN = [0.485, 0.456, 0.406]
FLOWERS_STD = [0.229, 0.224, 0.225]
FLOWERS_LR, FLOWERS_MOMENTUM, FLOWERS_L2 = 0.0125, 0.9, 1e-4
FLOWERS_BATCH = 32


def flowers_transforms(train: bool, size: int = 224, resize: int = 256):
    norm = T.Normalize(mean=FLOWERS_MEAN, std=FLOWERS_STD)
    if train:
        return T.Compose([T.RandomResizedCrop(size),
                          T.RandomHorizontalFlip(), norm])
    return T.Compose([T.Resize(resize), T.CenterCrop(size), norm])


class O2Classifier(nn.Layer):
    """``net``'s forward under ``auto_cast`` O2 (bf16), its logits
    returned in fp32 for the loss and the metrics."""

    def __init__(self, net):
        super().__init__()
        self.net = net

    def forward(self, x):
        with amp.auto_cast(level="O2", dtype="bfloat16"):
            return self.net(x).float()


def flowers_model():
    """The prepared ``Model`` and its optimizer (built on the current
    device, from the current seed)."""
    net = resnet50(num_classes=FLOWERS_CLASSES)
    opt = optimizer.Momentum(learning_rate=FLOWERS_LR,
                             momentum=FLOWERS_MOMENTUM,
                             parameters=net.parameters(),
                             weight_decay=FLOWERS_L2)
    net, opt = amp.decorate(models=net, optimizers=opt, level="O2",
                            dtype="bfloat16")
    model = Model(O2Classifier(net))
    model.prepare(opt, nn.CrossEntropyLoss(), metric.Accuracy())
    return model, opt
