"""LeNet (counterpart of ``paddle_tpu/vision/models/lenet.py``), BASELINE
config 0's model: two convolutions with ReLU and 2x2 max pooling, then
three linear layers, on ``[N, 1, 28, 28]`` inputs. Its 10 parameters
(61,610 elements) keep the reference's state-dict keys
(``features.0.weight`` ... ``fc.2.bias``), so
``models.convert.layer_state_from_numpy`` loads the JAX LeNet's weights."""

from __future__ import annotations

from ... import nn
from ...nn import functional as F

__all__ = ["LeNet"]


class LeNet(nn.Layer):
    def __init__(self, num_classes=10):
        super().__init__()
        self.num_classes = num_classes
        self.features = nn.Sequential(
            nn.Conv2D(1, 6, 3, stride=1, padding=1),
            nn.ReLU(),
            nn.MaxPool2D(2, 2),
            nn.Conv2D(6, 16, 5, stride=1, padding=0),
            nn.ReLU(),
            nn.MaxPool2D(2, 2),
        )
        if num_classes > 0:
            self.fc = nn.Sequential(
                nn.Linear(400, 120),
                nn.Linear(120, 84),
                nn.Linear(84, num_classes),
            )

    def forward(self, inputs):
        x = self.features(inputs)
        if self.num_classes > 0:
            x = self.fc(F.flatten(x, 1))
        return x
