"""LeNet-5 (LeCun et al. 1998), the model of the MNIST drive.

The port of ``mxnet_tpu/gluon/model_zoo/vision/lenet.py``: NCHW input
of 28 x 28 x 1, ``features`` = Conv2D(20, 5, tanh), MaxPool(2, 2),
Conv2D(50, 5, tanh), MaxPool(2, 2), Flatten, Dense(500, tanh), then
``output`` = Dense(classes), with the JAX ``collect_params()`` names
(``features.0.weight`` (20, 1, 5, 5) OIHW, ..., ``features.5.weight``
(500, 800), ``output.weight`` (classes, 500)).  The JAX layers infer
their input widths at the first forward; here they are given:
``in_units = 50 * 4 * 4 = 800`` for 28 x 28 input.  Built on ``cuda:0``
unless ``device="cpu"`` is passed.
"""
from __future__ import annotations

import torch

from ....context import resolve_device
from ...block import HybridBlock
from ...nn import Conv2D, Dense, Flatten, HybridSequential, MaxPool2D

__all__ = ["LeNet", "lenet"]


class LeNet(HybridBlock):
    def __init__(self, classes: int = 10, in_channels: int = 1,
                 in_units: int = 800, device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.features = HybridSequential().add(
            Conv2D(20, 5, activation="tanh", in_channels=in_channels, **kw),
            MaxPool2D(2, 2),
            Conv2D(50, 5, activation="tanh", in_channels=20, **kw),
            MaxPool2D(2, 2),
            Flatten(),
            Dense(500, activation="tanh", in_units=in_units, **kw))
        self.output = Dense(classes, in_units=500, **kw)

    def forward(self, x):
        return self.output(self.features(x))


def lenet(classes: int = 10, **kw) -> LeNet:
    return LeNet(classes=classes, **kw)
