"""Activation layers (``mxnet_tpu/gluon/nn/activations.py``): Activation,
LeakyReLU, PReLU, ELU, SELU, Swish, GELU and SiLU, over ``ops.nn``'s
``activation`` and ``leaky_relu``.  ``PReLU``'s ``alpha`` is a parameter
of ``in_channels`` (1 by default, broadcast over every channel),
``Constant(0.25)`` unless another initializer is given; its width is
never inferred, as in the JAX layer."""
from __future__ import annotations

import torch

from ... import initializer as _init
from ...ops import nn as _ops
from ..block import HybridBlock
from .basic_layers import _empty

__all__ = ["Activation", "LeakyReLU", "PReLU", "ELU", "SELU", "Swish", "GELU",
           "SiLU"]


class Activation(HybridBlock):
    """Elementwise activation by name (:func:`ops.nn.activation`)."""

    def __init__(self, activation: str):
        super().__init__()
        self._act_type = activation

    def forward(self, x):
        return _ops.activation(x, self._act_type)


class LeakyReLU(HybridBlock):
    """``x`` above 0, ``alpha * x`` below."""

    def __init__(self, alpha: float):
        super().__init__()
        self._alpha = alpha

    def forward(self, x):
        return _ops.leaky_relu(x, act_type="leaky", slope=self._alpha)


class PReLU(HybridBlock):
    """``x`` above 0, ``alpha * x`` below, ``alpha`` learned per channel
    (axis 1): ``PReLU(alpha_initializer=None, in_channels=1)``."""

    def __init__(self, alpha_initializer=None, in_channels: int = 1,
                 device=None, dtype=torch.float32):
        super().__init__()
        self.alpha = _empty((int(in_channels),), device, dtype,
                            alpha_initializer or _init.Constant(0.25))

    def forward(self, x):
        return _ops.leaky_relu(x, self.alpha, act_type="prelu")


class ELU(HybridBlock):
    """``x`` above 0, ``alpha * (exp(x) - 1)`` below."""

    def __init__(self, alpha: float = 1.0):
        super().__init__()
        self._alpha = alpha

    def forward(self, x):
        return _ops.leaky_relu(x, act_type="elu", slope=self._alpha)


class SELU(HybridBlock):
    """Scaled ELU with the fixed constants of ``jax.nn.selu``."""

    def forward(self, x):
        return _ops.leaky_relu(x, act_type="selu")


class GELU(HybridBlock):
    """GELU: ``approximation="erf"`` (the default) is exact, any other
    value the tanh form, as the JAX layer picks them."""

    def __init__(self, approximation: str = "erf"):
        super().__init__()
        self._approx = approximation

    def forward(self, x):
        return _ops.activation(
            x, "erf_gelu" if self._approx == "erf" else "gelu")


class Swish(HybridBlock):
    """``x * sigmoid(beta * x)``."""

    def __init__(self, beta: float = 1.0):
        super().__init__()
        self._beta = beta

    def forward(self, x):
        return x * torch.sigmoid(self._beta * x)


class SiLU(HybridBlock):
    """``x * sigmoid(x)``."""

    def forward(self, x):
        return _ops.activation(x, "silu")
