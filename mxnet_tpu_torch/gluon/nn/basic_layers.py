"""The layers of the serving and training paths as ``nn.Module``s:
Dense, Dropout, Embedding, LayerNorm, BatchNorm, BatchNormReLU,
Activation, Flatten and HybridSequential, with the JAX package's
parameter names and shapes (``weight`` (units, in_units), ``bias``;
``gamma`` / ``beta``; BatchNorm's ``running_mean`` / ``running_var``).
Parameters are trainable (``requires_grad``); serving runs its forwards
under ``torch.inference_mode`` or ``torch.no_grad``.  Dropout and
BatchNorm train exactly when ``autograd.is_training()`` is true (inside
``autograd.record()``), as the JAX layers do; the module's ``.training``
flag does not decide.

The JAX layers infer their input width at the first forward
(``in_channels=0``); the port's take it at construction and raise
without it."""
from __future__ import annotations

import torch
from torch import nn

from ... import autograd as _ag
from ... import numpy_extension as _npx
from ... import random as _random
from ...base import MXNetError
from ...ops import nn as _ops
from ..block import HybridBlock

__all__ = ["Dense", "Dropout", "Embedding", "LayerNorm", "BatchNorm",
           "BatchNormReLU", "Activation", "Flatten", "HybridSequential"]


def _empty(shape, device, dtype):
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype))


class Dense(HybridBlock):
    """Fully-connected layer ``y = act(x W^T + b)``, in the JAX package's
    signature: ``Dense(units, activation=None, use_bias=True,
    flatten=True, dtype, in_units=0)``.  ``flatten=True`` collapses all
    but the batch axis first; ``flatten=False`` keeps the leading axes,
    as the transformer layers use it.  ``activation`` is an
    :func:`~mxnet_tpu_torch.ops.nn.activation` name or None.  The port
    builds the weight at construction, so ``in_units`` must be given:
    ``in_units=0`` (the reference infers it at the first forward)
    raises."""

    def __init__(self, units: int, activation=None, use_bias: bool = True,
                 flatten: bool = True, dtype=torch.float32,
                 in_units: int = 0, device=None):
        super().__init__()
        if int(in_units) <= 0:
            raise MXNetError(
                f"Dense({units}): in_units must be given; the port builds "
                "parameters at construction (deferred shape inference is "
                "ROADMAP A6)")
        self._flatten = flatten
        self._act = activation
        self.weight = _empty((units, int(in_units)), device, dtype)
        self.bias = _empty((units,), device, dtype) if use_bias else None

    def forward(self, x):
        y = _ops.fully_connected(x, self.weight, self.bias,
                                 flatten=self._flatten)
        return y if self._act is None else _ops.activation(y, self._act)


class Dropout(HybridBlock):
    """Dropout with rate ``rate`` in training
    (``autograd.is_training()``); the identity outside it, which is all
    that serving runs.  The keep-mask comes from a uniform drawn in f32,
    whatever ``x``'s type, from the port's seeded generator of ``x``'s
    device (:func:`mxnet_tpu_torch.random.generator`), never from torch's
    global RNG; kept values are ``x / keep`` in ``x``'s type, ``keep = 1 -
    rate`` taken in that type, as the JAX package's ``dropout`` computes
    ``jnp.where(mask, x / keep, 0)`` (``mxnet_tpu/ops/nn.py``).  A uniform
    drawn in bf16 takes a few thousand values and keeps the wrong share."""

    def __init__(self, rate: float):
        super().__init__()
        self._rate = float(rate)

    def forward(self, x):
        if not _ag.is_training() or self._rate == 0.0:
            return x
        u = torch.rand(x.shape, generator=_random.generator(x.device),
                       device=x.device, dtype=torch.float32)
        # keep rounded to x's type on the host, as JAX rounds the weakly
        # typed scalar; the division itself runs in f32 and rounds once
        keep = torch.tensor(1.0 - self._rate, dtype=x.dtype).item()
        return torch.where(u >= self._rate, x / keep, 0.0)


class Embedding(HybridBlock):
    """Row gather from ``weight`` (input_dim, output_dim), in the JAX
    package's signature: ``Embedding(input_dim, output_dim, dtype,
    weight_initializer=None, sparse_grad=False)``.  Ids of any type are
    cast to an integer type first, as the JAX op takes
    ``indices.astype(int32)`` (float ids truncate toward zero).
    ``sparse_grad=True`` (row-sparse gradients) is not ported."""

    def __init__(self, input_dim: int, output_dim: int, dtype=torch.float32,
                 weight_initializer=None, sparse_grad: bool = False,
                 device=None):
        super().__init__()
        if weight_initializer is not None:
            raise MXNetError("Embedding(weight_initializer=...) is not "
                             "ported (initialize(seed) draws every weight); "
                             "ROADMAP A10")
        if sparse_grad:
            raise MXNetError("Embedding(sparse_grad=True) is not ported; "
                             "ROADMAP A6, long tail")
        self.weight = _empty((input_dim, output_dim), device, dtype)

    def forward(self, x):
        if x.dtype not in (torch.int32, torch.int64):
            x = x.to(torch.int32)
        return self.weight[x]


_FILLS = {"zeros": 0.0, "ones": 1.0}


def _fill(init, what: str) -> float:
    if init not in _FILLS:
        raise MXNetError(f"{what}={init!r} is not ported ({sorted(_FILLS)} "
                         "are); ROADMAP A10")
    return _FILLS[init]


class LayerNorm(HybridBlock):
    """Layer normalization over the last axis with ``gamma`` / ``beta``,
    in the JAX package's signature: ``LayerNorm(axis=-1, epsilon=1e-5,
    center=True, scale=True, beta_initializer="zeros",
    gamma_initializer="ones", in_channels=0)``.  ``center=False`` /
    ``scale=False`` keep beta / gamma at their initial value with no
    gradient, as the reference's non-differentiable parameters.  Another
    ``axis`` raises (ROADMAP A6), and so does ``in_channels=0``: the port
    builds parameters at construction."""

    def __init__(self, axis: int = -1, epsilon: float = 1e-5,
                 center: bool = True, scale: bool = True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels: int = 0, device=None, dtype=torch.float32):
        super().__init__()
        if axis != -1:
            raise MXNetError(f"LayerNorm(axis={axis}) is not ported (the "
                             "last axis, -1, is); ROADMAP A6, long tail")
        c = _known(in_channels, "LayerNorm in_channels")
        self._epsilon = epsilon
        #: the values ``initialize`` gives gamma and beta
        self.fills = {"gamma": _fill(gamma_initializer, "gamma_initializer"),
                      "beta": _fill(beta_initializer, "beta_initializer")}
        kw = dict(device=device, dtype=dtype)
        self.gamma = nn.Parameter(torch.full((c,), self.fills["gamma"], **kw),
                                  requires_grad=scale)
        self.beta = nn.Parameter(torch.full((c,), self.fills["beta"], **kw),
                                 requires_grad=center)

    def forward(self, x):
        return _ops.layer_norm(x, self.gamma, self.beta, self._epsilon)


def _known(n: int, what: str) -> int:
    if int(n) <= 0:
        raise MXNetError(f"{what} must be given: the port builds parameters "
                         "at construction (no deferred shape inference)")
    return int(n)


class HybridSequential(HybridBlock, nn.Sequential):
    """Stack of blocks run in order; children are named ``0``, ``1``, ...
    in the order :meth:`add` receives them, as in the JAX package."""

    def add(self, *blocks):
        for b in blocks:
            self.append(b)
        return self


class Activation(HybridBlock):
    """Elementwise activation by name (:func:`ops.nn.activation`)."""

    def __init__(self, activation: str):
        super().__init__()
        self._act_type = activation

    def forward(self, x):
        return _ops.activation(x, self._act_type)


class Flatten(HybridBlock):
    """(N, ...) -> (N, prod(...))."""

    def forward(self, x):
        return x.reshape(x.shape[0], -1)


class BatchNorm(HybridBlock):
    """Batch normalization over ``axis`` (1 for NCHW, -1 for NHWC).

    ``gamma`` / ``beta`` are parameters (trainable when ``scale`` /
    ``center``; ``scale=False`` fixes gamma at 1), ``running_mean`` /
    ``running_var`` buffers.  In training (``autograd.is_training()``) the
    batch statistics normalize and the running statistics blend as
    ``m * momentum + batch * (1 - momentum)`` with the biased variance,
    in place; outside training the running statistics normalize."""

    def __init__(self, axis: int = 1, momentum: float = 0.9,
                 epsilon: float = 1e-5, center: bool = True,
                 scale: bool = True, use_global_stats: bool = False,
                 in_channels: int = 0, device=None, dtype=torch.float32):
        super().__init__()
        c = _known(in_channels, "BatchNorm in_channels")
        self._axis = axis
        self._momentum = momentum
        self._epsilon = epsilon
        self._scale = scale
        self._use_global_stats = use_global_stats
        kw = dict(device=device, dtype=dtype)
        self.gamma = nn.Parameter(torch.ones(c, **kw), requires_grad=scale)
        self.beta = nn.Parameter(torch.zeros(c, **kw), requires_grad=center)
        self.register_buffer("running_mean", torch.zeros(c, **kw))
        self.register_buffer("running_var", torch.ones(c, **kw))

    def _args(self):
        return dict(eps=self._epsilon, momentum=self._momentum,
                    fix_gamma=not self._scale,
                    use_global_stats=self._use_global_stats, axis=self._axis)

    def forward(self, x):
        return _npx.batch_norm(x, self.gamma, self.beta, self.running_mean,
                               self.running_var, **self._args())


class BatchNormReLU(BatchNorm):
    """BatchNorm fused with relu (``npx.batch_norm_with_relu``): in
    training on channel-last input the hand-written ``bn_act`` kernels
    compute the statistics in one read and normalize + relu in another;
    outside training relu of the running-statistics batch norm."""

    def forward(self, x):
        return _npx.batch_norm_with_relu(x, self.gamma, self.beta,
                                         self.running_mean, self.running_var,
                                         **self._args())
