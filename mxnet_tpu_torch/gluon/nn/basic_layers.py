"""The basic layers as ``nn.Module``s, the port of
``mxnet_tpu/gluon/nn/basic_layers.py``: Sequential, HybridSequential,
Dense, Dropout, Embedding, BatchNorm, SyncBatchNorm, BatchNormReLU,
LayerNorm, GroupNorm, InstanceNorm, Flatten, Identity, Lambda,
HybridLambda, Concatenate and HybridConcatenate, with the JAX package's
parameter names and shapes (``weight`` (units, in_units), ``bias``;
``gamma`` / ``beta``; BatchNorm's ``running_mean`` / ``running_var``).
Parameters are trainable (``requires_grad``); serving runs its forwards
under ``torch.inference_mode`` or ``torch.no_grad``.  Dropout and
BatchNorm train exactly when ``autograd.is_training()`` is true (inside
``autograd.record()``), as the JAX layers do; the module's ``.training``
flag does not decide.

Each layer takes the reference's arguments in the reference's order,
its ``*_initializer`` arguments among them: the tensors are built
empty, record their initializer (``gluon.parameter.with_init``) and get
their values from ``Block.initialize``, through the name routing of
``mx.init``.  A width of 0 (``in_units=0``, ``in_channels=0``, the
defaults) leaves the tensors that need it deferred
(``gluon.parameter.deferred``): the layer's ``infer_shape`` reads the
width off its first input, as the JAX layer's does, and the tensor is
materialized and drawn then.

A layer is built on ``device``, resolved as every entry point resolves
it (``context.resolve_device``): None is ``cuda:0``, and a machine
without a card raises unless the caller passes ``device="cpu"``.
``Dropout``, ``Flatten``, ``Identity`` and the lambdas hold no tensor."""
from __future__ import annotations

import torch
from torch import nn

from ... import autograd as _ag
from ... import numpy as _np
from ... import numpy_extension as _npx
from ...base import MXNetError
from ...context import resolve_device
from ...ops import nn as _ops
from ..block import Block, HybridBlock
from ..parameter import deferred, set_shape, with_init

__all__ = ["Sequential", "HybridSequential", "Dense", "Dropout", "Embedding",
           "BatchNorm", "SyncBatchNorm", "BatchNormReLU", "LayerNorm",
           "GroupNorm", "InstanceNorm", "Flatten", "Lambda", "HybridLambda",
           "Identity", "Concatenate", "HybridConcatenate"]


def _known(shape) -> bool:
    return all(int(s) > 0 for s in shape)


def _empty(shape, device, dtype, init=None, requires_grad=True):
    """An uninitialized parameter on ``device`` (``resolve_device``: None
    is ``cuda:0``) that records ``init``; deferred when a width in
    ``shape`` is 0 (not known until the first forward)."""
    dev = resolve_device(device)
    if not _known(shape):
        return deferred(dev, dtype, init, requires_grad)
    return with_init(nn.Parameter(
        torch.empty(shape, device=dev, dtype=dtype),
        requires_grad=requires_grad), init)


def _empty_buffer(shape, device, dtype, init=None):
    """As :func:`_empty`, for a buffer (BatchNorm's running
    statistics)."""
    dev = resolve_device(device)
    if not _known(shape):
        return deferred(dev, dtype, init, buffer=True)
    return with_init(torch.empty(shape, device=dev, dtype=dtype), init)


class Dense(HybridBlock):
    """Fully-connected layer ``y = act(x W^T + b)``, in the JAX package's
    signature: ``Dense(units, activation=None, use_bias=True,
    flatten=True, dtype, weight_initializer=None,
    bias_initializer="zeros", in_units=0)``.  ``flatten=True`` collapses all
    but the batch axis first; ``flatten=False`` keeps the leading axes,
    as the transformer layers use it.  ``activation`` is an
    :func:`~mxnet_tpu_torch.ops.nn.activation` name or None.
    ``in_units=0`` defers the weight until the first input gives the
    width (its size past the batch axis, or its last axis without
    ``flatten``)."""

    def __init__(self, units: int, activation=None, use_bias: bool = True,
                 flatten: bool = True, dtype=torch.float32,
                 weight_initializer=None, bias_initializer="zeros",
                 in_units: int = 0, device=None):
        super().__init__()
        self._units = int(units)
        self._flatten = flatten
        self._act = activation
        self.weight = _empty((units, int(in_units)), device, dtype,
                             weight_initializer)
        self.bias = _empty((units,), device, dtype, bias_initializer) \
            if use_bias else None

    def infer_shape(self, x, *args):
        in_units = x[0].numel() if self._flatten else x.shape[-1]
        set_shape(self.weight, (self._units, in_units))

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
    drawn in bf16 takes a few thousand values and keeps the wrong share.
    ``axes``: the mask is drawn with size 1 along these axes and
    broadcast, so one draw keeps or drops a whole slice along them, as
    the JAX ``dropout`` draws it."""

    def __init__(self, rate: float, axes=()):
        super().__init__()
        self._rate = float(rate)
        self._axes = tuple(axes or ())

    def forward(self, x):
        if not _ag.is_training():
            return x
        return _ops.dropout(x, self._rate, self._axes)


class Embedding(HybridBlock):
    """Row gather from ``weight`` (input_dim, output_dim), in the JAX
    package's signature: ``Embedding(input_dim, output_dim, dtype,
    weight_initializer=None, sparse_grad=False)``.  Ids of any type are
    cast to an integer type first, as the JAX op takes
    ``indices.astype(int32)`` (float ids truncate toward zero).
    ``weight_initializer`` is the weight's own (``Block.initialize``'s
    default when None).  ``sparse_grad=True`` gives the weight a dense
    gradient of the same values: the JAX layer surfaces it as a
    ``RowSparseNDArray``, and the port has no sparse arrays (a recorded
    difference, ROADMAP C)."""

    def __init__(self, input_dim: int, output_dim: int, dtype=torch.float32,
                 weight_initializer=None, sparse_grad: bool = False,
                 device=None):
        super().__init__()
        self._sparse_grad = bool(sparse_grad)
        self.weight = _empty((input_dim, output_dim), device, dtype,
                             weight_initializer)

    def forward(self, x):
        if x.dtype not in (torch.int32, torch.int64):
            x = x.to(torch.int32)
        return self.weight[x]


class _Norm(HybridBlock):
    """``gamma`` / ``beta`` of ``in_channels`` (deferred when 0) with
    their initializers; ``center=False`` / ``scale=False`` keep beta /
    gamma at their initial value with no gradient, as the reference's
    non-differentiable parameters."""

    def __init__(self, center, scale, beta_initializer, gamma_initializer,
                 in_channels, device, dtype):
        super().__init__()
        c = int(in_channels)
        self.gamma = _empty((c,), device, dtype, gamma_initializer, scale)
        self.beta = _empty((c,), device, dtype, beta_initializer, center)

    def _infer_channels(self, c):
        for t in (self.gamma, self.beta):
            set_shape(t, (c,))


class LayerNorm(_Norm):
    """Layer normalization over ``axis`` with ``gamma`` / ``beta``, in the
    JAX package's signature: ``LayerNorm(axis=-1, epsilon=1e-5,
    center=True, scale=True, beta_initializer="zeros",
    gamma_initializer="ones", in_channels=0)``.  The initializers go
    through ``mx.init``'s name routing, so beta starts at 0 and gamma at
    1 whatever they name, as in the JAX package."""

    def __init__(self, axis: int = -1, epsilon: float = 1e-5,
                 center: bool = True, scale: bool = True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels: int = 0, device=None, dtype=torch.float32):
        super().__init__(center, scale, beta_initializer, gamma_initializer,
                         in_channels, device, dtype)
        self._axis = int(axis)
        self._epsilon = epsilon

    def infer_shape(self, x, *args):
        self._infer_channels(x.shape[self._axis])

    def forward(self, x):
        return _ops.layer_norm(x, self.gamma, self.beta, self._epsilon,
                               axis=self._axis)


class GroupNorm(_Norm):
    """Group normalization of channel-first input (``ops.nn.group_norm``)
    in the JAX signature: ``GroupNorm(num_groups=1, epsilon=1e-5,
    center=True, scale=True, beta_initializer="zeros",
    gamma_initializer="ones", in_channels=0)``; the width is axis 1's."""

    def __init__(self, num_groups: int = 1, epsilon: float = 1e-5,
                 center: bool = True, scale: bool = True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels: int = 0, device=None, dtype=torch.float32):
        super().__init__(center, scale, beta_initializer, gamma_initializer,
                         in_channels, device, dtype)
        self._num_groups = int(num_groups)
        self._epsilon = epsilon

    def infer_shape(self, x, *args):
        self._infer_channels(x.shape[1])

    def forward(self, x):
        return _ops.group_norm(x, self.gamma, self.beta, self._num_groups,
                               self._epsilon)


class InstanceNorm(_Norm):
    """Instance normalization of channel-first input
    (``ops.nn.instance_norm``) in the JAX signature: ``InstanceNorm(
    axis=1, epsilon=1e-5, center=True, scale=True, beta_initializer=
    "zeros", gamma_initializer="ones", in_channels=0)``; as in the JAX
    layer the width is axis 1's and ``axis`` is kept but not read."""

    def __init__(self, axis: int = 1, epsilon: float = 1e-5,
                 center: bool = True, scale: bool = True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels: int = 0, device=None, dtype=torch.float32):
        super().__init__(center, scale, beta_initializer, gamma_initializer,
                         in_channels, device, dtype)
        self._axis = axis
        self._epsilon = epsilon

    def infer_shape(self, x, *args):
        self._infer_channels(x.shape[1])

    def forward(self, x):
        return _ops.instance_norm(x, self.gamma, self.beta, self._epsilon)


class _Stack:
    """``add`` and slicing of the sequential containers."""

    def add(self, *blocks):
        for b in blocks:
            self.append(b)
        return self

    def __getitem__(self, key):
        if isinstance(key, slice):
            return type(self)().add(*list(self)[key])
        return super().__getitem__(key)


class HybridSequential(_Stack, HybridBlock, nn.Sequential):
    """Stack of blocks run in order; children are named ``0``, ``1``, ...
    in the order :meth:`add` (or the constructor) receives them, as in
    the JAX package.  A slice is a new stack of the same blocks,
    numbered from ``0`` as the JAX package's ``__getitem__`` adds them
    (``features[:-1]``)."""


class Sequential(_Stack, Block, nn.Sequential):
    """:class:`HybridSequential`'s plain-block twin (the JAX
    ``Sequential``): ``hybridize`` reaches its children."""


class _Concat:
    """Runs every child on the same input and concatenates their outputs
    along ``axis``."""

    def __init__(self, axis: int = -1):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return torch.cat([b(x) for b in self], dim=self.axis)


class HybridConcatenate(_Concat, HybridSequential):
    """The JAX ``HybridConcatenate``: its children's outputs on one input,
    concatenated along ``axis`` (-1 by default)."""


class Concatenate(_Concat, Sequential):
    """:class:`HybridConcatenate`'s plain-block twin."""


class Flatten(HybridBlock):
    """(N, ...) -> (N, prod(...))."""

    def forward(self, x):
        return x.reshape(x.shape[0], -1)


class Identity(HybridBlock):
    """Returns its input."""

    def forward(self, x):
        return x


def _named_function(function, who: str):
    """``function`` itself, or the ``mx.np`` / ``npx`` function a string
    names, as the JAX lambdas look it up."""
    if not isinstance(function, str):
        return function
    fn = getattr(_np, function, None) or getattr(_npx, function, None)
    if fn is None:
        raise MXNetError(f"unknown function name '{function}' for {who}")
    return fn


class Lambda(Block):
    """Wraps a function, or the name of an ``mx.np`` / ``npx`` function,
    as a block."""

    def __init__(self, function):
        super().__init__()
        self._func = _named_function(function, "Lambda")

    def forward(self, *args):
        return self._func(*args)


class HybridLambda(HybridBlock):
    """:class:`Lambda` as a hybrid block."""

    def __init__(self, function):
        super().__init__()
        self._func = _named_function(function, "HybridLambda")

    def forward(self, *args):
        return self._func(*args)


class BatchNorm(HybridBlock):
    """Batch normalization over ``axis`` (1 for NCHW, -1 for NHWC).

    ``gamma`` / ``beta`` are parameters (trainable when ``scale`` /
    ``center``; ``scale=False`` fixes gamma at 1), ``running_mean`` /
    ``running_var`` buffers, each with its initializer (through the name
    routing: 0 for beta and the mean, 1 for gamma and the variance).
    The signature is the reference's: ``BatchNorm(axis=1, momentum=0.9,
    epsilon=1e-5, center=True, scale=True, use_global_stats=False,
    beta_initializer="zeros", gamma_initializer="ones",
    running_mean_initializer="zeros", running_variance_initializer="ones",
    in_channels=0)``; ``in_channels=0`` takes the width of ``axis`` at the
    first forward.  In training (``autograd.is_training()``) the
    batch statistics normalize and the running statistics blend as
    ``m * momentum + batch * (1 - momentum)`` with the biased variance,
    in place; outside training the running statistics normalize."""

    def __init__(self, axis: int = 1, momentum: float = 0.9,
                 epsilon: float = 1e-5, center: bool = True,
                 scale: bool = True, use_global_stats: bool = False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels: int = 0,
                 device=None, dtype=torch.float32):
        super().__init__()
        c = (int(in_channels),)
        self._axis = axis
        self._momentum = momentum
        self._epsilon = epsilon
        self._scale = scale
        self._use_global_stats = use_global_stats
        device = resolve_device(device)
        self.gamma = _empty(c, device, dtype, gamma_initializer, scale)
        self.beta = _empty(c, device, dtype, beta_initializer, center)
        self.register_buffer("running_mean", _empty_buffer(
            c, device, dtype, running_mean_initializer))
        self.register_buffer("running_var", _empty_buffer(
            c, device, dtype, running_variance_initializer))

    def infer_shape(self, x, *args):
        c = x.shape[self._axis]
        for t in (self.gamma, self.beta, self.running_mean,
                  self.running_var):
            set_shape(t, (c,))

    def _args(self):
        return dict(eps=self._epsilon, momentum=self._momentum,
                    fix_gamma=not self._scale,
                    use_global_stats=self._use_global_stats, axis=self._axis)

    def forward(self, x):
        return _npx.batch_norm(x, self.gamma, self.beta, self.running_mean,
                               self.running_var, **self._args())


class SyncBatchNorm(BatchNorm):
    """Batch norm over the whole data-parallel batch (the JAX
    ``SyncBatchNorm(in_channels=0, num_devices=None, **kwargs)``).  Every
    ``BatchNorm`` of the port already takes the global batch's
    statistics inside ``ShardedTrainer``'s dp mesh (``ops.nn.
    batch_stats_group``), as GSPMD gives the JAX layer; ``num_devices``
    is accepted and not read."""

    def __init__(self, in_channels: int = 0, num_devices=None, **kwargs):
        kwargs.pop("ndev", None)
        super().__init__(in_channels=in_channels, **kwargs)


class BatchNormReLU(BatchNorm):
    """BatchNorm fused with relu (``npx.batch_norm_with_relu``): in
    training on channel-last input the hand-written ``bn_act`` kernels
    compute the statistics in one read and normalize + relu in another;
    outside training relu of the running-statistics batch norm."""

    def forward(self, x):
        return _npx.batch_norm_with_relu(x, self.gamma, self.beta,
                                         self.running_mean, self.running_var,
                                         **self._args())
