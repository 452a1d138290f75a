"""Convolution and pooling layers: Conv2D, Conv2DTranspose, MaxPool2D,
AvgPool2D, GlobalMaxPool2D, GlobalAvgPool2D and ReflectionPad2D
(``mxnet_tpu/gluon/nn/conv_layers.py``).

The weight's layout follows the data's, as in the JAX package: ``OIHW``
for ``layout="NCHW"``, ``OHWI`` for ``layout="NHWC"`` (a transposed
convolution's is (in, out / groups, kh, kw), or (in, kh, kw, out /
groups) channel-last).  The convolution and pooling themselves are
``ops.nn`` (cuDNN on the card); ``activation`` (LeNet's ``"tanh"``) is
``ops.nn.activation`` after it.  The constructors take the reference's
arguments in its order; the weight and bias record their initializers
for ``Block.initialize``, and ``in_channels=0`` (the default) defers the
weight until the first input gives the width (axis 1, or the last axis
channel-last)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ... import numpy_extension as _npx
from ...ops import nn as _ops
from ..block import HybridBlock
from ..parameter import set_shape
from .basic_layers import _empty

__all__ = ["Conv2D", "Conv2DTranspose", "MaxPool2D", "AvgPool2D",
           "GlobalMaxPool2D", "GlobalAvgPool2D", "ReflectionPad2D"]


def _pair(v):
    return (int(v),) * 2 if isinstance(v, int) else tuple(int(e) for e in v)


class _Conv(HybridBlock):
    """The convolutions' shared parts (the JAX ``_Conv``)."""

    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, activation, use_bias, weight_initializer,
                 bias_initializer, in_channels, device, dtype,
                 transpose=False, output_padding=0):
        super().__init__()
        self._act = activation
        self._channels = int(channels)
        self._layout = layout
        self._channel_last = _ops.is_channel_last(layout, 4)
        self._kernel = _pair(kernel_size)
        self._strides = _pair(strides)
        self._padding = _pair(padding)
        self._dilation = _pair(dilation)
        self._groups = int(groups)
        self._transpose = transpose
        self._output_padding = _pair(output_padding)
        self.weight = _empty(self._weight_shape(int(in_channels)), device,
                             dtype, weight_initializer)
        self.bias = _empty((channels,), device, dtype, bias_initializer) \
            if use_bias else None

    def _weight_shape(self, c_in):
        g = self._groups
        if self._transpose:
            major, minor = c_in, self._channels // g
        else:
            major, minor = self._channels, c_in // g
        if self._channel_last:
            return (major,) + self._kernel + (minor,)
        return (major, minor) + self._kernel

    def infer_shape(self, x, *args):
        c_in = x.shape[-1] if self._channel_last else x.shape[1]
        set_shape(self.weight, self._weight_shape(c_in))

    def _activate(self, y):
        return y if self._act is None else _ops.activation(y, self._act)


class Conv2D(_Conv):
    """2-D convolution with ``weight`` (channels, kh, kw, in_channels)
    for NHWC or (channels, in_channels, kh, kw) for NCHW, and ``bias``
    (channels,) when ``use_bias``; then ``activation`` when given.
    ``Conv2D(channels, kernel_size, strides=(1, 1), padding=(0, 0),
    dilation=(1, 1), groups=1, layout="NCHW", activation=None,
    use_bias=True, weight_initializer=None, bias_initializer="zeros",
    in_channels=0)``, as the reference."""

    def __init__(self, channels: int, kernel_size, strides=(1, 1),
                 padding=(0, 0), dilation=(1, 1), groups: int = 1,
                 layout: str = "NCHW", activation=None, use_bias: bool = True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels: int = 0, device=None, dtype=torch.float32):
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, activation, use_bias,
                         weight_initializer, bias_initializer, in_channels,
                         device, dtype)

    def forward(self, x):
        y = _npx.convolution(x, self.weight, self.bias,
                             stride=self._strides, dilate=self._dilation,
                             pad=self._padding, num_group=self._groups,
                             no_bias=self.bias is None, layout=self._layout)
        return self._activate(y)


class Conv2DTranspose(_Conv):
    """2-D transposed convolution (``ops.nn.deconvolution``) in the JAX
    signature: ``Conv2DTranspose(channels, kernel_size, strides=(1, 1),
    padding=(0, 0), output_padding=(0, 0), dilation=(1, 1), groups=1,
    layout="NCHW", activation=None, use_bias=True,
    weight_initializer=None, bias_initializer="zeros", in_channels=0)``;
    ``output_padding`` is the op's ``adj``."""

    def __init__(self, channels: int, kernel_size, strides=(1, 1),
                 padding=(0, 0), output_padding=(0, 0), dilation=(1, 1),
                 groups: int = 1, layout: str = "NCHW", activation=None,
                 use_bias: bool = True, weight_initializer=None,
                 bias_initializer="zeros", in_channels: int = 0, device=None,
                 dtype=torch.float32):
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, activation, use_bias,
                         weight_initializer, bias_initializer, in_channels,
                         device, dtype, transpose=True,
                         output_padding=output_padding)

    def forward(self, x):
        y = _ops.deconvolution(x, self.weight, self.bias,
                               stride=self._strides, dilate=self._dilation,
                               pad=self._padding, adj=self._output_padding,
                               num_group=self._groups,
                               no_bias=self.bias is None, layout=self._layout)
        return self._activate(y)


class _Pool(HybridBlock):
    def __init__(self, pool_size, strides, padding, ceil_mode: bool,
                 global_pool: bool, pool_type: str, layout: str,
                 count_include_pad: bool = True):
        super().__init__()
        _ops.is_channel_last(layout, 4)            # refuses unknown layouts
        self._kernel = _pair(pool_size)
        self._stride = _pair(strides if strides is not None else pool_size)
        self._pad = _pair(padding)
        self._global = global_pool
        self._type = pool_type
        self._convention = "full" if ceil_mode else "valid"
        self._count_include_pad = count_include_pad
        self._layout = layout

    def forward(self, x):
        return _npx.pooling(x, kernel=self._kernel, pool_type=self._type,
                            stride=self._stride, pad=self._pad,
                            global_pool=self._global,
                            count_include_pad=self._count_include_pad,
                            pooling_convention=self._convention,
                            layout=self._layout)


class MaxPool2D(_Pool):
    """``MaxPool2D(pool_size=(2, 2), strides=None, padding=0,
    layout="NCHW", ceil_mode=False)``, as the reference;
    ``ceil_mode=True`` is ``pooling_convention="full"``."""

    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout: str = "NCHW", ceil_mode: bool = False):
        super().__init__(pool_size, strides, padding, ceil_mode, False, "max",
                         layout)


class AvgPool2D(_Pool):
    """``AvgPool2D(pool_size=(2, 2), strides=None, padding=0,
    layout="NCHW", ceil_mode=False, count_include_pad=True)``, as the
    reference."""

    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout: str = "NCHW", ceil_mode: bool = False,
                 count_include_pad: bool = True):
        super().__init__(pool_size, strides, padding, ceil_mode, False, "avg",
                         layout, count_include_pad)


class GlobalMaxPool2D(_Pool):
    """Max over the spatial axes, kept as size-1 axes."""

    def __init__(self, layout: str = "NCHW"):
        super().__init__(1, None, 0, False, True, "max", layout)


class GlobalAvgPool2D(_Pool):
    """Mean over the spatial axes, kept as size-1 axes."""

    def __init__(self, layout: str = "NCHW"):
        super().__init__(1, None, 0, False, True, "avg", layout)


class ReflectionPad2D(HybridBlock):
    """Reflection padding of the last two axes of channel-first input
    (``ReflectionPad2D(padding=0)``: an int for all four sides, or
    (left, right, top, bottom)), as the JAX layer pads them."""

    def __init__(self, padding=0):
        super().__init__()
        self._padding = (int(padding),) * 4 if isinstance(padding, int) \
            else tuple(int(p) for p in padding)

    def forward(self, x):
        return F.pad(x, self._padding, mode="reflect")
