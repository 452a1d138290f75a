"""Gluon layers of the port (``mxnet_tpu/gluon/nn``): the 2-D layers,
activations and containers, ``Block`` and ``HybridBlock``.  A JAX name
not yet ported raises :class:`~mxnet_tpu_torch.base.MXNetError` naming
its ROADMAP item (``_not_ported.GLUON_NN``)."""
from ... import _not_ported
from ..block import Block, HybridBlock
from . import activations, basic_layers, conv_layers, extended_layers
from .activations import (ELU, GELU, SELU, Activation, LeakyReLU, PReLU,
                          SiLU, Swish)
from .basic_layers import (BatchNorm, BatchNormReLU, Concatenate, Dense,
                           Dropout, Embedding, Flatten, GroupNorm,
                           HybridConcatenate, HybridLambda, HybridSequential,
                           Identity, InstanceNorm, Lambda, LayerNorm,
                           Sequential, SyncBatchNorm)
from .conv_layers import (AvgPool2D, Conv2D, Conv2DTranspose,
                          GlobalAvgPool2D, GlobalMaxPool2D, MaxPool2D,
                          ReflectionPad2D)
from .extended_layers import PixelShuffle2D

__all__ = (["Block", "HybridBlock"] + activations.__all__
           + basic_layers.__all__ + conv_layers.__all__ + ["PixelShuffle2D"])

__getattr__ = _not_ported.module_getattr(__name__, "mx.gluon.nn",
                                         _not_ported.GLUON_NN)
