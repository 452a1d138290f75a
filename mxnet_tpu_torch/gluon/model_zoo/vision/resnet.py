"""ResNet v1 (He et al. 2015) with the MXNet Gluon zoo's structure.

The port of the v1 half of ``mxnet_tpu/gluon/model_zoo/vision/resnet.py``:
``BasicBlockV1``, ``BottleneckV1`` (stride on the first 1x1
convolution), ``ResNetV1`` and ``resnet{18,34,50,101,152}_v1``, with
``thumbnail`` (the CIFAR 3x3 stem), ``classes`` and ``fused_bn_relu``
(each BatchNorm -> relu pair one ``BatchNormReLU``, a structure variant
with other child indices).  Channel-last ``layout="NHWC"`` with OHWI
convolution weights; the fused variant's BatchNormReLU layers run the
hand-written ``bn_act`` kernels in training.

Child indices give the JAX package's ``collect_params()`` names letter
for letter (``features.0.weight``, ``features.1.gamma``,
``features.3.0.body.0.weight``, ..., ``output.weight``), with
``running_mean`` / ``running_var`` as buffers, so ``convert.load_into``
maps them one to one.  The JAX blocks infer input widths at the first
forward; here each block is told its ``in_channels``.  Models are built
on ``cuda:0`` unless ``device="cpu"`` is passed; their BatchNorms train
inside ``autograd.record()`` (a trainer's step enters it).

Not ported, raising :class:`MXNetError` with the roadmap item: ResNet v2
(``version=2``, ROADMAP A6), the space-to-depth stem (``stem_type="s2d"``,
ROADMAP A6) and channel-first ``layout="NCHW"`` ResNets (ROADMAP A6;
channel-first convolutions run since LeNet).
"""
from __future__ import annotations

import torch

from ....base import MXNetError
from ....context import resolve_device
from ...block import HybridBlock
from ...nn import (Activation, BatchNorm, BatchNormReLU, Conv2D, Dense,
                   GlobalAvgPool2D, HybridSequential, MaxPool2D)
from ._common import bn_axis

__all__ = ["ResNetV1", "BasicBlockV1", "BottleneckV1", "get_resnet",
           "resnet18_v1", "resnet34_v1", "resnet50_v1", "resnet101_v1",
           "resnet152_v1"]


def _bn_act(c, ax, fused, kw):
    """BatchNorm -> relu as layers: one fused ``BatchNormReLU`` or the
    reference ``BatchNorm`` + ``Activation`` pair."""
    if fused:
        return [BatchNormReLU(axis=ax, in_channels=c, **kw)]
    return [BatchNorm(axis=ax, in_channels=c, **kw), Activation("relu")]


def _conv3x3(channels, stride, in_channels, layout, kw):
    return Conv2D(channels, 3, strides=stride, padding=1, use_bias=False,
                  in_channels=in_channels, layout=layout, **kw)


def _downsample(channels, stride, in_channels, layout, ax, kw):
    return HybridSequential().add(
        Conv2D(channels, 1, strides=stride, use_bias=False,
               in_channels=in_channels, layout=layout, **kw),
        BatchNorm(axis=ax, in_channels=channels, **kw))


class _Residual(HybridBlock):
    """``relu(body(x) + residual)``, the residual ``x`` or
    ``downsample(x)``."""

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(self.body(x) + residual)


class BasicBlockV1(_Residual):
    """Two 3x3 convolutions (stride on the first)."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 layout="NCHW", fused_bn_relu=False, **kw):
        super().__init__()
        ax = bn_axis(layout)
        self.body = HybridSequential().add(
            _conv3x3(channels, stride, in_channels, layout, kw),
            *_bn_act(channels, ax, fused_bn_relu, kw),
            _conv3x3(channels, 1, channels, layout, kw),
            BatchNorm(axis=ax, in_channels=channels, **kw))
        self.downsample = _downsample(channels, stride, in_channels, layout,
                                      ax, kw) if downsample else None


class BottleneckV1(_Residual):
    """1x1 (stride) -> 3x3 -> 1x1 at ``channels // 4`` wide, expanding
    to ``channels``."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 layout="NCHW", fused_bn_relu=False, **kw):
        super().__init__()
        ax = bn_axis(layout)
        mid = channels // 4
        self.body = HybridSequential().add(
            Conv2D(mid, 1, strides=stride, use_bias=False,
                   in_channels=in_channels, layout=layout, **kw),
            *_bn_act(mid, ax, fused_bn_relu, kw),
            _conv3x3(mid, 1, mid, layout, kw),
            *_bn_act(mid, ax, fused_bn_relu, kw),
            Conv2D(channels, 1, strides=1, use_bias=False, in_channels=mid,
                   layout=layout, **kw),
            BatchNorm(axis=ax, in_channels=channels, **kw))
        self.downsample = _downsample(channels, stride, in_channels, layout,
                                      ax, kw) if downsample else None


class ResNetV1(HybridBlock):
    """ResNet v1: stem (7x7/2 conv, BN, relu, 3x3/2 max pool; or the 3x3
    thumbnail conv), four stages of ``block``, global average pool and
    a ``classes``-way Dense.  Input (N, H, W, 3) for ``layout="NHWC"``;
    output (N, classes) logits."""

    def __init__(self, block, layers, channels, classes=1000,
                 thumbnail=False, layout="NCHW", stem_type="default",
                 fused_bn_relu=False, device=None, dtype=torch.float32):
        super().__init__()
        if len(channels) != len(layers) + 1:
            raise MXNetError("channels must have len(layers)+1 entries")
        if layout != "NHWC":
            raise MXNetError(f"ResNetV1 layout={layout!r} is not ported "
                             "(NHWC is); channel-first ResNets are "
                             "ROADMAP A6, long tail")
        if stem_type != "default":
            raise MXNetError(f"ResNetV1 stem_type={stem_type!r} is not "
                             "ported (the space-to-depth stem is ROADMAP "
                             "A6, long tail)")
        if dtype != torch.float32:
            raise MXNetError("the bn_act kernels of this port take float32 "
                             f"activations; got dtype={dtype}")
        kw = dict(device=resolve_device(device), dtype=dtype)
        ax = bn_axis(layout)
        self.features = HybridSequential()
        if thumbnail:
            self.features.add(_conv3x3(channels[0], 1, 3, layout, kw))
        else:
            self.features.add(
                Conv2D(channels[0], 7, 2, 3, use_bias=False, in_channels=3,
                       layout=layout, **kw),
                *_bn_act(channels[0], ax, fused_bn_relu, kw),
                MaxPool2D(3, 2, 1, layout=layout))
        for i, num_layer in enumerate(layers):
            stage = HybridSequential()
            c_in, c_out = channels[i], channels[i + 1]
            stage.add(block(c_out, 1 if i == 0 else 2, c_out != c_in,
                            in_channels=c_in, layout=layout,
                            fused_bn_relu=fused_bn_relu, **kw))
            for _ in range(num_layer - 1):
                stage.add(block(c_out, 1, False, in_channels=c_out,
                                layout=layout, fused_bn_relu=fused_bn_relu,
                                **kw))
            self.features.add(stage)
        self.features.add(GlobalAvgPool2D(layout=layout))
        self.output = Dense(classes, in_units=channels[-1], **kw)

    @property
    def device(self) -> torch.device:
        return self.output.weight.device

    def forward(self, x):
        return self.output(self.features(x))


# spec table (the reference's resnet_spec)
_SPEC = {18: ("basic_block", [2, 2, 2, 2], [64, 64, 128, 256, 512]),
         34: ("basic_block", [3, 4, 6, 3], [64, 64, 128, 256, 512]),
         50: ("bottle_neck", [3, 4, 6, 3], [64, 256, 512, 1024, 2048]),
         101: ("bottle_neck", [3, 4, 23, 3], [64, 256, 512, 1024, 2048]),
         152: ("bottle_neck", [3, 8, 36, 3], [64, 256, 512, 1024, 2048])}


def get_resnet(version, num_layers, pretrained=False, **kwargs) -> ResNetV1:
    """ResNet v1 of ``num_layers`` (18, 34, 50, 101, 152); keyword
    arguments go to :class:`ResNetV1` (``classes``, ``thumbnail``,
    ``layout``, ``fused_bn_relu``, ``device``, ...)."""
    if num_layers not in _SPEC:
        raise MXNetError(f"invalid resnet depth {num_layers}; options "
                         f"{sorted(_SPEC)}")
    if version not in (1, 2):
        raise MXNetError("version must be 1 or 2")
    if version == 2:
        raise MXNetError("ResNet v2 is not ported (v1 is); ROADMAP A6, "
                         "long tail")
    if pretrained:
        raise MXNetError("pretrained weights are not ported (no model "
                         "store); load them with convert.load_into")
    block_type, layers, channels = _SPEC[num_layers]
    block = BasicBlockV1 if block_type == "basic_block" else BottleneckV1
    return ResNetV1(block, layers, channels, **kwargs)


def resnet18_v1(**kw):
    return get_resnet(1, 18, **kw)


def resnet34_v1(**kw):
    return get_resnet(1, 34, **kw)


def resnet50_v1(**kw):
    return get_resnet(1, 50, **kw)


def resnet101_v1(**kw):
    return get_resnet(1, 101, **kw)


def resnet152_v1(**kw):
    return get_resnet(1, 152, **kw)
