"""Inception v3 (Szegedy et al. 2015) with the MXNet Gluon zoo's
structure: the port of ``mxnet_tpu/gluon/model_zoo/vision/inception.py``.

Every width but the output's is left to deferred inference, as in the
JAX model: the convolutions, batch norms and the classifier read their
input widths at the first forward (``gluon.parameter``), so call the net
once (or load weights) before ``ShardedTrainer`` or a trainer step.
``layout="NCHW"`` (the default) or ``"NHWC"`` threads the layout through
every convolution, pool, batch-norm axis and concatenation; batch norms
take ``epsilon=0.001``.  Child indices and attribute names give the JAX
``collect_params()`` names letter for letter (``features.0.0.weight``,
``features.7.1.1.1.gamma``, ``features.16.b1a.0.weight``, ...,
``output.weight``), so ``convert.load_into`` carries a JAX net's
weights.  The tail's ``AvgPool2D(8)`` fixes the input at 299 x 299.
Models are built on ``cuda:0`` unless ``device="cpu"`` is passed."""
from __future__ import annotations

import torch

from ....base import MXNetError
from ....context import resolve_device
from ... import nn
from ...block import HybridBlock
from ._common import bn_axis as _ax

__all__ = ["Inception3", "inception_v3"]


def _conv(channels, kernel, stride=1, pad=0, layout="NCHW", kw=None):
    return nn.HybridSequential().add(
        nn.Conv2D(channels, kernel, stride, pad, use_bias=False,
                  layout=layout, **kw),
        nn.BatchNorm(epsilon=0.001, axis=_ax(layout), **kw),
        nn.Activation("relu"))


def _seq(*blocks):
    return nn.HybridSequential().add(*blocks)


class _Branches(HybridBlock):
    """Runs each branch on the input and concatenates their outputs on
    the channel axis; branches are children ``0``, ``1``, ..."""

    def __init__(self, branches, axis=1):
        super().__init__()
        self._axis = axis
        for i, b in enumerate(branches):
            self.register_child(b, str(i))

    def forward(self, x):
        return torch.cat([b(x) for b in self.children()], dim=self._axis)


def _make_A(pool_features, lo, kw):
    return _Branches([
        _conv(64, 1, layout=lo, kw=kw),
        _seq(_conv(48, 1, layout=lo, kw=kw),
             _conv(64, 5, pad=2, layout=lo, kw=kw)),
        _seq(_conv(64, 1, layout=lo, kw=kw),
             _conv(96, 3, pad=1, layout=lo, kw=kw),
             _conv(96, 3, pad=1, layout=lo, kw=kw)),
        _seq(nn.AvgPool2D(3, 1, 1, layout=lo),
             _conv(pool_features, 1, layout=lo, kw=kw)),
    ], axis=_ax(lo))


def _make_B(lo, kw):
    return _Branches([
        _conv(384, 3, 2, layout=lo, kw=kw),
        _seq(_conv(64, 1, layout=lo, kw=kw),
             _conv(96, 3, pad=1, layout=lo, kw=kw),
             _conv(96, 3, 2, layout=lo, kw=kw)),
        _seq(nn.MaxPool2D(3, 2, layout=lo)),
    ], axis=_ax(lo))


def _make_C(c, lo, kw):
    return _Branches([
        _conv(192, 1, layout=lo, kw=kw),
        _seq(_conv(c, 1, layout=lo, kw=kw),
             _conv(c, (1, 7), pad=(0, 3), layout=lo, kw=kw),
             _conv(192, (7, 1), pad=(3, 0), layout=lo, kw=kw)),
        _seq(_conv(c, 1, layout=lo, kw=kw),
             _conv(c, (7, 1), pad=(3, 0), layout=lo, kw=kw),
             _conv(c, (1, 7), pad=(0, 3), layout=lo, kw=kw),
             _conv(c, (7, 1), pad=(3, 0), layout=lo, kw=kw),
             _conv(192, (1, 7), pad=(0, 3), layout=lo, kw=kw)),
        _seq(nn.AvgPool2D(3, 1, 1, layout=lo),
             _conv(192, 1, layout=lo, kw=kw)),
    ], axis=_ax(lo))


def _make_D(lo, kw):
    return _Branches([
        _seq(_conv(192, 1, layout=lo, kw=kw),
             _conv(320, 3, 2, layout=lo, kw=kw)),
        _seq(_conv(192, 1, layout=lo, kw=kw),
             _conv(192, (1, 7), pad=(0, 3), layout=lo, kw=kw),
             _conv(192, (7, 1), pad=(3, 0), layout=lo, kw=kw),
             _conv(192, 3, 2, layout=lo, kw=kw)),
        _seq(nn.MaxPool2D(3, 2, layout=lo)),
    ], axis=_ax(lo))


class _BlockE(HybridBlock):
    """The last blocks: two branches split into 1x3 and 3x1 halves."""

    def __init__(self, lo, kw):
        super().__init__()
        self._axis = _ax(lo)
        self.b0 = _conv(320, 1, layout=lo, kw=kw)
        self.b1_stem = _conv(384, 1, layout=lo, kw=kw)
        self.b1a = _conv(384, (1, 3), pad=(0, 1), layout=lo, kw=kw)
        self.b1b = _conv(384, (3, 1), pad=(1, 0), layout=lo, kw=kw)
        self.b2_stem = _seq(_conv(448, 1, layout=lo, kw=kw),
                            _conv(384, 3, pad=1, layout=lo, kw=kw))
        self.b2a = _conv(384, (1, 3), pad=(0, 1), layout=lo, kw=kw)
        self.b2b = _conv(384, (3, 1), pad=(1, 0), layout=lo, kw=kw)
        self.b3 = _seq(nn.AvgPool2D(3, 1, 1, layout=lo),
                       _conv(192, 1, layout=lo, kw=kw))

    def forward(self, x):
        ax = self._axis
        s1 = self.b1_stem(x)
        s2 = self.b2_stem(x)
        return torch.cat(
            [self.b0(x), torch.cat([self.b1a(s1), self.b1b(s1)], dim=ax),
             torch.cat([self.b2a(s2), self.b2b(s2)], dim=ax), self.b3(x)],
            dim=ax)


class Inception3(HybridBlock):
    """Inception v3: input (N, 3, 299, 299) for ``layout="NCHW"``, (N,
    299, 299, 3) for ``"NHWC"``; output (N, classes) logits."""

    def __init__(self, classes=1000, layout="NCHW", device=None,
                 dtype=torch.float32):
        super().__init__()
        kw = dict(device=resolve_device(device), dtype=dtype)
        lo = layout
        self.features = nn.HybridSequential()
        self.features.add(
            _conv(32, 3, 2, layout=lo, kw=kw), _conv(32, 3, layout=lo, kw=kw),
            _conv(64, 3, pad=1, layout=lo, kw=kw),
            nn.MaxPool2D(3, 2, layout=lo),
            _conv(80, 1, layout=lo, kw=kw), _conv(192, 3, layout=lo, kw=kw),
            nn.MaxPool2D(3, 2, layout=lo),
            _make_A(32, lo, kw), _make_A(64, lo, kw), _make_A(64, lo, kw),
            _make_B(lo, kw),
            _make_C(128, lo, kw), _make_C(160, lo, kw),
            _make_C(160, lo, kw), _make_C(192, lo, kw),
            _make_D(lo, kw),
            _BlockE(lo, kw), _BlockE(lo, kw),
            nn.AvgPool2D(8, layout=lo), nn.Dropout(0.5), nn.Flatten())
        self.output = nn.Dense(classes, **kw)

    def forward(self, x):
        return self.output(self.features(x))


def inception_v3(pretrained=False, ctx=None, root=None, **kw):
    """Inception v3; keyword arguments go to :class:`Inception3`
    (``classes``, ``layout``, ``device``, ``dtype``)."""
    if pretrained:
        raise MXNetError("pretrained weights are not ported (no model "
                         "store); load them with convert.load_into")
    return Inception3(**kw)
