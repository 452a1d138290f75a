"""Carry the JAX package's parameters over to the port's modules.

The caller takes the values of ``block.collect_params()`` out as numpy
arrays (``{name: p.data().asnumpy()}``); this module maps them onto the
port's ``state_dict`` by name, so both packages compute the same
function.  The port's parameter names and layouts are the JAX package's
(Dense weights are (units, in_units) in both), so the map is the
identity on names; what it adds is the check that both sides hold
exactly the same names with the same shapes.  The port never imports JAX
to do this.

The names of the pretraining slice (``BERTForPretrain`` over
``bert_12_768_12``; ``L`` runs over the encoder layers):

* ``bert.word_embed.weight`` (V, U), ``bert.token_type_embed.weight``
  (2, U), ``bert.position_weight`` (512, U),
  ``bert.embed_layer_norm.gamma`` / ``.beta`` (U,);
* ``bert.encoder.layers.L.attention.qkv.weight`` (3U, U) / ``.bias``,
  ``...attention.proj.weight`` (U, U) / ``.bias``,
  ``...ffn.ffn1.weight`` (H, U) / ``.bias``, ``...ffn.ffn2.weight``
  (U, H) / ``.bias``, ``...layer_norm_att.gamma`` / ``.beta``,
  ``...layer_norm_ffn.gamma`` / ``.beta``;
* ``bert.pooler.weight`` (U, U) / ``.bias``;
* ``mlm_transform.weight`` (U, U) / ``.bias``,
  ``mlm_layer_norm.gamma`` / ``.beta``, ``mlm_bias`` (V,),
  ``nsp.weight`` (2, U) / ``.bias``.

The MLM decoder is tied: it multiplies by ``bert.word_embed.weight`` and
has no weight of its own, in both packages, so only ``mlm_bias`` is
carried for it.  Without the ``bert.`` prefix the same names are
``BERTModel``'s (the batch-serving slice); the decode slice's
``TransformerLM`` has ``word_embed.weight``, ``position_weight``,
``layers.L.*`` and ``out_bias``.

The ResNet v1 names (``gluon.model_zoo.vision.resnet``; ``S`` runs over
the four stages 3..6, ``K`` over a stage's blocks):

* the stem: ``features.0.weight`` (64, 7, 7, 3) for NHWC (OHWI), then
  its BatchNorm ``features.1.gamma`` / ``.beta`` / ``.running_mean`` /
  ``.running_var`` (64,) (the fused variant's ``BatchNormReLU``; the
  plain variant's relu at ``features.2`` holds nothing and the max pool
  moves from ``features.2`` to ``features.3``, the stages one up);
* each block: ``features.S.K.body.I.weight`` for its convolutions and
  ``features.S.K.body.I.{gamma,beta,running_mean,running_var}`` for its
  BatchNorms, in body order (fused bottleneck: conv 0, BNReLU 1, conv
  2, BNReLU 3, conv 4, BatchNorm 5), and for the first block of a stage
  ``features.S.0.downsample.0.weight`` / ``downsample.1.*``;
* the head: ``output.weight`` (classes, 2048) and ``output.bias``.

Channel-first ResNets (``layout="NCHW"``, the JAX package's default)
keep the same names: ``features.0.weight`` is (64, 3, 7, 7) (OIHW) and
every BatchNorm normalizes axis 1.  The plain (``fused_bn_relu=False``)
bottleneck body is conv 0, BatchNorm 1, relu 2, conv 3, BatchNorm 4,
relu 5, conv 6, BatchNorm 7; its stem is conv 0, BatchNorm 1, relu 2,
max pool 3, so the stages are ``features.4`` .. ``features.7``.

The SSD names (``gluon.model_zoo.ssd``; ``ssd_512_resnet50_v1`` over
that channel-first ResNet-50, ``K`` over the 3 extras, ``I`` over the 4
scales):

* the trunk: ``features.trunk.0.<i>...``, the ResNet's ``features.<i>``
  without its global pool (``features.trunk.0.0.weight``,
  ``features.trunk.0.1.gamma``, ..., ``features.trunk.0.7.2.body.7.beta``);
* the extras: ``features.extras.K.0.weight`` / ``.bias`` (the 1x1
  convolution to 128) and ``features.extras.K.1.weight`` / ``.bias``
  (the 3x3/2 convolution to 256);
* the heads: ``class_predictors.I.weight`` (A (C+1), w, 3, 3) /
  ``.bias`` and ``box_predictors.I.weight`` (4 A, w, 3, 3) / ``.bias``,
  A = 4 anchors a cell, w the scale's width (2048, then 256).

``running_mean`` and ``running_var`` are buffers in the port (they are
parameters with ``grad_req="null"`` in the JAX package) and are carried
by name with the same check.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from .base import MXNetError

__all__ = ["params_from_jax", "load_into"]


def _tensor(value) -> torch.Tensor:
    """A CPU tensor holding ``value``'s bits.  A bf16 array (the
    ``bfloat16`` dtype numpy gets from JAX, which torch cannot take) is
    carried bit for bit through an int16 view, recognised by its dtype's
    name so the port needs no package that defines it."""
    arr = np.array(value, copy=True)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def params_from_jax(named_numpy: Mapping[str, np.ndarray]
                    ) -> Dict[str, torch.Tensor]:
    """``{collect_params name: numpy array}`` -> a ``state_dict`` of CPU
    tensors for the port's module of the same structure; f32, f16 and
    bf16 arrays keep their type and bits."""
    return {name: _tensor(value) for name, value in named_numpy.items()}


@torch.no_grad()
def load_into(module: torch.nn.Module,
              named_numpy: Mapping[str, np.ndarray]) -> torch.nn.Module:
    """Copy the JAX package's parameter values into ``module``'s
    parameters and buffers (on its own device) and mark them
    initialized; raises when names or shapes do not match one to one.  A
    tensor whose width waits for the first forward takes the JAX
    array's shape (loading finishes a deferred init, as the JAX
    ``Parameter.set_data`` does)."""
    from .gluon.parameter import is_deferred, mark_initialized, materialize

    state = params_from_jax(named_numpy)
    own = dict(module.named_parameters())
    own.update(module.named_buffers())
    missing = sorted(set(own) - set(state))
    extra = sorted(set(state) - set(own))
    if missing or extra:
        raise MXNetError(f"parameter names differ: missing {missing}, "
                         f"unexpected {extra}")
    for name, p in own.items():
        src = state[name]
        if is_deferred(p):
            p.__dict__.pop("_mx_deferred", None)
            materialize(p, src.shape)
        if tuple(src.shape) != tuple(p.shape):
            raise MXNetError(f"{name}: shape {tuple(src.shape)} from JAX, "
                             f"{tuple(p.shape)} in the port")
        p.copy_(src.to(p.dtype))
        mark_initialized(p)
    return module
