"""``npx``: the fused-attention, convolution, pooling, batch-norm,
activation, dropout, fused-RNN, CTC and bounding-box operators of the
port, on tensors.

The port of ``flash_attention``, ``multi_head_attention``,
``convolution``, ``deconvolution``, ``pooling``, ``batch_norm``,
``batch_norm_with_relu``, ``layer_norm``, ``group_norm``,
``instance_norm``, ``activation``, ``leaky_relu``, ``dropout``, ``rnn``,
``ctc_loss``, ``box_iou``, ``box_nms``, ``roi_align``, ``box_encode``,
``box_decode`` and ``bipartite_matching`` from
``mxnet_tpu/numpy_extension/__init__.py`` (the last seven over
``ops.ctc`` and ``ops.boxes``).  They take and return
torch tensors (the JAX package wraps NDArrays).  The attention is
``ops.attention.flash_attention``, so CUDA tensors go through the
hand-written flash kernel and CPU tensors through its plain version;
``batch_norm_with_relu`` in training on channel-last input goes through
the hand-written ``bn_act`` kernels the same way.

The batch-norm operators train exactly when
``autograd.is_training()`` is true (inside ``autograd.record()`` or
``train_mode()``), as the JAX operators do; in training the running
statistics are updated IN PLACE (under ``torch.no_grad``), as the
reference mutates them.  Extension ops registered by ``rtc`` or
``library`` are attached here too (``npx.pallas_squared_relu``, ...).
"""
from __future__ import annotations

import torch

from .. import _not_ported
from .. import autograd as _ag
from .. import random as _random
from ..base import MXNetError
from ..ops import attention as _att
from ..ops import boxes as _bx
from ..ops import ctc as _ctc
from ..ops import nn as _nn
from ..ops import rnn as _rnn

__all__ = ["flash_attention", "multi_head_attention", "convolution",
           "deconvolution", "pooling", "batch_norm", "batch_norm_with_relu",
           "layer_norm", "group_norm", "instance_norm", "activation",
           "leaky_relu", "dropout", "rnn", "ctc_loss", "box_iou", "box_nms",
           "roi_align", "box_encode", "box_decode", "bipartite_matching"]


def flash_attention(query, key, value, mask=None, valid_length=None,
                    causal: bool = False, scale=None):
    """Fused attention on (B, H, T, D) tensors.  ``valid_length`` (B,)
    key lengths stay on the kernel; a boolean ``mask`` runs the plain
    version (``ops.attention.flash_attention``)."""
    return _att.flash_attention(query, key, value, mask=mask, causal=causal,
                                scale=scale, kv_valid_length=valid_length)


def multi_head_attention(query, key, value, num_heads: int, mask=None,
                         valid_length=None, causal: bool = False, scale=None):
    """(B, T, H*D) -> (B, T, H*D) multi-head attention: split the heads
    into (B, H, T, D), attend, merge them back.  ``valid_length``: (B,)
    key lengths (the padding mask that stays on the kernel)."""
    if query.shape[-1] % num_heads:
        raise MXNetError(f"embedding dim {query.shape[-1]} not divisible by "
                         f"num_heads {num_heads}")
    b, tq, emb = query.shape
    tk = key.shape[1]
    d = emb // num_heads

    def heads(x, t):                      # (B, T, H*D) -> (B, H, T, D)
        return x.reshape(b, t, num_heads, d).transpose(1, 2).contiguous()

    o = _att.flash_attention(heads(query, tq), heads(key, tk),
                             heads(value, tk), mask=mask, causal=causal,
                             scale=scale, kv_valid_length=valid_length)
    return o.transpose(1, 2).reshape(b, tq, emb)


def convolution(data, weight, bias=None, stride=1, dilate=1, pad=0,
                num_group=1, no_bias=False, layout=None):
    """2-D convolution (``ops.nn.convolution``; cuDNN on the card); the
    kernel size and filter count are ``weight``'s."""
    return _nn.convolution(data, weight, bias, stride=stride, dilate=dilate,
                           pad=pad, num_group=num_group, no_bias=no_bias,
                           layout=layout)


def deconvolution(data, weight, bias=None, kernel=None, stride=1, dilate=1,
                  pad=0, adj=0, num_filter=None, num_group=1, no_bias=False,
                  target_shape=None, layout=None):
    """2-D transposed convolution (``ops.nn.deconvolution``); the kernel
    size and filter count are ``weight``'s."""
    return _nn.deconvolution(data, weight, bias, stride=stride,
                             dilate=dilate, pad=pad, adj=adj,
                             num_group=num_group, no_bias=no_bias,
                             layout=layout)


def layer_norm(x, gamma, beta, axis=-1, eps=1e-5):
    """Layer normalization over ``axis`` (``ops.nn.layer_norm``)."""
    return _nn.layer_norm(x, gamma, beta, eps, axis=axis)


def group_norm(x, gamma, beta, num_groups=1, eps=1e-5):
    """Group normalization of channel-first ``x`` (``ops.nn.group_norm``)."""
    return _nn.group_norm(x, gamma, beta, num_groups, eps)


def instance_norm(x, gamma, beta, eps=1e-5):
    """Instance normalization of channel-first ``x``
    (``ops.nn.instance_norm``)."""
    return _nn.instance_norm(x, gamma, beta, eps)


def leaky_relu(data, gamma=None, act_type: str = "leaky", slope: float = 0.25,
               lower_bound: float = 0.125, upper_bound: float = 0.334, **kw):
    """The leaky family (``ops.nn.leaky_relu``: leaky, prelu, elu, selu,
    gelu, rrelu); rrelu draws its slopes in training
    (``autograd.is_training()``) from the port's seeded generator of
    ``data``'s device, as the JAX op draws them from its key."""
    gen = _random.generator(data.device) if act_type == "rrelu" and \
        _ag.is_training() else None
    return _nn.leaky_relu(data, gamma, act_type, slope, lower_bound,
                          upper_bound, generator=gen)


def pooling(data, kernel=1, pool_type="max", stride=None, pad=0,
            global_pool=False, count_include_pad=True,
            pooling_convention="valid", layout=None):
    """Max / avg / global pooling (``ops.nn.pooling``)."""
    return _nn.pooling(data, kernel=kernel, pool_type=pool_type,
                       stride=stride, pad=pad, global_pool=global_pool,
                       count_include_pad=count_include_pad,
                       pooling_convention=pooling_convention, layout=layout)


@torch.no_grad()
def _write_stats(running_mean, running_var, new_mean, new_var):
    running_mean.copy_(new_mean)
    running_var.copy_(new_var)


def batch_norm(x, gamma, beta, running_mean, running_var, eps=1e-5,
               momentum=0.9, fix_gamma=False, use_global_stats=False,
               axis=1):
    """Batch norm; in training (``autograd.is_training()``, and not
    ``use_global_stats``) with the batch statistics, writing the blended
    running statistics in place; otherwise with the running
    statistics."""
    if _ag.is_training() and not use_global_stats:
        out, new_mean, new_var = _nn.batch_norm_train(
            x, gamma, beta, running_mean, running_var, eps=eps,
            momentum=momentum, axis=axis, fix_gamma=fix_gamma)
        _write_stats(running_mean, running_var, new_mean, new_var)
        return out
    return _nn.batch_norm_infer(x, gamma, beta, running_mean, running_var,
                                eps=eps, axis=axis, fix_gamma=fix_gamma)


def batch_norm_with_relu(x, gamma, beta, running_mean, running_var,
                         eps=1e-5, momentum=0.9, fix_gamma=False,
                         use_global_stats=False, axis=1):
    """Batch norm fused with relu.  In training (as :func:`batch_norm`):
    ``ops.nn.batch_norm_act_train``, which runs the hand-written stats
    and apply kernels on channel-last input, writing the running
    statistics in place; otherwise ``relu`` of :func:`batch_norm` (no
    kernel)."""
    if _ag.is_training() and not use_global_stats:
        out, new_mean, new_var = _nn.batch_norm_act_train(
            x, gamma, beta, running_mean, running_var, eps=eps,
            momentum=momentum, axis=axis, fix_gamma=fix_gamma,
            act_type="relu")
        _write_stats(running_mean, running_var, new_mean, new_var)
        return out
    return torch.relu(batch_norm(
        x, gamma, beta, running_mean, running_var, eps=eps,
        momentum=momentum, fix_gamma=fix_gamma,
        use_global_stats=use_global_stats, axis=axis))


def activation(data, act_type: str = "relu"):
    """Elementwise activation by name (``ops.nn.activation``: the JAX
    package's ten)."""
    return _nn.activation(data, act_type)


def dropout(data, p: float = 0.5, mode: str = "training", axes=()):
    """Inverted dropout (``ops.nn.dropout``): only under
    ``autograd.is_training()``, unless ``mode="always"``; the mask from
    the port's seeded generator of ``data``'s device."""
    if not _ag.is_training() and mode != "always":
        return data
    return _nn.dropout(data, p, axes)


def rnn(data, parameters, state, state_cell=None, mode: str = "lstm",
        state_size=None, num_layers: int = 1, bidirectional: bool = False,
        p: float = 0.0, state_outputs: bool = True, projection_size=None,
        sequence_length=None, use_sequence_length: bool = False):
    """Fused multi-layer RNN over TNC ``data`` (``ops.rnn.rnn_fused``; ref
    src/operator/rnn.cc).  ``parameters``: the cuDNN-layout flat vector
    (or the per-(layer, direction) tuples).  Returns ``(out, hy, cy)`` for
    LSTM and ``(out, hy)`` otherwise, ``out`` alone when
    ``state_outputs`` is False.  Inter-layer dropout is active only under
    ``autograd.is_training()`` and with ``num_layers > 1``; its masks come
    from the port's seeded generator of ``data``'s device (the JAX op
    draws them from its global key)."""
    drop = p if (p > 0.0 and _ag.is_training() and num_layers > 1) else 0.0
    if mode == "lstm" and state_cell is None:
        raise MXNetError("lstm mode requires state_cell")
    if use_sequence_length and sequence_length is None:
        raise MXNetError("use_sequence_length=True requires sequence_length")
    res = _rnn.rnn_fused(
        data, parameters, state, state_cell if mode == "lstm" else None,
        mode=mode, state_size=state_size, num_layers=num_layers,
        bidirectional=bidirectional, p=drop,
        projection_size=projection_size, sequence_length=sequence_length,
        use_sequence_length=use_sequence_length,
        generator=_random.generator(data.device) if drop > 0.0 else None)
    return res[0] if not state_outputs else res


def _out(res, out):
    """``res``, or ``res`` written into ``out`` when given."""
    if out is None:
        return res
    out.copy_(res)
    return out


def ctc_loss(pred, labels, pred_lengths=None, label_lengths=None, out=None):
    """Connectionist temporal classification loss (``ops.ctc.ctc_loss``):
    ``pred`` (N, T, C) logits, ``labels`` (N, L), 0 the blank and the
    padding; (N,) losses."""
    return _out(_ctc.ctc_loss(pred, labels, pred_lengths=pred_lengths,
                              label_lengths=label_lengths), out)


def box_iou(lhs, rhs, format="corner", out=None):  # noqa: A002
    """Pairwise IoU (``ops.boxes.box_iou``)."""
    return _out(_bx.box_iou(lhs, rhs, fmt=format), out)


def box_nms(data, overlap_thresh=0.5, valid_thresh=0.0, topk=-1,
            coord_start=2, score_index=1, id_index=-1,
            force_suppress=False, out=None):
    """Greedy NMS (``ops.boxes.box_nms``)."""
    return _out(_bx.box_nms(
        data, overlap_thresh=overlap_thresh, valid_thresh=valid_thresh,
        topk=topk, coord_start=coord_start, score_index=score_index,
        id_index=id_index, force_suppress=force_suppress), out)


def roi_align(data, rois, pooled_size, spatial_scale=1.0, sample_ratio=2,
              out=None):
    """ROI Align (``ops.boxes.roi_align``); ``pooled_size`` an int or a
    pair."""
    ps = pooled_size if isinstance(pooled_size, (tuple, list)) \
        else (pooled_size, pooled_size)
    return _out(_bx.roi_align(data, rois, tuple(ps),
                              spatial_scale=spatial_scale,
                              sample_ratio=sample_ratio), out)


def box_encode(samples, matches, anchors, refs, means=None, stds=None, **kw):
    """Matched boxes as center-offset targets (``ops.boxes.box_encode``)."""
    return _bx.box_encode(samples, matches, anchors, refs, means, stds)


def box_decode(data, anchors, std0=0.1, std1=0.1, std2=0.2, std3=0.2,
               clip=-1.0, format="corner", **kw):  # noqa: A002
    """Center-offset predictions to corners (``ops.boxes.box_decode``)."""
    return _bx.box_decode(data, anchors, std0, std1, std2, std3, clip,
                          format)


def bipartite_matching(score, threshold=1e-12, is_ascend=False, topk=-1,
                       **kw):
    """Greedy bipartite matching (``ops.boxes.bipartite_matching``)."""
    return _bx.bipartite_matching(score, threshold, is_ascend, topk)


# a JAX npx name not yet ported raises naming its ROADMAP item
__getattr__ = _not_ported.module_getattr(__name__, "mx.npx", _not_ported.NPX)
