"""Dense, convolution, pooling and normalization ops of the serving
and training paths.

The dense ops, convolution and pooling were XLA ops in the JAX package
(``mxnet_tpu/ops/nn.py``), not Pallas kernels, so ``torch.nn.functional``
/ ``torch.matmul`` (cuDNN on the card) are their port.  Training-mode
batch norm fused with an activation on channel-last input
(:func:`batch_norm_act_train`) goes to the hand-written kernels of
``kernels/bn_act.py``.

Layouts are the JAX package's: ``NCHW`` with ``OIHW`` weights, or
channel-last ``NHWC`` with ``OHWI`` weights.  A channel-last tensor is
handed to PyTorch as the free ``permute(0, 3, 1, 2)`` view, which has
``channels_last`` strides, and its OHWI weight likewise, so cuDNN runs
NHWC convolutions and the result, permuted back, is again a contiguous
NHWC tensor: no layout copy on the card.

Under data parallelism each rank holds some rows of the batch, and the
JAX trainer's batch-norm statistics are the whole batch's (its step is
one program over the global batch).  Inside :func:`batch_stats_group`
(``ShardedTrainer`` enters it around each step's forward and backward)
the training-mode batch norms reduce their sums over the group's ranks:
the plain version through a differentiable all-reduce of the sums
(``parallel.collectives.all_reduce_autograd``), the ``bn_act`` kernels
through their dp mode (sums, all-reduce, fold) and an all-reduce of the
backward's ``sum(dy)`` and ``sum(dy * xhat)``.
"""
from __future__ import annotations

import contextlib
import math
import threading

import torch
import torch.nn.functional as F

from .. import random as _random
from ..base import MXNetError

__all__ = ["fully_connected", "layer_norm", "group_norm", "instance_norm",
           "erf_gelu", "tanh_gelu", "mish", "soft_sign", "activation",
           "leaky_relu", "dropout", "convolution", "deconvolution", "pooling",
           "batch_norm_train", "batch_norm_infer", "batch_norm_act_train",
           "is_channel_last", "batch_stats_group"]

_SYNC = threading.local()


@contextlib.contextmanager
def batch_stats_group(group):
    """Batch norm in this block takes its statistics over the ranks of
    ``group`` (a process group; None: this rank's rows alone)."""
    prev = getattr(_SYNC, "group", None)
    _SYNC.group = group
    try:
        yield
    finally:
        _SYNC.group = prev


def _stats_group():
    return getattr(_SYNC, "group", None)


def fully_connected(x, weight, bias=None, flatten: bool = True):
    """``y = x @ weight.T + bias`` with ``weight`` (units, in_units);
    ``flatten=True`` collapses all but the batch axis first.  Mixed types
    promote as ``jnp.matmul`` and ``+`` do (a bf16 x with f32 weights, as
    ``amp.convert_hybrid_block`` leaves them, gives f32)."""
    if flatten and x.ndim > 2:
        x = x.reshape(x.shape[0], -1)
    dt = torch.promote_types(x.dtype, weight.dtype)   # jnp's: bf16, f16 -> f32
    y = torch.matmul(x.to(dt), weight.to(dt).T)
    return y if bias is None else y + bias


def layer_norm(x, gamma, beta, eps: float = 1e-5, axis: int = -1):
    """Normalize over ``axis`` (the last by default): ``(x - mean) /
    sqrt(var + eps)`` (biased variance), then ``* gamma + beta`` along
    that axis.  Another axis is moved last and back.

    f32 runs one fused ``F.layer_norm``.  Other types follow the JAX
    op's dtypes (``mxnet_tpu/ops/nn.py`` ``layer_norm``): the statistics
    accumulate in f32 and the normalized rows come back in ``x``'s type,
    then ``* gamma + beta`` in the promoted type of ``x``, ``gamma`` and
    ``beta``.  Where x, gamma and beta share a 16-bit type (a 16-bit
    policy or ``Block.cast``) the rows are rounded once, where the JAX op
    rounds ``x - mean`` and the product apart (a recorded difference, one
    16-bit ulp of a 16-bit result).  Where 16-bit rows meet f32
    parameters (``amp.convert_hybrid_block``) the result is f32, so the
    rows take the JAX op's roundings exactly: mean and variance in f32
    rounded to x's type, ``x - mean`` and the correctly rounded ``rsqrt``
    and their product in x's type."""
    axis = axis % x.ndim
    if axis != x.ndim - 1:
        return layer_norm(x.movedim(axis, -1), gamma, beta, eps).movedim(
            -1, axis)
    n = (x.shape[-1],)
    if x.dtype == gamma.dtype == beta.dtype == torch.float32:
        return F.layer_norm(x, n, gamma, beta, eps)
    if x.dtype == gamma.dtype == beta.dtype:
        return F.layer_norm(x, n, None, None, eps) * gamma + beta
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True).to(x.dtype)
    inv = torch.rsqrt((var + eps).double()).to(x.dtype)
    return (x - mean.to(x.dtype)) * inv * gamma + beta


def _normalize(x, axes, eps: float):
    """``(x - mean) * rsqrt(var + eps)`` over ``axes`` (biased variance),
    as the JAX ops compute it."""
    mean = x.mean(dim=axes, keepdim=True)
    var = (x - mean).square().mean(dim=axes, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps)


def _per_channel(t, x):
    return t.reshape((1, -1) + (1,) * (x.ndim - 2))


def group_norm(x, gamma, beta, num_groups: int = 1, eps: float = 1e-5):
    """Group normalization of channel-first ``x`` (N, C, ...): the
    channels split into ``num_groups`` groups, each normalized over its
    channels and the spatial axes, then ``* gamma + beta`` per channel
    (``mxnet_tpu/ops/nn.py:391``)."""
    n, c = x.shape[:2]
    if c % num_groups:
        raise MXNetError(f"group_norm: {c} channels do not split into "
                         f"{num_groups} groups")
    g = x.reshape((n, num_groups, c // num_groups) + tuple(x.shape[2:]))
    y = _normalize(g, tuple(range(2, g.ndim)), eps).reshape(x.shape)
    return y * _per_channel(gamma, x) + _per_channel(beta, x)


def instance_norm(x, gamma, beta, eps: float = 1e-5):
    """Instance normalization of channel-first ``x``: each (sample,
    channel) over the spatial axes, then ``* gamma + beta`` per channel
    (``mxnet_tpu/ops/nn.py:406``)."""
    y = _normalize(x, tuple(range(2, x.ndim)), eps)
    return y * _per_channel(gamma, x) + _per_channel(beta, x)


def leaky_relu(x, gamma=None, act_type: str = "leaky", slope: float = 0.25,
               lower_bound: float = 0.125, upper_bound: float = 0.334,
               generator=None):
    """The leaky family of ``mxnet_tpu/ops/nn.py`` ``leaky_relu``:
    ``"leaky"`` (``slope * x`` below 0), ``"prelu"`` (``gamma * x`` below
    0, ``gamma`` per channel on axis 1), ``"elu"`` (``slope * (exp(x) -
    1)`` below 0), ``"selu"``, ``"gelu"`` (the erf form) and ``"rrelu"``
    (a slope a value drawn uniform in ``[lower_bound, upper_bound)``
    from ``generator``, or their mean without one, as the JAX op takes
    its mean without a key)."""
    if act_type == "leaky":
        return torch.where(x > 0, x, slope * x)
    if act_type == "prelu":
        g = gamma
        if g.ndim < x.ndim and x.ndim > 1:
            g = _per_channel(g, x)
        return torch.where(x > 0, x, g * x)
    if act_type == "elu":
        return torch.where(x > 0, x, slope * (torch.exp(x) - 1))
    if act_type == "selu":
        return torch.selu(x)
    if act_type == "gelu":
        return erf_gelu(x)
    if act_type == "rrelu":
        if generator is None:
            s = (lower_bound + upper_bound) / 2.0
        else:
            s = (torch.rand(x.shape, generator=generator, device=x.device)
                 * (upper_bound - lower_bound) + lower_bound).to(x.dtype)
        return torch.where(x > 0, x, s * x)
    raise MXNetError(f"unknown leaky_relu act_type '{act_type}'")


def erf_gelu(x):
    """Exact GELU, ``x * Phi(x)`` with the erf form (not the tanh
    approximation); in ``x``'s type, as ``jax.nn.gelu`` (the 16-bit types
    computed in f32 inside and rounded once)."""
    return F.gelu(x, approximate="none")


def tanh_gelu(x):
    """GELU in its tanh form, ``jax.nn.gelu``'s default."""
    return F.gelu(x, approximate="tanh")


def mish(x):
    """``x * tanh(softplus(x))``."""
    return x * torch.tanh(F.softplus(x))


def soft_sign(x):
    """``x / (|x| + 1)``, as ``jax.nn.soft_sign``."""
    return x / (x.abs() + 1)


# the JAX package's table (``mxnet_tpu/ops/nn.py`` ``_ACTIVATIONS``)
_ACTIVATIONS = {
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "softrelu": F.softplus,
    "softsign": soft_sign,
    "log_sigmoid": F.logsigmoid,
    "mish": mish,
    "gelu": tanh_gelu,
    "erf_gelu": erf_gelu,
    "silu": F.silu,
}


def activation(x, act_type: str = "relu"):
    """Elementwise activation by the JAX package's name: ``"relu"``,
    ``"sigmoid"``, ``"tanh"``, ``"softrelu"`` (softplus), ``"softsign"``,
    ``"log_sigmoid"``, ``"mish"``, ``"gelu"`` (the tanh form),
    ``"erf_gelu"`` (exact) or ``"silu"``."""
    fn = _ACTIVATIONS.get(act_type)
    if fn is None:
        raise MXNetError(f"unknown activation {act_type!r}; the port has "
                         f"{sorted(_ACTIVATIONS)}")
    return fn(x)


def dropout(x, p: float, axes=(), generator=None):
    """Inverted dropout at rate ``p``: the keep-mask comes from a uniform
    drawn in f32, whatever ``x``'s type, from ``generator`` (the port's
    seeded generator of ``x``'s device when None), with size 1 along
    ``axes`` so one draw keeps or drops a whole slice there; kept values
    are ``x / keep`` in ``x``'s type, ``keep = 1 - p`` taken in that type,
    as the JAX ``dropout`` computes ``jnp.where(mask, x / keep, 0)``.  A
    uniform drawn in bf16 takes a few thousand values and keeps the
    wrong share."""
    if p <= 0.0:
        return x
    shape = list(x.shape)
    for ax in axes:
        shape[ax] = 1
    gen = generator if generator is not None else _random.generator(x.device)
    u = torch.rand(shape, generator=gen, device=x.device, dtype=torch.float32)
    # keep rounded to x's type on the host, as JAX rounds the weakly
    # typed scalar; the division itself runs in f32 and rounds once
    keep = torch.tensor(1.0 - p, dtype=x.dtype).item()
    return torch.where(u >= p, x / keep, 0.0)


# -- convolution and pooling ------------------------------------------------

_LAYOUTS = {"NCHW": False, "NHWC": True}     # 2-D layouts -> channel-last


def is_channel_last(layout, ndim: int) -> bool:
    """Whether a 2-D ``layout`` keeps channels last; raises on a rank
    other than 4 or an unknown layout."""
    if ndim != 4:
        raise MXNetError(f"only 2-D convolution and pooling are ported "
                         f"(input of rank {ndim}); ROADMAP A6, long tail")
    lay = layout or "NCHW"
    if lay not in _LAYOUTS:
        raise MXNetError(f"layout {lay!r} unknown; use {sorted(_LAYOUTS)}")
    return _LAYOUTS[lay]


def _pair(v):
    return (int(v),) * 2 if isinstance(v, int) else tuple(int(e) for e in v)


def _nchw(x, last: bool):
    return x.permute(0, 3, 1, 2) if last else x


def _back(y, last: bool):
    return y.permute(0, 2, 3, 1) if last else y


def convolution(x, weight, bias=None, stride=1, dilate=1, pad=0,
                num_group: int = 1, no_bias: bool = False, layout=None):
    """2-D convolution: ``x`` NCHW with an OIHW ``weight``, or NHWC with
    an OHWI ``weight`` (module docstring); symmetric ``pad``."""
    last = is_channel_last(layout, x.ndim)
    if x.dtype != weight.dtype:       # lax.conv_general_dilated refuses too
        raise MXNetError(f"convolution of a {x.dtype} input with a "
                         f"{weight.dtype} weight: the types must match (cast "
                         "the block with Block.cast, or the input)")
    w = weight.permute(0, 3, 1, 2) if last else weight
    b = None if no_bias else bias
    late = b is not None and b.dtype != x.dtype  # added after, promoted
    xin, padding = _nchw(x, last), _pair(pad)
    if xin.device.type == "cpu" and xin.dtype == torch.bfloat16 \
            and any(padding):
        # PyTorch's CPU bf16 convolution leaves garbage in the weight
        # gradient's taps over implicit padding where a map is one wide
        # and the stride above 1 (an SSD extra at 128 x 128); explicit
        # zeros give the same function, and every tap a computed zero
        xin = F.pad(xin, (padding[1], padding[1], padding[0], padding[0]))
        padding = (0, 0)
    y = F.conv2d(xin, w, None if late else b, stride=_pair(stride),
                 padding=padding, dilation=_pair(dilate),
                 groups=int(num_group))
    y = _back(y, last)
    if late:
        y = y + b.reshape([-1] + [1] * (y.ndim - 2) if not last else [-1])
    return y


def deconvolution(x, weight, bias=None, stride=1, dilate=1, pad=0, adj=0,
                  num_group: int = 1, no_bias: bool = False, layout=None):
    """2-D transposed convolution (``mxnet_tpu/ops/nn.py:121``): ``x``
    NCHW with an (in, out / groups, kh, kw) ``weight``, or NHWC with
    its channel-last form (in, kh, kw, out / groups).  The output is
    ``(in - 1) * stride - 2 * pad + dilate * (k - 1) + 1 + adj`` wide,
    for any ``adj`` (PyTorch's ``output_padding`` must stay below the
    stride), as the JAX op's extra padding gives: the transposed
    convolution runs unpadded, and the output is its window from ``pad``
    on, zeros past its end."""
    last = is_channel_last(layout, x.ndim)
    if x.dtype != weight.dtype:
        raise MXNetError(f"deconvolution of a {x.dtype} input with a "
                         f"{weight.dtype} weight: the types must match")
    w = weight.permute(0, 3, 1, 2) if last else weight
    y = F.conv_transpose2d(_nchw(x, last), w, None, stride=_pair(stride),
                           dilation=_pair(dilate), groups=int(num_group))
    (ph, pw), (ah, aw) = _pair(pad), _pair(adj)
    hw = [y.shape[2] - 2 * ph + ah, y.shape[3] - 2 * pw + aw]
    y = F.pad(y, (0, max(0, pw + hw[1] - y.shape[3]),
                  0, max(0, ph + hw[0] - y.shape[2])))
    y = y[:, :, ph:ph + hw[0], pw:pw + hw[1]]
    if bias is not None and not no_bias:
        y = y + bias.reshape(1, -1, 1, 1)
    return _back(y, last)


def pooling(x, kernel=1, pool_type: str = "max", stride=None, pad=0,
            global_pool: bool = False, count_include_pad: bool = True,
            pooling_convention: str = "valid", layout=None):
    """2-D max / avg pooling and their global forms; padding is implicit
    (-inf for max; for avg counted in the divisor when
    ``count_include_pad``), as the JAX package pads its reduce window.
    ``pooling_convention="full"`` (the layers' ``ceil_mode=True``) pads
    the high edge by ``pad + stride - 1`` as the JAX op does, and an avg
    window counts that padding when ``count_include_pad`` (the JAX
    op's divisor is the window's size), unlike PyTorch's ``ceil_mode``,
    which clips the last window."""
    last = is_channel_last(layout, x.ndim)
    if pool_type not in ("max", "avg"):
        raise MXNetError(f"pool_type {pool_type!r} is not ported (max, avg "
                         "are); ROADMAP A6, long tail")
    if global_pool:
        axes = (1, 2) if last else (2, 3)
        if pool_type == "max":
            return x.amax(dim=axes, keepdim=True)
        return x.mean(dim=axes, keepdim=True)
    if pooling_convention not in ("valid", "full"):
        raise MXNetError(f"pooling_convention={pooling_convention!r} is "
                         "unknown ('valid', 'full')")
    ks = _pair(kernel)
    st = _pair(stride if stride is not None else kernel)
    pd = _pair(pad)
    xc = _nchw(x, last)
    if pooling_convention == "full":
        edges = (pd[1], pd[1] + st[1] - 1, pd[0], pd[0] + st[0] - 1)
        if pool_type == "max":
            y = F.max_pool2d(F.pad(xc, edges, value=-math.inf), ks, st)
        elif count_include_pad:
            y = F.avg_pool2d(F.pad(xc, edges), ks, st)
        else:
            ones = F.pad(torch.ones_like(xc[:1, :1]), edges)
            y = F.avg_pool2d(F.pad(xc, edges), ks, st) / \
                F.avg_pool2d(ones, ks, st)
        return _back(y, last)
    if pool_type == "max":
        y = F.max_pool2d(xc, ks, st, pd)
    else:
        y = F.avg_pool2d(xc, ks, st, pd, count_include_pad=count_include_pad)
    return _back(y, last)


# -- normalization -----------------------------------------------------------

def _channel_shape(x, axis: int):
    shape = [1] * x.ndim
    shape[axis] = x.shape[axis]
    return shape


_HALF = (torch.bfloat16, torch.float16)


def _blend(moving, batch, momentum: float):
    """MXNet's running-statistics blend ``m * momentum + batch * (1 -
    momentum)`` (the opposite of PyTorch's momentum convention), off the
    graph, in the buffer's dtype.  A 16-bit buffer (the trainer's cast
    copy) gets the JAX op's values under XLA on the CPU: ``momentum``
    rounded to the buffer's type (a weakly typed scalar; 0.8984375 for
    0.9 in bf16), the product in f32 (rounded to f16 for an f16 buffer,
    kept in f32 for bf16), the batch term and the sum in f32, one cast."""
    with torch.no_grad():
        if moving.dtype not in _HALF:
            return (moving * momentum + batch.detach() * (1 - momentum)
                    ).to(moving.dtype)
        m = torch.tensor(momentum, dtype=moving.dtype).item()
        kept = moving.float() * m
        if moving.dtype == torch.float16:
            kept = kept.half().float()
        return (kept + batch.detach().float() * (1 - momentum)
                ).to(moving.dtype)


def batch_norm_train(x, gamma, beta, moving_mean, moving_var,
                     eps: float = 1e-5, momentum: float = 0.9, axis: int = 1,
                     fix_gamma: bool = False, use_global_stats: bool = False):
    """Training-mode batch norm: ``(out, new_moving_mean,
    new_moving_var)``.  Batch statistics over every axis but ``axis``
    (two-pass biased variance) in f32 whatever x's type, folded in f32
    into per-channel scale and shift rounded to x's type, and ``out`` in
    x's type (the JAX package's 16-bit rules); the new moving statistics
    are returned in the buffers' type, not written (the ``npx`` layer
    writes them)."""
    from ..kernels import bn_act as _kbn

    axis = axis % x.ndim
    if fix_gamma:
        gamma = torch.ones_like(gamma)
    axes = tuple(i for i in range(x.ndim) if i != axis)
    shape = _channel_shape(x, axis)
    group = _stats_group()
    if use_global_stats:
        mean, var = moving_mean, moving_var
        new_mean, new_var = moving_mean, moving_var
    else:
        xf = x.float() if x.dtype in _HALF else x
        if group is None:
            mean = xf.mean(dim=axes)
            var = (xf - mean.reshape(shape)).square().mean(dim=axes)
        else:
            mean, var = _dp_moments(xf, axes, shape, group)
        new_mean = _blend(moving_mean, mean, momentum)
        new_var = _blend(moving_var, var, momentum)
    inv = torch.rsqrt(var + eps)
    g = gamma.float() if gamma.dtype in _HALF else gamma
    b = beta.float() if beta.dtype in _HALF else beta
    scale = (g * inv).to(x.dtype).reshape(shape)
    shift = (b - mean * g * inv).to(x.dtype).reshape(shape)
    # the apply's roundings (bf16 twice, f16 once) are the kernel's
    return _kbn.bn_apply_plain(x, scale, shift, "identity"), new_mean, \
        new_var


def _dp_moments(xf, axes, shape, group):
    """The mean and the two-pass biased variance over the rows of every
    rank of ``group``: each sum all-reduced (differentiably) with the row
    count, then divided."""
    from ..parallel.collectives import all_reduce_autograd

    rows = xf.numel() // max(1, math.prod(shape))
    s = all_reduce_autograd(torch.cat([
        xf.sum(dim=axes), xf.new_full((1,), float(rows))]), group)
    n = s[-1].detach()
    mean = s[:-1] / n
    var = all_reduce_autograd(
        (xf - mean.reshape(shape)).square().sum(dim=axes), group) / n
    return mean, var


def _fold16(gamma, beta, mean, var, eps: float):
    """``(scale, shift)`` of 16-bit statistics (one type) in that type, as
    XLA on the CPU computes the JAX op's fold under ``jit``: every op
    rounded to the type (torch's own 16-bit ops, which compute in f32 and
    round); in f16 ``eps`` rounded to the type first, ``rsqrt`` as ``1 /
    sqrt`` and ``beta - (mean * gamma) * inv`` rounded once (a fused
    multiply-add, ``addcmul``); in bf16 ``rsqrt`` of the rounded ``var +
    eps`` in f32, rounded once (torch's bf16 ``rsqrt`` rounds otherwise)."""
    mg = mean * gamma
    if var.dtype == torch.float16:
        inv = torch.reciprocal(torch.sqrt(
            var + float(torch.tensor(eps, dtype=var.dtype))))
        return gamma * inv, torch.addcmul(beta, mg, inv, value=-1.0)
    inv = torch.rsqrt((var + eps).float()).to(var.dtype)
    return gamma * inv, beta - mg * inv


def batch_norm_infer(x, gamma, beta, moving_mean, moving_var,
                     eps: float = 1e-5, axis: int = 1, fix_gamma: bool = False):
    """Inference batch norm with the moving statistics, folded into
    per-channel scale and shift, as the JAX op (``mxnet_tpu/ops/nn.py``
    ``batch_norm_infer``): ``rsqrt(var + eps)`` and the fold in the
    statistics' type, scale and shift cast to x's type, ``y = x * scale +
    shift`` in x's type (a 16-bit x with f32 statistics gives a 16-bit
    y).  16-bit statistics fold with XLA-on-the-CPU's roundings
    (:func:`_fold16`), and the apply rounds as the batch-norm kernels' do
    (bf16 twice, f16 once), so the result equals the jitted JAX op's
    bits.  A few launches a layer: serving runs it once a layer a
    batch."""
    axis = axis % x.ndim
    if fix_gamma:
        gamma = torch.ones_like(gamma)
    shape = _channel_shape(x, axis)
    stats = (gamma, beta, moving_mean, moving_var)
    if moving_var.dtype in _HALF and all(t.dtype == moving_var.dtype
                                         for t in stats):
        scale, shift = _fold16(*stats, eps)
    else:
        inv = torch.rsqrt(moving_var + eps)
        scale, shift = gamma * inv, beta - moving_mean * gamma * inv
    scale = scale.to(x.dtype).reshape(shape)
    shift = shift.to(x.dtype).reshape(shape)
    if x.dtype == torch.float16:      # the f32 sum rounded once
        return torch.addcmul(shift, x, scale)
    return x * scale + shift          # bf16: the product, then the sum


def batch_norm_act_train(x, gamma, beta, moving_mean, moving_var,
                         eps: float = 1e-5, momentum: float = 0.9,
                         axis: int = 1, fix_gamma: bool = False,
                         use_global_stats: bool = False,
                         act_type: str = "relu"):
    """Training-mode batch norm fused with an activation: ``(out,
    new_moving_mean, new_moving_var)``.

    Channel-last input (``axis`` the last) with act ``relu`` or
    ``identity`` goes to ``kernels.bn_act.bn_act_train`` (the
    hand-written stats and apply kernels on the card, their plain
    versions on the CPU; one-pass variance); anything else composes
    :func:`batch_norm_train` and :func:`activation`, as the JAX package
    does.  Any row count takes the kernel path."""
    from ..kernels import bn_act as _kbn

    axis = axis % x.ndim
    if (not use_global_stats and axis == x.ndim - 1
            and _kbn.supported_act(act_type)):
        g = torch.ones_like(gamma) if fix_gamma else gamma
        out, mean, var = _kbn.bn_act_train(x, g, beta, eps, act_type,
                                           group=_stats_group())
        return (out, _blend(moving_mean, mean, momentum),
                _blend(moving_var, var, momentum))
    out, new_mean, new_var = batch_norm_train(
        x, gamma, beta, moving_mean, moving_var, eps=eps, momentum=momentum,
        axis=axis, fix_gamma=fix_gamma, use_global_stats=use_global_stats)
    if act_type != "identity":
        out = activation(out, act_type)
    return out, new_mean, new_var
