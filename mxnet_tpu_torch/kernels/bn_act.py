"""Fused batch-norm statistics + scale/shift + activation (channel-last).

The port of ``mxnet_tpu/kernels/bn_act.py``.  Training-mode batch norm
over a channel-last tensor viewed as ``(rows, C)`` runs in two passes
with one read of ``x`` each:

* :func:`bn_stats`: the per-channel statistics, with the JAX kernel's
  one-pass variance ``mean = s / n``, ``var = max(ss / n - mean^2, 0)``
  (not ``torch.var``), summed in float64 where the JAX kernel sums in
  f32, and folded with ``gamma`` and ``beta`` into the per-channel
  ``scale = gamma * rsqrt(var + eps)`` and ``shift = beta - mean *
  gamma * rsqrt(var + eps)`` (the JAX package's fold, in f32);
* :func:`bn_apply`: ``y = x * scale + shift``, then relu when asked.

``x`` is f32, bf16 or f16, and ``gamma`` / ``beta`` / ``scale`` /
``shift`` are in its type.  A 16-bit ``x`` follows the JAX package's
rules: mean and var in f32, scale and shift rounded to x's type, ``y``
in x's type with the rounding XLA on the CPU gives the TPU kernel (bf16:
the product rounded to bf16, then the sum; f16: the f32 sum rounded
once), the backward in f32.

CUDA tensors launch the hand-written kernels of ``csrc/bn_act.cu``
(any ``rows >= 1`` and ``C >= 1``, contiguous, any alignment; the
statistics and the fold in one launch; counted as ``bn_act_stats`` /
``bn_act_apply`` in f32 and ``bn_act_stats.bf16``, ``...f16`` in 16
bits) or raise; CPU tensors run :func:`bn_stats_plain` /
:func:`bn_apply_plain`, the same formulas in plain PyTorch.  Unlike the
TPU kernels, which need a row count that some preferred block divides
(``pick_row_block``), the port's kernels take any row count, so
``batch_norm_act_train`` has no "not tile-able" fallback.

:func:`bn_act_train` is the training-mode op as an autograd function:
``(y, mean, var)``.  Its backward is the analytic BN(+relu) gradient of
``_bn_act_bwd`` in plain PyTorch (the JAX package has no Pallas
backward), in f32 with ``dx`` in x's type and ``dgamma`` / ``dbeta`` in
gamma's, with the terms of the statistics' own gradients, so
differentiating through the returned ``mean`` / ``var`` matches
``jax.grad``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..base import MXNetError
from . import registry as _kreg

__all__ = ["bn_act_train", "bn_stats", "bn_apply", "bn_stats_plain",
           "bn_apply_plain", "supported_act", "plan", "rows_view",
           "STATS_COLS"]

_ACTS = ("relu", "identity")
_NT = 256                  # threads a block (csrc/bn_act.cu NT)
_BLOCKS_PER_SM = 4         # one wave: 4 resident 256-thread blocks an SM
_MIN_ROWS_PER_THREAD = 8   # below this a split costs more than it hides
STATS_COLS = 16            # columns a stats block reads (its combine's width)
# x's type -> the C entries' and launch counts' suffix
_SFX = {torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16"}


def supported_act(act_type: str) -> bool:
    """Whether the kernels fuse ``act_type`` (``"relu"``, ``"identity"``)."""
    return act_type in _ACTS


def _kernel_name(kernel: str, dtype) -> str:
    """The registry name of ``kernel`` (``"bn_act_stats"`` or
    ``"bn_act_apply"``) for x of ``dtype``: the f32 kernels keep their
    names, the 16-bit ones add ``.bf16`` / ``.f16``."""
    sfx = _SFX.get(dtype)
    if sfx is None:
        raise MXNetError(f"{kernel}: no kernel for {dtype}; the kernels "
                         f"take {list(_SFX)}")
    return kernel if sfx == "f32" else f"{kernel}.{sfx}"


class Plan(NamedTuple):
    """The kernels' grid: ``tx`` column groups of ``vec`` values by
    ``256 // tx`` rows a block; ``col_blocks`` x ``splits`` blocks, each
    split ``rows_per_split`` rows."""

    vec: int
    tx: int
    col_blocks: int
    splits: int
    rows_per_split: int


def plan(rows: int, c: int, sms: int, cols: int = 128,
         width: int = 4) -> Plan:
    """The grid for ``(rows, C)`` on a card of ``sms`` SMs: column groups
    of ``width`` values (one 16-byte access: 4 f32, 8 16-bit; 1 where the
    pointers are not 16-byte aligned) when ``C % width == 0``, else of 1;
    up to 32 column groups a block and at most ``cols`` columns (a warp
    reads whole row segments), and enough row splits for about ``4 *
    sms`` blocks (one wave, no tail) while every thread keeps at least 8
    rows.  The stats kernel plans ``cols=STATS_COLS``: its last block of
    a column block combines that block's partials, and narrow blocks
    keep that tail short and spread it over more blocks."""
    if rows < 1 or c < 1:
        raise MXNetError(f"bn_act: empty input ({rows} rows, C={c})")
    vec = width if c % width == 0 else 1
    ncv = c // vec
    tx = 1
    while tx < min(ncv, 32, max(1, cols // vec)):
        tx *= 2
    col_blocks = -(-ncv // tx)
    most = max(1, rows // ((_NT // tx) * _MIN_ROWS_PER_THREAD))
    want = max(1, -(-_BLOCKS_PER_SM * sms // col_blocks))
    splits = min(want, most, 65535)
    rows_per_split = -(-rows // splits)
    return Plan(vec, tx, col_blocks, -(-rows // rows_per_split),
                rows_per_split)


def rows_view(x: torch.Tensor) -> torch.Tensor:
    """``x`` (..., C), channel-last, as ``(rows, C)``.  A tensor off the
    CPU must already lie in that order (contiguous): the view is free,
    and a hidden copy would add a full read and write per layer, so it
    raises instead.  A CPU tensor is reshaped (the plain versions take
    any strides)."""
    c = x.shape[-1]
    if x.device.type != "cpu" and not x.is_contiguous():
        raise MXNetError(f"bn_act: input of shape {tuple(x.shape)} and "
                         f"strides {x.stride()} is not a contiguous "
                         "channel-last (rows, C) view; refusing to copy")
    return x.reshape(-1, c)


# -------------------------------------------------------- plain versions
def bn_stats_plain(x2d: torch.Tensor, gamma: torch.Tensor,
                   beta: torch.Tensor, eps: float):
    """``(mean, var, scale, shift)`` of the columns of ``x2d``: the mean
    and the one-pass variance of the TPU kernel (module docstring),
    summed and combined in float64 as the kernel does (where a channel's
    variance is tiny beside its mean squared, f32 sums would cancel to
    noise), as f32; then the fold in f32, each operation rounded on its
    own as the kernel computes it: ``inv = rsqrt(var + eps)`` (correctly
    rounded: the square root taken in float64), ``scale = gamma * inv``,
    ``shift = beta - (mean * gamma) * inv``, scale and shift rounded to
    x's type."""
    n = x2d.shape[0]
    xd = x2d.double()
    mean = xd.sum(0) / n
    var = torch.clamp_min((xd * xd).sum(0) / n - mean * mean, 0.0)
    mean, var = mean.float(), var.float()
    inv = torch.rsqrt((var + eps).double()).float()
    g = gamma.float()
    dt = x2d.dtype
    return (mean, var, (g * inv).to(dt),
            (beta.float() - mean * g * inv).to(dt))


def bn_apply_plain(x2d: torch.Tensor, scale: torch.Tensor,
                   shift: torch.Tensor, act: str) -> torch.Tensor:
    """``x2d * scale + shift`` in x's type, then relu when ``act ==
    "relu"``.  f32 and bf16 round the product and then the sum (torch's
    own ``x * scale + shift``); f16 rounds the f32 sum once, as XLA on
    the CPU computes the JAX op."""
    if x2d.dtype == torch.float16:
        y = (x2d.float() * scale.float() + shift.float()).half()
    else:
        y = x2d * scale + shift
    return torch.relu(y) if act == "relu" else y


# ------------------------------------------------------- kernel wrappers
def _entry(symbol: str, argtypes):
    from . import _build

    fn = getattr(_build.load("bn_act.cu"), symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=256)
def _device_plan(rows: int, c: int, device_index: int, cols: int = 128,
                 width: int = 4) -> Plan:
    props = torch.cuda.get_device_properties(device_index)
    return plan(rows, c, props.multi_processor_count, cols, width)


def _width(dtype, *tensors) -> int:
    """Values of one 16-byte access (4 f32, 8 16-bit) when every pointer
    is 16-byte aligned, else 1."""
    if any(t.data_ptr() % 16 for t in tensors):
        return 1
    return 128 // torch.finfo(dtype).bits


def _check_act(act: str):
    if not supported_act(act):
        raise MXNetError(f"bn_act: activation {act!r} is not fused; the "
                         f"kernels take {list(_ACTS)}")


def _check_dev(op: str, x2d):
    if x2d.device.type != "cuda":
        raise MXNetError(f"{op}: no kernel for {x2d.device}")
    if x2d.ndim != 2:
        raise MXNetError(f"{op}: expected (rows, C), got {tuple(x2d.shape)}")


# (device index, stream) -> (tickets, partials): the stats kernel's
# workspace, kept so that a call allocates only its outputs.  Its tickets
# are zeroed once, and each launch leaves them at 0.  A hybridized block
# captures on a stream of its own, and its warm run there makes that
# stream's workspace before the capture, so no allocation or memset lands
# inside a graph; graphs of one block share it and replay in turn.  A
# larger shape replaces the workspace, and graphs captured over the old
# one still read and write its addresses: a replaced workspace is kept in
# _RETIRED for the life of the process, never freed.
_WORKSPACE = {}
_RETIRED = []


def _workspace(device, stream: int, col_blocks: int, nparts: int):
    key = (device.index, stream)
    ws = _WORKSPACE.get(key)
    if ws is None or ws[0].numel() < col_blocks or ws[1].numel() < nparts:
        old = (0, 0) if ws is None else (ws[0].numel(), ws[1].numel())
        if ws is not None:
            _RETIRED.append(ws)
        ws = (torch.zeros(max(col_blocks, old[0]), dtype=torch.int32,
                          device=device),
              torch.empty(max(nparts, old[1]), dtype=torch.float64,
                          device=device))
        _WORKSPACE[key] = ws
    return ws


def bn_stats(x2d: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
             eps: float):
    """Per-channel ``(mean, var, scale, shift)`` of ``(rows, C)`` with
    ``gamma`` and ``beta`` (C,) in x's type: mean and var f32, scale and
    shift in x's type (module docstring).  CUDA: one launch of
    ``csrc/bn_act.cu``'s stats kernel, the fold included, or raise; CPU:
    :func:`bn_stats_plain`."""
    if x2d.device.type == "cpu":
        return bn_stats_plain(x2d, gamma, beta, eps)
    _check_dev("bn_stats", x2d)
    name = _kernel_name("bn_act_stats", x2d.dtype)
    dt, (rows, c) = x2d.dtype, x2d.shape
    _kreg.check_tensors("bn_stats", x2d.device,
                        [("x", x2d, dt, (rows, c)),
                         ("gamma", gamma, dt, (c,)),
                         ("beta", beta, dt, (c,))], aligned=False)
    p = _device_plan(rows, c, x2d.device.index, STATS_COLS,
                     _width(dt, x2d))
    stream = torch.cuda.current_stream(x2d.device).cuda_stream
    ticket, part = _workspace(x2d.device, stream, p.col_blocks,
                              p.splits * 2 * c)
    ldo = -(-c // 8) * 8             # rows of out 16-byte aligned
    elt = x2d.element_size()
    # f32 mean and var, then scale and shift in x's type
    out = torch.empty(2 * ldo + ldo * elt // 2, dtype=torch.float32,
                      device=x2d.device)
    fn = _entry(f"mx_bn_stats_{_SFX[dt]}",
                [ctypes.c_void_p] * 3 + [ctypes.c_float, ctypes.c_longlong]
                + [ctypes.c_int] * 5 + [ctypes.c_longlong]
                + [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p])
    with torch.cuda.device(x2d.device):
        err = fn(x2d.data_ptr(), gamma.data_ptr(), beta.data_ptr(), eps,
                 rows, c, p.vec, p.tx, p.col_blocks, p.splits,
                 p.rows_per_split, part.data_ptr(), ticket.data_ptr(),
                 out.data_ptr(), ldo, stream)
    if err != 0:
        raise MXNetError(f"{name} kernel launch failed: CUDA error {err}")
    _kreg.count_launch(name)
    fold = out[2 * ldo:].view(dt)
    return out[:c], out[ldo:ldo + c], fold[:c], fold[ldo:ldo + c]


def bn_apply(x2d: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
             act: str) -> torch.Tensor:
    """``act(x2d * scale + shift)`` over ``(rows, C)`` with per-channel
    ``scale`` and ``shift`` (C,) in x's type.  CUDA: ``csrc/bn_act.cu``'s
    apply kernel into a new tensor, or raise; CPU:
    :func:`bn_apply_plain`."""
    _check_act(act)
    if x2d.device.type == "cpu":
        return bn_apply_plain(x2d, scale, shift, act)
    _check_dev("bn_apply", x2d)
    name = _kernel_name("bn_act_apply", x2d.dtype)
    dt, (rows, c) = x2d.dtype, x2d.shape
    y = torch.empty((rows, c), dtype=dt, device=x2d.device)
    _kreg.check_tensors("bn_apply", x2d.device,
                        [("x", x2d, dt, (rows, c)),
                         ("scale", scale, dt, (c,)),
                         ("shift", shift, dt, (c,))], aligned=False)
    p = _device_plan(rows, c, x2d.device.index, 128,
                     _width(dt, x2d, scale, shift))
    fn = _entry(f"mx_bn_apply_{_SFX[dt]}",
                [ctypes.c_void_p] * 4 + [ctypes.c_longlong] +
                [ctypes.c_int] * 6 + [ctypes.c_longlong, ctypes.c_void_p])
    with torch.cuda.device(x2d.device):
        err = fn(x2d.data_ptr(), scale.data_ptr(), shift.data_ptr(),
                 y.data_ptr(), rows, c, int(act == "relu"), p.vec, p.tx,
                 p.col_blocks, p.splits, p.rows_per_split,
                 torch.cuda.current_stream(x2d.device).cuda_stream)
    if err != 0:
        raise MXNetError(f"{name} kernel launch failed: CUDA error {err}")
    _kreg.count_launch(name)
    return y


# ------------------------------------------------------- the autograd op
class _BNAct(torch.autograd.Function):
    """Forward: one stats call (the fold included), one apply call.
    Backward: the analytic gradient in f32 (module docstring), saving
    ``x`` and ``y`` (the relu mask is ``y > 0``)."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps, act):
        x2d = rows_view(x)
        mean, var, scale, shift = bn_stats(x2d, gamma, beta, eps)
        y = bn_apply(x2d, scale, shift, act).view(x.shape)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, gamma, mean, var, y)
        ctx.eps, ctx.act = eps, act
        return y, mean, var

    @staticmethod
    def backward(ctx, gy, gmean, gvar):
        x, gamma, mean, var, y = ctx.saved_tensors
        c = x.shape[-1]
        x2d = x.reshape(-1, c)
        n = x2d.shape[0]
        inv = torch.rsqrt(var + ctx.eps)
        gy = x2d.new_zeros(x2d.shape, dtype=torch.float32) if gy is None \
            else gy.reshape(-1, c).float()
        if ctx.act == "relu":
            gy = gy * (y.reshape(-1, c) > 0)
        xc = x2d.float() - mean
        xhat = xc * inv
        dgamma = (gy * xhat).sum(0)
        dbeta = gy.sum(0)
        dx = (gamma.float() * inv) * (gy - dbeta / n - xhat * dgamma / n)
        if gmean is not None:
            dx = dx + gmean / n
        if gvar is not None:
            dx = dx + gvar * 2.0 * xc / n
        need = ctx.needs_input_grad
        return (dx.to(x.dtype).view(x.shape) if need[0] else None,
                dgamma.to(gamma.dtype) if need[1] else None,
                dbeta.to(gamma.dtype) if need[2] else None, None, None)


def bn_act_train(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                 eps: float, act: str):
    """Training-mode BN + activation on channel-LAST ``x`` (f32, bf16 or
    f16, with ``gamma`` / ``beta`` in its type on the card): ``(y, mean,
    var)``, ``y`` in x's type and the batch statistics (C,) in f32; the
    caller blends the running statistics, as ``ops.nn.batch_norm_train``
    does."""
    _check_act(act)
    return _BNAct.apply(x, gamma, beta, float(eps), act)
