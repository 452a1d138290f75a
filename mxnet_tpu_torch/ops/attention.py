"""Fused attention, decode-mode attention against a KV cache, and the
cache primitives.

The port of ``mxnet_tpu/ops/attention.py``.  Every function works on
``(B, H, T, d)`` tensors, the JAX package's layout.

``flash_attention`` and ``flash_attention_decode`` dispatch by device:
CUDA tensors launch the hand-written Hopper kernel
(``csrc/flash_attention.cu``, ``csrc/decode_attention.cu``) or raise; CPU
tensors run the kernel's plain version (:func:`flash_attention_reference`,
:func:`flash_attention_decode_reference`).  Nothing falls back from the
card to the plain version.  The one route that never reaches a kernel is
``flash_attention`` with a general boolean ``mask``, which runs
:func:`attention_reference` on any device, as the JAX package routes it.

When q, k or v requires grad, ``flash_attention`` runs through
:class:`FlashAttentionFunction`, the port of the JAX package's
``_flash`` custom VJP: its forward launches the forward kernel with the
row lse and saves it, its backward launches the dq and dk/dv kernels
(``kernels/flash_bwd.py``; their plain versions on the CPU).
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import numpy as np
import torch

from ..base import MXNetError
from ..kernels import flash_bwd as _fbwd
from ..kernels import registry as _kreg

__all__ = ["attention_reference", "flash_attention", "flash_attention_reference",
           "FlashAttentionFunction", "flash_attention_decode",
           "flash_attention_decode_reference", "decode_mask", "cache_append",
           "cache_page_copy", "quantize_kv", "dequantize_kv", "split_plan",
           "decode_kernel_name", "SPLIT_TQ"]

_NEG_INF = float("-inf")
_HALF = _fbwd._HALF       # bf16 and f16 take the 16-bit kernels

# The decode kernel's split-K path takes Tq <= SPLIT_TQ query rows and
# d <= 256; longer chunks and wider heads run its tensor-core chunk path.
SPLIT_TQ = 8
_SPLIT_MIN = 128      # positions a split holds at least, and their multiple
_SPLIT_WAVES = 3      # blocks aimed at, in multiples of the card's SMs
_SPLIT_MAX = 8        # splits at most (a portable cluster's blocks)


def attention_reference(q, k, v, mask=None, scale: Optional[float] = None):
    """Plain softmax attention on (B, H, T, D).  ``mask`` is boolean,
    broadcastable to (B, H, Tq, Tk): True = attend.  Fully masked rows
    give zeros, not NaN."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * scale
    if mask is not None:
        logits = logits.masked_fill(~mask, _NEG_INF)
    w = torch.softmax(logits, dim=-1)
    if mask is not None:
        w = torch.where(torch.isfinite(logits).any(-1, keepdim=True), w,
                        torch.zeros((), dtype=w.dtype, device=w.device))
    return torch.einsum("bhqk,bhkd->bhqd", w.to(v.dtype), v)


def _merge_mask(mask, kv_len, tq: int, tk: int, causal: bool, device):
    """Combine a boolean ``mask``, (B,) ``kv_len`` and the causal flag into
    one boolean mask broadcastable to (B, H, Tq, Tk), or None."""
    m = mask
    if kv_len is not None:
        lens = torch.as_tensor(kv_len, device=device)
        lm = (torch.arange(tk, device=device)[None, :]
              < lens[:, None])[:, None, None, :]
        m = lm if m is None else m & lm
    if causal:
        cm = torch.ones(tq, tk, dtype=torch.bool, device=device).tril()
        cm = cm[None, None]
        m = cm if m is None else m & cm
    return m


def flash_attention_reference(q, k, v, mask=None, causal: bool = False,
                              scale: Optional[float] = None,
                              kv_valid_length=None, return_lse: bool = False):
    """The flash kernel's plain version: the mask, ``kv_valid_length`` and
    ``causal`` merged into one boolean mask, then
    :func:`attention_reference` (f32), or for bf16 / f16 inputs the TPU
    kernel's roundings (:func:`_flash16_reference`).  With ``return_lse``
    also the (B, H, Tq) f32 row log-sum-exp (-inf for a row with nothing
    to attend)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    m = _merge_mask(mask, kv_valid_length, q.shape[2], k.shape[2], causal,
                    q.device)
    if q.dtype in _HALF:
        out, lse = _flash16_reference(q, k, v, m, scale)
        return (out, lse) if return_lse else out
    out = attention_reference(q, k, v, mask=m, scale=scale)
    if not return_lse:
        return out
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * scale
    if m is not None:
        logits = logits.masked_fill(~m, _NEG_INF)
    return out, torch.logsumexp(logits, dim=-1)


def _flash16_reference(q, k, v, m, scale: float):
    """``(out, lse)`` as the TPU kernels compute them where q, k or v is
    16-bit (``mxnet_tpu/ops/attention.py`` ``_flash_kernel`` and
    ``_decode_kernel``; the types may differ, as decode's do): S in f32
    from upcast q and k; ``p = exp(s - max)`` rounded to v's type for P V
    (kept f32 for an f32 v), the products summed in f32; ``l`` summed from
    the f32 p; ``out = acc / l`` rounded to q's type once; the lse f32.
    The row max here is over every key at once where the kernels take a
    running max over key tiles, so each rounded p may differ by one 16-bit
    ulp from theirs."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if m is not None:
        s = s.masked_fill(~m, _NEG_INF)
    mx = s.amax(-1, keepdim=True)
    safe = torch.where(torch.isfinite(mx), mx, torch.zeros_like(mx))
    p = torch.where(torch.isfinite(s), torch.exp(s - safe),
                    torch.zeros((), dtype=s.dtype, device=s.device))
    l = p.sum(-1, keepdim=True)
    acc = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    out = (acc / torch.where(l == 0, torch.ones_like(l), l)).to(q.dtype)
    lse = (safe + torch.log(torch.where(l == 0, torch.ones_like(l), l)))
    lse = torch.where(l == 0, torch.full_like(l, _NEG_INF), lse)
    return out, lse[..., 0]


def _check_flash_args(q, k, v, kv_len):
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise MXNetError("flash_attention takes (B, H, T, d) q, k and v; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, tq, d = q.shape
    tk = k.shape[2]
    if not (d >= 1 and tk >= 1):
        raise MXNetError(
            f"flash_attention kernel takes d >= 1 and Tk >= 1; got d={d}, "
            f"Tk={tk}")
    dt = q.dtype
    if dt != torch.float32 and dt not in _HALF:
        raise MXNetError(f"flash_attention kernels take float32, bfloat16 "
                         f"or float16; got {dt}")
    want = [("q", q, dt, (b, h, tq, d)),
            ("k", k, dt, (b, h, tk, d)),
            ("v", v, dt, (b, h, tk, d))]
    if kv_len is not None:
        want.append(("kv_valid_length", kv_len, torch.int32, (b,)))
    _kreg.check_tensors("flash_attention", q.device, want, aligned=False)


def _launch_flash(q, k, v, kv_len, causal, scale, return_lse):
    from ..kernels import _build

    _check_flash_args(q, k, v, kv_len)
    b, h, tq, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device) \
        if return_lse else None
    if out.numel() == 0:                      # nothing to launch
        return (out, lse) if return_lse else out
    suffix = _HALF.get(q.dtype, "f32")
    fn = getattr(_build.load("flash_attention.cu"),
                 f"mx_flash_attention_{suffix}")
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + \
            [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 kv_len.data_ptr() if kv_len is not None else None,
                 out.data_ptr(), lse.data_ptr() if lse is not None else None,
                 b, h, tq, k.shape[2], d, int(causal), scale,
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise MXNetError(f"flash_attention kernel launch failed: CUDA error "
                         f"{err}")
    _kreg.count_launch(_fbwd._name("flash_attention", q.dtype))
    return (out, lse) if return_lse else out


def _flash_forward(q, k, v, kv_len, causal: bool, scale: float,
                   return_lse: bool):
    """The forward on the kernel (CUDA) or its plain version (CPU)."""
    if q.device.type == "cuda":
        if kv_len is not None:
            kv_len = torch.as_tensor(kv_len, device=q.device).to(
                torch.int32).contiguous()
        return _launch_flash(q, k, v, kv_len, causal, scale, return_lse)
    if q.device.type != "cpu":
        raise MXNetError(f"flash_attention: no kernel for {q.device}")
    return flash_attention_reference(q, k, v, causal=causal, scale=scale,
                                     kv_valid_length=kv_len,
                                     return_lse=return_lse)


class FlashAttentionFunction(torch.autograd.Function):
    """Flash attention with its gradient: the port of the JAX package's
    ``_flash`` custom VJP (``_flash_fwd`` / ``_flash_bwd``).

    ``apply(q, k, v, kv_len, causal, scale, return_lse)``.  The forward
    runs the forward kernel with the row lse and saves ``(q, k, v,
    kv_len, out, lse)``; the backward runs the dq and dk/dv kernels on
    the saved lse (:func:`~mxnet_tpu_torch.kernels.flash_bwd.
    flash_attention_bwd`).  With ``return_lse`` the lse is returned as a
    second output that carries no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, kv_len, causal, scale, return_lse):
        if kv_len is not None:            # saved for the backward
            kv_len = torch.as_tensor(kv_len, device=q.device).to(
                torch.int32).contiguous()
        out, lse = _flash_forward(q, k, v, kv_len, causal, scale, True)
        ctx.save_for_backward(q, k, v, kv_len, out, lse)
        ctx.causal, ctx.scale = causal, scale
        if not return_lse:
            return out
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, g, *_lse_grad):
        q, k, v, kv_len, out, lse = ctx.saved_tensors
        dq, dk, dv = _fbwd.flash_attention_bwd(
            q, k, v, g.contiguous(), out, lse, kv_len, ctx.causal, ctx.scale)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, mask=None, causal: bool = False,
                    scale: Optional[float] = None, kv_valid_length=None,
                    return_lse: bool = False):
    """Fused multi-head attention on (B, H, T, d) tensors.

    mask: optional boolean, broadcastable to (B, H, Tq, Tk); True = attend.
        A general mask never reaches the kernel: it runs
        :func:`attention_reference` on any device, as the JAX package
        routes it.  The batch-serving path never passes one.
    kv_valid_length: optional (B,) int key lengths; key positions >= the
        row's length are masked (and never read by the kernel, so they
        may hold anything).  A row of length 0 gives output 0.
    causal: query position ``i`` attends key positions ``<= i``.
    scale: logit scale; defaults to ``1/sqrt(d)``.
    return_lse: also return the (B, H, Tq) f32 row log-sum-exp (-inf for
        a row with nothing to attend).

    Without ``mask``, CUDA tensors launch the hand-written kernel
    (``csrc/flash_attention.cu``: f32, bf16 or f16 q, k and v of one
    type, each type its own kernel; contiguous, any Tq and Tk >= 1, any
    d >= 1) or raise; CPU tensors run
    :func:`flash_attention_reference`.  When q, k or v requires grad the
    call goes through :class:`FlashAttentionFunction`, whose backward is
    the dq and dk/dv kernel pair."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if mask is not None:
        return flash_attention_reference(
            q, k, v, mask=mask.to(torch.bool), causal=causal, scale=scale,
            kv_valid_length=kv_valid_length, return_lse=return_lse)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFunction.apply(q, k, v, kv_valid_length,
                                            bool(causal), float(scale),
                                            return_lse)
    return _flash_forward(q, k, v, kv_valid_length, bool(causal),
                          float(scale), return_lse)


def decode_mask(cache_len, tq: int, tk: int):
    """(B, 1, Tq, Tk) boolean chunk-causal cache mask: local query ``i``
    (at global position ``cache_len + i``) attends cache positions
    ``<= cache_len + i``."""
    qidx = torch.arange(tq, dtype=torch.int32, device=cache_len.device)
    kpos = torch.arange(tk, dtype=torch.int32, device=cache_len.device)
    m = kpos[None, None, :] <= (cache_len.to(torch.int32)[:, None, None]
                                + qidx[None, :, None])
    return m[:, None]


def cache_append(cache, new, lengths):
    """Write ``new`` (B, H, T, d) into the fixed-capacity cache
    (B, H, C, d) at each row's offset ``lengths`` (B,):
    ``cache[b, :, lengths[b]:lengths[b]+T] = new[b]``.

    Updates ``cache`` IN PLACE and returns it: this takes the place of
    the JAX package's buffer donation, so a decode step never holds an
    old and a new cache at once.  ``lengths`` as a tensor stays where it
    is: one scatter at ``lengths[:, None] + arange(T)``, with the start
    clamped into ``[0, C - T]`` as the JAX ``dynamic_update_slice``
    clamps it, and no read back to the host (so a CUDA graph can hold
    it); grow the cache to the next capacity bucket before a window
    would pass it.  ``lengths`` given on the host (a list or a numpy
    array) is checked first: a window past the capacity raises."""
    b, t, cap = cache.shape[0], new.shape[2], cache.shape[2]
    if not torch.is_tensor(lengths):
        lens = [int(x) for x in np.asarray(lengths).reshape(-1)]
        if len(lens) != b:
            raise MXNetError(f"cache_append: {len(lens)} lengths for {b} "
                             "cache rows")
        if any(x < 0 or x + t > cap for x in lens):
            raise MXNetError(f"cache_append: window of {t} at offsets "
                             f"{lens} passes capacity {cap}; grow the cache "
                             "first")
        lengths = torch.tensor(lens, device=cache.device)
    start = lengths.to(device=cache.device, dtype=torch.long).reshape(-1)
    if start.shape[0] != b:
        raise MXNetError(f"cache_append: {start.shape[0]} lengths for {b} "
                         "cache rows")
    start = start.clamp(0, max(cap - t, 0))
    # one scatter for all rows: cache[r, :, start[r] + i] = new[r, :, i]
    pos = start[:, None] + torch.arange(t, device=cache.device)
    rows = torch.arange(b, device=cache.device)[:, None]
    cache[rows, :, pos] = new.to(cache.dtype).transpose(1, 2)
    return cache


def quantize_kv(x):
    """Symmetric per-position int8 quantization: ``x`` (B, H, T, dh) ->
    ``(q int8 (B, H, T, dh), scale f32 (B, H, T, 1))`` with
    ``scale = amax / 127`` (``1/127`` for an all-zero row) and
    round-half-to-even, as the JAX package rounds.  Quantize BEFORE
    :func:`cache_append`: a raw float->int8 cast truncates."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax > 0.0, amax / 127.0,
                        torch.full_like(amax, 1.0 / 127.0))
    q = torch.clamp(torch.round(xf / scale), -127.0, 127.0).to(torch.int8)
    return q, scale


def dequantize_kv(q, scale, dtype=torch.float32):
    """Inverse of :func:`quantize_kv`: ``q.float() * scale`` in ``dtype``."""
    return (q.float() * scale).to(dtype)


def cache_page_copy(dst, src, n_pages: int, *, src_start: int = 0,
                    dst_start: int = 0, dst_row=0):
    """Copy ``n_pages`` consecutive capacity-axis rows of ``src``
    (B_s, H, C_s, dh), from ``src_start``, into ``dst`` (B_d, H, C_d, dh)
    at row ``dst_row`` and position ``dst_start``.

    Updates ``dst`` IN PLACE and returns it, in place of the JAX
    package's donated ``dynamic_update_slice``.  ``dst_row`` may be a
    tensor on ``dst``'s device (the JAX op's traced slot): it is not read
    back, and is clamped into ``[0, B_d - B_s]`` as the JAX op clamps it,
    so one CUDA graph serves every slot.  A window that does not fit
    either tensor raises."""
    if dst.ndim != 4 or src.ndim != 4:
        raise ValueError(
            f"cache_page_copy moves (B, H, C, dh) page layouts, got "
            f"dst.ndim={dst.ndim}, src.ndim={src.ndim}")
    n = int(n_pages)
    bs = src.shape[0]
    row_ok = torch.is_tensor(dst_row) or \
        (0 <= dst_row and dst_row + bs <= dst.shape[0])
    if (src_start < 0 or src_start + n > src.shape[2] or dst_start < 0
            or dst_start + n > dst.shape[2] or bs > dst.shape[0]
            or not row_ok):
        raise MXNetError(
            f"cache_page_copy window (rows {dst_row}+{bs}, pages {n} from "
            f"{src_start} to {dst_start}) does not fit src {tuple(src.shape)} "
            f"/ dst {tuple(dst.shape)}")
    pages = src[:, :, src_start:src_start + n].to(dst.dtype)
    if not torch.is_tensor(dst_row):
        dst[dst_row:dst_row + bs, :, dst_start:dst_start + n] = pages
        return dst
    row = dst_row.to(device=dst.device, dtype=torch.long).reshape(-1)[:1]
    rows = row.clamp(0, dst.shape[0] - bs) + \
        torch.arange(bs, device=dst.device)
    dst[:, :, dst_start:dst_start + n].index_copy_(0, rows, pages)
    return dst


def flash_attention_decode_reference(q, k, v, cache_len,
                                     scale: Optional[float] = None,
                                     return_lse: bool = False,
                                     k_scale=None, v_scale=None):
    """The decode kernel's plain version: attention with the chunk-causal
    mask materialized, an int8 cache dequantized to f32 first.  f32
    queries over an f32 or int8 cache run masked softmax attention in f32;
    any pair with a 16-bit side runs the TPU kernel's roundings
    (:func:`_flash16_reference`): q and k widened to f32, P rounded to v's
    type for a 16-bit cache, the output in q's type, the lse f32."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if k_scale is not None:
        k = dequantize_kv(k, k_scale)
        v = dequantize_kv(v, v_scale)
    m = decode_mask(torch.as_tensor(cache_len, device=q.device),
                    q.shape[2], k.shape[2])
    if q.dtype in _HALF or k.dtype in _HALF:
        out, lse = _flash16_reference(q, k, v, m, scale)
        return (out, lse) if return_lse else out
    out = attention_reference(q, k, v, mask=m, scale=scale)
    if return_lse:
        logits = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * scale
        logits = logits.masked_fill(~m, _NEG_INF)
        return out, torch.logsumexp(logits, dim=-1)
    return out


_DECODE_TYPES = {torch.float32: "f32", torch.bfloat16: "bf16",
                 torch.float16: "f16", torch.int8: "int8"}


def decode_kernel_name(q_dtype, kv_dtype) -> str:
    """The registry name of the decode kernel for ``q_dtype`` queries
    (f32, bf16, f16) over a cache of ``kv_dtype`` (f32, bf16, f16, or
    ``torch.int8`` for a quantized cache): ``flash_attention_decode`` and
    ``flash_attention_decode_int8`` for f32 queries over f32 and int8,
    ``flash_attention_decode.<q>_<cache>`` (``.bf16_bf16``, ``.f32_f16``,
    ...) for the other ten pairs."""
    qn, kn = _DECODE_TYPES.get(q_dtype), _DECODE_TYPES.get(kv_dtype)
    if qn in (None, "int8") or kn is None:
        raise MXNetError(f"flash_attention_decode kernels take f32, bf16 or "
                         f"f16 queries over an f32, bf16, f16 or int8 cache; "
                         f"got {q_dtype} over {kv_dtype}")
    if qn == "f32" and kn in ("f32", "int8"):
        return "flash_attention_decode" + ("_int8" if kn == "int8" else "")
    return f"flash_attention_decode.{qn}_{kn}"


def _has_chunk_path(q_dtype, kv_dtype) -> bool:
    """Whether the pair runs Tq > ``SPLIT_TQ`` (and d > 256) on the
    tensor-core forward core: one float type on both sides, or f32
    queries over int8.  Mixed pairs run split-K in query groups."""
    return q_dtype == kv_dtype or (q_dtype == torch.float32
                                   and kv_dtype == torch.int8)


def _check_cuda_args(q, k, v, cache_len, k_scale, v_scale):
    b, h, tq, d = q.shape
    c = k.shape[2]
    if not (d >= 1 and c >= 1):
        raise MXNetError(
            f"flash_attention_decode kernel takes d >= 1 and C >= 1; got "
            f"d={d}, C={c}")
    quant = k_scale is not None
    kv_dtype = torch.int8 if quant else k.dtype
    decode_kernel_name(q.dtype, kv_dtype)          # raises for other types
    if not _has_chunk_path(q.dtype, kv_dtype) and d > 256:
        raise MXNetError(
            f"flash_attention_decode: {q.dtype} queries over a {kv_dtype} "
            f"cache take d <= 256 (their chunks run split-K); got d={d}")
    want = [("q", q, q.dtype, (b, h, tq, d)),
            ("k", k, kv_dtype, (b, h, c, d)),
            ("v", v, kv_dtype, (b, h, c, d)),
            ("cache_len", cache_len, torch.int32, (b,))]
    if quant:
        want += [("k_scale", k_scale, torch.float32, (b, h, c, 1)),
                 ("v_scale", v_scale, torch.float32, (b, h, c, 1))]
    _kreg.check_tensors("flash_attention_decode", q.device, want,
                        aligned=False)


def split_plan(bh: int, tq: int, c: int, d: int, sms: int,
               grouped: bool = False):
    """``(L, S)``: the decode kernel's split of a cache of capacity ``c``
    into ``S`` splits of ``L`` positions for ``bh`` = B * H heads on a card
    of ``sms`` SMs, or ``(0, 0)`` for the tensor-core chunk path (Tq >
    ``SPLIT_TQ`` or d > 256).  With ``grouped`` (a mixed pair, which has
    no chunk path) a longer chunk splits too, its blocks one a group of
    ``SPLIT_TQ`` query rows.  Enough splits that the blocks cover the SMs
    ``_SPLIT_WAVES`` times (at most ``_SPLIT_MAX``), each a multiple of
    ``_SPLIT_MIN`` positions; the lengths live on the card, so the plan
    reads only shapes and a split past a row's length does no work."""
    if d > 256 or (tq > SPLIT_TQ and not grouped):
        return 0, 0
    bh *= -(-tq // SPLIT_TQ)
    want = min(_SPLIT_MAX, max(1, -(-(_SPLIT_WAVES * sms) // max(1, bh))))
    length = max(_SPLIT_MIN, -(-c // want))
    length = -(-length // _SPLIT_MIN) * _SPLIT_MIN
    return length, -(-c // length)


_SMS = {}


def _sm_count(device) -> int:
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def _entry(q_dtype, kv_dtype):
    """The C entry ``mx_decode_attention_<q>_<cache>`` of the pair's
    source (``csrc/decode_attention.cu`` for f32 queries,
    ``decode_attention_bf16.cu`` / ``_f16.cu`` for 16-bit ones) with its
    argtypes set: q, k, k_scale, v, v_scale, cache_len, out, lse, then
    B, H, Tq, C, d, L, S, scale, stream (every pointer and the stream as
    ``c_void_p``)."""
    from ..kernels import _build

    qn, kn = _DECODE_TYPES[q_dtype], _DECODE_TYPES[kv_dtype]
    src = "decode_attention.cu" if qn == "f32" else \
        f"decode_attention_{qn}.cu"
    fn = getattr(_build.load(src), f"mx_decode_attention_{qn}_{kn}")
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + \
            [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _launch_cuda(q, k, v, cache_len, scale, return_lse, k_scale, v_scale,
                 plan=None):
    """One call of the decode kernel on CUDA tensors; ``plan`` overrides
    :func:`split_plan`'s ``(L, S)`` (``(0, 0)``: the chunk path)."""
    _check_cuda_args(q, k, v, cache_len, k_scale, v_scale)
    b, h, tq, d = q.shape
    c = k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device) \
        if return_lse else None
    if out.numel() == 0:                      # nothing to launch
        return (out, lse) if return_lse else out
    kv_dtype = torch.int8 if k_scale is not None else k.dtype
    length, splits = plan if plan is not None else \
        split_plan(b * h, tq, c, d, _sm_count(q.device),
                   grouped=not _has_chunk_path(q.dtype, kv_dtype))
    with torch.cuda.device(q.device):
        tail = (b, h, tq, c, d, length, splits, scale,
                torch.cuda.current_stream(q.device).cuda_stream)
        scales = (k_scale.data_ptr(), v_scale.data_ptr()) \
            if k_scale is not None else (None, None)
        err = _entry(q.dtype, kv_dtype)(
            q.data_ptr(), k.data_ptr(), scales[0], v.data_ptr(), scales[1],
            cache_len.data_ptr(), out.data_ptr(),
            lse.data_ptr() if lse is not None else None, *tail)
    name = decode_kernel_name(q.dtype, kv_dtype)
    if err != 0:
        raise MXNetError(f"{name} kernel launch failed: CUDA error {err}")
    _kreg.count_launch(name)
    return (out, lse) if return_lse else out


def flash_attention_decode(q, k, v, cache_len, scale: Optional[float] = None,
                           return_lse: bool = False, k_scale=None,
                           v_scale=None):
    """Decode-mode attention: ``Tq`` freshly appended queries against a
    fixed-capacity KV cache.

    q: (B, H, Tq, d); k/v: (B, H, C, d) caches that ALREADY hold the
        chunk's own keys/values (:func:`cache_append` first).
    cache_len: (B,) int — valid entries BEFORE the chunk was appended.
        Query ``i`` attends cache positions ``<= cache_len + i``; rows past
        that are never read, so they may hold anything.
    return_lse: also return the (B, H, Tq) f32 row log-sum-exp.
    k_scale/v_scale: per-position f32 scales (B, H, C, 1) of an int8 cache
        (:func:`quantize_kv`); the kernel dequantizes per loaded tile, so
        the cache stays int8 on the card.  Pass both or neither.

    q is f32, bf16 or f16 and the cache f32, bf16, f16 (k and v of one
    type) or int8 with its scales: twelve pairs, each its own kernel, the
    output in q's type (the TPU kernel's numerics: scores in f32, P
    rounded to v's type for a 16-bit cache).  CUDA tensors launch the
    hand-written kernel (:func:`decode_kernel_name`; contiguous inputs,
    any Tq, C and d >= 1, d <= 256 where q's type is not the cache's:
    split-K over the cache for Tq <= ``SPLIT_TQ`` and d <= 256, the
    tensor-core chunk path otherwise) or raise; CPU tensors run
    :func:`flash_attention_decode_reference`."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("flash_attention_decode: pass both k_scale and "
                         "v_scale (quantized cache) or neither")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cuda":
        return _launch_cuda(q, k, v, cache_len, float(scale), return_lse,
                            k_scale, v_scale)
    if q.device.type != "cpu":
        raise MXNetError(f"flash_attention_decode: no kernel for {q.device}")
    return flash_attention_decode_reference(q, k, v, cache_len, scale,
                                            return_lse, k_scale, v_scale)
