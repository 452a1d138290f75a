"""Flash-attention backward: the dq kernel and the dk/dv kernel.

The port of ``mxnet_tpu/kernels/flash_bwd.py``.  From the forward's
output ``out`` and row log-sum-exp ``lse`` (B, H, Tq):

    delta_i = sum(g_i * out_i)
    p_ij  = exp(s_ij - lse_i),   s_ij = scale * q_i . k_j
    ds    = p * (g v^T - delta)
    dq_i  = scale * sum_j ds_ij k_j            (dq kernel)
    dk_j  = scale * sum_i ds_ij q_i            (dk/dv kernel)
    dv_j  = sum_i p_ij g_i

with the forward's masks (per-row ``kv_len``, ``causal``).  CUDA tensors
launch the two hand-written kernels of ``csrc/flash_attention_bwd.cu``
(contiguous, any Tq and Tk >= 1, any d >= 1; products on tensor cores,
no global TF32 flag) or raise: the dq kernel computes delta in its
prologue and hands it to the dk/dv kernel.  f32 inputs take the 3xTF32
kernels; bf16 and f16 inputs (q, k, v, g and out of one type, lse f32)
take 16-bit kernels of their own, which write dq, dk and dv in that type.
Where every key of a head fits one block of the 16-bit dk/dv kernel
(Tk <= ``FUSED_TK`` and d <= ``FUSED_D``: BERT's training shape) that
kernel runs alone in its fused mode, one launch for dq, dk and dv.
CPU tensors run :func:`flash_attention_bwd_reference`, which
materializes the score matrix.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from ..base import MXNetError
from . import registry as _kreg

__all__ = ["flash_attention_bwd", "flash_attention_bwd_reference",
           "launch_dq", "launch_dkv", "launch_fused", "fused"]

# bf16 and f16 take the 16-bit kernels (here and in ops.attention's
# forward): their C entries' suffix and launch counts' name
_HALF = {torch.bfloat16: "bf16", torch.float16: "f16"}


# the 16-bit dk/dv kernel's fused mode: one block owns a head's keys
FUSED_TK, FUSED_D = 128, 64


def fused(q, k) -> bool:
    """Whether :func:`flash_attention_bwd` runs the fused mode (one launch
    of the dk/dv kernel) for these inputs rather than dq, then dk/dv."""
    return q.dtype in _HALF and k.shape[2] <= FUSED_TK and \
        q.shape[3] <= FUSED_D


def _name(kernel: str, dtype) -> str:
    """``kernel``'s launch-count name for inputs of ``dtype``."""
    return kernel if dtype == torch.float32 else f"{kernel}.{_HALF[dtype]}"


def flash_attention_bwd_reference(q, k, v, g, out, lse, kv_len=None,
                                  causal: bool = False,
                                  scale: Optional[float] = None):
    """The kernels' plain version: ``(dq, dk, dv)`` from the materialized
    (B, H, Tq, Tk) score matrix, by the formulas of the module docstring.
    A masked entry of p and ds is 0 by selection, so a row with nothing
    to attend (lse = -inf) gives zeros, not NaN.  Every operand is cast to
    f32 and the gradients back to the inputs' types at the end, as the
    TPU kernels do (``mxnet_tpu/kernels/flash_bwd.py``)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    from ..ops.attention import _merge_mask

    dts = (q.dtype, k.dtype, v.dtype)
    q, k, v, g, out = (t.float() for t in (q, k, v, g, out))
    live = _merge_mask(None, kv_len, q.shape[2], k.shape[2], causal,
                       q.device)
    if live is None:
        live = torch.ones((), dtype=torch.bool, device=q.device)
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    lse_safe = torch.where(torch.isfinite(lse), lse, torch.zeros_like(lse))
    zero = torch.zeros((), dtype=s.dtype, device=s.device)
    p = torch.where(live, torch.exp(s - lse_safe[..., None]), zero)
    dp = torch.einsum("bhqd,bhkd->bhqk", g, v)
    delta = (g * out).sum(-1)
    ds = torch.where(live, p * (dp - delta[..., None]), zero)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", p, g)
    return dq.to(dts[0]), dk.to(dts[1]), dv.to(dts[2])


def _check_args(q, k, v, g, out, lse, kv_len):
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise MXNetError("flash_attention_bwd takes (B, H, T, d) q, k, v; "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, tq, d = q.shape
    tk = k.shape[2]
    if not (d >= 1 and tk >= 1):
        raise MXNetError(
            f"flash_attention_bwd kernels take d >= 1 and Tk >= 1; got "
            f"d={d}, Tk={tk}")
    dt = q.dtype
    if dt != torch.float32 and dt not in _HALF:
        raise MXNetError(f"flash_attention_bwd kernels take float32, "
                         f"bfloat16 or float16; got {dt}")
    want = [("q", q, dt, (b, h, tq, d)),
            ("k", k, dt, (b, h, tk, d)),
            ("v", v, dt, (b, h, tk, d)),
            ("g", g, dt, (b, h, tq, d)),
            ("out", out, dt, (b, h, tq, d)),
            ("lse", lse, torch.float32, (b, h, tq))]
    if kv_len is not None:
        want.append(("kv_len", kv_len, torch.int32, (b,)))
    _kreg.check_tensors("flash_attention_bwd", q.device, want,
                        aligned=False)


def _entry(symbol: str, n_ptr: int):
    from . import _build

    fn = getattr(_build.load("flash_attention_bwd.cu"), symbol)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 6 + \
            [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def launch_dq(q, k, v, g, out, lse, kv_len, causal: bool, scale: float):
    """One launch of the dq kernel on checked CUDA inputs; returns
    ``(dq, delta)``, delta the (B, H, Tq) f32 row sums of ``g * out``
    that the kernel computes and :func:`launch_dkv` takes."""
    b, h, tq, d = q.shape
    dq = torch.empty_like(q)
    delta = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = _entry(f"mx_flash_attention_bwd_dq_{_HALF.get(q.dtype, 'f32')}",
                     9)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            out.data_ptr(), lse.data_ptr(),
            kv_len.data_ptr() if kv_len is not None else None, dq.data_ptr(),
            delta.data_ptr(), b, h, tq, k.shape[2], d, int(causal), scale,
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise MXNetError(f"flash_attention_bwd_dq kernel launch failed: "
                         f"CUDA error {err}")
    _kreg.count_launch(_name("flash_attention_bwd_dq", q.dtype))
    return dq, delta


def launch_dkv(q, k, v, g, lse, delta, kv_len, causal: bool, scale: float):
    """One launch of the dk/dv kernel on checked CUDA inputs and the dq
    kernel's ``delta``; returns ``(dk, dv)``."""
    b, h, tq, d = q.shape
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    with torch.cuda.device(q.device):
        err = _entry(
            f"mx_flash_attention_bwd_dkv_{_HALF.get(q.dtype, 'f32')}", 9)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            lse.data_ptr(), delta.data_ptr(),
            kv_len.data_ptr() if kv_len is not None else None, dk.data_ptr(),
            dv.data_ptr(), b, h, tq, k.shape[2], d, int(causal), scale,
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise MXNetError(f"flash_attention_bwd_dkv kernel launch failed: "
                         f"CUDA error {err}")
    _kreg.count_launch(_name("flash_attention_bwd_dkv", q.dtype))
    return dk, dv


def launch_fused(q, k, v, g, out, lse, kv_len, causal: bool, scale: float):
    """One launch of the 16-bit dk/dv kernel in its fused mode on checked
    CUDA inputs with :func:`fused` true (delta formed in the block, dq
    written whole by the block that owns the head's keys); returns
    ``(dq, dk, dv)`` and counts a launch of the dk/dv kernel."""
    b, h, tq, d = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        err = _entry(f"mx_flash_attention_bwd_fused_{_HALF[q.dtype]}", 10)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            out.data_ptr(), lse.data_ptr(),
            kv_len.data_ptr() if kv_len is not None else None, dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), b, h, tq, k.shape[2], d,
            int(causal), scale, torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise MXNetError(f"flash_attention_bwd_dkv kernel (fused) launch "
                         f"failed: CUDA error {err}")
    _kreg.count_launch(_name("flash_attention_bwd_dkv", q.dtype))
    return dq, dk, dv


def _launch(q, k, v, g, out, lse, kv_len, causal, scale):
    _check_args(q, k, v, g, out, lse, kv_len)
    b, h, tq, _ = q.shape
    if b * h == 0 or tq == 0:                 # nothing attends: no launch
        return (torch.empty_like(q), torch.zeros_like(k),
                torch.zeros_like(v))
    if fused(q, k):
        return launch_fused(q, k, v, g, out, lse, kv_len, causal, scale)
    dq, delta = launch_dq(q, k, v, g, out, lse, kv_len, causal, scale)
    dk, dv = launch_dkv(q, k, v, g, lse, delta, kv_len, causal, scale)
    return dq, dk, dv


def flash_attention_bwd(q, k, v, g, out, lse, kv_len=None,
                        causal: bool = False, scale: Optional[float] = None):
    """``(dq, dk, dv)`` of flash attention for the output gradient ``g``,
    from the forward's ``out`` and row ``lse`` (B, H, Tq) f32.  ``kv_len``
    is the forward's optional (B,) key lengths.

    CUDA tensors launch the dq kernel, then the dk/dv kernel (one launch
    each; 16-bit inputs with :func:`fused` true: the dk/dv kernel alone)
    or raise; CPU tensors run :func:`flash_attention_bwd_reference`."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cuda":
        if kv_len is not None:
            kv_len = torch.as_tensor(kv_len, device=q.device).to(
                torch.int32).contiguous()
        return _launch(q, k, v, g, out, lse, kv_len, bool(causal),
                       float(scale))
    if q.device.type != "cpu":
        raise MXNetError(f"flash_attention_bwd: no kernel for {q.device}")
    return flash_attention_bwd_reference(q, k, v, g, out, lse, kv_len,
                                         causal, scale)
