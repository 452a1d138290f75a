"""The port's kernel names and their launch counts.

Each hand-written kernel has one name here and one plain-integer launch
count.  A kernel's wrapper adds one to its count where it launches the
kernel and nowhere else, so a run can show that its main path went
through the kernel (``reset_launches()`` before, ``launches()`` after).
A launch recorded into a CUDA graph (``HybridBlock.hybridize()``) runs
nothing when it is recorded: a launch on a stream under :func:`recording`
goes to that stream's recorder instead (from any thread: a captured
backward runs on autograd's worker thread), and each replay of the graph
adds the recorded counts with :func:`count_launches`.

There is no mode switch and no silent fallback: a wrapper given CPU
tensors runs the kernel's plain PyTorch version, a wrapper given CUDA
tensors launches the kernel or raises.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Tuple

from ..base import MXNetError

__all__ = ["KERNELS", "count_launch", "count_launches", "recording",
           "launches", "reset_launches", "check_tensors"]

# name -> (CUDA source under mxnet_tpu_torch/csrc, the TPU kernel it replaces)
KERNELS: Dict[str, Tuple[str, str]] = {
    "flash_attention": (
        "flash_attention.cu",
        "mxnet_tpu/ops/attention.py:59 _flash_kernel"),
    "flash_attention_decode": (
        "decode_attention.cu",
        "mxnet_tpu/ops/attention.py:333 _decode_kernel (f32 cache)"),
    "flash_attention_decode_int8": (
        "decode_attention.cu",
        "mxnet_tpu/ops/attention.py:333 _decode_kernel (int8 cache)"),
    # the other ten (query type, cache type) pairs of the decode kernel
    **{f"flash_attention_decode.{q}_{kv}": (
        "decode_attention.cu" if q == "f32" else f"decode_attention_{q}.cu",
        f"mxnet_tpu/ops/attention.py:333 _decode_kernel ({q} queries, {kv} "
        "cache)")
       for q in ("f32", "bf16", "f16") for kv in ("f32", "int8", "bf16", "f16")
       if q != "f32" or kv in ("bf16", "f16")},
    "flash_attention_bwd_dq": (
        "flash_attention_bwd.cu",
        "mxnet_tpu/kernels/flash_bwd.py:59 _dq_kernel"),
    "flash_attention_bwd_dkv": (
        "flash_attention_bwd.cu",
        "mxnet_tpu/kernels/flash_bwd.py:97 _dkv_kernel"),
    # the 16-bit variants: bf16 and f16 inputs, a kernel each
    **{f"{name}.{dt}": (src, f"{tpu} ({dt})")
       for name, src, tpu in (
           ("flash_attention", "flash_attention.cu",
            "mxnet_tpu/ops/attention.py:59 _flash_kernel"),
           ("flash_attention_bwd_dq", "flash_attention_bwd.cu",
            "mxnet_tpu/kernels/flash_bwd.py:59 _dq_kernel"),
           ("flash_attention_bwd_dkv", "flash_attention_bwd.cu",
            "mxnet_tpu/kernels/flash_bwd.py:97 _dkv_kernel"))
       for dt in ("bf16", "f16")},
    "opt_arena": (
        "opt_arena.cu",
        "mxnet_tpu/kernels/opt_arena.py:131 _arena_kernel"),
    "bn_act_stats": (
        "bn_act.cu",
        "mxnet_tpu/kernels/bn_act.py:55 _bn_stats_kernel"),
    "bn_act_apply": (
        "bn_act.cu",
        "mxnet_tpu/kernels/bn_act.py:70 _bn_apply_kernel"),
    **{f"{name}.{dt}": ("bn_act.cu", f"{tpu} ({dt})")
       for name, tpu in (
           ("bn_act_stats", "mxnet_tpu/kernels/bn_act.py:55 _bn_stats_kernel"),
           ("bn_act_apply", "mxnet_tpu/kernels/bn_act.py:70 _bn_apply_kernel"))
       for dt in ("bf16", "f16")},
    "ext_sqrelu_fwd": (
        "ext_ops.cu",
        "example/extensions/pallas_ops.py:37 _sqrelu_fwd_kernel"),
    "ext_sqrelu_bwd": (
        "ext_ops.cu",
        "example/extensions/pallas_ops.py:43 _sqrelu_bwd_kernel"),
    "ext_axpb": (
        "ext_ops.cu",
        "example/extensions/pallas_ops.py:64 _axpb_kernel"),
}

_LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}
_LOCK = threading.Lock()
# capture stream (its CUDA handle) -> the launches recorded on it
_RECORDERS: Dict[int, Dict[str, int]] = {}


def count_launch(name: str):
    """Add one launch of kernel ``name``; called by its wrapper only,
    after it launched on the current stream.  On a stream under
    :func:`recording` the launch goes to its recorder, not to the
    counts."""
    if name not in _LAUNCHES:
        raise MXNetError(f"unknown kernel {name!r}; registry has "
                         f"{sorted(KERNELS)}")
    if _RECORDERS:
        import torch

        rec = _RECORDERS.get(torch.cuda.current_stream().cuda_stream)
        if rec is not None:
            with _LOCK:
                rec[name] = rec.get(name, 0) + 1
            return
    with _LOCK:
        _LAUNCHES[name] += 1


def count_launches(counts: Dict[str, int]):
    """Add ``counts`` (kernel name -> launches), as one replay of a CUDA
    graph launches them."""
    with _LOCK:
        for name, n in counts.items():
            _LAUNCHES[name] += n


@contextlib.contextmanager
def recording(stream):
    """Collect the launches on ``stream`` (a ``torch.cuda.Stream``) into
    the yielded dict instead of the counts: a CUDA graph's capture, whose
    kernels run only when the graph is replayed."""
    key = stream.cuda_stream
    counts: Dict[str, int] = {}
    with _LOCK:
        prev = _RECORDERS.get(key)
        _RECORDERS[key] = counts
    try:
        yield counts
    finally:
        with _LOCK:
            if prev is None:
                del _RECORDERS[key]
            else:
                _RECORDERS[key] = prev


def launches() -> Dict[str, int]:
    """Snapshot of every kernel's launch count."""
    with _LOCK:
        return dict(_LAUNCHES)


def reset_launches():
    """Set every launch count to 0."""
    with _LOCK:
        for name in _LAUNCHES:
            _LAUNCHES[name] = 0


def check_tensors(op: str, device, want, aligned: bool = True):
    """Raise unless every ``(name, tensor, dtype, shape)`` of ``want`` lies
    on ``device`` with that dtype and shape, contiguous and (with
    ``aligned``) 16-byte aligned: what a kernel's wrapper checks before it
    passes pointers.  A kernel that takes any alignment (it loads with
    scalar copies where a pointer is not 16-byte aligned) passes
    ``aligned=False``."""
    for name, t, dtype, shape in want:
        if t.device != device:
            raise MXNetError(f"{op}: {name} on {t.device}, expected {device}")
        if t.dtype != dtype or tuple(t.shape) != tuple(shape):
            raise MXNetError(f"{op}: {name} must be {dtype} {tuple(shape)}, "
                             f"got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise MXNetError(f"{op}: {name} must be contiguous")
        if aligned and t.data_ptr() % 16:
            raise MXNetError(f"{op}: {name} must be 16-byte aligned")
