"""Runtime kernel authoring: user kernels registered as framework ops.

The port of ``mxnet_tpu/rtc.py``.  A user writes a kernel (a
hand-written CUDA kernel behind a Python wrapper, as
``kernels/ext_ops.py`` does, or any PyTorch function) and registers it
with :func:`register`; it is then called like a built-in op, from
``npx`` too::

    op = mx.rtc.register("my_scale", scale, grad=scale_grad)
    y = op(x, alpha=3.0)         # recorded by autograd.record()

The op's positional arguments are its inputs; its keyword arguments
are config, passed on every call to ``fn`` and to ``grad``, except
``out=``: a single-output op given ``out`` computes its result, copies
it into ``out`` (``copy_``, which casts to ``out``'s dtype and, under
autograd, records the copy) and returns ``out``, as the JAX op writes
into its ``out``.  A
plain-PyTorch ``fn`` is differentiable as it is.  A kernel leaves no
autograd graph, so an op that must train passes ``grad``:
``grad(cotangent, *inputs, **config)`` returns one cotangent per input
(a tuple; a tensor for a one-input op), and runs as the backward of a
``torch.autograd.Function`` (it may launch a kernel too).  Without
``grad``, an op whose output carries no graph while an input requires
one (so torch would drop the gradient without a word) gets a backward
that raises :class:`MXNetError` naming ``grad=``; the JAX package fails
loudly there too (a ``pallas_call`` has no VJP).

``CudaModule`` / ``CudaKernel`` (compiling CUDA source at run time with
NVRTC) raise: the JAX package has no such compiler either.
``example/extensions/torch_ops.py`` shows the pattern that takes its
place: kernels built with the package's own and registered here.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from .base import MXNetError

__all__ = ["register", "kernels", "CudaModule", "CudaKernel"]

_KERNELS: Dict[str, Callable] = {}


def kernels() -> Dict[str, Callable]:
    """name -> registered op."""
    return dict(_KERNELS)


class _WithGrad(torch.autograd.Function):
    """``fn`` forward, ``grad`` backward (module docstring)."""

    @staticmethod
    def forward(ctx, spec, *args):
        fn, _, config = spec
        ctx.spec = spec
        ctx.tensor_at = [i for i, a in enumerate(args) if torch.is_tensor(a)]
        ctx.others = [None if torch.is_tensor(a) else a for a in args]
        ctx.save_for_backward(*(args[i] for i in ctx.tensor_at))
        out = fn(*args, **config)
        ctx.tuple_out = isinstance(out, (tuple, list))
        return tuple(out) if ctx.tuple_out else out

    @staticmethod
    def backward(ctx, *gs):
        _, grad, config = ctx.spec
        args = list(ctx.others)
        for i, t in zip(ctx.tensor_at, ctx.saved_tensors):
            args[i] = t
        cots = grad(gs if ctx.tuple_out else gs[0], *args, **config)
        if torch.is_tensor(cots):
            cots = (cots,)
        cots = list(cots) + [None] * (len(args) - len(cots))
        return (None,) + tuple(c if i in ctx.tensor_at else None
                               for i, c in enumerate(cots))


class _NoGrad(torch.autograd.Function):
    """Passes an output through; its backward raises (module
    docstring)."""

    @staticmethod
    def forward(ctx, name, out, *inputs):
        ctx.name = name
        return out.view_as(out)

    @staticmethod
    def backward(ctx, *gs):
        raise MXNetError(
            f"op '{ctx.name}' has no gradient: its result was computed "
            "outside autograd (a kernel or a host function); an op that "
            "must train is registered with rtc.register(..., grad=...)")


def guard_no_grad(name: str, out, args):
    """``out`` as it is, or, under grad mode with an input that requires
    a gradient, every output tensor with no graph behind a backward that
    raises."""
    need = [a for a in args if torch.is_tensor(a) and a.requires_grad]
    if not need or not torch.is_grad_enabled():
        return out

    def wrap(o):
        if torch.is_tensor(o) and o.grad_fn is None and not o.requires_grad:
            return _NoGrad.apply(name, o, *need)
        return o

    if isinstance(out, (tuple, list)):
        return type(out)(wrap(o) for o in out)
    return wrap(out)


def register(name: str, fn: Callable, grad: Optional[Callable] = None,
             attach_npx: bool = True) -> Callable:
    """Register ``fn(*inputs, **config)`` as the op ``name`` (module
    docstring); with ``attach_npx`` also as ``npx.<name>``.  A name that
    is taken raises, and leaves nothing registered."""
    if not callable(fn):
        raise MXNetError("rtc.register needs a callable kernel")
    if name in _KERNELS:
        raise MXNetError(f"kernel '{name}' already registered")

    def op(*args, out=None, **config):
        if grad is None:
            res = guard_no_grad(name, fn(*args, **config), args)
        else:
            res = _WithGrad.apply((fn, grad, config), *args)
        if out is None:
            return res
        if not torch.is_tensor(res):
            raise MXNetError(f"op '{name}': out= is only supported for "
                             "single-output ops")
        return out.copy_(res)

    op.__name__ = name
    if attach_npx:
        from . import numpy_extension as npx

        if name in vars(npx):  # not __getattr__'s not-ported names
            raise MXNetError(f"op '{name}' already exists in npx")
        setattr(npx, name, op)
    _KERNELS[name] = op
    return op


_MSG = ("mx.rtc.CudaModule compiles CUDA source at run time with NVRTC, "
        "which this port does not do. Write the kernel as a source the "
        "package builds (nvcc, a plain C interface loaded with ctypes), "
        "wrap it in Python and register it with mx.rtc.register(name, fn, "
        "grad=...), as example/extensions/torch_ops.py does, or load such "
        "an extension with mx.library.load.")


class CudaModule:
    def __init__(self, *args, **kwargs):
        raise MXNetError(_MSG)


class CudaKernel:
    def __init__(self, *args, **kwargs):
        raise MXNetError(_MSG)
