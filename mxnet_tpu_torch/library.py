"""``mx.library.load``: extensions loaded at run time.

The port of ``mxnet_tpu/library.py``.  Two kinds of extension:

* a Python file (``.py``): its ``register_ops(mx)`` runs with
  ``mxnet_tpu_torch`` as ``mx`` and returns ``{name: op}``; each op is
  attached as ``npx.<name>`` (``example/extensions/torch_ops.py``
  registers its kernels through ``mx.rtc.register`` this way);
* a native library (``.so``) with the JAX package's small C interface::

      int          MXTPULibNumOps(void);
      const char*  MXTPULibOpName(int i);
      int          MXTPULibOpCompute(int i, const float* in, float* out,
                                     long long n);   // elementwise f32

  Each op runs its C function on the host, as the JAX package runs it
  through ``pure_callback``: the input is copied to the host as f32 and
  the result back to the input's device.  That is the reference's
  design for an opaque foreign function, not a fallback.  Such an op
  has no gradient: a backward through it raises (``rtc.guard_no_grad``).

A name that ``npx`` already has raises :class:`MXNetError`.
"""
from __future__ import annotations

import ctypes
import importlib.util
import os
from typing import Callable, Dict

import torch

from .base import MXNetError
from .rtc import guard_no_grad

__all__ = ["load", "loaded_ops"]

_LOADED: Dict[str, Callable] = {}


def loaded_ops() -> Dict[str, Callable]:
    """name -> op for every extension op loaded so far."""
    return dict(_LOADED)


def _register_npx(name: str, fn: Callable):
    from . import numpy_extension as npx

    if name in vars(npx):  # not __getattr__'s not-ported names
        raise MXNetError(f"op '{name}' already exists in npx")
    setattr(npx, name, fn)
    _LOADED[name] = fn


def _load_python(path: str):
    spec = importlib.util.spec_from_file_location(
        f"mxnet_tpu_torch_ext_{os.path.basename(path)[:-3]}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if not hasattr(mod, "register_ops"):
        raise MXNetError(f"{path} has no register_ops(mx) entry point")
    import mxnet_tpu_torch as mx

    registered = mod.register_ops(mx)
    for name, fn in (registered or {}).items():
        _register_npx(name, fn)
    return registered


def _native_op(lib, index: int, name: str):
    def op(data: torch.Tensor) -> torch.Tensor:
        x = data.detach().to("cpu", torch.float32).contiguous()
        y = torch.empty_like(x)
        rc = lib.MXTPULibOpCompute(index, x.data_ptr(), y.data_ptr(),
                                   x.numel())
        if rc != 0:
            raise MXNetError(f"extension op {name} failed (rc={rc})")
        return guard_no_grad(name, y.to(data.device), (data,))

    op.__name__ = name
    return op


def _load_native(path: str):
    lib = ctypes.CDLL(path)
    lib.MXTPULibNumOps.restype = ctypes.c_int
    lib.MXTPULibNumOps.argtypes = []
    lib.MXTPULibOpName.restype = ctypes.c_char_p
    lib.MXTPULibOpName.argtypes = [ctypes.c_int]
    lib.MXTPULibOpCompute.restype = ctypes.c_int
    lib.MXTPULibOpCompute.argtypes = [ctypes.c_int, ctypes.c_void_p,
                                      ctypes.c_void_p, ctypes.c_longlong]
    names = {}
    for i in range(lib.MXTPULibNumOps()):
        op_name = lib.MXTPULibOpName(i).decode()
        fn = _native_op(lib, i, op_name)
        _register_npx(op_name, fn)
        names[op_name] = fn
    # keep the library loaded as long as its ops are registered
    _LOADED[f"__lib__{path}"] = lib
    return names


def load(path: str):
    """Load an extension (module docstring); returns ``{name: op}``."""
    if not os.path.exists(path):
        raise MXNetError(f"extension not found: {path}")
    if path.endswith(".py"):
        return _load_python(path)
    if path.endswith(".so"):
        return _load_native(path)
    raise MXNetError(f"unsupported extension type: {path} (.py or .so)")
