"""MXNet's ``grad_req`` on the port's parameters.

The port of ``Parameter.grad_req`` (``mxnet_tpu/gluon/parameter.py:30``
and its setter at ``:96``).  The port's parameters are
``torch.nn.Parameter``s; their request is kept on the tensor:

* ``"write"`` (the default): each backward overwrites the gradient;
* ``"add"``: each backward adds to it, which is torch's own rule;
* ``"null"``: no gradient (``requires_grad`` False, ``.grad`` None).

torch always adds into ``.grad``.  So "write" is a pre-hook on the
parameter's gradient accumulator (the ``AccumulateGrad`` node) that
zeroes ``.grad`` in place just before the backward's gradient lands: the
node runs once per backward with the whole gradient, and
``torch.autograd.grad`` never runs it, so ``autograd.grad`` leaves
``.grad`` alone, as in MXNet.  Zeroing in place keeps ``.grad`` the same
tensor (a view into ``ShardedTrainer``'s gradient arena stays one).

torch keeps a leaf's accumulator only while a graph or someone else
holds it, and the accumulator holds its parameter.  So a
:class:`GradReqHooks` object holds the nodes, and the hooks act while it
lives; ``Block.collect_params()`` keeps one on the block and
``gluon.Trainer`` one for its parameters.  A parameter carries one hook
at a time: a holder hooks only parameters that no living holder has
hooked, and keeps the holders that did alive.

A parameter (or BatchNorm's running-statistics buffer) also carries the
initializer its layer was given (:func:`with_init`, the JAX
``Parameter(init=...)``) and whether it holds values yet
(:func:`initialized`): the port builds its tensors with ``torch.empty``,
and ``Block.initialize`` leaves an initialized tensor alone unless
``force_reinit``, as ``Parameter.initialize`` does
(``mxnet_tpu/gluon/parameter.py:116-147``).

A layer given a width of 0 (``Dense(in_units=0)``, ``Conv2D(in_channels=
0)``, ...) holds a deferred tensor (:func:`deferred`): PyTorch's
``UninitializedParameter`` / ``UninitializedBuffer``, carrying its
initializer, device, dtype and ``grad_req``, whose every use raises
:class:`~mxnet_tpu_torch.base.DeferredInitializationError`, as the JAX
``Parameter.data()`` does before its shape is known (``parameter.py:
27-160``).  ``Block.__call__`` catches it, the layer's ``infer_shape``
sets the shapes (:func:`set_shape`) and :func:`materialize` turns each
tensor into an ordinary one in place: the same object, so a dict from
``collect_params`` or a ``gluon.Trainer`` built before the first call
holds the materialized tensor, and a "write" hook asked for before it
is put on its accumulator then.
"""
from __future__ import annotations

import weakref
from typing import Iterable, List

import torch
from torch.nn.parameter import UninitializedBuffer, UninitializedParameter

from ..base import DeferredInitializationError, MXNetError

__all__ = ["GRAD_REQS", "grad_req", "set_grad_req", "GradReqHooks", "rehook",
           "with_init", "recorded_init", "initialized", "mark_initialized",
           "carry_marks", "deferred", "is_deferred", "set_shape",
           "materialize", "retype"]

GRAD_REQS = ("write", "add", "null")


def grad_req(p: torch.Tensor) -> str:
    """``p``'s request: as set, else "write" (or "null" for a tensor that
    takes no gradient)."""
    return p.__dict__.get("_mx_grad_req",
                          "write" if p.requires_grad else "null")


def set_grad_req(p: torch.Tensor, req: str):
    """Set ``p``'s request (module docstring)."""
    if req not in GRAD_REQS:
        raise MXNetError(f"grad_req must be write/add/null, got {req}")
    p._mx_grad_req = req
    p.requires_grad = req != "null"
    if req == "null":
        p.grad = None


def _zero_before_write(ref):
    def hook(grad_outputs):
        p = ref()
        if p is not None and p.grad is not None and grad_req(p) == "write":
            p.grad.zero_()
    return hook


class GradReqHooks:
    """Holds the gradient accumulators that carry the "write" hooks of
    some parameters (module docstring); one hook per parameter."""

    def __init__(self):
        self._nodes: List[object] = []
        self._others: List["GradReqHooks"] = []

    def attach(self, params: Iterable[torch.Tensor]):
        for p in params:
            ref = p.__dict__.get("_mx_grad_hooks")
            owner = ref() if ref is not None else None
            if owner is not None:
                if owner is not self and owner not in self._others:
                    self._others.append(owner)
                continue
            if is_deferred(p):
                # no accumulator yet: materialize() hooks it (rehook)
                p._mx_grad_hooks = weakref.ref(self)
                continue
            was = p.requires_grad
            with torch.enable_grad():
                p.requires_grad_(True)
                node = p.view_as(p).grad_fn.next_functions[0][0]
                p.requires_grad_(was)
            node.register_prehook(_zero_before_write(weakref.ref(p)))
            self._nodes.append(node)
            p._mx_grad_hooks = weakref.ref(self)


def rehook(p: torch.Tensor):
    """Put ``p``'s "write" hook on its current gradient accumulator: torch
    makes a new one when ``p.data`` changes type (``Block.cast``), and the
    holder that hooked the old one hooks the new one."""
    ref = p.__dict__.pop("_mx_grad_hooks", None)
    owner = ref() if ref is not None else None
    if owner is not None:
        owner.attach([p])


def with_init(t: torch.Tensor, init) -> torch.Tensor:
    """Record ``init`` (an initializer, its registered name or None for
    ``initialize``'s default) as ``t``'s own; returns ``t``."""
    t._mx_init = init
    return t


def recorded_init(t: torch.Tensor):
    """The initializer :func:`with_init` recorded on ``t``, or None."""
    return t.__dict__.get("_mx_init")


def initialized(t: torch.Tensor) -> bool:
    """Whether ``t`` holds values: set by ``Block.initialize``,
    ``load_parameters``, ``ShardedTrainer.load_states`` and
    ``convert.load_into``."""
    return t.__dict__.get("_mx_initialized", False)


def mark_initialized(t: torch.Tensor):
    t._mx_initialized = True


def carry_marks(old: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """Give ``new`` (a buffer's replacement, cast or moved) ``old``'s
    initializer and initialized mark; returns ``new``."""
    for key in ("_mx_init", "_mx_initialized"):
        if key in old.__dict__:
            new.__dict__[key] = old.__dict__[key]
    return new


# -- deferred tensors ---------------------------------------------------------
# what a deferred tensor allows: hashing (dict keys), its type's
# questions, ``requires_grad_`` and its properties (device, dtype,
# requires_grad, grad, its storage through ``data``), but no property
# that is a view of it (``T``)
_ALLOWED = (torch.Tensor.__hash__, torch.Tensor.is_floating_point,
            torch.Tensor.is_complex, torch.Tensor.get_device,
            torch._has_compatible_shallow_copy_type)
_STORAGE = ("data", "grad")
_VIEWS = ("T", "mT", "H", "mH", "real", "imag")


def _refuse(what) -> DeferredInitializationError:
    return DeferredInitializationError(
        f"a parameter has not been initialized yet because its "
        f"initialization was deferred ({what}); its shape is known at "
        "the first forward pass, which initializes it")


class _Deferred:
    """Every use of the tensor but the properties above raises
    :class:`DeferredInitializationError` (PyTorch's own raises a
    ``ValueError``, and lets ``.to`` / ``.size`` through)."""

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        if func is torch.Tensor.requires_grad_:       # a flag, no data
            t, flag = (tuple(args) + (True,))[:2]
            t.requires_grad = (kwargs or {}).get("requires_grad", flag)
            return t
        prop = getattr(getattr(func, "__self__", None), "__name__", None)
        if func in _ALLOWED or func.__class__.__name__ == "method-wrapper":
            if prop in _VIEWS:
                raise _refuse(prop)
            out = torch._C._disabled_torch_function_impl(
                func, types, args, kwargs or {})
            if isinstance(out, torch.Tensor) and prop not in _STORAGE:
                raise _refuse(prop)
            return out
        raise _refuse(getattr(func, "__name__", func))

    @property
    def shape(self):
        raise _refuse("shape")


class DeferredParameter(_Deferred, UninitializedParameter):
    """A parameter whose shape waits for the first forward."""
    cls_to_become = torch.nn.Parameter


class DeferredBuffer(_Deferred, UninitializedBuffer):
    """A buffer (BatchNorm's running statistics) whose shape waits for
    the first forward."""
    cls_to_become = torch.Tensor


def deferred(device, dtype, init=None, requires_grad: bool = True,
             buffer: bool = False) -> torch.Tensor:
    """A deferred parameter (or buffer) on ``device`` of ``dtype`` that
    records ``init``."""
    t = DeferredBuffer(False, device, dtype) if buffer else \
        DeferredParameter(requires_grad, device, dtype)
    return with_init(t, init)


def is_deferred(t) -> bool:
    return isinstance(t, _Deferred)


def set_shape(t: torch.Tensor, shape):
    """Record the shape a layer's ``infer_shape`` found for ``t`` (a
    tensor that already has one keeps it)."""
    if is_deferred(t):
        shape = tuple(int(s) for s in shape)
        if not all(s > 0 for s in shape):
            raise DeferredInitializationError(
                f"inferred shape {shape} still has an unknown width")
        t._mx_shape = shape


def materialize(t: torch.Tensor, shape=None):
    """Give deferred ``t`` its shape (the one :func:`set_shape` recorded
    unless given) in place: it becomes a ``Parameter`` (a plain tensor
    for a buffer) of its device and dtype, uninitialized, keeping its
    marks; a "write" hook asked for meanwhile goes on its accumulator."""
    shape = shape if shape is not None else t.__dict__.get("_mx_shape")
    if shape is None:
        raise DeferredInitializationError("the shape of a deferred "
                                          "parameter is still unknown")
    t.__dict__.pop("_mx_shape", None)
    t.materialize(tuple(int(s) for s in shape), device=t.device,
                  dtype=t.dtype)
    rehook(t)
    return t


def retype(t: torch.Tensor, device=None, dtype=None):
    """Move or cast deferred ``t`` in place: it materializes on
    ``device`` in ``dtype``, as the JAX ``Parameter.cast`` records the
    type for a deferred init."""
    t.data = torch.empty(0, device=device if device is not None
                         else t.device,
                         dtype=dtype if dtype is not None else t.dtype)
