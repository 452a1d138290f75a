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
"""
from __future__ import annotations

import weakref
from typing import Iterable, List

import torch

from ..base import MXNetError

__all__ = ["GRAD_REQS", "grad_req", "set_grad_req", "GradReqHooks", "rehook"]

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
    p.requires_grad_(req != "null")
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
