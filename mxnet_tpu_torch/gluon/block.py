"""Gluon's ``Block`` and ``HybridBlock`` as ``torch.nn.Module``s.

The port of ``Block`` / ``HybridBlock`` from ``mxnet_tpu/gluon/block.py``
(``collect_params`` :135, ``initialize`` :159, ``cast`` :173,
``zero_grad`` :180, ``setattr``, ``hybridize`` :272 and :826).  Every layer and model of the
port derives from :class:`HybridBlock`, so children register by
attribute assignment (torch's rule, as the JAX ``Block.__setattr__``
does) and a parameter's structured name is its ``named_parameters``
name, the JAX ``collect_params()`` name letter for letter
(``features.0.weight``, ...).

What differs from the JAX blocks: ``collect_params()`` returns
``{name: torch.nn.Parameter}`` and holds no buffers (BatchNorm's
running statistics are buffers here, parameters with ``grad_req="null"``
there); ``initialize`` takes a seed, not an initializer object
(``initializer.seeded_init``, the Xavier rule of the JAX default);
``hybridize()`` is accepted and the block still runs eagerly (no
trace, no CUDA graph).

``save_parameters`` / ``load_parameters`` (``mxnet_tpu/gluon/block.py:
203-240``) write and read the JAX package's array file
(``ndarray.utils``) keyed by structured name: the parameters and the
buffers (BatchNorm's running statistics, parameters of the JAX blocks),
so a file written by either package loads into the other's block of the
same structure.
"""
from __future__ import annotations

import re
from typing import Dict, Optional

import torch
from torch import nn

from ..base import MXNetError
from ..initializer import seeded_init
from .parameter import GradReqHooks, rehook, set_grad_req

__all__ = ["Block", "HybridBlock"]


class Block(nn.Module):
    """Base block (module docstring)."""

    def collect_params(self, select: Optional[str] = None
                       ) -> Dict[str, nn.Parameter]:
        """``{structured name: parameter}``, those whose name matches the
        regular expression ``select`` when given.  Puts the parameters
        under their ``grad_req`` (``gluon.parameter``): the block holds
        the hooks that make "write" overwrite."""
        params = dict(self.named_parameters())
        if select is not None:
            pat = re.compile(select)
            params = {k: v for k, v in params.items() if pat.match(k)}
        hooks = self.__dict__.get("_grad_req_hooks")
        if hooks is None:
            hooks = self.__dict__["_grad_req_hooks"] = GradReqHooks()
        hooks.attach(params.values())
        return params

    def initialize(self, seed: int = 0):
        """Seeded random weights (:func:`initializer.seeded_init`);
        returns the block."""
        return seeded_init(self, seed)

    @torch.no_grad()
    def cast(self, dtype):
        """Cast every floating parameter and every floating buffer of the
        block and its children to ``dtype`` (a torch dtype or a name such
        as ``"bfloat16"``), in place; returns the block.  The JAX
        ``Block.cast`` (``mxnet_tpu/gluon/block.py:173``) casts every
        ``collect_params()`` entry, BatchNorm's running statistics among
        them; here those are buffers, so buffers are cast too.  A
        parameter stays the same tensor (its ``grad_req`` and "write" hook
        stay attached); one that had a gradient gets a zero gradient of
        the new type, as ``Parameter.cast`` re-attaches it.  The model's
        own dtype attribute is not touched: a ``TransformerLM`` keeps the
        cache type its constructor set, as in the JAX package."""
        dt = _torch_dtype(dtype)
        for mod in self.modules():
            for p in mod.parameters(recurse=False):
                if p.is_floating_point() and p.dtype != dt:
                    had_grad = p.grad is not None
                    p.grad = None
                    # torch drops a leaf's gradient accumulator when its
                    # type changes: the "write" hook moves to the new one
                    p.data = p.data.to(dt)
                    rehook(p)
                    if had_grad:
                        p.grad = torch.zeros_like(p)
            for name, b in list(mod.named_buffers(recurse=False)):
                if b is not None and b.is_floating_point() and b.dtype != dt:
                    mod._buffers[name] = b.to(dt)
        return self

    def zero_grad(self, set_to_none: bool = False):
        """Zero every parameter's gradient in place (MXNet's rule;
        ``set_to_none=True`` drops them, torch's)."""
        super().zero_grad(set_to_none=set_to_none)

    def _saved(self) -> Dict[str, torch.Tensor]:
        """``{structured name: tensor}``: the parameters and persistent
        buffers, each once."""
        keep = set(self.state_dict(keep_vars=True))
        out = dict(self.named_parameters())
        out.update((n, b) for n, b in self.named_buffers() if n in keep)
        return out

    def save_parameters(self, filename: str, deduplicate: bool = False):
        """Write the parameters and buffers to ``filename`` (module
        docstring)."""
        from ..ndarray import save

        save(filename, self._saved())

    @torch.no_grad()
    def load_parameters(self, filename: str, ctx=None,
                        allow_missing: bool = False,
                        ignore_extra: bool = False, cast_dtype: bool = False,
                        dtype_source: str = "current", device=None):
        """Read a :meth:`save_parameters` file (of either package) into
        this block's parameters and buffers, in place on their device.
        A name of the block missing from the file raises unless
        ``allow_missing``, a name of the file not in the block unless
        ``ignore_extra``; with ``cast_dtype`` a tensor takes the saved
        dtype (the JAX package's rule), else the value is cast to the
        tensor's."""
        from ..ndarray import load

        loaded = load(filename)
        own = self._saved()
        if not allow_missing:
            for name in own:
                if name not in loaded:
                    raise MXNetError(
                        f"Parameter '{name}' is missing in file "
                        f"'{filename}'. Set allow_missing=True to ignore "
                        "missing parameters.")
        for name, value in loaded.items():
            if name not in own:
                if not ignore_extra:
                    raise MXNetError(
                        f"Parameter '{name}' loaded from file '{filename}' "
                        "is not present in the Block. Set "
                        "ignore_extra=True to ignore.")
                continue
            t = own[name]
            if tuple(value.shape) != tuple(t.shape):
                raise MXNetError(f"{name}: shape {tuple(value.shape)} in "
                                 f"'{filename}', {tuple(t.shape)} in the "
                                 "block")
            if cast_dtype and value.dtype != t.dtype:
                t.data = value.to(t.device)
            else:
                t.copy_(value)
        return self

    def setattr(self, name: str, value):
        """Set an attribute on every parameter (``grad_req``, ``lr_mult``,
        ``wd_mult``)."""
        for p in self.collect_params().values():
            if name == "grad_req":
                set_grad_req(p, value)
            else:
                setattr(p, name, value)

    def hybridize(self, active: bool = True, static_alloc: bool = False,
                  static_shape: bool = False, inline_limit: int = 2,
                  forward_bulk_size: Optional[int] = None,
                  backward_bulk_size: Optional[int] = None):
        """Accepted with the JAX signature; the block and its children
        still run eagerly (module docstring)."""


_DTYPE_NAMES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "float16": torch.float16, "float64": torch.float64}


def _torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype, a numpy dtype or its name
    (``"bfloat16"``), as ``jnp.dtype`` reads the JAX ``cast``'s."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = str(getattr(dtype, "name", dtype))
    if name not in _DTYPE_NAMES:
        raise MXNetError(f"cast: unknown dtype {dtype!r}")
    return _DTYPE_NAMES[name]


class HybridBlock(Block):
    """A block that may be hybridized (:meth:`Block.hybridize`)."""
