"""Gluon's ``Block`` and ``HybridBlock`` as ``torch.nn.Module``s.

The port of ``Block`` / ``HybridBlock`` from ``mxnet_tpu/gluon/block.py``
(``collect_params`` :135, ``initialize`` :159-171, ``cast`` :173,
``zero_grad`` :180, ``setattr``, ``hybridize`` :272 and :826).  Every layer and model of the
port derives from :class:`HybridBlock`, so children register by
attribute assignment (torch's rule, as the JAX ``Block.__setattr__``
does) and a parameter's structured name is its ``named_parameters``
name, the JAX ``collect_params()`` name letter for letter
(``features.0.weight``, ...).

What differs from the JAX blocks: ``collect_params()`` returns
``{name: torch.nn.Parameter}`` and holds no buffers (BatchNorm's
running statistics are buffers here, parameters with ``grad_req="null"``
there, and ``initialize`` gives them their layer's initializers
through the same name routing).

``hybridize()`` is the JAX package's ``_CachedOp`` (``:421-718``) with a
CUDA graph where JAX has a ``jax.jit``: on the card, the first call of
each input signature (after the first, eager, call) warms the forward on
a capture stream of its own (kernels built and loaded, cuBLAS handles
and workspaces made), captures it with ``torch.cuda.CUDAGraph``, and
replays it; later calls copy their inputs into the graph's static inputs
and replay.  Outputs are cloned out of the graph, except those that are
a donated argument's buffers (``donate_args``).  The signature is
``(training, recording, the argument tree, the device)`` with every
parameter's, buffer's and argument leaf's shape and dtype; on the card
it also holds the storage address of every parameter, buffer and
donated argument leaf, read on each call, since a graph has them baked
in.  So whatever rebinds a tensor's storage (``cast``,
``load_parameters(cast_dtype=True)``, a device move, ``p.data = ...``)
makes the next call capture again, and the graphs over the old storage
are dropped; a donated argument other than a graph's own buffers is a
signature of its own, so two callers never share a buffer.  An update
in place (``copy_``, a trainer step, ``initialize(force_reinit=True)``)
is read by the next replay as it is.  Under ``autograd.record()`` the block is one node of
the tape: the forward and its backward are a captured graph each (the
pattern of ``torch.cuda.make_graphed_callables``), parameter gradients
leave the backward graph into their accumulators, BatchNorm's running
statistics update inside the forward graph, and Dropout draws from the
port's generator registered with the graph, so each replay draws new
masks.  A forward that cannot be captured (one that reads a card tensor
back, ``.item()``, ``.cpu()``, ...) raises :class:`MXNetError`; nothing
falls back to eager on the card.  On the CPU the cached op keeps the
same signature table, counters and retrace guard and runs the block
eagerly.  A hybridized block records a tape node only inside
``autograd.record()``, as the JAX block does; outside it the forward runs
as inference (no graph for torch's autograd).

``save_parameters`` / ``load_parameters`` (``mxnet_tpu/gluon/block.py:
203-240``) write and read the JAX package's array file
(``ndarray.utils``) keyed by structured name: the parameters and the
buffers (BatchNorm's running statistics, parameters of the JAX blocks),
so a file written by either package loads into the other's block of the
same structure.
"""
from __future__ import annotations

import contextlib
import gc
import numbers
import re
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .. import autograd as _ag
from .. import initializer as _init
from .. import random as _random
from .. import telemetry as _tel
from ..analysis import retrace as _retrace
from ..base import DeferredInitializationError, MXNetError
from ..context import resolve_device
from ..jit.bucketing import ShapeBucketer
from ..kernels import registry as _kreg
from ..trace import recorder as _tr
from .parameter import (GradReqHooks, carry_marks, initialized,
                        is_deferred, mark_initialized, materialize,
                        recorded_init, rehook, retype, set_grad_req)

__all__ = ["Block", "HybridBlock", "WarmupHandle", "trace_guard",
           "pipeline_atoms"]

class Block(nn.Module):
    """Base block (module docstring)."""

    def __call__(self, *args, **kwargs):
        try:
            return super().__call__(*args, **kwargs)
        except DeferredInitializationError:
            # a width of this block's own tensors waits for its input
            # (``gluon.parameter``): infer it, materialize, run again, as
            # the JAX ``Block.__call__`` does; each child handles its own
            if not self._own_deferred():
                raise
            self._deferred_infer_and_init(*args, **kwargs)
            return super().__call__(*args, **kwargs)

    def _own_deferred(self) -> List[Tuple[str, torch.Tensor]]:
        return [(n, t) for d in (self._parameters, self._buffers)
                for n, t in d.items() if t is not None and is_deferred(t)]

    @torch.no_grad()
    def _deferred_infer_and_init(self, *args, **kwargs):
        """``infer_shape`` from the first input, then each deferred
        tensor of this block materialized and drawn from the initializer
        that ``initialize`` recorded for it (``Parameter.
        _finish_deferred_init``)."""
        own = self._own_deferred()
        for name, t in own:
            if "_mx_deferred" not in t.__dict__:
                raise MXNetError(
                    f"Parameter '{name}' of {type(self).__name__} has not "
                    "been initialized. You should initialize parameters "
                    "with Block.initialize().")
        self.infer_shape(*args, **kwargs)
        for name, t in own:
            ini, full = t.__dict__.pop("_mx_deferred")
            materialize(t)
            ini(_init.InitDesc(full), t)
            mark_initialized(t)

    def infer_shape(self, *args, **kwargs):
        """Set the shapes of this block's deferred tensors from its
        inputs (``gluon.parameter.set_shape``); the layers that infer a
        width override it (the JAX ``HybridBlock.infer_shape``)."""
        raise MXNetError(
            f"{type(self).__name__} has deferred-init parameters but does "
            "not implement infer_shape")

    def register_child(self, block, name: Optional[str] = None):
        """Add ``block`` as a child named ``name`` (its index among the
        children when None), as the JAX ``Block.register_child`` does;
        the child is a torch submodule, so its parameters take the name
        as their prefix."""
        self.add_module(name if name is not None else str(len(self._modules)),
                        block)
        return block

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

    @torch.no_grad()
    def initialize(self, init=None, ctx=None, verbose: bool = False,
                   force_reinit: bool = False, device=None):
        """Initialize every parameter and persistent buffer (BatchNorm's
        running statistics) not yet initialized, or all of them with
        ``force_reinit``; returns the block.  Each tensor takes the
        initializer its layer recorded, else ``init`` (an initializer,
        ``Mixed`` or a registered name; ``Uniform()`` when None), called
        with its structured name (``features.0.weight``), so the name
        routing of :meth:`initializer.Initializer.init` applies.  Values
        are drawn from ``mx.random.seed``'s CPU generator in parameter
        order (``named_parameters``), each shared tensor once.  ``ctx`` / ``device`` naming another
        device moves the block there first (each parameter stays the
        same tensor, its ``grad_req`` hook moved as :meth:`cast` does)."""
        if isinstance(init, numbers.Number):
            raise MXNetError(
                f"initialize(init={init!r}): init is an initializer, not a "
                "seed; seed with mx.random.seed(s), then initialize("
                "mx.init.Xavier())")
        default = _init.Uniform() if init is None else init
        if isinstance(default, str):
            default = _init.create(default)
        where = ctx if ctx is not None else device
        if isinstance(where, (list, tuple)):
            where = where[0] if where else None
        if where is not None:
            self._move(resolve_device(where))
        for name, t in self._saved(deferred=True).items():
            if initialized(t) and not force_reinit:
                continue
            ini = recorded_init(t)
            ini = default if ini is None else ini
            if isinstance(ini, str):
                ini = _init.create(ini)
            if is_deferred(t):
                # drawn when the first forward gives it a shape
                t._mx_deferred = (ini, name)
                continue
            ini(_init.InitDesc(name), t)
            mark_initialized(t)
        return self

    def _move(self, dev: torch.device):
        for mod in self.modules():
            for p in mod.parameters(recurse=False):
                if is_deferred(p):
                    retype(p, device=dev)
                elif p.device != dev:
                    grad, p.grad = p.grad, None
                    p.data = p.data.to(dev)
                    rehook(p)
                    if grad is not None:
                        p.grad = grad.to(dev)
            for name, b in list(mod.named_buffers(recurse=False)):
                if b is not None and is_deferred(b):
                    retype(b, device=dev)
                elif b is not None and b.device != dev:
                    mod._buffers[name] = carry_marks(b, b.to(dev))

    @torch.no_grad()
    def cast(self, dtype):
        """Cast every floating parameter and every floating buffer of the
        block and its children to ``dtype`` (a torch dtype or a name such
        as ``"bfloat16"``), in place; returns the block.  The JAX
        ``Block.cast`` (``mxnet_tpu/gluon/block.py:173``) casts every
        ``collect_params()`` entry, BatchNorm's running statistics among
        them; here those are buffers, so buffers are cast too.  A
        deferred tensor takes ``dtype`` for when it materializes.  A
        parameter stays the same tensor (its ``grad_req`` and "write" hook
        stay attached); one that had a gradient gets a zero gradient of
        the new type, as ``Parameter.cast`` re-attaches it.  The model's
        own dtype attribute is not touched: a ``TransformerLM`` keeps the
        cache type its constructor set, as in the JAX package."""
        dt = _torch_dtype(dtype)
        for mod in self.modules():
            for p in mod.parameters(recurse=False):
                if is_deferred(p):
                    if p.is_floating_point():
                        retype(p, dtype=dt)
                elif p.is_floating_point() and p.dtype != dt:
                    had_grad = p.grad is not None
                    p.grad = None
                    # torch drops a leaf's gradient accumulator when its
                    # type changes: the "write" hook moves to the new one
                    p.data = p.data.to(dt)
                    rehook(p)
                    if had_grad:
                        p.grad = torch.zeros_like(p)
            for name, b in list(mod.named_buffers(recurse=False)):
                if b is not None and is_deferred(b):
                    if b.is_floating_point():
                        retype(b, dtype=dt)
                elif b is not None and b.is_floating_point() and \
                        b.dtype != dt:
                    mod._buffers[name] = carry_marks(b, b.to(dt))
        return self

    def _apply(self, fn, recurse=True):
        """torch's conversions (``to``, ``cuda``, ``float``, ...): a
        deferred tensor takes the device and type ``fn`` gives an empty
        tensor of its own, for when it materializes, as :meth:`cast` and
        ``initialize(device=)`` do; the others convert as torch converts
        them."""

        def convert(t):
            if not is_deferred(t):
                return fn(t)
            probe = fn(torch.empty(0, device=t.device, dtype=t.dtype))
            retype(t, device=probe.device, dtype=probe.dtype)
            return t

        return super()._apply(convert, recurse)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        """``load_state_dict`` into a deferred tensor materializes it at
        the loaded shape first, as :meth:`load_parameters` does (a block's
        ``state_dict()`` raises while a tensor of it is deferred: there is
        no value to save)."""
        for name, t in self._own_deferred():
            if prefix + name in state_dict:
                t.__dict__.pop("_mx_deferred", None)
                materialize(t, state_dict[prefix + name].shape)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def zero_grad(self, set_to_none: bool = False):
        """Zero every parameter's gradient in place (MXNet's rule;
        ``set_to_none=True`` drops them, torch's)."""
        super().zero_grad(set_to_none=set_to_none)

    def _saved(self, deferred: bool = False) -> Dict[str, torch.Tensor]:
        """``{structured name: tensor}``: the parameters and persistent
        buffers, each once; deferred ones only when ``deferred`` (a
        file holds no tensor without a shape, as the JAX package writes
        only a parameter's data)."""
        keep = set(self.state_dict(keep_vars=True))
        out = dict(self.named_parameters())
        out.update((n, b) for n, b in self.named_buffers() if n in keep)
        if not deferred:
            out = {n: t for n, t in out.items() if not is_deferred(t)}
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
        own = self._saved(deferred=True)
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
            if is_deferred(t):
                # loading finishes a deferred init at the loaded shape,
                # as the JAX ``Parameter.set_data`` does
                t.__dict__.pop("_mx_deferred", None)
                materialize(t, value.shape)
            if tuple(value.shape) != tuple(t.shape):
                raise MXNetError(f"{name}: shape {tuple(value.shape)} in "
                                 f"'{filename}', {tuple(t.shape)} in the "
                                 "block")
            if cast_dtype and value.dtype != t.dtype:
                t.data = value.to(t.device)
            else:
                t.copy_(value)
            mark_initialized(t)
        return self

    def setattr(self, name: str, value):
        """Set an attribute on every parameter (``grad_req``, ``lr_mult``,
        ``wd_mult``)."""
        for p in self.collect_params().values():
            if name == "grad_req":
                set_grad_req(p, value)
            else:
                setattr(p, name, value)

    def hybridize(self, active: bool = True, **kwargs):
        """On a plain block: hybridize each child (the JAX
        ``Block.hybridize``); a torch container's children are reached
        through it."""
        for child in self.children():
            _hybridize_tree(child, active, **kwargs)


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


# One process-wide lock for captures: a capture's warm run and the
# capture itself hold it, so a background ``warmup()`` and a first call
# on another thread never capture at once (the counterpart of the JAX
# ``_TRACE_LOCK``).  Replays do not take it.
_CAPTURE_LOCK = threading.RLock()


def trace_guard():
    """The global capture lock (the JAX ``trace_guard``).  A capture here
    swaps no state, so a reader of parameters needs it only to wait for
    a capture in flight."""
    return _CAPTURE_LOCK


def pipeline_atoms(block) -> List[nn.Module]:
    """``block`` flattened into the ordered units that pipeline stages
    are cut from (``parallel.pipeline.split_stages``): its direct
    children in registration order, ``HybridSequential`` /
    ``nn.Sequential`` children recursed into (their forward is the fold
    of their children); any other child is one atom, and a block with no
    children is its own.  Whether the top level's children fold to
    ``block``'s forward is checked numerically by ``ShardedTrainer``
    before its first pipelined step."""
    def rec(b):
        if isinstance(b, nn.Sequential):
            return [a for c in b.children() for a in rec(c)]
        return [b]

    atoms = [a for c in block.children() for a in rec(c)]
    return atoms if atoms else [block]


def _hybridize_tree(mod, active, **kwargs):
    """``mod.hybridize(active, **kwargs)``, or into its children when it
    is a torch container without one (``nn.ModuleList``)."""
    if isinstance(mod, Block):
        mod.hybridize(active, **kwargs)
    else:
        for child in mod.children():
            _hybridize_tree(child, active, **kwargs)


_NP_DTYPES: Dict[Any, torch.dtype] = {}


def _leaf_dtype(x) -> torch.dtype:
    if torch.is_tensor(x):
        return x.dtype
    dt = _NP_DTYPES.get(x.dtype)
    if dt is None:
        dt = _NP_DTYPES[x.dtype] = torch.from_numpy(np.empty(0, x.dtype)).dtype
    return dt


_DTYPE_NAME: Dict[Any, str] = {}


def _spec(x) -> tuple:
    """``(shape, dtype)`` of a tensor or numpy leaf, as the signature
    and the retrace guard read it."""
    name = _DTYPE_NAME.get(x.dtype)
    if name is None:
        name = _DTYPE_NAME[x.dtype] = \
            str(_leaf_dtype(x)).replace("torch.", "")
    return (tuple(x.shape), name)


def _is_leaf(o) -> bool:
    return torch.is_tensor(o) or isinstance(o, np.ndarray)


def _flatten(obj):
    """Flatten nested (list/tuple/dict) structures of tensors and numpy
    arrays; any other value is a static part of the tree."""
    leaves: List[Any] = []

    def rec(o):
        if _is_leaf(o):
            leaves.append(o)
            return ("@",)
        if o is None:
            return (None,)
        if isinstance(o, (list, tuple)):
            return (type(o).__name__, [rec(x) for x in o])
        if isinstance(o, dict):
            return ("dict", [(k, rec(v)) for k, v in sorted(o.items())])
        return ("#", o)

    return leaves, rec(obj)


def _count_leaves(tree) -> int:
    tag = tree[0]
    if tag == "@":
        return 1
    if tag in ("list", "tuple"):
        return sum(_count_leaves(t) for t in tree[1])
    if tag == "dict":
        return sum(_count_leaves(t) for _, t in tree[1])
    return 0


def _unflatten(tree, leaves):
    it = iter(leaves)

    def rec(t):
        tag = t[0]
        if tag == "@":
            return next(it)
        if tag is None:
            return None
        if tag == "list":
            return [rec(x) for x in t[1]]
        if tag == "tuple":
            return tuple(rec(x) for x in t[1])
        if tag == "dict":
            return {k: rec(v) for k, v in t[1]}
        return t[1]

    return rec(tree)


def _pad_args(bucketer: ShapeBucketer, args):
    """Pad the tensor and numpy leaves of ``args`` up to their bucket
    shapes with ``bucketer.pad_value`` (the JAX ``_pad_args``).  Returns
    ``(padded_args, unpad_fn)``; ``unpad_fn`` (None when nothing padded)
    slices output leaves back: for every axis this call padded, an
    output axis of exactly the padded size is cut back to the original.
    When two input leaves pad the same axis to different (orig, padded)
    sizes the mapping is ambiguous and that axis stays padded."""
    padded_axes: Dict[int, set] = {}

    def pad_leaf(x):
        shape = tuple(x.shape)
        target = bucketer.bucket_shape(shape)
        if target == shape:
            return x
        for a in bucketer.spec:
            if a < len(shape) and shape[a] != target[a]:
                padded_axes.setdefault(a, set()).add((shape[a], target[a]))
        if torch.is_tensor(x):
            out = x.new_full(target, bucketer.pad_value)
            out[tuple(slice(0, n) for n in shape)] = x
            return out
        return np.pad(np.asarray(x), [(0, t - n) for n, t in
                                      zip(shape, target)],
                      constant_values=bucketer.pad_value)

    def rec(o):
        if _is_leaf(o):
            return pad_leaf(o)
        if isinstance(o, (list, tuple)):
            return type(o)(rec(v) for v in o)
        if isinstance(o, dict):
            return {k: rec(v) for k, v in o.items()}
        return o

    new_args = rec(args)
    cut_axes = {a: next(iter(pairs))
                for a, pairs in padded_axes.items() if len(pairs) == 1}
    if not cut_axes:
        return (new_args, None) if padded_axes else (args, None)

    def unpad(out):
        def cut(o):
            if _is_leaf(o):
                shape = tuple(o.shape)
                sl = [slice(None)] * len(shape)
                hit = False
                for a, (orig, pad) in cut_axes.items():
                    if a < len(shape) and shape[a] == pad:
                        sl[a] = slice(0, orig)
                        hit = True
                return o[tuple(sl)] if hit else o
            if isinstance(o, (list, tuple)):
                return type(o)(cut(v) for v in o)
            if isinstance(o, dict):
                return {k: cut(v) for k, v in o.items()}
            return o

        return cut(out)

    return new_args, unpad


class _Graph:
    """One captured signature: its graph (two for a recorded one), the
    static inputs it reads, the outputs it writes and the kernel launches
    one replay makes.  A donated leaf's static slot is None: the graph
    does not hold the caller's buffer, whose address is in the
    signature, and reads and writes whichever tensor the caller passes
    there."""

    __slots__ = ("fwd", "bwd", "static", "out_tree", "out_static", "keep",
                 "launches", "bwd_launches", "diff", "grad_out", "grads",
                 "n_in", "version", "device")

    def __init__(self, fwd, static, out_tree, out_static, keep, launches,
                 device):
        self.fwd = fwd
        self.static = static
        self.out_tree = out_tree
        self.out_static = out_static
        # for each output, the donated leaf it is (returned as the
        # caller's own tensor), or None (a clone is returned)
        self.keep = keep
        self.launches = launches
        self.device = device
        self.bwd = None
        self.bwd_launches: Dict[str, int] = {}
        self.diff: List[int] = []     # outputs that carry a gradient
        self.grad_out: List[torch.Tensor] = []
        self.grads: List[Optional[torch.Tensor]] = []
        self.n_in: List[int] = []     # leaves whose gradient is returned
        self.version = 0              # forward replays so far


def _grad_state(state) -> List[torch.Tensor]:
    """The state tensors that take a gradient, each once (a tied
    parameter sits in two modules)."""
    return list({id(t): t for t in state if t.requires_grad}.values())


class _GraphedStep(torch.autograd.Function):
    """A recorded signature as one node of the tape: the forward replays
    the forward graph, the backward the backward graph."""

    @staticmethod
    def forward(ctx, op, g, *flat):
        outs = op._replay(g, flat[:len(g.static)])
        ctx.op, ctx.g, ctx.version = op, g, g.version
        ctx.n_flat = len(flat)
        diff = set(g.diff)
        frozen = [o for i, o in enumerate(outs)
                  if i not in diff and torch.is_tensor(o)]
        if frozen:
            ctx.mark_non_differentiable(*frozen)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gouts):
        g = ctx.g
        if ctx.version != g.version:
            raise MXNetError(
                f"hybridize: {type(ctx.op.block).__name__}'s captured "
                "forward was replayed again before the backward of an "
                "earlier call; call backward before the next forward of "
                "the same signature")
        grads = ctx.op._replay_backward(g, gouts)
        res: List[Optional[torch.Tensor]] = [None] * (2 + ctx.n_flat)
        n_leaves = len(g.static)
        for j, i in enumerate(g.n_in):
            res[2 + i] = grads[j]
        for j, grad in enumerate(grads[len(g.n_in):]):
            res[2 + n_leaves + j] = grad
        return tuple(res)


class _CachedOp:
    """The graph executor of one hybridized block (module docstring; the
    JAX ``_CachedOp``)."""

    def __init__(self, block: "HybridBlock"):
        self.block = block
        self._graphs: Dict[tuple, _Graph] = {}
        self._traced: set = set()
        self._calls = 0
        self._dicts = None            # the modules' tensor dicts, read per call
        self._specs = None            # (addresses, specs) of the state
        self._donated_at: Dict[str, tuple] = {}   # by argument tree
        self._pool = None             # shared by the inference graphs
        self._streams: Dict[tuple, Any] = {}
        self._event = None            # behind the last replay's outputs
        self._lock = threading.Lock()  # one replay's copies and launches

    def clear(self):
        if self._graphs and torch.cuda.is_available():
            torch.cuda.synchronize()
        self._graphs.clear()
        self._traced.clear()
        self._calls = 0
        self._dicts = None
        self._specs = None
        self._donated_at.clear()
        self._pool = None

    # -- signatures --------------------------------------------------------
    def _state(self):
        """The block's parameters and buffers as they are bound now (read
        from each module's dicts on every call, so a rebinding of any
        kind is seen) and their storage addresses.  A module that gains
        a tensor, or a child replaced, after the first call needs
        ``hybridize()`` again, as the JAX block's parameter list does."""
        dicts = self._dicts
        if dicts is None:
            mods = list(self.block.modules())
            dicts = self._dicts = [d for d in [m._parameters for m in mods]
                                   + [m._buffers for m in mods] if d]
        tensors = [t for d in dicts for t in d.values() if t is not None]
        return tensors, tuple([t.data_ptr() for t in tensors])

    def _signature(self, args, training: bool, recording: bool):
        tensors, ptrs = self._state()
        known = self._specs
        if known is None or known[0] != ptrs:
            known = self._specs = (ptrs, tuple(_spec(t) for t in tensors))
        dev = tensors[0].device if tensors else None
        leaves, tree = _flatten(args)
        if dev is None:
            dev = next((x.device for x in leaves if torch.is_tensor(x)),
                       torch.device("cpu"))
        rtree = repr(tree)
        where = None
        if dev.type == "cuda":
            # a graph reads the storage it was captured over
            idx = self._donated_at.get(rtree)
            if idx is None:
                idx = self._donated_at[rtree] = \
                    tuple(sorted(self._donated(tree)))
            where = (ptrs, tuple([leaves[i].data_ptr()
                                  if torch.is_tensor(leaves[i]) else None
                                  for i in idx]))
        key = (training, rtree, len(tensors), recording, str(dev), where)
        sig = (key, known[1] + tuple(_spec(x) for x in leaves))
        return sig, leaves, tree, dev, tensors

    def _note_trace(self, sig, n_calls: Optional[int] = None):
        """Record a newly captured signature and let the retrace guard
        (``analysis.retrace``) flag unbounded signature growth."""
        self._traced.add(sig)
        _retrace.on_trace(
            type(self.block).__name__, sig, self._traced, n_calls=n_calls,
            bucketed=self.block._bucketer is not None)

    def _miss(self, sig, leaves, tree, training, recording, dev, state,
              warmup: bool, n_calls=None):
        # the capture is the port's compile: hybridize.compile_seconds is
        # its timer, and the span carries the same wall time onto the
        # timeline (warmup=True for a warmup's capture, as in JAX)
        with _tr.span("hybridize.compile", timer="hybridize.compile_seconds",
                      block=type(self.block).__name__,
                      **({"warmup": True} if warmup else {})):
            if dev.type == "cuda":
                self._capture(sig, leaves, tree, training, recording, dev,
                              state)
        if _tel._ENABLED:
            _tel.inc("hybridize.cache_misses")
            if warmup:
                _tel.inc("hybridize.warmup_compiles")
        self._note_trace(sig, n_calls=n_calls)

    # -- calls -------------------------------------------------------------
    def warmup(self, args, training: bool = False) -> bool:
        """Capture the signature of ``args`` (in training mode, as under
        ``autograd.record()``, with ``training``) without touching the
        model's state: the warm run's changes to buffers and to the
        generator are put back.  Returns True when a signature was new."""
        if self.block._bucketer is not None:
            args, _ = _pad_args(self.block._bucketer, args)
        recording = bool(training)
        sig, leaves, tree, dev, state = self._signature(args, training,
                                                        recording)
        if sig in self._traced:
            return False
        with _CAPTURE_LOCK:
            if sig in self._traced:
                return False
            self._miss(sig, leaves, tree, training, recording, dev, state,
                       warmup=True)
        return True

    def __call__(self, args, kwargs):
        if kwargs:
            raise MXNetError("hybridized blocks do not support kwargs in "
                             "forward")
        self._calls += 1
        bucketer = self.block._bucketer
        unpad = None
        if bucketer is not None:
            args, unpad = _pad_args(bucketer, args)
        training = _ag.is_training()
        recording = _ag.is_recording() and torch.is_grad_enabled()
        sig, leaves, tree, dev, state = self._signature(args, training,
                                                        recording)
        if sig not in self._traced:
            with _CAPTURE_LOCK:
                if sig not in self._traced:
                    self._miss(sig, leaves, tree, training, recording, dev,
                               state, warmup=False, n_calls=self._calls)
                elif _tel._ENABLED:
                    _tel.inc("hybridize.cache_hits")
        elif _tel._ENABLED:
            _tel.inc("hybridize.cache_hits")
        if dev.type != "cuda":
            if recording:
                out = self.block.forward(*args)
            else:
                with torch.no_grad():
                    out = self.block.forward(*args)
        else:
            g = self._graphs[sig]
            if g.bwd is not None:
                flat = list(leaves) + _grad_state(state)
                out = _unflatten(g.out_tree,
                                 list(_GraphedStep.apply(self, g, *flat)))
            else:
                with torch.no_grad():
                    out = _unflatten(g.out_tree, self._replay(g, leaves))
        return unpad(out) if unpad is not None else out

    # -- capture -----------------------------------------------------------
    def _capture_stream(self, dev):
        """This thread's capture stream for this block: the warm run and
        the capture run on it, so what the kernels keep per stream (the
        batch-norm statistics workspace, cuBLAS's) is made by the warm
        run and never inside a graph, and differs between blocks."""
        key = (threading.get_ident(), dev.index)
        cs = self._streams.get(key)
        if cs is None:
            cs = self._streams[key] = torch.cuda.Stream(device=dev)
        return cs

    def _donated(self, tree) -> set:
        """Leaf indices of the top-level arguments in ``donate_args``."""
        donate = self.block._donate_args
        if not donate:
            return set()
        idx, off = set(), 0
        for pos, sub in enumerate(tree[1]):
            n = _count_leaves(sub)
            if pos in donate:
                idx.update(range(off, off + n))
            off += n
        return idx

    def _save_state(self, dev):
        """The buffers and the generator, as the warm run finds them."""
        gen = _random.generator(dev)
        return ([(b, b.clone()) for b in self.block.buffers()],
                gen, gen.get_state())

    @staticmethod
    def _restore_state(saved):
        bufs, gen, gstate = saved
        with torch.no_grad():
            for b, v in bufs:
                b.copy_(v)
        gen.set_state(gstate)

    def _drop_stale(self, sig):
        """Drop the graphs captured over other parameter or buffer
        storage than ``sig``'s (before a ``cast``, a load with
        ``cast_dtype``, a rebinding): they would replay only if that
        storage came back, and hold their memory until then."""
        ptrs = sig[0][5][0]
        stale = [k for k in self._graphs if k[0][5][0] != ptrs]
        for k in stale:
            del self._graphs[k]
            self._traced.discard(k)
        if not self._graphs:
            self._pool = None

    def _capture(self, sig, leaves, tree, training, recording, dev, state):
        donated = set() if recording else self._donated(tree)
        self._drop_stale(sig)
        with torch.inference_mode(False), torch.cuda.device(dev):
            cur = torch.cuda.current_stream(dev)
            static = []
            for i, x in enumerate(leaves):
                if i in donated:
                    if not (torch.is_tensor(x) and x.device == dev and
                            x.is_contiguous()):
                        raise MXNetError(
                            f"hybridize: {type(self.block).__name__}'s "
                            f"donated argument leaf #{i} must be a "
                            f"contiguous tensor on {dev}: the graph reads "
                            "and writes it in place")
                    static.append(x)      # the donated buffer itself
                    continue
                src = x if torch.is_tensor(x) else torch.as_tensor(x)
                st = torch.empty(src.shape, dtype=src.dtype, device=dev)
                with torch.no_grad():
                    st.copy_(src)
                if recording and torch.is_tensor(x) and x.requires_grad:
                    st.requires_grad_(True)
                static.append(st)
            cs = self._capture_stream(dev)
            cs.wait_stream(cur)
            if recording:
                g = self._capture_recorded(static, tree, training, dev, cs,
                                           state)
            else:
                g = self._capture_inference(static, tree, training, dev, cs,
                                            donated)
            cur.wait_stream(cs)
        self._graphs[sig] = g

    def _graph_call(self, g, fn, cs, pool, launches):
        """Capture ``fn()`` into ``g`` on ``cs``; a forward that cannot be
        captured raises :class:`MXNetError` with the capture ended."""
        # no cyclic garbage collection inside a capture: a dead block's
        # graph destroyed there would invalidate it
        gc_was = gc.isenabled()
        gc.disable()
        try:
            return self._graph_call_nogc(g, fn, cs, pool, launches)
        finally:
            if gc_was:
                gc.enable()

    def _graph_call_nogc(self, g, fn, cs, pool, launches):
        with torch.cuda.stream(cs), _kreg.recording(cs) as counts:
            g.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                out = fn()
            except BaseException as err:
                self._end_failed_capture(g, pool, cs)
                raise MXNetError(
                    f"hybridize: {type(self.block).__name__}'s forward "
                    f"cannot be captured as a CUDA graph ({type(err).__name__}"
                    f": {err}); a captured forward must not read a card "
                    "tensor back to the host (.item(), .tolist(), .cpu()) "
                    "or synchronize") from err
            try:
                g.capture_end()
            except Exception as err:
                self._end_failed_capture(None, pool, cs)
                raise MXNetError(
                    f"hybridize: capturing {type(self.block).__name__}'s "
                    f"forward failed: {err}") from err
        launches.update(counts)
        return out

    def _end_failed_capture(self, g, pool, cs):
        """Leave no trace of a capture that an error invalidated.  Its
        ``capture_end`` raises before it stops routing the stream's
        allocations into ``pool`` and before the generators it holds
        leave their capturing state, and the pool refuses later
        captures: so the routing is ended here, the block takes a new
        pool, and one small capture that draws from both generators
        (the port's and torch's default, registered with every graph)
        runs to its end, which returns them to normal draws."""
        if g is not None:
            try:
                g.capture_end()
            except Exception:  # noqa: BLE001 — the first error wins
                pass
        try:
            torch._C._cuda_endAllocateToPool(cs.device.index, pool)
        except Exception:  # noqa: BLE001 — capture_end had ended it
            pass
        if pool == self._pool:
            self._pool = None
        reset = self._new_graph(cs.device)
        with torch.cuda.stream(cs):
            reset.capture_begin(pool=torch.cuda.graph_pool_handle(),
                                capture_error_mode="thread_local")
            torch.rand(1, device=cs.device,
                       generator=_random.generator(cs.device))
            torch.rand(1, device=cs.device)
            reset.capture_end()

    def _new_graph(self, dev):
        g = torch.cuda.CUDAGraph()
        g.register_generator_state(_random.generator(dev))
        return g

    def _capture_inference(self, static, tree, training, dev, cs, donated):
        block = self.block
        with torch.cuda.stream(cs), _ag.pause(train_mode=training):
            saved = self._save_state(dev)
            warm = [x.clone() if i in donated else x
                    for i, x in enumerate(static)]
            block.forward(*_unflatten(tree, warm))
            del warm
            self._restore_state(saved)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        args = _unflatten(tree, static)
        own = [(i, static[i]) for i in sorted(donated)]

        def run():
            with _ag.pause(train_mode=training):
                return self._land_donated(block.forward(*args), args)

        launches: Dict[str, int] = {}
        graph = self._new_graph(dev)
        out = self._graph_call(graph, run, cs, self._pool, launches)
        out_leaves, out_tree = _flatten(out)
        keep = [next((i for i, d in own if o is d), None)
                for o in out_leaves]
        out_leaves = [None if k is not None else o
                      for o, k in zip(out_leaves, keep)]
        static = [None if i in donated else x for i, x in enumerate(static)]
        return _Graph(graph, static, out_tree, out_leaves, keep, launches,
                      dev)

    def _land_donated(self, out, args):
        """Where the block returns new tensors for a donated argument
        (an output item with its tree, shapes and dtypes), copy them into
        the donated buffers and return those: the caller that rebinds to
        the output keeps passing the same buffers, and so replays the
        same graph."""
        donate = self.block._donate_args
        if not donate:
            return out
        items = list(out) if isinstance(out, tuple) else [out]
        for pos in donate:
            if pos >= len(args):
                continue
            d_leaves, d_tree = _flatten(args[pos])
            for j, item in enumerate(items):
                i_leaves, i_tree = _flatten(item)
                if i_tree != d_tree or len(i_leaves) != len(d_leaves) or \
                        any(_spec(a) != _spec(b)
                            for a, b in zip(i_leaves, d_leaves)):
                    continue
                for a, b in zip(i_leaves, d_leaves):
                    if a is not b:
                        b.copy_(a)
                items[j] = args[pos]
                break
        return tuple(items) if isinstance(out, tuple) else items[0]

    def _aliased_forward(self, aliases, args):
        """``block.forward(*args)`` with each parameter replaced by its
        alias (the same storage, a leaf of its own).  A parameter's
        gradient accumulator was made on the stream of its first eager
        use, and a backward that reaches it from a capture stream makes
        that stream wait on it, which a capture refuses; an alias's
        accumulator is made inside the capture."""
        swapped = []
        for mod in self.block.modules():
            for name, p in mod._parameters.items():
                if p is not None and id(p) in aliases:
                    mod._parameters[name] = aliases[id(p)]
                    swapped.append((mod, name, p))
        try:
            return self.block.forward(*args)
        finally:
            for mod, name, p in swapped:
                mod._parameters[name] = p

    def _capture_recorded(self, static, tree, training, dev, cs, state):
        params = _grad_state(state)
        aliases = {id(p): p.detach().requires_grad_() for p in params}
        n_in = [i for i, x in enumerate(static) if x.requires_grad]
        inputs = [static[i] for i in n_in] + \
            [aliases[id(p)] for p in params]
        args = _unflatten(tree, static)
        with torch.cuda.stream(cs), _ag.record(train_mode=training):
            saved = self._save_state(dev)
            outs = [o for o in _flatten(self._aliased_forward(aliases,
                                                              args))[0]
                    if torch.is_tensor(o) and o.requires_grad]
            if outs:
                torch.autograd.grad(outs, inputs,
                                    [torch.ones_like(o) for o in outs],
                                    allow_unused=True)
            del outs
            self._restore_state(saved)
        pool = torch.cuda.graph_pool_handle()   # this pair's own

        def forward():
            with _ag.record(train_mode=training):
                return self._aliased_forward(aliases, args)

        launches: Dict[str, int] = {}
        fwd = self._new_graph(dev)
        out = self._graph_call(fwd, forward, cs, pool, launches)
        out_leaves, out_tree = _flatten(out)
        diff = [i for i, o in enumerate(out_leaves)
                if torch.is_tensor(o) and o.requires_grad]
        with torch.cuda.stream(cs):
            grad_out = [torch.empty_like(out_leaves[i]) for i in diff]
        heads = [out_leaves[i] for i in diff]
        g = _Graph(fwd, static, out_tree,
                   [o.detach() if torch.is_tensor(o) else o
                    for o in out_leaves],
                   [None] * len(out_leaves), launches, dev)
        if not heads:        # nothing to differentiate: a forward alone
            return g

        def backward():
            return list(torch.autograd.grad(heads, inputs, grad_out,
                                            allow_unused=True))

        g.bwd = self._new_graph(dev)
        g.grads = self._graph_call(g.bwd, backward, cs, pool, g.bwd_launches)
        g.diff, g.grad_out, g.n_in = diff, grad_out, n_in
        return g

    # -- replay ------------------------------------------------------------
    def _replay(self, g: _Graph, leaves):
        """Copy ``leaves`` into the graph's static inputs (a donated
        leaf is one already), replay, and return the outputs: clones,
        or the donated buffers themselves."""
        with self._lock, torch.no_grad():
            cur = torch.cuda.current_stream(g.device)
            if self._event is not None:
                cur.wait_event(self._event)
            for st, x in zip(g.static, leaves):
                if st is not None and x is not st:
                    st.copy_(x if torch.is_tensor(x) else torch.as_tensor(x))
            g.fwd.replay()
            outs = [leaves[k] if k is not None else
                    o.clone() if torch.is_tensor(o) else o
                    for o, k in zip(g.out_static, g.keep)]
            g.version += 1
            if self._event is None:
                self._event = torch.cuda.Event()
            self._event.record(cur)
        _kreg.count_launches(g.launches)
        return outs

    def _replay_backward(self, g: _Graph, gouts):
        with self._lock, torch.no_grad():
            cur = torch.cuda.current_stream(g.device)
            cur.wait_event(self._event)
            for j, i in enumerate(g.diff):
                if gouts[i] is None:
                    g.grad_out[j].zero_()
                else:
                    g.grad_out[j].copy_(gouts[i])
            g.bwd.replay()
            grads = [x.clone() if x is not None else None for x in g.grads]
            self._event.record(cur)
        _kreg.count_launches(g.bwd_launches)
        return grads


class WarmupHandle:
    """A background ``warmup()`` in flight: its captures run on a thread
    of their own; ``wait()`` before timing."""

    def __init__(self, fn, device=None):
        self.result = None
        self.error: Optional[BaseException] = None
        # the spawning thread's correlation rides onto the warmup thread,
        # so its capture spans stay attributed to the owner
        self._corr = _tr.capture()
        self._thread = threading.Thread(target=self._run, args=(fn, device),
                                        name="mx-jit-warmup", daemon=True)
        self._thread.start()

    def _run(self, fn, device):
        _tr.attach(self._corr)
        try:
            if device is not None and device.type == "cuda":
                with torch.cuda.device(device):
                    self.result = fn()
            else:
                self.result = fn()
        except BaseException as e:  # noqa: BLE001 — rethrown at wait()
            self.error = e

    def done(self) -> bool:
        return not self._thread.is_alive()

    def wait(self, timeout: Optional[float] = None):
        """Join the warmup thread; rethrows its error, returns the number
        of signatures it captured."""
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise MXNetError(f"warmup still running after {timeout}s")
        if self.error is not None:
            raise self.error
        return self.result


_EAGER = threading.local()


@contextlib.contextmanager
def eager_calls():
    """Run hybridized blocks eagerly on this thread: a caller that
    traces the forward into a program of its own (``ShardedTrainer``'s
    step, on parameters it swaps in) calls the block's forward, not its
    graphs."""
    prev = getattr(_EAGER, "on", False)
    _EAGER.on = True
    try:
        yield
    finally:
        _EAGER.on = prev


def _clone_tree(obj):
    """``obj`` with every tensor cloned."""
    leaves, tree = _flatten(obj)
    return _unflatten(tree, [x.clone() if torch.is_tensor(x) else x
                             for x in leaves])


def _is_shape(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(i, int) for i in x)


def _warmup_leaf(x, device):
    """One warmup input leaf: a tensor as it is, a numpy array as a tensor
    on ``device``, a shape tuple (zeros, float32) or a ``(shape, dtype)`` pair (zeros of a
    torch dtype or a numpy dtype name) on ``device``; any other tuple
    recurses (a nested state tree, the decode path's cache)."""
    if torch.is_tensor(x):
        return x
    if isinstance(x, np.ndarray):
        return torch.as_tensor(x, device=device)
    if isinstance(x, tuple) and x and _is_shape(x):
        return torch.zeros(x, dtype=torch.float32, device=device)
    if isinstance(x, tuple) and len(x) == 2 and _is_shape(x[0]) and \
            not isinstance(x[1], tuple):
        dt = x[1] if isinstance(x[1], torch.dtype) else \
            _leaf_dtype(np.empty(0, np.dtype(x[1])))
        return torch.zeros(x[0], dtype=dt, device=device)
    if isinstance(x, tuple) and x:
        return tuple(_warmup_leaf(e, device) for e in x)
    raise MXNetError(
        f"warmup sample leaf must be an array, a shape tuple, a (shape, "
        f"dtype) pair, or a tuple tree of those; got {x!r}")


def _normalize_warmup_samples(samples, device) -> List[tuple]:
    """The ``warmup()`` argument as a list of argument tuples."""
    def one(s) -> tuple:
        if isinstance(s, tuple) and s and not _is_shape(s) and not (
                len(s) == 2 and _is_shape(s[0])
                and not isinstance(s[1], tuple)):
            return tuple(_warmup_leaf(e, device) for e in s)
        return (_warmup_leaf(s, device),)

    if isinstance(samples, list):
        return [one(s) for s in samples]
    return [one(samples)]


def _expand_sample(bucketer: ShapeBucketer, sample: tuple) -> List[tuple]:
    """Every bucket combination for ``sample`` (zeros of each leaf's
    dtype and device): the warmup's coverage set."""
    ref = max((tuple(x.shape) for x in sample), key=len)
    out = []
    for shape in bucketer.expand(ref):
        combo = {a: shape[a] for a in bucketer.spec if a < len(shape)}
        leaves = []
        for x in sample:
            sh = list(x.shape)
            for a, size in combo.items():
                if a < len(sh):
                    sh[a] = size
            if torch.is_tensor(x):
                leaves.append(x.new_zeros(sh))
            else:
                leaves.append(np.zeros(sh, x.dtype))
        out.append(tuple(leaves))
    return out


class HybridBlock(Block):
    """A block whose forward can be captured and replayed as a CUDA graph
    (:meth:`hybridize`; module docstring)."""

    _active = False
    _cached_op: Optional[_CachedOp] = None
    _warmed_up = False
    _bucketer: Optional[ShapeBucketer] = None
    _donate_args: Optional[Tuple[int, ...]] = None

    def hybridize(self, active: bool = True, static_alloc: bool = False,
                  static_shape: bool = False, inline_limit: int = 2,
                  forward_bulk_size: Optional[int] = None,
                  backward_bulk_size: Optional[int] = None,
                  bucketer: Optional[ShapeBucketer] = None,
                  donate_args: Optional[Tuple[int, ...]] = None, **kwargs):
        """Capture this block's forward (module docstring), with the JAX
        signature (``mxnet_tpu/gluon/block.py:826``).  ``static_alloc``,
        ``static_shape`` and the bulk sizes are accepted: a graph is
        statically planned.  Clears the captured signatures; the
        children's caches are turned off, as they are inside this
        block's graph.

        ``bucketer`` (a ``jit.ShapeBucketer`` or its spec dict) pads the
        caller's inputs up to a bucket and slices the outputs back, so
        drifting shapes capture at most ``len(buckets)`` graphs.

        ``donate_args`` marks top-level argument positions whose tensors
        (contiguous, on the block's device) the graph reads and writes in
        place (inference only): their addresses are part of the
        signature, so they are never copied, and other buffers are a
        signature of their own.  Where the block returns new tensors for
        such an argument the graph copies them into the caller's buffers
        and returns those (the decode path's cache).  A caller rebinds
        to what a call returns, and passes it back."""
        self._active = active
        if isinstance(bucketer, dict):
            bucketer = ShapeBucketer(bucketer)
        self._bucketer = bucketer
        self._donate_args = tuple(donate_args) if donate_args else None
        self._flags = dict(static_alloc=static_alloc,
                           static_shape=static_shape, **kwargs)
        if self._cached_op is not None:
            self._cached_op.clear()
        self._warmed_up = False
        for mod in self.modules():
            if mod is not self and isinstance(mod, HybridBlock):
                mod._deactivate()
        return self

    def _deactivate(self):
        self._active = False
        self._bucketer = None
        self._donate_args = None
        if self._cached_op is not None:
            self._cached_op.clear()
        self._warmed_up = False

    def optimize_for(self, x, *args, backend=None, clear=False, **kwargs):
        """Hybridize and run once on the given input (the JAX
        ``optimize_for``; no backend partitioning)."""
        self.hybridize(True, **kwargs)
        return self(x, *args)

    def _device_hint(self, samples=None) -> torch.device:
        for t in list(self.parameters()) + list(self.buffers()):
            return t.device
        leaves, _ = _flatten(samples)
        for x in leaves:
            if torch.is_tensor(x):
                return x.device
        return torch.device("cuda", 0) if torch.cuda.is_available() \
            else torch.device("cpu")

    def warmup(self, samples, train_mode: bool = False,
               background: bool = False):
        """Capture this hybridized block's signatures ahead of the first
        real call (the JAX ``warmup``).  ``samples`` is one sample or a
        list; each is an argument tuple of tensors / arrays, a single
        one, a shape tuple (zeros, float32) or a ``(shape, dtype)`` pair.
        With a bucketer attached every sample expands over the bucket
        grid.  Signatures already captured are skipped, so a later call
        of a warmed signature adds no ``hybridize.cache_misses``.
        ``train_mode=True`` captures the recorded (training) pair of
        graphs.  ``background=True`` returns a :class:`WarmupHandle` at
        once and captures on its own thread and stream.  Returns the
        number of new captures."""
        if not self._active:
            raise MXNetError("warmup() requires hybridize() first")
        dev = self._device_hint(samples)
        norm = _normalize_warmup_samples(samples, dev)
        if not self._warmed_up:
            # the eager first call, as the first real call would make it,
            # on copies: a warmup writes to none of the samples (a decode
            # entry's are its live caches)
            with torch.no_grad():
                super().__call__(*_clone_tree(norm[0]))
            self._warmed_up = True
        if self._cached_op is None:
            self._cached_op = _CachedOp(self)
        if self._bucketer is not None:
            expanded: List[tuple] = []
            for s in norm:
                expanded.extend(_expand_sample(self._bucketer, s))
            norm = expanded
        cached_op = self._cached_op
        # every warmup run gets its own correlation id, so the spans it
        # produces (even on the background thread) answer "which warmup
        # captured this"
        wid = _tr.next_id("warmup")

        def run():
            with _tr.correlate(warmup=wid), \
                    _tr.span("jit.warmup", timer="jit.warmup_seconds",
                             timer_on_error=True, block=type(self).__name__):
                return sum(1 for s in norm if cached_op.warmup(s, train_mode))

        if background:
            return WarmupHandle(run, dev)
        return run()

    def __call__(self, *args, **kwargs):
        if not self._active or getattr(_EAGER, "on", False):
            return super().__call__(*args, **kwargs)
        if not self._warmed_up:
            # the first call runs eagerly, as the JAX block's does
            out = super().__call__(*args, **kwargs)
            self._warmed_up = True
            return out
        if self._cached_op is None:
            self._cached_op = _CachedOp(self)
        for hook in self._forward_pre_hooks.values():
            res = hook(self, args)
            if res is not None:
                args = res if isinstance(res, tuple) else (res,)
        out = self._cached_op(args, kwargs)
        for hook in self._forward_hooks.values():
            res = hook(self, args, out)
            if res is not None:
                out = res
        return out
