"""The trainer of the port: ``ShardedTrainer`` on one device.

The 1-device subset of ``mxnet_tpu/parallel/trainer.py``.  A step mirrors
the JAX package's ``loss_of`` and ``apply_update``: ``loss =
mean(loss_fn(net(*x), y))``, the backward pass, then the optimizer
update through one of two adapters:

* :class:`_ArenaOptAdapter` (the default for exact ``SGD`` / ``NAG`` /
  ``Adam`` with f32 parameters and uniform lr/wd multipliers): weight
  decay and clipping are folded into each gradient, ONE launch of the
  flat-arena kernel (``kernels/opt_arena.py``) updates every element and
  its state arenas, and ``p += delta`` is applied per leaf;
* :class:`_FusedOptAdapter` (``multi_tensor=True``, any registry
  optimizer): parameters that share shape, dtype, state structure, lr /
  wd multipliers and state shapes form a group, and ONE
  ``torch.func.vmap`` of the optimizer's own ``update`` updates a group,
  so norm-based optimizers (LAMB, LARS, LANS, LBSGD) keep one norm per
  tensor.  A group's parameters and states are views into one stacked
  tensor each, set up once (``param.data = stack[j]``), and the gradient
  arena is laid out group by group, so a group's gradients are one view
  of the arena: a step stacks and unstacks nothing.  A group of one runs
  the plain update, as does every tensor of an optimizer that is not
  ``vmappable`` (``optimizer`` module docstring);
* :class:`_OptAdapter`: the optimizer's per-parameter ``update`` (AdamW,
  or ``fused_opt="off"``).

The learning rate of update ``k`` is ``lr_scheduler(k)`` when the trainer
(or its optimizer) has a schedule, read on the host after the step count
rises and handed to the update (the arena kernel too) as a host scalar.
``grad_accum=k`` runs ``k`` calls of :meth:`ShardedTrainer.step` a
window: each micro-batch's gradients are unscaled in f32 and summed into
an f32 accumulator of the arena's layout, in the JAX package's order
(``acc = g1; acc = acc + g2; ...``); the k-th call writes ``acc / k``
into the gradient arena, and the update, the finite check and the
loss-scale rule read that.  The buffers update at every micro-batch.
:meth:`ShardedTrainer.save_states` / :meth:`ShardedTrainer.load_states`
write and read the JAX trainer's ``.npz`` (``param/<name>``,
``aux/<name>``, ``opt/<i>`` in per-parameter leaf order or the arena's
state arenas stripped of padding, ``meta/t``, ``meta/scale``,
``meta/good``, ``meta/skipped``); in place of the JAX key ``meta/key``
the port stores its dropout generator's state under
``meta/torch_generator``.

The net's buffers (BatchNorm's running statistics) are its auxiliary
state, :attr:`ShardedTrainer.aux_names`: the forward and backward of
each step run inside ``autograd.record()``, so the layers train
(``autograd.is_training()``, as the JAX trainer's
``pause(train_mode=True)``) and update them in place, as the JAX
trainer carries its mutated aux state out of the step.

Every trainable parameter's ``.grad`` is a view into one preallocated
flat gradient arena, so the backward writes (and, for a tied weight such
as BERT's word embedding, accumulates) straight into it: the port's
counterpart of the JAX step's single gradient concatenate.  The arena is
zeroed in place before each backward; a ``.grad`` that was replaced or
set to None (``zero_grad(set_to_none=True)``) is put back as the view.

Low precision (``compute_dtype=torch.bfloat16`` or ``torch.float16``)
is the JAX trainer's policy, not ``torch.autocast``: the master
parameters stay f32 and the optimizer sees f32 parameters and f32
gradients; once a step every floating parameter, buffer and input is
cast to ``compute_dtype`` (one cast a parameter, however often the net
uses it: BERT's tied decoder sums its 16-bit cotangents before the
cast's gradient, as in JAX), the forward runs on the cast copies
(``torch.func.functional_call``), and autograd through the casts writes
the f32 gradients into the arena.  The loss is ``mean(loss_fn(pred,
y))`` cast to f32.  Dynamic loss scaling (``loss_scaling="auto"``: on
exactly for f16) multiplies the loss by the scale before the backward,
divides the gradients by it in f32 and checks them as :func:`all_finite`
does; on overflow every parameter and optimizer state is left as it was
(a per-leaf select against a copy taken before the update), the scale
halves (floored at 1) and the skipped count rises;
after 2000 clean steps the scale doubles.  The check, the select and the
scale stay on the device, so a step never waits on the host.  The
buffers (BatchNorm's running statistics) are cast with the parameters;
the layers blend the batch statistics into the 16-bit copies in the
copies' type, and after the backward each copy that was written is
carried into its f32 buffer, as the JAX trainer casts its mutated aux
state back to f32.  A step that the loss scale skips keeps the
statistics it blended, as in the JAX trainer, which returns the mutated
aux state whatever the finite check says.

Steps are dispatched asynchronously: ``step`` returns the loss as a lazy
0-d tensor, and at most ``MXNET_MAX_INFLIGHT_STEPS`` (default 2) steps
are in flight (``engine.BoundedInflight`` waits on a CUDA event recorded
after each step).  What the JAX trainer offers beyond one device
(meshes, ``partition="zero1"``, ``overlap``, shard-wise checkpoints)
raises :class:`MXNetError` naming the roadmap item that ports it.
"""
from __future__ import annotations

import copy
from typing import Any, List, Optional

import numpy as np
import torch

from .. import autograd as _ag
from .. import optimizer as _opt_mod
from .. import random as _random
from .. import telemetry as _tel
from ..base import MXNetError, get_env
from ..engine import BoundedInflight
from ..gluon.block import eager_calls
from ..kernels import opt_arena as _oa

__all__ = ["ShardedTrainer", "all_finite"]

# compute_dtype names -> torch dtypes
_DTYPES = {"bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
           "float16": torch.float16, "fp16": torch.float16,
           "float32": torch.float32, "fp32": torch.float32}
_GROWTH_INTERVAL = 2000    # clean steps before the loss scale doubles


def all_finite(grads) -> torch.Tensor:
    """A 0-d bool tensor: whether every gradient's f32 sum is finite (the
    reference's all_finite op, as the JAX package ports it), on the
    gradients' device, with no host sync."""
    sums = torch.stack([g.float().sum() for g in grads])
    return torch.isfinite(sums).all()


def _tensors(tree) -> List[torch.Tensor]:
    """Every tensor of a state tree (None, a tensor, or tuples / lists of
    them), in order."""
    if tree is None:
        return []
    if torch.is_tensor(tree):
        return [tree]
    return [t for e in tree for t in _tensors(e)]


def _cast(x, dtype):
    """``x`` (a tensor, or a tuple / list of them) with every floating
    tensor cast to ``dtype``; integer tensors as they are."""
    if isinstance(x, (tuple, list)):
        return type(x)(_cast(e, dtype) for e in x)
    if torch.is_tensor(x) and x.is_floating_point():
        return x.to(dtype)
    return x

_LATER = "is not ported yet ({item}, a later slice of the trainer)"


def _not_ported(what: str, item: str = "ROADMAP A1") -> MXNetError:
    return MXNetError(f"ShardedTrainer: {what} " + _LATER.format(item=item))


def _make_opt(optimizer, learning_rate, weight_decay, momentum, **extra):
    """An optimizer instance from a name (the trainer's lr, wd and, for
    sgd / nag, momentum) or as given."""
    if isinstance(optimizer, _opt_mod.Optimizer):
        return optimizer
    kwargs = dict(learning_rate=learning_rate, wd=weight_decay, **extra)
    if optimizer in ("sgd", "nag", "signum"):
        kwargs["momentum"] = momentum
    return _opt_mod.create(optimizer, **kwargs)


class _StepCounts(dict):
    """Stands in for ``Optimizer._index_update_count`` during a trainer
    step: every index reads the trainer's step count (the JAX package's
    ``_TracedCounts``)."""

    def __init__(self, t):
        super().__init__()
        self._t = t

    def __getitem__(self, key):
        return self._t

    def setdefault(self, key, default=None):
        return self._t


def _rebuild(template, leaves):
    """A state tree of ``template``'s structure with its tensors taken in
    order from the iterator ``leaves``."""
    if template is None:
        return None
    if torch.is_tensor(template):
        return next(leaves)
    return tuple(_rebuild(t, leaves) for t in template)


def _struct(template) -> str:
    """The structure of a state tree: ``0`` for None, ``a`` for a tensor."""
    if template is None:
        return "0"
    if torch.is_tensor(template):
        return "a"
    return "(" + ",".join(_struct(t) for t in template) + ")"


class _OptAdapter:
    """Per-parameter update: the optimizer's own ``update`` on each
    parameter, with the trainer's lr and step count."""

    def __init__(self, optimizer):
        self.opt = optimizer
        self.states: List[Any] = []

    def order(self, params: List[torch.Tensor]) -> List[int]:
        """The parameters' order in the gradient arena."""
        return list(range(len(params)))

    def init_state(self, params: List[torch.Tensor], layout):
        with torch.no_grad():
            self.states = [self.opt.create_state(i, p)
                           for i, p in enumerate(params)]

    def leaves(self) -> List[torch.Tensor]:
        """The optimizer state's tensors in checkpoint order (``opt/<i>``
        of :meth:`ShardedTrainer.save_states`)."""
        return _tensors(self.states)

    def storages(self, params) -> List[torch.Tensor]:
        """Tensors that hold every parameter and state element once: what
        the loss-scale select keeps on a skipped step."""
        return list(params) + self.leaves()

    def _step_opt(self, lr, t):
        opt = copy.copy(self.opt)
        opt.rescale_grad = 1.0          # the loss mean already scaled
        opt.lr_scheduler = None
        opt.lr = lr
        opt._index_update_count = _StepCounts(t)
        opt._update_count = lambda *a, **k: None
        return opt

    def update(self, params, grads, garena, lr, t):
        opt = self._step_opt(lr, t)
        for i, (p, g) in enumerate(zip(params, grads)):
            opt.update(i, p, g, self.states[i])


class _FusedOptAdapter(_OptAdapter):
    """Multi-tensor update (module docstring): one ``torch.func.vmap`` of
    ``update`` for each group of parameters with the JAX package's
    grouping key (``mxnet_tpu/parallel/trainer.py:486-495``); a group's
    parameters and state leaves are views into stacked tensors made once.
    ``groups`` lists each group's parameter indices, in the order of
    their first member."""

    def __init__(self, optimizer):
        super().__init__(optimizer)
        self.groups: List[List[int]] = []
        self._stacks: List[Any] = []
        self._goff: List[int] = []
        self._fresh: Optional[List[Any]] = None

    def _index_sig(self, i):
        """The host-side lr / wd multipliers of index ``i`` (the lookups of
        ``Optimizer._get_lr`` / ``_get_wd``): a group shares its first
        member's."""
        opt = self.opt
        param = opt.param_dict.get(i)
        if param is not None:
            lm = getattr(param, "lr_mult", 1.0)
            wm = getattr(param, "wd_mult", 1.0)
        else:
            name = opt.idx2name.get(i)
            lm = opt.lr_mult.get(i, opt.lr_mult.get(name, 1.0))
            wm = opt.wd_mult.get(i, opt.wd_mult.get(name, 1.0))
        return (float(lm), float(wm))

    def _plan(self, params):
        with torch.no_grad():
            states = [self.opt.create_state(i, p)
                      for i, p in enumerate(params)]
        groups = {}
        for i, (p, st) in enumerate(zip(params, states)):
            if not self.opt.vmappable:
                key = i
            else:
                key = (tuple(p.shape), p.dtype, _struct(st),
                       self._index_sig(i),
                       tuple((tuple(t.shape), t.dtype)
                             for t in _tensors(st)))
            groups.setdefault(key, []).append(i)
        self.groups = sorted(groups.values(), key=lambda g: g[0])
        self._fresh = states

    def order(self, params):
        if not self.groups:
            self._plan(params)
        return [i for g in self.groups for i in g]

    @torch.no_grad()
    def init_state(self, params, layout):
        if not self.groups:
            self._plan(params)
        fresh, self._fresh = self._fresh, None
        self.states = list(fresh)
        self._stacks, self._goff = [], []
        pos = {i: k for k, i in enumerate(self.order(params))}
        for g in self.groups:
            self._goff.append(layout.offsets[pos[g[0]]])
            if len(g) == 1:
                self._stacks.append(None)
                continue
            stack = torch.stack([params[i].detach() for i in g])
            for j, i in enumerate(g):
                params[i].data = stack[j]
            leaves = [torch.stack(ls) for ls in
                      zip(*[_tensors(fresh[i]) for i in g])]
            for j, i in enumerate(g):
                self.states[i] = _rebuild(fresh[i],
                                          iter([l[j] for l in leaves]))
            self._stacks.append((stack, leaves))

    def storages(self, params):
        out: List[torch.Tensor] = []
        for g, stack in zip(self.groups, self._stacks):
            if stack is None:
                out += [params[g[0]]] + _tensors(self.states[g[0]])
            else:
                out += [stack[0]] + stack[1]
        return out

    def update(self, params, grads, garena, lr, t):
        opt = self._step_opt(lr, t)
        for g, stack, off in zip(self.groups, self._stacks, self._goff):
            i0 = g[0]
            if stack is None:
                opt.update(i0, params[i0], grads[i0], self.states[i0])
                continue
            w, leaves = stack
            gs = garena[off:off + w.numel()].view(w.shape)
            template = self.states[i0]

            def one(wj, gj, *lj, i0=i0, template=template):
                opt.update(i0, wj, gj, _rebuild(template, iter(lj)))
                return wj

            torch.func.vmap(one)(w, gs, *leaves)


class _ArenaOptAdapter(_OptAdapter):
    """Flat-arena update: one kernel launch per step for every parameter
    (module docstring).  State lives in flat arenas of the gradient
    arena's layout; the delta arena is allocated once and reused."""

    def __init__(self, optimizer):
        super().__init__(optimizer)
        self.layout: Optional[_oa.ArenaLayout] = None
        self._delta: Optional[torch.Tensor] = None
        name = type(optimizer).__name__
        if name in ("SGD", "NAG"):
            self.variant = "momentum" if getattr(optimizer, "momentum",
                                                 0.0) else "sgd"
            self._nesterov = name == "NAG"
        else:
            self.variant = "adam"
            self._nesterov = False

    @classmethod
    def supports(cls, opt):
        """Whether ``opt`` can run as a flat-arena update, with the reason
        when not.  Exact types only: subclasses (AdamW, ...) change the
        update math."""
        if type(opt) not in (_opt_mod.SGD, _opt_mod.NAG, _opt_mod.Adam):
            return False, (f"optimizer {type(opt).__name__} not "
                           "arena-fusible (elementwise sgd/momentum/adam "
                           "only)")
        if opt.lr_mult or opt.wd_mult:
            return False, "per-parameter lr/wd multipliers"
        for p in opt.param_dict.values():
            if getattr(p, "lr_mult", 1.0) != 1.0 or \
                    getattr(p, "wd_mult", 1.0) != 1.0:
                return False, "per-parameter lr/wd multipliers"
        return True, ""

    def init_state(self, params, layout):
        self.layout = layout
        kw = dict(dtype=torch.float32, device=params[0].device)
        self.states = [torch.zeros(layout.padded, **kw)
                       for _ in range(_oa.VARIANT_STATES[self.variant])]
        self._delta = torch.empty(layout.padded, **kw)

    def update(self, params, grads, garena, lr, t):
        opt = self.opt
        wd = float(opt.wd)
        clip = float(opt.clip_gradient) if opt.clip_gradient is not None \
            else -1.0
        # per-leaf fold in the arena, in the order of the JAX adapter:
        # clip, then g + wd * p (reads the parameter, never packed)
        if clip > 0:
            for g in grads:
                g.clamp_(-abs(clip), abs(clip))
        if wd:
            torch._foreach_add_(grads, torch._foreach_mul(
                params, float(np.float32(wd))))
        kw = {}
        if self.variant == "momentum":
            kw = dict(momentum=float(opt.momentum), nesterov=self._nesterov)
        elif self.variant == "adam":
            kw = dict(beta1=float(opt.beta1), beta2=float(opt.beta2),
                      eps=float(opt.epsilon))
        delta, _ = _oa.arena_update(self.variant, garena, self.states, lr,
                                    t, out=self._delta, **kw)
        lay = self.layout
        torch._foreach_add_(params, [
            delta[off:off + size].view(shape) for off, size, shape in
            zip(lay.offsets, lay.sizes, lay.shapes)])


def _pick_adapter(opt, multi_tensor: bool, fused_opt: Optional[str]):
    """``fused_opt``: ``None`` picks the arena whenever the optimizer is
    arena-fusible and ``multi_tensor`` was not asked for; ``"arena"``
    requires the arena (raises when it cannot run); ``"off"`` pins the
    per-parameter adapters.  Otherwise ``multi_tensor=True`` takes the
    multi-tensor adapter and ``False`` the per-parameter one, as
    ``mxnet_tpu/parallel/trainer.py:789-819`` picks.  Returns
    ``(adapter, reason)``: why the arena was not taken, or ``""``.  (The
    trainer takes f32 parameters only, which the arena needs.)"""
    if fused_opt not in (None, "arena", "off"):
        raise MXNetError(f"fused_opt={fused_opt!r} unknown; use None, "
                         "'arena' or 'off'")
    reason = "fused_opt='off'"
    if fused_opt == "arena" or (fused_opt is None and not multi_tensor):
        ok, reason = _ArenaOptAdapter.supports(opt)
        if ok:
            return _ArenaOptAdapter(opt), ""
        if fused_opt == "arena":
            raise MXNetError("fused_opt='arena' requested but unavailable: "
                             + reason)
    elif fused_opt is None:
        reason = "multi_tensor=True"
    if multi_tensor:
        return _FusedOptAdapter(opt), reason
    return _OptAdapter(opt), reason


def _on(x, device):
    """A host array or tensor as a tensor on ``device`` (a tuple or list
    element-wise)."""
    if isinstance(x, (tuple, list)):
        return tuple(_on(e, device) for e in x)
    if not torch.is_tensor(x):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device, non_blocking=True)


class ShardedTrainer:
    """End-to-end trainer for an ``nn.Module`` on one device (module
    docstring).

    ``net`` is a port module whose parameters live on one device (the
    trainer trains there); ``loss_fn(pred, y)`` returns per-sample losses
    and ``pred`` is ``net(*x)`` (a tuple of outputs passes as a tuple).
    ``optimizer`` is a registry name or an ``Optimizer``; names get the
    trainer's ``learning_rate``, ``weight_decay`` and, for sgd / nag,
    ``momentum``.  ``fused_opt`` and ``multi_tensor``: see
    :func:`_pick_adapter`; :attr:`uses_arena` says which adapter runs.
    ``train_names`` are the trained parameters' names, sorted as the JAX
    trainer sorts them (the optimizer's index ``i`` is the i-th), and
    ``aux_names`` the buffers' (module docstring).  ``lr_scheduler``,
    ``grad_accum`` and the checkpoints: module docstring."""

    def __init__(self, net, loss_fn, mesh=None, optimizer="sgd",
                 learning_rate: float = 0.01, weight_decay: float = 0.0,
                 momentum: float = 0.9, compute_dtype=None,
                 lr_scheduler=None, grad_accum: int = 1,
                 multi_tensor: bool = False,
                 max_inflight: Optional[int] = None,
                 partition: Optional[str] = None,
                 fused_opt: Optional[str] = None,
                 overlap: Optional[bool] = None,
                 init_loss_scale: float = 2.0 ** 16,
                 loss_scaling: Any = "auto"):
        if mesh is not None and int(getattr(mesh, "size", 1)) > 1:
            raise _not_ported(f"a mesh of {mesh.size} devices",
                              "ROADMAP A6, multi-device")
        if partition is None:
            partition = get_env("MXNET_PARTITION", "replicated", str)
        if partition != "replicated":
            raise _not_ported(f"partition={partition!r}",
                              "ROADMAP A6, multi-device")
        if overlap is None:
            overlap = get_env("MXNET_OVERLAP", False, bool)
        if overlap:
            raise _not_ported("overlap=True", "ROADMAP A6, multi-device")
        if int(grad_accum) < 1:
            raise MXNetError(f"grad_accum={grad_accum} must be >= 1")
        self.grad_accum = int(grad_accum)
        self.net = net
        self.loss_fn = loss_fn
        # sorted by name, as the JAX trainer orders them: the index an
        # optimizer sees, the order of the checkpoint's leaves and the
        # arena's layout are the JAX package's
        named = sorted((n, p) for n, p in net.named_parameters()
                       if p.requires_grad)
        if not named:
            raise MXNetError("ShardedTrainer: the net has no trainable "
                             "parameters")
        self.train_names = [n for n, _ in named]
        self.params = [p for _, p in named]
        devices = {p.device for p in self.params}
        if len(devices) != 1:
            raise _not_ported(f"parameters on {sorted(map(str, devices))}",
                              "ROADMAP A6, multi-device")
        self.device = devices.pop()
        buffers = sorted(net.named_buffers())
        self.aux_names = [n for n, _ in buffers]
        away = sorted(n for n, b in buffers if b.device != self.device)
        if away:
            raise MXNetError(f"ShardedTrainer: buffers {away} are not on "
                             f"the parameters' device {self.device}")
        if any(p.dtype != torch.float32 for p in self.params):
            raise _not_ported("non-f32 parameters")
        opt = _make_opt(optimizer, learning_rate, weight_decay, momentum)
        self._adapter, self.arena_refused = _pick_adapter(
            opt, bool(multi_tensor), fused_opt)
        # the arena in the adapter's order: a multi-tensor group's
        # gradients are one contiguous view
        order = self._adapter.order(self.params)
        self.layout = _oa.build_layout(
            [tuple(self.params[i].shape) for i in order])
        self._garena = torch.zeros(self.layout.padded, dtype=torch.float32,
                                   device=self.device)
        self._gviews: List[torch.Tensor] = [None] * len(self.params)
        for i, off, size, shape in zip(order, self.layout.offsets,
                                       self.layout.sizes,
                                       self.layout.shapes):
            self._gviews[i] = self._garena[off:off + size].view(shape)
        self._attach_grads()
        self._init_policy(compute_dtype, loss_scaling, init_loss_scale)
        self._adapter.init_state(self.params, self.layout)
        self._lr = float(opt.lr) if optimizer is opt else float(learning_rate)
        #: the schedule of the learning rate (the optimizer's when none is
        #: given); update k runs at ``lr_scheduler(k)``
        self.lr_scheduler = lr_scheduler if lr_scheduler is not None \
            else opt.lr_scheduler
        self._t = 0
        self._micro = 0
        self._accum: Optional[torch.Tensor] = None
        self._inflight = BoundedInflight(max_inflight)

    # -- the low-precision policy -------------------------------------------
    def _init_policy(self, compute_dtype, loss_scaling, init_loss_scale):
        """``compute_dtype`` and dynamic loss scaling (module docstring),
        with the JAX trainer's errors."""
        if isinstance(compute_dtype, str):
            if compute_dtype not in _DTYPES:
                raise MXNetError(f"compute_dtype={compute_dtype!r} unknown; "
                                 f"use one of {sorted(_DTYPES)}")
            compute_dtype = _DTYPES[compute_dtype]
        if compute_dtype is not None and (
                not isinstance(compute_dtype, torch.dtype)
                or not compute_dtype.is_floating_point):
            raise MXNetError(f"compute_dtype={compute_dtype!r} is not a "
                             "floating torch dtype")
        #: the policy's forward dtype (None = pure f32)
        self.compute_dtype = compute_dtype
        if loss_scaling not in ("auto", True, False):
            raise MXNetError(f"loss_scaling={loss_scaling!r} unknown; use "
                             "'auto', True or False")
        if loss_scaling == "auto":
            dynamic = compute_dtype == torch.float16
        else:
            dynamic = bool(loss_scaling)
            if dynamic and compute_dtype is None:
                raise MXNetError(
                    "loss_scaling=True without a compute_dtype: f32 steps "
                    "cannot overflow, scaling would only mask a config bug")
        self._dynamic_scaling = dynamic
        self._buffer_copies = []
        kw = dict(device=self.device)
        lay = self.layout    # the arena's segments: each leaf, the padding
        tail = [lay.padded - lay.total] if lay.padded > lay.total else []
        self._segments = torch.tensor(list(lay.sizes) + tail, **kw)
        self._scale = torch.tensor(float(init_loss_scale) if dynamic else 1.0,
                                   dtype=torch.float32, **kw)
        self._good = torch.zeros((), dtype=torch.int32, **kw)
        self._skipped = torch.zeros((), dtype=torch.int32, **kw)
        self._amp_tel_every = int(get_env("MXNET_AMP_TELEMETRY_EVERY", 50,
                                          int))

    @property
    def loss_scale(self) -> float:
        """The dynamic loss scale (1.0 when scaling is off); reading it
        waits for the last dispatched step."""
        return float(self._scale)

    @property
    def skipped_steps(self) -> int:
        """Updates skipped on non-finite gradients since construction
        (dynamic loss scaling only; 0 otherwise).  Reading it waits for
        the last dispatched step."""
        return int(self._skipped)

    def _forward(self, xs):
        """The net on ``xs``, under the policy: the f32 net as it is, or
        the net on copies of its floating parameters and buffers (and of
        the floating inputs) cast to ``compute_dtype``.  The buffers'
        copies are kept, with their version counters, for
        :meth:`_carry_buffers`.  A hybridized net runs eagerly here: the
        step is a program of its own (the JAX trainer jits the whole
        step), and the 16-bit copies are new tensors every step."""
        with eager_calls():
            if self.compute_dtype is None:
                return self.net(*xs)
            dt = self.compute_dtype
            swap = {n: _cast(t, dt) for n, t in self.net.named_parameters()}
            self._buffer_copies = []
            for n, b in self.net.named_buffers():
                swap[n] = _cast(b, dt)
                if swap[n] is not b:
                    self._buffer_copies.append((b, swap[n],
                                                swap[n]._version))
            return torch.func.functional_call(self.net, swap,
                                              _cast(xs, dt))

    def _carry_buffers(self):
        """Write every buffer copy that the 16-bit forward wrote in place
        (BatchNorm's blended running statistics) into its f32 buffer."""
        for buf, copy16, version in self._buffer_copies:
            if copy16._version != version:
                buf.copy_(copy16)
        self._buffer_copies = []

    def _update_scaled(self, lr, unscale: bool = True):
        """The update under dynamic loss scaling: unscale (unless a
        gradient-accumulation window already did), check, update, then
        keep the old parameters and optimizer states where the check
        failed, and move the scale; all on the device.

        The check is :func:`all_finite` on the arena: the f32 sum of each
        gradient's segment.  The select works on the f32 storages' bits
        as int32 (``new * ok + old * (1 - ok)`` is exact in integers,
        where in floats a NaN or inf of a skipped update would survive a
        multiply by 0): a copy before the update and three multi-tensor
        ops after it, over the adapter's storages (a multi-tensor group's
        stacked tensors, not its views)."""
        if unscale:
            self._garena.div_(self._scale)
        # unsafe: the lengths are the layout's own, and their validation
        # reads them back to the host, a sync a step
        ok = torch.isfinite(torch.segment_reduce(
            self._garena, "sum", lengths=self._segments, unsafe=True)).all()
        leaves = [t.view(torch.int32)
                  for t in self._adapter.storages(self.params)]
        old = torch._foreach_mul(leaves, 1)
        self._adapter.update(self.params, self._gviews, self._garena, lr,
                             self._t)
        keep = ok.to(torch.int32)
        torch._foreach_mul_(leaves, keep)
        torch._foreach_add_(leaves, torch._foreach_mul(old, 1 - keep))
        grown = self._good + 1 >= _GROWTH_INTERVAL
        self._scale = torch.where(
            ok, torch.where(grown, self._scale * 2.0, self._scale),
            torch.clamp(self._scale * 0.5, min=1.0))
        self._good = torch.where(ok, torch.where(grown, 0, self._good + 1),
                                 0).to(torch.int32)
        self._skipped = torch.where(ok, self._skipped, self._skipped + 1)

    def _publish_amp_gauges(self):
        """``amp.loss_scale`` / ``amp.skipped_steps`` every
        ``MXNET_AMP_TELEMETRY_EVERY`` (default 50) steps: the read waits
        for the step, so it is gated to keep the in-flight window deep."""
        if not (self._dynamic_scaling and _tel._ENABLED
                and self._amp_tel_every
                and self._t % self._amp_tel_every == 0):
            return
        _tel.set_gauge("amp.loss_scale", self.loss_scale)
        _tel.set_gauge("amp.skipped_steps", self.skipped_steps)

    # -- adapters -----------------------------------------------------------
    @property
    def uses_arena(self) -> bool:
        """True when the flat-arena kernel runs the update."""
        return isinstance(self._adapter, _ArenaOptAdapter)

    # -- lr ------------------------------------------------------------------
    @property
    def learning_rate(self) -> float:
        """The lr of the last update (``lr_scheduler(t)`` under a
        schedule), and so of the next one without a schedule."""
        if self.lr_scheduler is not None:
            return float(self.lr_scheduler(self._t))
        return self._lr

    def set_learning_rate(self, lr: float):
        if self.lr_scheduler is not None:
            raise MXNetError(
                "LRScheduler of the trainer has already been defined; "
                "mutate the scheduler instead of calling set_learning_rate")
        self._lr = float(lr)

    # -- the step ------------------------------------------------------------
    def _attach_grads(self):
        """Point every ``.grad`` at its view of the gradient arena (again,
        where something replaced it)."""
        for p, view in zip(self.params, self._gviews):
            if p.grad is not view:
                p.grad = view

    def step(self, x, y, block: bool = False):
        """One training step on batch ``(x, y)`` (host arrays or tensors;
        ``x`` a tuple for a multi-input net).  Returns the loss as a lazy
        0-d tensor; ``block=True`` drains the in-flight steps and returns
        a float."""
        loss = self._step(_on(x, self.device), _on(y, self.device))
        if block:
            self.drain()
            return float(loss)
        return loss

    def _step(self, xs, y):
        xs = xs if isinstance(xs, tuple) else (xs,)
        window = self.grad_accum > 1
        if not window:
            self._t += 1
        self._attach_grads()
        self._garena.zero_()
        with _ag.record():
            loss = self.loss_fn(self._forward(xs), y).mean().float()
            (loss * self._scale if self._dynamic_scaling else loss).backward()
        with torch.no_grad():
            if self.compute_dtype is not None:
                self._carry_buffers()
            if not window:
                self._apply(unscale=True)
            elif self._accumulate():
                self._t += 1
                torch.div(self._accum, self.grad_accum, out=self._garena)
                self._apply(unscale=False)
        self._publish_amp_gauges()
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
        self._inflight.push(event)
        return loss.detach()

    def _accumulate(self) -> bool:
        """Add this micro-batch's unscaled f32 gradients to the window's
        accumulator, in the JAX order; True on the window's last one."""
        g = self._garena
        if self._dynamic_scaling:
            g = g.div_(self._scale)
        if self._micro == 0:
            if self._accum is None:
                self._accum = torch.empty_like(self._garena)
            self._accum.copy_(g)
        else:
            self._accum.add_(g)
        self._micro += 1
        if self._micro < self.grad_accum:
            return False
        self._micro = 0
        return True

    def _apply(self, unscale: bool):
        """The optimizer update of step ``self._t`` from the gradient
        arena, at the lr read after the count rose."""
        lr = self.learning_rate
        if self._dynamic_scaling:
            self._update_scaled(lr, unscale)
        else:
            self._adapter.update(self.params, self._gviews, self._garena,
                                 lr, self._t)

    def drain(self):
        """Wait for every in-flight step."""
        self._inflight.drain()

    # -- checkpoints ---------------------------------------------------------
    def save_states(self, fname: str):
        """The whole training state into one ``.npz`` in the JAX
        trainer's keys (module docstring), written atomically
        (``resilience.checkpoint.write_payload``).  Raises in the middle
        of a gradient-accumulation window."""
        from ..resilience.checkpoint import write_payload

        if self._micro != 0:
            raise MXNetError(
                f"save_states called mid gradient-accumulation window "
                f"({self._micro}/{self.grad_accum} micro-batches pending); "
                f"step to a window boundary first")
        self.drain()
        blob = {}
        for n, p in zip(self.train_names, self.params):
            blob[f"param/{n}"] = p.detach().cpu().numpy()
        for n, b in self.net.named_buffers():
            blob[f"aux/{n}"] = b.detach().cpu().numpy()
        arena = isinstance(self._adapter, _ArenaOptAdapter)
        for i, leaf in enumerate(self._adapter.leaves()):
            if arena:
                leaf = leaf[:self.layout.total]
            blob[f"opt/{i}"] = leaf.detach().cpu().numpy()
        blob["meta/t"] = np.asarray(self._t)
        blob["meta/scale"] = np.asarray(float(self._scale), np.float32)
        blob["meta/good"] = np.asarray(int(self._good), np.int32)
        blob["meta/skipped"] = np.asarray(int(self._skipped), np.int32)
        blob["meta/torch_generator"] = \
            _random.generator(self.device).get_state().numpy()
        write_payload(fname, lambda f: np.savez(f, **blob))

    @torch.no_grad()
    def load_states(self, fname: str):
        """Restore a :meth:`save_states` checkpoint (the port's or the JAX
        trainer's) into this trainer, in place: parameters, buffers,
        optimizer state, step count and loss-scale state, and the dropout
        generator where the file holds the port's.  A per-parameter
        checkpoint on an arena trainer, or the other way round, raises."""
        self.drain()
        with np.load(fname) as z:
            blob = {k: z[k] for k in z.files}
        for key in blob:
            if key.startswith("param/") and \
                    key[len("param/"):] not in self.train_names:
                raise MXNetError(f"checkpoint param '{key[6:]}' unknown")
        leaves = self._adapter.leaves()
        n_blob = sum(1 for k in blob if k.startswith("opt/"))
        if n_blob != len(leaves):
            raise _layout_mismatch(f"{n_blob} saved leaves, {len(leaves)} "
                                   "expected")
        arena = isinstance(self._adapter, _ArenaOptAdapter)
        for i, leaf in enumerate(leaves):
            v = blob[f"opt/{i}"]
            want = (self.layout.total,) if arena else tuple(leaf.shape)
            if tuple(v.shape) != want:
                raise _layout_mismatch(f"leaf {i} has shape "
                                       f"{tuple(v.shape)}, expected {want}")
        from ..gluon.parameter import mark_initialized

        named = dict(zip(self.train_names, self.params))
        for n, p in named.items():
            p.copy_(torch.from_numpy(blob[f"param/{n}"]))
            mark_initialized(p)
        for n, b in self.net.named_buffers():
            b.copy_(torch.from_numpy(blob[f"aux/{n}"]))
            mark_initialized(b)
        for i, leaf in enumerate(leaves):
            v = torch.from_numpy(blob[f"opt/{i}"])
            if arena:
                leaf.zero_()
                leaf[:self.layout.total].copy_(v)
            else:
                leaf.copy_(v)
        self._t = int(blob["meta/t"])
        self._scale.fill_(float(blob["meta/scale"]))
        self._good.fill_(int(blob["meta/good"]))
        self._skipped.fill_(int(blob.get("meta/skipped", 0)))
        if "meta/torch_generator" in blob:
            _random.generator(self.device).set_state(
                torch.from_numpy(blob["meta/torch_generator"]))
        self._micro = 0


def _layout_mismatch(detail) -> MXNetError:
    """The JAX trainer's refusal to load optimizer state of another
    layout (per-parameter against flat arena)."""
    return MXNetError(
        f"checkpoint optimizer state does not match this trainer's layout "
        f"({detail}): it was saved under a different optimizer layout "
        "(per-param vs flat-arena) or optimizer; rebuild the trainer with "
        "the matching fused_opt setting")
