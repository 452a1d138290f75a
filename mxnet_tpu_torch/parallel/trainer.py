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
* :class:`_OptAdapter`: the optimizer's per-parameter ``update`` (AdamW,
  or ``fused_opt="off"``).

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
(meshes, ``partition="zero1"``, ``overlap``, gradient accumulation,
``multi_tensor``, ``lr_scheduler``, checkpoints) raises
:class:`MXNetError` naming the roadmap item that ports it.
"""
from __future__ import annotations

import copy
from typing import Any, List, Optional

import numpy as np
import torch

from .. import autograd as _ag
from .. import optimizer as _opt_mod
from .. import telemetry as _tel
from ..base import MXNetError, get_env
from ..engine import BoundedInflight
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


class _OptAdapter:
    """Per-parameter update: the optimizer's own ``update`` on each
    parameter, with the trainer's lr and step count."""

    def __init__(self, optimizer):
        self.opt = optimizer
        self.states: List[Any] = []

    def init_state(self, params: List[torch.Tensor], layout):
        with torch.no_grad():
            self.states = [self.opt.create_state(i, p)
                           for i, p in enumerate(params)]

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


def _pick_adapter(opt, fused_opt: Optional[str]):
    """``fused_opt``: ``None`` picks the arena whenever the optimizer is
    arena-fusible, else the per-parameter adapter; ``"arena"`` requires
    the arena (raises when it cannot run); ``"off"`` pins the
    per-parameter adapter.  Returns ``(adapter, reason)``: why the arena
    was not taken, or ``""``.  (The trainer takes f32 parameters only,
    which the arena needs.)"""
    if fused_opt not in (None, "arena", "off"):
        raise MXNetError(f"fused_opt={fused_opt!r} unknown; use None, "
                         "'arena' or 'off'")
    if fused_opt == "off":
        return _OptAdapter(opt), "fused_opt='off'"
    ok, reason = _ArenaOptAdapter.supports(opt)
    if ok:
        return _ArenaOptAdapter(opt), ""
    if fused_opt == "arena":
        raise MXNetError("fused_opt='arena' requested but unavailable: "
                         + reason)
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
    ``momentum``.  ``fused_opt``: see :func:`_pick_adapter`;
    :attr:`uses_arena` says which adapter runs.  ``train_names`` are the
    trained parameters' names, ``aux_names`` the buffers' (module
    docstring)."""

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
        if int(grad_accum) != 1:
            raise _not_ported(f"grad_accum={grad_accum}")
        if multi_tensor:
            raise _not_ported("multi_tensor=True")
        if lr_scheduler is not None:
            raise _not_ported("lr_scheduler")
        self.net = net
        self.loss_fn = loss_fn
        named = [(n, p) for n, p in net.named_parameters() if p.requires_grad]
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
        buffers = list(net.named_buffers())
        self.aux_names = [n for n, _ in buffers]
        away = sorted(n for n, b in buffers if b.device != self.device)
        if away:
            raise MXNetError(f"ShardedTrainer: buffers {away} are not on "
                             f"the parameters' device {self.device}")
        if any(p.dtype != torch.float32 for p in self.params):
            raise _not_ported("non-f32 parameters")
        opt = _make_opt(optimizer, learning_rate, weight_decay, momentum)
        if opt.lr_scheduler is not None:
            raise _not_ported("an optimizer with an lr_scheduler")
        self._adapter, self.arena_refused = _pick_adapter(opt, fused_opt)
        self.layout = _oa.build_layout([tuple(p.shape) for p in self.params])
        self._garena = torch.zeros(self.layout.padded, dtype=torch.float32,
                                   device=self.device)
        self._gviews = [self._garena[off:off + size].view(shape)
                        for off, size, shape in zip(self.layout.offsets,
                                                    self.layout.sizes,
                                                    self.layout.shapes)]
        self._attach_grads()
        self._init_policy(compute_dtype, loss_scaling, init_loss_scale)
        self._adapter.init_state(self.params, self.layout)
        self._lr = float(opt.lr) if optimizer is opt else float(learning_rate)
        self._t = 0
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
        :meth:`_carry_buffers`."""
        if self.compute_dtype is None:
            return self.net(*xs)
        dt = self.compute_dtype
        swap = {n: _cast(t, dt) for n, t in self.net.named_parameters()}
        self._buffer_copies = []
        for n, b in self.net.named_buffers():
            swap[n] = _cast(b, dt)
            if swap[n] is not b:
                self._buffer_copies.append((b, swap[n], swap[n]._version))
        return torch.func.functional_call(self.net, swap, _cast(xs, dt))

    def _carry_buffers(self):
        """Write every buffer copy that the 16-bit forward wrote in place
        (BatchNorm's blended running statistics) into its f32 buffer."""
        for buf, copy16, version in self._buffer_copies:
            if copy16._version != version:
                buf.copy_(copy16)
        self._buffer_copies = []

    def _update_scaled(self, lr):
        """The update under dynamic loss scaling: unscale, check, update,
        then keep the old parameters and optimizer states where the check
        failed, and move the scale; all on the device.

        The check is :func:`all_finite` on the arena: the f32 sum of each
        gradient's segment.  The select works on the f32 leaves' bits as
        int32 (``new * ok + old * (1 - ok)`` is exact in integers, where
        in floats a NaN or inf of a skipped update would survive a
        multiply by 0): a copy before the update and three multi-tensor
        ops after it, in place of a clone and a ``where`` a leaf."""
        self._garena.div_(self._scale)
        # unsafe: the lengths are the layout's own, and their validation
        # reads them back to the host, a sync a step
        ok = torch.isfinite(torch.segment_reduce(
            self._garena, "sum", lengths=self._segments, unsafe=True)).all()
        leaves = [t.view(torch.int32) for t in
                  self.params + _tensors(self._adapter.states)]
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
        return self._lr

    def set_learning_rate(self, lr: float):
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
        self._t += 1
        self._attach_grads()
        self._garena.zero_()
        with _ag.record():
            loss = self.loss_fn(self._forward(xs), y).mean().float()
            (loss * self._scale if self._dynamic_scaling else loss).backward()
        with torch.no_grad():
            if self.compute_dtype is not None:
                self._carry_buffers()
            if self._dynamic_scaling:
                self._update_scaled(self.learning_rate)
            else:
                self._adapter.update(self.params, self._gviews,
                                     self._garena, self.learning_rate,
                                     self._t)
        self._publish_amp_gauges()
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
        self._inflight.push(event)
        return loss.detach()

    def drain(self):
        """Wait for every in-flight step."""
        self._inflight.drain()

    # -- not ported ----------------------------------------------------------
    def save_states(self, fname: str):
        raise _not_ported("save_states (checkpoints)")

    def load_states(self, fname: str):
        raise _not_ported("load_states (checkpoints)")
