"""Optimizers: the registry, ``SGD``, ``NAG``, ``Adam``, ``AdamW`` and the
per-index ``Updater``.

The port of ``mxnet_tpu/optimizer/__init__.py``'s surface for the
training slice: ``create('adam', ...)``, ``create_state(index, weight)``
and ``update(index, weight, grad, state)``, which updates ``weight`` and
the state tensors IN PLACE (the JAX package rebinds immutable arrays).
Each update performs the operations of the JAX package's jitted kernel
(``_sgd_kernel``, ``_adam_kernel``, ``_adamw_kernel``) in the same
order, in float32: the hyperparameters enter as float32 scalars, as the
jitted kernels receive them, and ``1 - beta**t`` is computed in float32.
With ``multi_precision=True`` an f16 weight keeps an f32 master copy in
its state (``create_state_multi_precision``): the update runs on the
master with the gradient cast to f32, and the weight is written back in
f16 (``update_multi_precision``), as the JAX package does.
Plain PyTorch: the JAX package ran these through XLA, not Pallas.  The
flat-arena update that the trainer runs by default is
``kernels/opt_arena.py``; ``gluon.Trainer`` updates per parameter
through an :class:`Updater`, as the JAX ``gluon.Trainer`` does.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..base import MXNetError

__all__ = ["Optimizer", "register", "create", "SGD", "NAG", "Adam", "AdamW",
           "Updater", "get_updater"]

_REG: Dict[str, type] = {}


def register(klass):
    """Register an optimizer class under its lower-case name."""
    _REG[klass.__name__.lower()] = klass
    return klass


def create(name, **kwargs) -> "Optimizer":
    """An optimizer by registered name (an instance passes through)."""
    if isinstance(name, Optimizer):
        return name
    klass = _REG.get(str(name).lower())
    if klass is None:
        raise MXNetError(f"optimizer {name!r} is not ported; the port has "
                         f"{sorted(_REG)}")
    return klass(**kwargs)


def _f32(x) -> float:
    """``x`` rounded to float32, as a Python float (exact in float32)."""
    return float(np.float32(x))


def bias_correction(beta: float, t) -> float:
    """``1 - beta**t`` computed in float32, as the jitted kernels and the
    arena kernel compute it."""
    return _f32(np.float32(1.0) - np.float32(beta) ** np.float32(t))


class Optimizer:
    """Base optimizer: learning rate, weight decay, gradient rescale and
    clip, per-index update counts and lr/wd multipliers."""

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=None, lr_scheduler=None,
                 multi_precision=False, param_dict=None, **extra):
        known_compat = {"sym", "begin_num_update", "allow_np_array",
                        "aggregate_num", "use_fused_step"}
        junk = set(extra) - known_compat
        if junk:
            raise TypeError(f"{type(self).__name__} got unknown "
                            f"hyperparameters {sorted(junk)}")
        self.rescale_grad = rescale_grad
        self.lr = learning_rate if learning_rate is not None else 0.01
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None and learning_rate is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.multi_precision = multi_precision
        self.param_dict = param_dict or {}
        self.idx2name = dict(param_idx2name or {})
        self.lr_mult: Dict[Any, float] = {}
        self.wd_mult: Dict[Any, float] = {}
        self._index_update_count: Dict[Any, int] = {}
        self.begin_num_update = int(extra.get("begin_num_update", 0))
        self.num_update = self.begin_num_update

    def _update_count(self, index):
        for idx in index if isinstance(index, (list, tuple)) else [index]:
            self._index_update_count.setdefault(idx, self.begin_num_update)
            self._index_update_count[idx] += 1
            self.num_update = max(self._index_update_count[idx],
                                  self.num_update)

    def _get_lr(self, index) -> float:
        lr = self.lr_scheduler(self.num_update) \
            if self.lr_scheduler is not None else self.lr
        param = self.param_dict.get(index)
        if param is not None:
            lr *= getattr(param, "lr_mult", 1.0)
        elif index in self.lr_mult:
            lr *= self.lr_mult[index]
        elif index in self.idx2name:
            lr *= self.lr_mult.get(self.idx2name[index], 1.0)
        return lr

    def _get_wd(self, index) -> float:
        wd = self.wd
        param = self.param_dict.get(index)
        if param is not None:
            wd *= getattr(param, "wd_mult", 1.0)
        elif index in self.wd_mult:
            wd *= self.wd_mult[index]
        elif index in self.idx2name:
            wd *= self.wd_mult.get(self.idx2name[index], 1.0)
        return wd

    def set_learning_rate(self, lr):
        if self.lr_scheduler is not None:
            raise MXNetError("LRScheduler of the optimizer has already been "
                             "defined")
        self.lr = lr

    @property
    def learning_rate(self):
        if self.lr_scheduler is not None:
            return self.lr_scheduler(self.num_update)
        return self.lr

    @learning_rate.setter
    def learning_rate(self, lr):
        self.set_learning_rate(lr)

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult.update(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        self.wd_mult.update(args_wd_mult)

    def create_state(self, index, weight: torch.Tensor):
        return None

    def _master(self, weight) -> bool:
        return bool(self.multi_precision) and weight.dtype == torch.float16

    def create_state_multi_precision(self, index, weight: torch.Tensor):
        """``(f32 master copy, state of the master)`` for an f16 weight
        under ``multi_precision``; the plain state otherwise."""
        if self._master(weight):
            w32 = weight.detach().float()
            return (w32, self.create_state(index, w32))
        return self.create_state(index, weight)

    def update_multi_precision(self, index, weight: torch.Tensor,
                               grad: torch.Tensor, state):
        """``update`` on the f32 master with the gradient in f32, then the
        master written back into the f16 weight; ``update`` otherwise."""
        if self._master(weight):
            w32, inner = state
            self.update(index, w32, grad.float(), inner)
            weight.copy_(w32)
        else:
            self.update(index, weight, grad, state)

    def _clip(self):
        return self.clip_gradient if self.clip_gradient is not None else -1.0

    def update(self, index, weight: torch.Tensor, grad: torch.Tensor, state):
        raise NotImplementedError

    def __repr__(self):
        return f"{type(self).__name__}(lr={self.lr})"


def _prep(g, rescale, clip):
    """``g * rescale``, clipped to ``|clip|`` when ``clip > 0``: the first
    two lines of every kernel."""
    g = g * _f32(rescale)
    if clip > 0:
        g = torch.clamp(g, -abs(_f32(clip)), abs(_f32(clip)))
    return g


@register
class SGD(Optimizer):
    """SGD with optional momentum (nesterov in :class:`NAG`)."""

    def __init__(self, learning_rate=0.01, momentum=0.0, lazy_update=False,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return torch.zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = _f32(self._get_lr(index)), self._get_wd(index)
        g = _prep(grad.to(weight.dtype), self.rescale_grad, self._clip())
        g = g + _f32(wd) * weight
        if state is None:
            weight.copy_(weight - lr * g)
            return
        mu = _f32(self.momentum)
        mom = mu * state - lr * g
        state.copy_(mom)
        if isinstance(self, NAG):
            weight.copy_(weight + mu * mom - lr * g)
        else:
            weight.copy_(weight + mom)


@register
class NAG(SGD):
    """Nesterov accelerated SGD."""


@register
class Adam(Optimizer):
    """Adam with L2 weight decay folded into the gradient."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_update=False, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return (torch.zeros_like(weight), torch.zeros_like(weight))

    def _moments(self, g, state, t):
        """Update ``(m, v)`` in place; return ``(mhat, vhat)``."""
        m, v = state
        b1, b2 = _f32(self.beta1), _f32(self.beta2)
        mm = b1 * m + _f32(np.float32(1.0) - np.float32(b1)) * g
        vv = b2 * v + _f32(np.float32(1.0) - np.float32(b2)) * (g * g)
        m.copy_(mm)
        v.copy_(vv)
        return (mm / bias_correction(self.beta1, t),
                vv / bias_correction(self.beta2, t))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        t = self._index_update_count[index]
        lr, wd = _f32(self._get_lr(index)), self._get_wd(index)
        g = _prep(grad.to(weight.dtype), self.rescale_grad, self._clip())
        g = g + _f32(wd) * weight
        mhat, vhat = self._moments(g, state, t)
        weight.copy_(weight - lr * mhat / (torch.sqrt(vhat)
                                           + _f32(self.epsilon)))


@register
class AdamW(Adam):
    """Adam with decoupled weight decay: ``w -= eta * (lr * mhat /
    (sqrt(vhat) + eps) + wd * w)``."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, correct_bias=True, eta=1.0, **kwargs):
        super().__init__(learning_rate=learning_rate, beta1=beta1,
                         beta2=beta2, epsilon=epsilon, **kwargs)
        self.eta = eta

    def update(self, index, weight, grad, state):
        self._update_count(index)
        t = self._index_update_count[index]
        lr, wd = _f32(self._get_lr(index)), _f32(self._get_wd(index))
        g = _prep(grad.to(weight.dtype), self.rescale_grad, self._clip())
        mhat, vhat = self._moments(g, state, t)
        step = lr * mhat / (torch.sqrt(vhat) + _f32(self.epsilon)) \
            + wd * weight
        weight.copy_(weight - _f32(self.eta) * step)


class Updater:
    """``updater(index, grad, weight)``: the optimizer's update of one
    parameter with the state of its index, made at the first update, both
    through the multi-precision path (``mxnet_tpu/optimizer/__init__.py:
    813-817``).  Checkpointing the states (``get_states`` /
    ``set_states``) is not ported (ROADMAP A1.4)."""

    def __init__(self, optimizer: Optimizer):
        self.optimizer = optimizer
        self.states: Dict[Any, Any] = {}

    def __call__(self, index, grad: torch.Tensor, weight: torch.Tensor):
        if index not in self.states:
            self.states[index] = \
                self.optimizer.create_state_multi_precision(index, weight)
        self.optimizer.update_multi_precision(index, weight, grad,
                                              self.states[index])


def get_updater(optimizer: Optimizer) -> Updater:
    return Updater(optimizer)
