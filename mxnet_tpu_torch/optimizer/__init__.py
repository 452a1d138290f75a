"""Optimizers: the registry of all 19, and the per-index ``Updater``.

The port of ``mxnet_tpu/optimizer/__init__.py``: ``create('adam', ...)``,
``create_state(index, weight)`` and ``update(index, weight, grad,
state)``, which updates ``weight`` and the state tensors IN PLACE (the
JAX package rebinds immutable arrays).  ``SGD``, ``NAG``, ``Adam`` and
``AdamW`` perform the operations of the JAX package's jitted kernels
(``_sgd_kernel``, ``_adam_kernel``, ``_adamw_kernel``) in the same
order, in float32: the hyperparameters enter as float32 scalars, as the
jitted kernels receive them, and ``1 - beta**t`` is computed in float32.
The other fifteen (``SGLD``, ``Adamax``, ``Nadam``, ``RMSProp``,
``AdaGrad``, ``AdaDelta``, ``Ftrl``, ``Signum``, ``LARS``, ``LAMB``,
``FTML``, ``LANS``, ``LBSGD``, ``DCASGD``, ``Test``) follow the JAX
package's eager code line by line: host arithmetic in Python floats, a
Python float meeting a tensor as a float32 scalar, as in JAX.  Choices
that depend on values (a norm that may be 0) are ``torch.where``, never
a host read, so an update never waits on the device and runs under
``torch.func.vmap`` (``ShardedTrainer(multi_tensor=True)``) with one
norm per tensor.  ``SGLD`` draws its noise from the port's seeded
generator (``random.generator``), not a JAX key.  An optimizer whose
update keeps host state across calls (``Nadam``'s momentum schedule) or
draws random numbers (``SGLD``) sets ``vmappable = False``: the
multi-tensor trainer updates its tensors one by one.

The base class carries the learning-rate schedule (``lr_scheduler``,
read with the update count), the lr / wd multipliers (``set_lr_mult``,
``set_wd_mult``, a parameter's ``lr_mult`` / ``wd_mult``) and
``begin_num_update``; :class:`Updater` pickles its states as
``{index: numpy array | tuple | None}``, the JAX package's format, so a
states file written by either package loads into the other.
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

import math
import pickle
from typing import Any, Dict

import numpy as np
import torch

from ..base import MXNetError

__all__ = ["Optimizer", "register", "create", "Updater", "get_updater",
           "SGD", "NAG", "Adam", "AdamW", "Adamax", "Nadam", "RMSProp",
           "AdaGrad", "AdaDelta", "Ftrl", "Signum", "LARS", "LAMB", "SGLD",
           "DCASGD", "Test", "FTML", "LANS", "LBSGD"]

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
    """Base optimizer: learning rate (or its schedule), weight decay,
    gradient rescale and clip, per-index update counts and lr/wd
    multipliers."""

    #: whether ``update`` may run under ``torch.func.vmap`` on a stack of
    #: same-shaped tensors (module docstring)
    vmappable = True

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

    def _prep_grad(self, grad):
        """``grad * rescale_grad``, clipped to ``[-clip, clip]`` when a
        clip is set: the JAX package's eager ``_prep_grad``."""
        g = grad * self.rescale_grad
        if self.clip_gradient is not None:
            c = self.clip_gradient
            g = torch.clamp(g, -c, c)
        return g

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


def _zeros(weight, n):
    """``n`` zero tensors shaped like ``weight``, each its own storage."""
    return tuple(torch.zeros_like(weight) for _ in range(n))


def _norm(x):
    """The 2-norm of the whole tensor (``jnp.linalg.norm`` of a vector or
    the Frobenius norm of a matrix); one per tensor under vmap."""
    return torch.linalg.vector_norm(x)


@register
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics: ``w - lr / 2 * g + N(0,
    lr)``, the noise from the port's seeded generator of the weight's
    device (module docstring)."""

    vmappable = False

    def __init__(self, learning_rate=0.01, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)

    def update(self, index, weight, grad, state):
        from .. import random as _random

        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        g = self._prep_grad(grad) + wd * weight
        noise = torch.randn(weight.shape, dtype=weight.dtype,
                            device=weight.device,
                            generator=_random.generator(weight.device))
        weight.copy_(weight - lr / 2 * g + noise * math.sqrt(lr))


@register
class Adamax(Optimizer):
    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2 = beta1, beta2

    def create_state(self, index, weight):
        return _zeros(weight, 2)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        t = self._index_update_count[index]
        lr, wd = self._get_lr(index), self._get_wd(index)
        lr /= (1 - self.beta1 ** t)
        m, u = state
        g = self._prep_grad(grad) + wd * weight
        mm = self.beta1 * m + (1 - self.beta1) * g
        uu = torch.maximum(self.beta2 * u, torch.abs(g))
        weight.copy_(weight - lr * mm / (uu + 1e-8))
        m.copy_(mm)
        u.copy_(uu)


@register
class Nadam(Optimizer):
    """Adam with Nesterov momentum.  ``m_schedule`` is host state that
    every update multiplies (the JAX package's and the reference's
    rule), so the order of the updates matters and the multi-tensor
    trainer updates Nadam's tensors one by one (module docstring)."""

    vmappable = False

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, schedule_decay=0.004, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.schedule_decay = schedule_decay
        self.m_schedule = 1.0

    def create_state(self, index, weight):
        return _zeros(weight, 2)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        t = self._index_update_count[index]
        lr, wd = self._get_lr(index), self._get_wd(index)
        g = self._prep_grad(grad) + wd * weight
        momentum_t = self.beta1 * (1.0 - 0.5 * 0.96 ** (
            t * self.schedule_decay))
        momentum_t_1 = self.beta1 * (1.0 - 0.5 * 0.96 ** (
            (t + 1) * self.schedule_decay))
        self.m_schedule = self.m_schedule * momentum_t
        m_schedule_next = self.m_schedule * momentum_t_1
        m, v = state
        mm = self.beta1 * m + (1 - self.beta1) * g
        vv = self.beta2 * v + (1 - self.beta2) * (g * g)
        g_prime = g / (1 - self.m_schedule)
        m_prime = mm / (1 - m_schedule_next)
        v_prime = vv / (1 - self.beta2 ** t)
        m_bar = (1 - momentum_t) * g_prime + momentum_t_1 * m_prime
        weight.copy_(weight - lr * m_bar / (torch.sqrt(v_prime)
                                            + self.epsilon))
        m.copy_(mm)
        v.copy_(vv)


@register
class RMSProp(Optimizer):
    """RMSProp, Tieleman & Hinton's or Graves's centered variant."""

    def __init__(self, learning_rate=0.001, rho=0.9, momentum=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.rho, self.momentum, self.epsilon = rho, momentum, epsilon
        self.centered = centered
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        return _zeros(weight, 3 if self.centered else 1)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        g = self._prep_grad(grad) + wd * weight
        if self.centered:
            n, gm, delta = state
            nn = self.rho * n + (1 - self.rho) * (g * g)
            gg = self.rho * gm + (1 - self.rho) * g
            dd = self.momentum * delta - lr * g / torch.sqrt(
                nn - gg * gg + self.epsilon)
            w = weight + dd
            n.copy_(nn)
            gm.copy_(gg)
            delta.copy_(dd)
        else:
            (n,) = state
            nn = self.rho * n + (1 - self.rho) * (g * g)
            w = weight - lr * g / torch.sqrt(nn + self.epsilon)
            n.copy_(nn)
        if self.clip_weights:
            w = torch.clamp(w, -self.clip_weights, self.clip_weights)
        weight.copy_(w)


@register
class AdaGrad(Optimizer):
    def __init__(self, learning_rate=0.01, epsilon=1e-7, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return torch.zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        g = self._prep_grad(grad) + wd * weight
        hh = state + g * g
        weight.copy_(weight - lr * g / (torch.sqrt(hh) + self.epsilon))
        state.copy_(hh)


@register
class AdaDelta(Optimizer):
    def __init__(self, learning_rate=1.0, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.rho, self.epsilon = rho, epsilon

    def create_state(self, index, weight):
        return _zeros(weight, 2)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        wd = self._get_wd(index)
        g = self._prep_grad(grad) + wd * weight
        acc_g, acc_delta = state
        ag = self.rho * acc_g + (1 - self.rho) * (g * g)
        delta = torch.sqrt(acc_delta + self.epsilon) / torch.sqrt(
            ag + self.epsilon) * g
        ad = self.rho * acc_delta + (1 - self.rho) * (delta * delta)
        weight.copy_(weight - self.lr * delta)
        acc_g.copy_(ag)
        acc_delta.copy_(ad)


@register
class Ftrl(Optimizer):
    """Follow the regularized leader (the ``ftrl_update`` kernel's
    math)."""

    def __init__(self, learning_rate=0.1, lamda1=0.01, beta=1.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1, self.beta = lamda1, beta

    def create_state(self, index, weight):
        return _zeros(weight, 2)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        g = self._prep_grad(grad)
        z, n = state
        nn = n + g * g
        sigma = (torch.sqrt(nn) - torch.sqrt(n)) / lr
        zz = z + g - sigma * weight
        w = torch.where(torch.abs(zz) > self.lamda1,
                        -(zz - torch.sign(zz) * self.lamda1)
                        / ((self.beta + torch.sqrt(nn)) / lr + wd), 0.0)
        weight.copy_(w.to(weight.dtype))
        z.copy_(zz)
        n.copy_(nn)


@register
class Signum(Optimizer):
    """signSGD with momentum."""

    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.wd_lh = wd_lh

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return torch.zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        g = self._prep_grad(grad) + wd * weight
        if state is not None:
            mm = self.momentum * state - (1 - self.momentum) * g
            w = (1 - lr * self.wd_lh) * weight + lr * torch.sign(mm)
            state.copy_(mm)
        else:
            w = (1 - lr * self.wd_lh) * weight - lr * torch.sign(g)
        weight.copy_(w)


@register
class LARS(Optimizer):
    """Layer-wise adaptive rate scaling: a trust ratio from the tensor's
    own weight and gradient norms."""

    def __init__(self, learning_rate=0.1, momentum=0.9, eta=0.001,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum, self.eta, self.epsilon = momentum, eta, epsilon

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return torch.zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        g = self._prep_grad(grad)
        w_norm = _norm(weight)
        g_norm = _norm(g)
        ratio = torch.where((w_norm > 0) & (g_norm > 0),
                            self.eta * w_norm
                            / (g_norm + wd * w_norm + self.epsilon), 1.0)
        g = g + wd * weight
        if state is not None:
            mm = self.momentum * state + lr * ratio * g
            weight.copy_(weight - mm)
            state.copy_(mm)
        else:
            weight.copy_(weight - lr * ratio * g)


def _bounded(w_norm, lower, upper):
    """``w_norm`` held to ``[lower, upper]`` where each is set."""
    if lower is not None:
        w_norm = torch.clamp(w_norm, min=lower)
    if upper is not None:
        w_norm = torch.clamp(w_norm, max=upper)
    return w_norm


@register
class LAMB(Optimizer):
    """Layer-wise adaptive moments for batch training."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-6, lower_bound=None, upper_bound=None,
                 bias_correction=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.lower_bound, self.upper_bound = lower_bound, upper_bound
        self.bias_correction = bias_correction

    def create_state(self, index, weight):
        return _zeros(weight, 2)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        t = self._index_update_count[index]
        lr, wd = self._get_lr(index), self._get_wd(index)
        g = self._prep_grad(grad)
        m, v = state
        mm = self.beta1 * m + (1 - self.beta1) * g
        vv = self.beta2 * v + (1 - self.beta2) * (g * g)
        if self.bias_correction:
            mhat = mm / (1 - self.beta1 ** t)
            vhat = vv / (1 - self.beta2 ** t)
        else:
            mhat, vhat = mm, vv
        r = mhat / (torch.sqrt(vhat) + self.epsilon) + wd * weight
        w_norm = _bounded(_norm(weight), self.lower_bound, self.upper_bound)
        r_norm = _norm(r)
        ratio = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            1.0)
        weight.copy_(weight - lr * ratio * r)
        m.copy_(mm)
        v.copy_(vv)


@register
class FTML(Optimizer):
    """Follow the moving leader (Zheng & Kwok 2017)."""

    def __init__(self, learning_rate=0.0025, beta1=0.6, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return _zeros(weight, 3)       # d, v, z

    def update(self, index, weight, grad, state):
        self._update_count(index)
        t = self._index_update_count[index]
        lr, wd = self._get_lr(index), self._get_wd(index)
        g = self._prep_grad(grad) + wd * weight
        d, v, z = state
        vv = self.beta2 * v + (1 - self.beta2) * (g * g)
        denom = torch.sqrt(vv / (1 - self.beta2 ** t)) + self.epsilon
        dd = (1 - self.beta1 ** t) / lr * denom
        sigma = dd - self.beta1 * d
        zz = self.beta1 * z + (1 - self.beta1) * g - sigma * weight
        weight.copy_(-zz / dd)
        d.copy_(dd)
        v.copy_(vv)
        z.copy_(zz)


@register
class LANS(Optimizer):
    """LAMB with normalized gradients."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-6, lower_bound=None, upper_bound=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.lower_bound, self.upper_bound = lower_bound, upper_bound

    def create_state(self, index, weight):
        return _zeros(weight, 2)

    def _trust(self, w_norm, r_norm):
        w_norm = _bounded(w_norm, self.lower_bound, self.upper_bound)
        return torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm, 1.0)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        t = self._index_update_count[index]
        lr, wd = self._get_lr(index), self._get_wd(index)
        g = self._prep_grad(grad)
        gnorm = _norm(g)
        g = torch.where(gnorm > 0, g / gnorm, g)
        m, v = state
        mm = self.beta1 * m + (1 - self.beta1) * g
        vv = self.beta2 * v + (1 - self.beta2) * (g * g)
        mhat = mm / (1 - self.beta1 ** t)
        vhat = vv / (1 - self.beta2 ** t)
        denom = torch.sqrt(vhat) + self.epsilon
        w_norm = _norm(weight)
        r1 = mhat / denom + wd * weight          # the momentum part
        r2 = g / denom + wd * weight             # the gradient part
        ratio1 = self._trust(w_norm, _norm(r1))
        ratio2 = self._trust(w_norm, _norm(r2))
        weight.copy_(weight - lr * (self.beta1 * ratio1 * r1
                                    + (1 - self.beta1) * ratio2 * r2))
        m.copy_(mm)
        v.copy_(vv)


@register
class LBSGD(Optimizer):
    """Large-batch SGD: LARS-style scaling per tensor and a warmup toward
    ``lr * batch_scale``."""

    def __init__(self, learning_rate=0.01, momentum=0.0, multi_precision=False,
                 warmup_strategy="linear", warmup_epochs=5, batch_scale=1,
                 updates_per_epoch=32, begin_epoch=0, num_epochs=60,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        if warmup_strategy not in ("linear", "power2", "sqrt", "lars"):
            raise ValueError(f"unknown warmup_strategy {warmup_strategy}")
        self.momentum = momentum
        self.warmup_strategy = warmup_strategy
        self.warmup_updates = max(1, warmup_epochs * updates_per_epoch)
        self.batch_scale = batch_scale

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return torch.zeros_like(weight)

    def _warmup_lr(self, lr, t):
        target = lr * self.batch_scale
        if t >= self.warmup_updates:
            return target
        frac = (t + 1) / self.warmup_updates
        if self.warmup_strategy == "power2":
            frac = frac ** 2
        elif self.warmup_strategy == "sqrt":
            frac = frac ** 0.5
        elif self.warmup_strategy == "lars":
            frac = 1.0
        return lr + (target - lr) * frac if self.batch_scale > 1 \
            else target * frac

    def update(self, index, weight, grad, state):
        self._update_count(index)
        t = self._index_update_count[index]
        lr = self._warmup_lr(self._get_lr(index), t)
        wd = self._get_wd(index)
        g = self._prep_grad(grad) + wd * weight
        w_norm = _norm(weight)
        g_norm = _norm(g)
        phi = torch.where((w_norm > 0) & (g_norm > 0), w_norm / g_norm, 1.0)
        step = lr * torch.clamp(phi, max=1.0) * g
        if state is not None:
            mm = self.momentum * state + step
            weight.copy_(weight - mm)
            state.copy_(mm)
        else:
            weight.copy_(weight - step)


@register
class DCASGD(Optimizer):
    """Delay-compensated asynchronous SGD.  The state's previous weight
    is a tensor of its own, a copy of the weight at creation."""

    def __init__(self, learning_rate=0.01, momentum=0.0, lamda=0.04,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum, self.lamda = momentum, lamda

    def create_state(self, index, weight):
        mom = torch.zeros_like(weight) if self.momentum != 0.0 else None
        return (mom, weight.detach().clone())

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        g = self._prep_grad(grad) + wd * weight
        mom, prev = state
        comp = g + self.lamda * g * g * (weight - prev)
        if mom is not None:
            mm = self.momentum * mom - lr * comp
            w = weight + mm
            mom.copy_(mm)
        else:
            w = weight - lr * comp
        prev.copy_(weight)
        weight.copy_(w)


@register
class Test(Optimizer):
    """The trivial optimizer of the reference's tests: ``w -= lr * g`` and
    the state sums the raw gradients."""

    def create_state(self, index, weight):
        return torch.zeros_like(weight)

    def update(self, index, weight, grad, state):
        weight.copy_(weight - self.lr * self._prep_grad(grad))
        state.copy_(state + grad)


def _states_to_numpy(s):
    if s is None:
        return None
    if torch.is_tensor(s):
        return s.detach().cpu().numpy()
    if isinstance(s, (tuple, list)):
        return tuple(_states_to_numpy(x) for x in s)
    return s


def _states_from_numpy(s):
    if s is None:
        return None
    if isinstance(s, np.ndarray):
        return torch.from_numpy(np.array(s, copy=True))
    if isinstance(s, tuple):
        return tuple(_states_from_numpy(x) for x in s)
    return s


def _states_to(s, device):
    if torch.is_tensor(s):
        return s.to(device)
    if isinstance(s, tuple):
        return tuple(_states_to(x, device) for x in s)
    return s


class Updater:
    """``updater(index, grad, weight)``: the optimizer's update of one
    parameter with the state of its index, made at the first update, both
    through the multi-precision path (``mxnet_tpu/optimizer/__init__.py:
    813-817``).  ``get_states`` / ``set_states`` carry the states in the
    JAX package's pickle (module docstring); loaded states move to their
    weight's device at its next update."""

    def __init__(self, optimizer: Optimizer):
        self.optimizer = optimizer
        self.states: Dict[Any, Any] = {}
        self.states_synced: Dict[Any, bool] = {}

    def __call__(self, index, grad: torch.Tensor, weight: torch.Tensor):
        if index not in self.states:
            self.states[index] = \
                self.optimizer.create_state_multi_precision(index, weight)
            self.states_synced[index] = True
        elif not self.states_synced.get(index, True):
            self.states[index] = _states_to(self.states[index],
                                            weight.device)
            self.states_synced[index] = True
        self.optimizer.update_multi_precision(index, weight, grad,
                                              self.states[index])

    def get_states(self, dump_optimizer: bool = False) -> bytes:
        payload = {k: _states_to_numpy(v) for k, v in self.states.items()}
        return pickle.dumps((payload, self.optimizer) if dump_optimizer
                            else payload)

    def set_states(self, states: bytes):
        obj = pickle.loads(states)
        if isinstance(obj, tuple):
            payload, self.optimizer = obj
        else:
            payload = obj
        self.states = {k: _states_from_numpy(v) for k, v in payload.items()}
        self.states_synced = {k: False for k in self.states}


def get_updater(optimizer: Optimizer) -> Updater:
    return Updater(optimizer)
