"""``gluon.Trainer``: the eager training loop's optimizer step.

The port of ``mxnet_tpu/gluon/trainer.py`` on one device::

    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.05, "momentum": 0.9})
    with autograd.record():
        loss = loss_fn(net(x), y)
    autograd.backward(loss)          # or loss.sum().backward()
    trainer.step(x.shape[0])

Parameters are indexed in ``sorted(params)`` order, as the JAX trainer
indexes them, so optimizer states and per-index multipliers line up.
``step(batch_size)`` sets ``rescale_grad = 1 / batch_size`` and updates
every parameter whose ``grad_req`` is not "null" in place (one whose
shape still waits for the first forward is skipped, as the JAX trainer
skips a parameter without data), through the
optimizer's per-parameter ``update`` (an ``optimizer.Updater``); a
parameter that never received a gradient updates with zeros, as the
JAX trainer's zero-filled gradient buffer does.  The trainer holds the
"write" hooks of its parameters (``gluon.parameter``), so each
backward overwrites the gradient the step reads.

``kvstore``: ``None`` / ``False`` keep the gradients as they are; a
name (``kvstore.create``: ``device``, ``dist_sync``, ...) or a
``KVStoreBase`` reduces them in ``allreduce_grads``: a cross-process
store sums every gradient over the ranks of ``parallel.dist`` (one
collective for all of them, ``pushpull_group``), and the update's
``rescale_grad`` becomes ``1 / (batch_size * num_workers)``, the
global batch's mean; ``compression_params`` go to the store
(``set_gradient_compression``).  The update runs here whatever
``update_on_kvstore`` says.  ``optimizer_params`` may carry an
``lr_scheduler`` (``lr_scheduler.py``), read with the update count.
``save_states`` / ``load_states`` carry the optimizer states in the
JAX package's file (``Updater.get_states``: a pickle of ``{index: numpy
array | tuple | None}``, written atomically), so a states file of either
package loads into the other.  As in the JAX package the file holds no
update counts: a resumed run continues its schedule and bias
corrections with ``optimizer_params={"begin_num_update": t}``.  Steps are dispatched asynchronously; at most
``MXNET_MAX_INFLIGHT_STEPS`` (default 2) are in flight
(``engine.BoundedInflight`` waits on a CUDA event recorded after each
step).  Telemetry: ``trainer.step_seconds``, the host time of a step.
"""
from __future__ import annotations

from typing import List

import torch

from .. import optimizer as opt_mod
from ..base import MXNetError
from ..engine import BoundedInflight
from ..trace import recorder as _tr
from .parameter import GradReqHooks, grad_req, is_deferred

__all__ = ["Trainer"]


class Trainer:
    """Applies an optimizer to a set of parameters (module docstring)."""

    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None):
        if isinstance(params, dict):
            param_list = [params[k] for k in sorted(params)]
        elif isinstance(params, (list, tuple)):
            param_list = list(params)
        else:
            raise MXNetError("params must be dict or list of Parameters")
        for p in param_list:
            if not isinstance(p, torch.nn.Parameter):
                raise MXNetError(f"Trainer expects Parameters, got {type(p)}")
        self._kv_name = kvstore
        self._compression_params = compression_params
        self._kvstore = None
        self._kv_initialized = False
        self._params: List[torch.nn.Parameter] = param_list
        self._hooks = GradReqHooks()
        self._hooks.attach(param_list)
        param_dict = dict(enumerate(param_list))
        if isinstance(optimizer, opt_mod.Optimizer):
            if optimizer_params:
                raise MXNetError("optimizer_params must be None if optimizer "
                                 "is an Optimizer instance")
            self._optimizer = optimizer
            self._optimizer.param_dict = param_dict
        else:
            self._optimizer = opt_mod.create(optimizer, param_dict=param_dict,
                                             **(optimizer_params or {}))
        self._updater = opt_mod.get_updater(self._optimizer)
        self._inflight = BoundedInflight()

    # -- kvstore --------------------------------------------------------------
    def _init_kvstore(self):
        """The store of ``kvstore`` (module docstring), with the
        compression parameters."""
        from ..kvstore import KVStoreBase
        from ..kvstore import create as kv_create

        if self._kv_name is None or self._kv_name is False:
            self._kvstore = None
        else:
            kv = self._kv_name if isinstance(self._kv_name, KVStoreBase) \
                else kv_create(self._kv_name)
            if self._compression_params:
                kv.set_gradient_compression(self._compression_params)
            self._kvstore = kv
        self._kv_initialized = True

    def _rescale(self, batch_size):
        """The gradients' scale: pushpull SUMS over the workers, so a dist
        store normalizes by the global batch (``batch_size`` is the
        per-worker batch)."""
        nw = self._kvstore.num_workers if self._kvstore is not None else 1
        return 1.0 / (batch_size * nw)

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    @learning_rate.setter
    def learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    @property
    def optimizer(self):
        return self._optimizer

    def step(self, batch_size, ignore_stale_grad: bool = False):
        """``allreduce_grads`` then ``update``; returns without waiting
        for the device (module docstring).  The call is the
        ``trainer.step`` span, timer ``trainer.step_seconds``."""
        with _tr.span("trainer.step", timer="trainer.step_seconds",
                      timer_on_error=True):
            self.allreduce_grads()
            self.update(batch_size, ignore_stale_grad)
            event = None
            dev = self._params[0].device if self._params else None
            if dev is not None and dev.type == "cuda":
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(dev))
            self._inflight.push(event)

    def drain(self):
        """Wait for every in-flight step."""
        self._inflight.drain()

    def allreduce_grads(self):
        """Sum the gradients through the store: over the ranks when it
        spans several processes (one fused collective, or one pushpull a
        parameter with an optimizer-on-store); a one-process store has
        one copy of each gradient, so nothing to do."""
        if not self._kv_initialized:
            self._init_kvstore()
        kv = self._kvstore
        if kv is None or kv.num_workers <= 1:
            return
        pending = [(i, p) for i, p in enumerate(self._params)
                   if grad_req(p) != "null" and not is_deferred(p)]
        for _, p in pending:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if not pending:
            return
        from .. import telemetry as _tel

        if _tel._ENABLED:
            _tel.inc("trainer.allreduce_calls")
            _tel.inc("trainer.allreduce_bytes",
                     sum(p.grad.numel() * p.grad.element_size()
                         for _, p in pending))
        with _tr.span("trainer.allreduce",
                      timer="trainer.allreduce_seconds",
                      timer_on_error=True):
            group = getattr(kv, "pushpull_group", None)
            if group is not None and getattr(kv, "_updater", None) is None:
                group([i for i, _ in pending], [p.grad for _, p in pending])
            else:
                for i, p in pending:
                    kv.pushpull(i, p.grad, out=p.grad)

    @torch.no_grad()
    def update(self, batch_size, ignore_stale_grad: bool = False):
        """One optimizer update of every parameter whose ``grad_req`` is
        not "null", with ``rescale_grad = 1 / batch_size``."""
        if not self._kv_initialized:
            self._init_kvstore()
        self._optimizer.rescale_grad = self._rescale(batch_size)
        for i, p in enumerate(self._params):
            if grad_req(p) == "null" or is_deferred(p):
                continue
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            self._updater(i, g, p)

    def zero_grad(self):
        """Zero every gradient in place."""
        for p in self._params:
            if p.grad is not None:
                p.grad.zero_()

    def save_states(self, fname):
        """The optimizer states into ``fname`` (module docstring), after
        the in-flight steps."""
        from ..resilience.checkpoint import write_payload

        self.drain()
        write_payload(fname, self._updater.get_states(dump_optimizer=False))

    def load_states(self, fname):
        """The optimizer states of a :meth:`save_states` file (of either
        package); each moves to its parameter's device at the next
        update.  The file is a pickle: load only files you trust."""
        with open(fname, "rb") as f:
            self._updater.set_states(f.read())
        self._optimizer = self._updater.optimizer
