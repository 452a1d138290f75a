"""Automatic mixed precision: the port of ``mxnet_tpu/amp``.

The policy is the JAX package's: bf16 (no loss scaling) or f16 (dynamic
loss scaling), f32 master parameters.  ``init`` records it;
``trainer_kwargs`` gives the ``ShardedTrainer`` arguments that run it
inside the step (``compute_dtype``, ``loss_scaling``), and
``init_trainer`` checks a ``ShardedTrainer`` against it or attaches a
:class:`LossScaler` to an eager ``gluon.Trainer``, whose loop then runs
``scale_loss`` / ``unscale``.  ``convert_hybrid_block`` casts a block's
parameters to the target type, keeping ``gamma``, ``beta``, ``bias``
and running statistics in f32.  There is no symbol graph in the port:
``convert_symbol`` raises (ROADMAP A6).
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from .loss_scaler import LossScaler

__all__ = ["init", "init_trainer", "trainer_kwargs", "convert_hybrid_block",
           "convert_model", "convert_symbol", "scale_loss", "unscale",
           "LossScaler", "list_bf16_ops", "list_fp32_ops"]

# ops whose parameters and inputs go to the low-precision type
_BF16_OPS = ["convolution", "deconvolution", "fully_connected", "batch_dot",
             "dot", "matmul", "embedding", "rnn"]
# ops kept f32 (reductions, normalizations, losses)
_FP32_OPS = ["batch_norm", "layer_norm", "group_norm", "instance_norm",
             "softmax", "log_softmax", "softmax_cross_entropy", "norm",
             "mean", "sum", "lrn"]

_state = {"initialized": False, "target_dtype": torch.bfloat16,
          "loss_scaler": None}


def list_bf16_ops():
    return list(_BF16_OPS)


def list_fp32_ops():
    return list(_FP32_OPS)


def _target(target_dtype) -> torch.dtype:
    """bf16 for ``"bfloat16"`` / ``"bf16"`` / ``torch.bfloat16``, else f16
    (the JAX package's rule, which takes names)."""
    if target_dtype is torch.bfloat16 or \
            str(target_dtype) in ("bfloat16", "bf16"):
        return torch.bfloat16
    return torch.float16


def init(target_dtype="bfloat16", target_precision_ops=None,
         conditional_fp32_ops=None, fp32_ops=None):
    """Record the policy; f16 gets a :class:`LossScaler`."""
    dt = _target(target_dtype)
    _state.update(initialized=True, target_dtype=dt)
    if dt == torch.float16:
        _state["loss_scaler"] = LossScaler()


def trainer_kwargs() -> dict:
    """The ``ShardedTrainer`` arguments of the active policy::

        amp.init(target_dtype="bfloat16")
        trainer = ShardedTrainer(net, loss, **amp.trainer_kwargs(), ...)

    ``compute_dtype`` is the target type and ``loss_scaling="auto"``
    (on exactly for f16); master parameters stay f32."""
    if not _state["initialized"]:
        raise MXNetError("amp.init() must be called before "
                         "amp.trainer_kwargs()")
    return {"compute_dtype": _state["target_dtype"], "loss_scaling": "auto"}


def init_trainer(trainer):
    """A ``ShardedTrainer`` runs the policy inside its step: check that it
    was built with it.  Any other trainer gets the f16 policy's
    :class:`LossScaler` for ``scale_loss``."""
    if not _state["initialized"]:
        raise MXNetError("amp.init() must be called before amp.init_trainer()")
    from ..parallel.trainer import ShardedTrainer

    if isinstance(trainer, ShardedTrainer):
        want = _state["target_dtype"]
        if trainer.compute_dtype != want:
            name = str(want).replace("torch.", "")
            raise MXNetError(
                f"amp {name} with ShardedTrainer: pass "
                f"compute_dtype=torch.{name} at construction (or use "
                "amp.trainer_kwargs()); the policy runs inside the step")
        if want == torch.float16 and not trainer._dynamic_scaling:
            raise MXNetError(
                "amp fp16 with ShardedTrainer: dynamic loss scaling was "
                "disabled (loss_scaling=False); fp16 gradients underflow "
                "without it")
        return
    if _state["loss_scaler"] is not None:
        trainer._amp_loss_scaler = _state["loss_scaler"]


def _grads(trainer):
    from ..gluon.parameter import grad_req

    return [p.grad for p in trainer._params
            if grad_req(p) != "null" and p.grad is not None]


class scale_loss:
    """``with amp.scale_loss(loss, trainer) as scaled: scaled.backward()``:
    multiplies by the current scale (and sets the optimizer's
    ``rescale_grad`` to its inverse); on exit the scaler checks the
    gradients and moves the scale."""

    def __init__(self, loss, trainer):
        self._trainer = trainer
        scaler = getattr(trainer, "_amp_loss_scaler", None)
        if scaler is None:
            self._scaled = loss
        else:
            self._scaled = loss * scaler.loss_scale
            trainer._optimizer.rescale_grad = 1.0 / scaler.loss_scale
        self._scaler = scaler

    def __enter__(self):
        return self._scaled

    def __exit__(self, *exc):
        if self._scaler is not None:
            self._scaler.post_backward(_grads(self._trainer))


def unscale(trainer):
    """Divide every gradient by the current loss scale, in place."""
    scaler = getattr(trainer, "_amp_loss_scaler", None)
    if scaler is None:
        return
    inv = 1.0 / scaler.loss_scale
    with torch.no_grad():
        for g in _grads(trainer):
            g.mul_(inv)


_KEEP_FP32 = ("gamma", "beta", "running_", "moving_", "bias")


def _cast_params(block, dtype, keep_fp32_patterns=_KEEP_FP32):
    for name, p in block.named_parameters():
        short = name.rsplit(".", 1)[-1]
        if any(short.startswith(pat) or pat in short
               for pat in keep_fp32_patterns):
            continue
        p.data = p.data.to(dtype)
    return block


def convert_hybrid_block(block, target_dtype="bfloat16",
                         target_dtype_ops=None, fp32_ops=None,
                         conditional_fp32_ops=None, excluded_sym_names=None,
                         ctx=None, device=None, cast_params_offline=True):
    """Cast the block's parameters to the target type in place, except
    ``gamma``, ``beta``, ``bias`` and running statistics (buffers here),
    which stay f32; returns the block."""
    dt = _target(target_dtype)
    _cast_params(block, dt)
    block._amp_dtype = dt
    return block


convert_model = convert_hybrid_block


def convert_symbol(sym, target_dtype="bfloat16", target_dtype_ops=None,
                   fp32_ops=None, excluded_sym_names=None):
    """The port has no symbol graph (``symbol/``): raises."""
    raise MXNetError("amp.convert_symbol: mx.symbol is not ported yet "
                     "(ROADMAP A6, long tail); convert a block with "
                     "amp.convert_hybrid_block")
