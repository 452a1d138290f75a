"""The dynamic loss scaler of the eager path.

The port of ``mxnet_tpu/amp/loss_scaler.py``: the scale doubles after
``scale_window`` clean steps and is divided by ``scale_factor`` (floored
at 1) on an overflow, which resets the window; ``skipped_steps`` counts
the overflow steps.  ``post_backward`` reads the finiteness of the
gradients on the host (the eager loop decides there whether to step).
``ShardedTrainer(compute_dtype=torch.float16)`` runs the same policy on
the device inside its step instead (``parallel/trainer.py``).
``state_dict`` / ``load_state_dict`` checkpoint the scaler, so a resumed
run neither re-warms the scale nor forgets its overflow history.
"""
from __future__ import annotations

import torch

from .. import telemetry as _tel

__all__ = ["LossScaler"]


class LossScaler:
    """Dynamic loss scaling (module docstring)."""

    def __init__(self, init_scale=2.0 ** 16, scale_factor=2.0,
                 scale_window=2000):
        self.loss_scale = init_scale
        self._scale_factor = scale_factor
        self._scale_window = scale_window
        self._unskipped = 0
        self.has_overflow = False
        #: overflow-skipped updates since construction or restore
        self.skipped_steps = 0

    def post_backward(self, grads) -> bool:
        """Check ``grads`` (tensors) and move the scale; True when the
        step must be skipped."""
        finite = bool(torch.stack([torch.isfinite(g).all()
                                   for g in grads]).all()) if grads else True
        self.has_overflow = not finite
        if self.has_overflow:
            self.loss_scale = max(self.loss_scale / self._scale_factor, 1.0)
            self._unskipped = 0
            self.skipped_steps += 1
        else:
            self._unskipped += 1
            if self._unskipped >= self._scale_window:
                self.loss_scale *= self._scale_factor
                self._unskipped = 0
        if _tel._ENABLED:
            _tel.set_gauge("amp.loss_scale", float(self.loss_scale))
            _tel.set_gauge("amp.skipped_steps", self.skipped_steps)
        return self.has_overflow

    def state_dict(self) -> dict:
        """The scaler's state as plain scalars."""
        return {"loss_scale": float(self.loss_scale),
                "scale_factor": float(self._scale_factor),
                "scale_window": int(self._scale_window),
                "unskipped": int(self._unskipped),
                "skipped_steps": int(self.skipped_steps)}

    def load_state_dict(self, state: dict):
        """Restore :meth:`state_dict` output; keys an older checkpoint
        lacks keep their constructed values."""
        self.loss_scale = float(state["loss_scale"])
        self._scale_factor = float(state.get("scale_factor",
                                             self._scale_factor))
        self._scale_window = int(state.get("scale_window",
                                           self._scale_window))
        self._unskipped = int(state.get("unskipped", 0))
        self.skipped_steps = int(state.get("skipped_steps", 0))
        self.has_overflow = False
