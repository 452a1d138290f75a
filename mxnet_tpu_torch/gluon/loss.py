"""Loss blocks of the training path.

The port of ``Loss`` and ``SoftmaxCrossEntropyLoss`` (``SoftmaxCELoss``)
from ``mxnet_tpu/gluon/loss.py``: a loss returns one value per sample,
the mean over every axis but ``batch_axis``.  Plain PyTorch: these were
XLA ops in the JAX package, not Pallas kernels.
"""
from __future__ import annotations

import torch

from .block import HybridBlock

__all__ = ["Loss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss"]


class Loss(HybridBlock):
    """Base loss: ``weight`` scales it, ``batch_axis`` survives the mean."""

    def __init__(self, weight=None, batch_axis: int = 0):
        super().__init__()
        self._weight = weight
        self._batch_axis = batch_axis

    def forward(self, *args, **kwargs):
        raise NotImplementedError

    def _mean(self, loss):
        axes = tuple(i for i in range(loss.ndim) if i != self._batch_axis)
        return loss.mean(dim=axes) if axes else loss


class SoftmaxCrossEntropyLoss(Loss):
    """Softmax cross entropy over ``axis``.

    ``sparse_label=True``: ``label`` holds class indices (the shape of
    ``pred`` without ``axis``, or with ``axis`` of size 1);
    ``sparse_label=False``: ``label`` is a distribution shaped like
    ``pred``.  ``from_logits=True`` takes ``pred`` as log-probabilities
    already.  ``sample_weight`` multiplies the per-element loss.

    Types follow the JAX loss: 16-bit scores give a 16-bit loss
    (``log_softmax`` in their type; the means accumulate in f32), and a
    dense f32 label or an f32 ``sample_weight`` promotes it to f32."""

    def __init__(self, axis: int = -1, sparse_label: bool = True,
                 from_logits: bool = False, weight=None, batch_axis: int = 0):
        super().__init__(weight, batch_axis)
        self._axis = axis
        self._sparse = sparse_label
        self._from_logits = from_logits

    def forward(self, pred, label, sample_weight=None):
        logp = pred if self._from_logits else \
            torch.log_softmax(pred, dim=self._axis)
        if self._sparse:
            li = torch.as_tensor(label, device=pred.device).long()
            if li.ndim == logp.ndim:
                li = li.squeeze(self._axis)
            loss = -torch.gather(logp, self._axis,
                                 li.unsqueeze(self._axis)).squeeze(self._axis)
        else:
            lab = torch.as_tensor(label, device=pred.device)
            if lab.dtype == torch.float64:      # JAX holds f64 as f32
                lab = lab.float()
            loss = -(lab.reshape(logp.shape) * logp).sum(dim=self._axis)
        if self._weight is not None:
            loss = loss * self._weight
        if sample_weight is not None:
            loss = loss * sample_weight
        return self._mean(loss)


SoftmaxCELoss = SoftmaxCrossEntropyLoss
