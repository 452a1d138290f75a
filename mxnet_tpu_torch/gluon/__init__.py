"""Gluon of the port: ``Block`` / ``HybridBlock``, ``Trainer``, layers,
the recurrent layers and cells (``rnn``), losses, the model zoo,
``data`` and ``metric``.  A JAX name not yet ported raises
:class:`~mxnet_tpu_torch.base.MXNetError` naming its ROADMAP item
(``_not_ported.GLUON``)."""
from .. import _not_ported
from . import data, loss, metric, model_zoo, nn, parameter, rnn
from .block import Block, HybridBlock
from .trainer import Trainer

__all__ = ["Block", "HybridBlock", "Trainer", "data", "loss", "metric",
           "model_zoo", "nn", "parameter", "rnn"]

__getattr__ = _not_ported.module_getattr(__name__, "mx.gluon",
                                         _not_ported.GLUON)
