"""Durable writes for checkpoints (the port's subset of
``mxnet_tpu/resilience``)."""
from .checkpoint import write_payload

__all__ = ["write_payload"]
