"""Durable writes for checkpoints and deterministic fault injection (the
port's subset of ``mxnet_tpu/resilience``)."""
from . import chaos
from .chaos import ChaosError
from .checkpoint import write_payload

__all__ = ["chaos", "ChaosError", "write_payload"]
