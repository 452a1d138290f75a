"""``PixelShuffle2D`` of ``mxnet_tpu/gluon/nn/extended_layers.py``; the
module's ``BatchNormReLU`` is ``basic_layers``' (re-exported here).  The
1-D and 3-D shuffles and the deformable convolutions are ROADMAP A6g."""
from __future__ import annotations

from ...base import MXNetError
from ..block import HybridBlock
from .basic_layers import BatchNormReLU

__all__ = ["PixelShuffle2D", "BatchNormReLU"]


class PixelShuffle2D(HybridBlock):
    """(N, C * fh * fw, H, W) -> (N, C, H * fh, W * fw), channel-first,
    as the JAX layer rearranges it: channel ``c * fh * fw + i * fw + j``
    goes to row offset ``i`` and column offset ``j``."""

    def __init__(self, factor):
        super().__init__()
        self._factors = (int(factor),) * 2 if isinstance(factor, int) \
            else tuple(int(f) for f in factor)

    def forward(self, x):
        fh, fw = self._factors
        n, c, h, w = x.shape
        if c % (fh * fw):
            raise MXNetError(f"channels {c} not divisible by prod(factor) "
                             f"{fh * fw}")
        cout = c // (fh * fw)
        y = x.reshape(n, cout, fh, fw, h, w).permute(0, 1, 4, 2, 5, 3)
        return y.reshape(n, cout, h * fh, w * fw)
