"""Fused recurrent layers RNN / LSTM / GRU, the port of
``mxnet_tpu/gluon/rnn/rnn_layer.py`` (ref python/mxnet/gluon/rnn/
rnn_layer.py → ``npx.rnn``, src/operator/rnn.cc).

Parameters are held unfused per layer and direction, with the JAX
package's names (``l0_i2h_weight``, ``r0_h2h_bias``, ...), so
``convert.load_into`` carries a JAX layer's weights unchanged.  Each
records its initializer for ``Block.initialize``, whose name routing
gives every ``*_bias`` zeros as in the JAX package.  The forward hands
the per-layer tensors to ``npx.rnn`` as they are: the JAX layer packs
them into the flat cuDNN vector first, which gives the same numbers.

The port builds its parameters at construction on ``device`` (None is
``cuda:0``); ``input_size=0`` (the default) defers the first layer's
``i2h_weight`` until the first input gives its width (its last axis),
as the JAX layer infers it.
"""
from __future__ import annotations

import torch

from ... import numpy_extension as npx
from ...base import MXNetError
from ...context import resolve_device
from ...ops.rnn import gates_of
from ..block import HybridBlock
from ..nn.basic_layers import _empty
from ..parameter import set_shape

__all__ = ["RNN", "LSTM", "GRU"]


class _RNNLayer(HybridBlock):
    def __init__(self, mode, hidden_size, num_layers=1, layout="TNC",
                 dropout=0.0, bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 dtype=torch.float32, use_sequence_length=False,
                 device=None):
        super().__init__()
        if layout not in ("TNC", "NTC"):
            raise MXNetError(f"Invalid layout '{layout}'; must be TNC or NTC")
        self._mode = mode
        self._hidden_size = hidden_size
        self._num_layers = num_layers
        self._layout = layout
        self._dropout = dropout
        self._dir = 2 if bidirectional else 1
        self._input_size = int(input_size)
        self._use_sequence_length = use_sequence_length
        self._gates = gates_of(mode)

        dev = resolve_device(device)
        ng, nh = self._gates, hidden_size
        for l in range(num_layers):
            in_sz = self._input_size if l == 0 else nh * self._dir
            for d in ("l", "r")[:self._dir]:
                for name, shape, init in (
                        ("i2h_weight", (ng * nh, in_sz),
                         i2h_weight_initializer),
                        ("h2h_weight", (ng * nh, nh), h2h_weight_initializer),
                        ("i2h_bias", (ng * nh,), i2h_bias_initializer),
                        ("h2h_bias", (ng * nh,), h2h_bias_initializer)):
                    setattr(self, f"{d}{l}_{name}",
                            _empty(shape, dev, dtype, init))

    def infer_shape(self, x, *args, **kwargs):
        in_sz = x.shape[2] if self._layout == "TNC" else x.shape[-1]
        for d in ("l", "r")[:self._dir]:
            set_shape(getattr(self, f"{d}0_i2h_weight"),
                      (self._gates * self._hidden_size, in_sz))

    # -- state ---------------------------------------------------------------
    def state_info(self, batch_size=0):
        info = [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}]
        if self._mode == "lstm":
            info.append(dict(info[0]))
        return info

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """Initial hidden (and cell) state, zeros by default (ref
        rnn_layer.py begin_state), on the layer's device unless
        ``device=`` says otherwise; ``func(shape, **kwargs)`` builds
        each."""
        func = func or torch.zeros
        kwargs.setdefault("device", self.l0_i2h_weight.device)
        return [func(info["shape"], **kwargs)
                for info in self.state_info(batch_size)]

    def _per_layer(self):
        return [tuple(getattr(self, f"{d}{l}_{name}") for name in
                      ("i2h_weight", "h2h_weight", "i2h_bias", "h2h_bias"))
                for l in range(self._num_layers)
                for d in ("l", "r")[:self._dir]]

    # -- forward -------------------------------------------------------------
    def forward(self, x, states=None, sequence_length=None):
        """x: (T, N, C) for TNC layout, (N, T, C) for NTC.  If ``states`` is
        given returns (output, out_states); else just output (ref
        rnn_layer.py forward_kernel)."""
        if self._use_sequence_length != (sequence_length is not None):
            raise MXNetError(
                "sequence_length must be given iff the layer was built with "
                "use_sequence_length=True (ref rnn_layer.py forward)")
        skip_states = states is None
        if self._layout == "NTC":
            x = x.transpose(0, 1)
        if skip_states:
            states = self.begin_state(batch_size=x.shape[1], dtype=x.dtype,
                                      device=x.device)
        if not isinstance(states, (list, tuple)):
            states = [states]

        res = npx.rnn(x, self._per_layer(), *states,
                      mode=self._mode, state_size=self._hidden_size,
                      num_layers=self._num_layers,
                      bidirectional=self._dir == 2, p=self._dropout,
                      state_outputs=True,
                      sequence_length=sequence_length,
                      use_sequence_length=sequence_length is not None)
        out, out_states = res[0], list(res[1:])
        if self._layout == "NTC":
            out = out.transpose(0, 1)
        return out if skip_states else (out, out_states)

    def __repr__(self):
        return (f"{type(self).__name__}({self._hidden_size}, "
                f"num_layers={self._num_layers}, "
                f"bidirectional={self._dir == 2}, layout={self._layout})")


class RNN(_RNNLayer):
    """Vanilla (Elman) RNN with relu/tanh activation (ref rnn_layer.py RNN)."""

    def __init__(self, hidden_size, num_layers=1, activation="relu", **kwargs):
        if activation not in ("relu", "tanh"):
            raise MXNetError("RNN activation must be 'relu' or 'tanh'")
        super().__init__(f"rnn_{activation}", hidden_size, num_layers, **kwargs)


class LSTM(_RNNLayer):
    """Multi-layer LSTM (ref rnn_layer.py LSTM; gates [i, f, g, o])."""

    def __init__(self, hidden_size, num_layers=1, **kwargs):
        super().__init__("lstm", hidden_size, num_layers, **kwargs)


class GRU(_RNNLayer):
    """Multi-layer GRU (ref rnn_layer.py GRU; cuDNN gate order [r, z, n])."""

    def __init__(self, hidden_size, num_layers=1, **kwargs):
        super().__init__("gru", hidden_size, num_layers, **kwargs)
