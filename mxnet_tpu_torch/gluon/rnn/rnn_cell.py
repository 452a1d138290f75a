"""Recurrent cells and their unroll, the port of
``mxnet_tpu/gluon/rnn/rnn_cell.py`` (ref python/mxnet/gluon/rnn/
rnn_cell.py).

Cells are explicit single-step recurrences for custom loops; the fused
layers of ``rnn_layer.py`` are the performance path.  ``unroll`` is a
Python loop over the steps.  Each cell keeps its JAX formula as written
(``LSTMCell`` sums ``i2h + h2h`` with each bias inside its product,
which is not ``ops.rnn.cell_step``'s order), with the JAX parameter
names (``i2h_weight``, ``h2h_weight``, ``i2h_bias``, ``h2h_bias``;
``LSTMPCell`` also ``h2r_weight``).

The port builds a cell's parameters at construction on ``device`` (None
is ``cuda:0``); ``input_size=0`` (the default) defers ``i2h_weight``
until the first step's input gives its width, as the JAX cell infers
it.  A state built by ``begin_state`` lands on the cell's device.  The
convolutional cells (``Conv{1,2,3}D{RNN,LSTM,GRU}Cell``) are not ported
(ROADMAP A6): the port has only 2-D convolution.
"""
from __future__ import annotations

from typing import List

import torch

from ... import autograd
from ... import numpy_extension as npx
from ...base import MXNetError
from ...context import resolve_device
from ...ops import nn as _ops
from ...ops.rnn import _reverse_seq
from ..block import HybridBlock
from ..nn.basic_layers import _empty
from ..parameter import set_shape

__all__ = ["RecurrentCell", "HybridRecurrentCell", "RNNCell", "LSTMCell",
           "GRUCell", "SequentialRNNCell", "DropoutCell", "ResidualCell",
           "BidirectionalCell", "ZoneoutCell", "ModifierCell",
           "VariationalDropoutCell", "LSTMPCell", "HybridSequentialRNNCell",
           "Conv1DRNNCell", "Conv2DRNNCell", "Conv3DRNNCell",
           "Conv1DLSTMCell", "Conv2DLSTMCell", "Conv3DLSTMCell",
           "Conv1DGRUCell", "Conv2DGRUCell", "Conv3DGRUCell"]


def _cells_state_info(cells, batch_size):
    return sum([c.state_info(batch_size) for c in cells], [])


def _cells_begin_state(cells, **kwargs):
    return sum([c.begin_state(**kwargs) for c in cells], [])


class RecurrentCell(HybridBlock):
    """Base class: one step of recurrence (ref rnn_cell.py:RecurrentCell)."""

    def reset(self):
        """Reset per-sequence state before starting a new sequence (ref
        rnn_cell.py RecurrentCell.reset)."""
        for child in self.children():
            if isinstance(child, RecurrentCell):
                child.reset()

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """The zero states of :meth:`state_info` (``func(shape,
        **kwargs)`` builds each), on the cell's device unless ``device=``
        says otherwise."""
        func = func or torch.zeros
        if "device" not in kwargs:
            p = next(self.parameters(), None)
            kwargs["device"] = p.device if p is not None \
                else resolve_device(None)
        return [func(info["shape"], **kwargs)
                for info in self.state_info(batch_size)]

    def __call__(self, inputs, states=None, **kwargs):
        if states is None:
            states = self.begin_state(batch_size=inputs.shape[0],
                                      dtype=inputs.dtype,
                                      device=inputs.device)
        return super().__call__(inputs, states, **kwargs)

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        """Unroll the cell ``length`` steps (ref rnn_cell.py unroll).

        inputs: (N, T, C) for NTC, (T, N, C) for TNC, or list of (N, C).
        Returns (outputs, states); outputs merged into one tensor on the
        time axis unless ``merge_outputs`` is False.  With
        ``valid_length`` (N,), outputs past a row's length are zeroed and
        each row's states are those of its last valid step."""
        if isinstance(inputs, (list, tuple)):
            seq = list(inputs)
            batch = seq[0].shape[0]
        else:
            axis = layout.find("T")
            if axis == 0:
                seq = [inputs[t] for t in range(length)]
            else:
                seq = [inputs[:, t] for t in range(length)]
            batch = inputs.shape[layout.find("N")]
        if len(seq) != length:
            raise MXNetError(f"unroll length {length} != inputs {len(seq)}")

        self.reset()
        states = begin_state if begin_state is not None else self.begin_state(
            batch_size=batch, dtype=seq[0].dtype, device=seq[0].device)
        outputs = []
        all_states = []
        for t in range(length):
            out, states = self(seq[t], states)
            outputs.append(out)
            if valid_length is not None:
                all_states.append(states)

        if valid_length is not None:
            # freeze states past each sequence's end + zero padded outputs
            valid_length = torch.as_tensor(valid_length,
                                           device=seq[0].device)
            idx = torch.clamp(valid_length.long() - 1, min=0)
            rows = torch.arange(batch, device=seq[0].device)
            states = [torch.stack([s[i] for s in all_states])[idx, rows]
                      for i in range(len(all_states[0]))]
            outputs = [
                out * (valid_length > t).to(out.dtype).reshape(-1, 1)
                for t, out in enumerate(outputs)]

        if merge_outputs is False:
            return outputs, states
        return torch.stack(outputs, dim=layout.find("T")), states


class HybridRecurrentCell(RecurrentCell):
    """Alias kept for API parity (every cell is a ``HybridBlock``)."""


class _GatedCell(RecurrentCell):
    _num_gates = 1

    def __init__(self, hidden_size, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 dtype=torch.float32, device=None):
        super().__init__()
        self._hidden_size = hidden_size
        self._input_size = int(input_size)
        dev = resolve_device(device)
        ng = self._num_gates
        self.i2h_weight = _empty((ng * hidden_size, self._input_size), dev,
                                 dtype, i2h_weight_initializer)
        self.h2h_weight = _empty((ng * hidden_size, hidden_size), dev, dtype,
                                 h2h_weight_initializer)
        self.i2h_bias = _empty((ng * hidden_size,), dev, dtype,
                               i2h_bias_initializer)
        self.h2h_bias = _empty((ng * hidden_size,), dev, dtype,
                               h2h_bias_initializer)

    def infer_shape(self, x, *args):
        set_shape(self.i2h_weight,
                  (self._num_gates * self._hidden_size, x.shape[-1]))

    def _proj(self, inputs, states):
        i2h = _ops.fully_connected(inputs, self.i2h_weight, self.i2h_bias)
        h2h = _ops.fully_connected(states[0], self.h2h_weight, self.h2h_bias)
        return i2h, h2h


class RNNCell(_GatedCell):
    """Elman cell: h' = act(W·x + b + R·h + r) (ref rnn_cell.py RNNCell)."""
    _num_gates = 1

    def __init__(self, hidden_size, activation="tanh", **kwargs):
        super().__init__(hidden_size, **kwargs)
        self._activation = activation

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size), "__layout__": "NC"}]

    def forward(self, inputs, states):
        i2h, h2h = self._proj(inputs, states)
        out = npx.activation(i2h + h2h, act_type=self._activation)
        return out, [out]


class LSTMCell(_GatedCell):
    """LSTM cell, gate order [i, f, g, o] (ref rnn_cell.py LSTMCell)."""
    _num_gates = 4

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size), "__layout__": "NC"},
                {"shape": (batch_size, self._hidden_size), "__layout__": "NC"}]

    def forward(self, inputs, states):
        i2h, h2h = self._proj(inputs, states)
        g = i2h + h2h
        h = self._hidden_size
        i, f, gg, o = (g[:, :h], g[:, h:2 * h], g[:, 2 * h:3 * h], g[:, 3 * h:])
        c = i.sigmoid() * gg.tanh() + f.sigmoid() * states[1]
        out = o.sigmoid() * c.tanh()
        return out, [out, c]


class GRUCell(_GatedCell):
    """GRU cell, cuDNN gate order [r, z, n] with the reset gate applied to
    the h2h candidate incl. its bias (ref rnn_cell.py GRUCell)."""
    _num_gates = 3

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size), "__layout__": "NC"}]

    def forward(self, inputs, states):
        i2h, h2h = self._proj(inputs, states)
        h = self._hidden_size
        xr, xz, xn = i2h[:, :h], i2h[:, h:2 * h], i2h[:, 2 * h:]
        hr, hz, hn = h2h[:, :h], h2h[:, h:2 * h], h2h[:, 2 * h:]
        r = (xr + hr).sigmoid()
        z = (xz + hz).sigmoid()
        n = (xn + r * hn).tanh()
        out = (1.0 - z) * n + z * states[0]
        return out, [out]


class SequentialRNNCell(RecurrentCell):
    """Stack of cells applied in sequence each step (ref SequentialRNNCell);
    the children are ``cell0``, ``cell1``, ... as in the JAX package."""

    def __init__(self):
        super().__init__()
        self._cells: List[RecurrentCell] = []

    def add(self, *cells):
        for c in cells:
            self._cells.append(c)
            setattr(self, f"cell{len(self._cells) - 1}", c)

    def __len__(self):
        return len(self._cells)

    def __getitem__(self, i):
        return self._cells[i]

    def state_info(self, batch_size=0):
        return _cells_state_info(self._cells, batch_size)

    def begin_state(self, **kwargs):
        return _cells_begin_state(self._cells, **kwargs)

    def forward(self, inputs, states):
        next_states = []
        p = 0
        for cell in self._cells:
            n = len(cell.state_info())
            inputs, st = cell(inputs, states[p:p + n])
            next_states.extend(st)
            p += n
        return inputs, next_states


class DropoutCell(RecurrentCell):
    """Dropout on the step output (ref DropoutCell); only under
    ``autograd.is_training()``."""

    def __init__(self, rate):
        super().__init__()
        self._rate = rate

    def state_info(self, batch_size=0):
        return []

    def begin_state(self, **kwargs):
        return []

    def forward(self, inputs, states):
        return npx.dropout(inputs, p=self._rate), states


class ModifierCell(RecurrentCell):
    """Base for cells that decorate another cell (ref rnn_cell.py
    ModifierCell): state handling delegates to base_cell."""

    def __init__(self, base_cell):
        super().__init__()
        self.base_cell = base_cell

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def begin_state(self, **kwargs):
        return self.base_cell.begin_state(**kwargs)

    def forward(self, inputs, states):
        raise NotImplementedError

    def __repr__(self):
        return f"{type(self).__name__}({self.base_cell!r})"


class ResidualCell(ModifierCell):
    """Adds the input to the base cell's output (ref ResidualCell)."""

    def forward(self, inputs, states):
        out, states = self.base_cell(inputs, states)
        return out + inputs, states


class ZoneoutCell(ModifierCell):
    """Zoneout regularization: randomly keep previous state entries (ref
    ZoneoutCell); only under ``autograd.is_training()``."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        super().__init__(base_cell)
        self._zo, self._zs = zoneout_outputs, zoneout_states
        self._prev_out = None

    def reset(self):
        super().reset()
        self._prev_out = None

    def begin_state(self, **kwargs):
        self._prev_out = None
        return self.base_cell.begin_state(**kwargs)

    def forward(self, inputs, states):
        out, next_states = self.base_cell(inputs, states)
        if autograd.is_training():
            def mix(p, new, old):
                if p <= 0.0:
                    return new
                if old is None:
                    # first step zones against zeros (ref rnn_cell.py:960)
                    old = torch.zeros_like(new)
                mask = npx.dropout(torch.ones_like(new), p=p,
                                   mode="always") > 0
                return torch.where(mask, new, old)

            prev = self._prev_out
            out = mix(self._zo, out, prev)
            next_states = [mix(self._zs, ns, s)
                           for ns, s in zip(next_states, states)]
        self._prev_out = out
        return out, next_states


class BidirectionalCell(RecurrentCell):
    """Runs two cells over opposite directions; only usable via unroll (ref
    BidirectionalCell)."""

    def __init__(self, l_cell, r_cell):
        super().__init__()
        self.l_cell, self.r_cell = l_cell, r_cell

    def state_info(self, batch_size=0):
        return _cells_state_info([self.l_cell, self.r_cell], batch_size)

    def begin_state(self, **kwargs):
        return _cells_begin_state([self.l_cell, self.r_cell], **kwargs)

    def forward(self, inputs, states):
        raise MXNetError("BidirectionalCell cannot be stepped; use unroll")

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        if isinstance(inputs, (list, tuple)):
            seq = list(inputs)
        else:
            axis = layout.find("T")
            seq = [inputs[t] if axis == 0 else inputs[:, t]
                   for t in range(length)]
        batch = seq[0].shape[0]
        states = begin_state if begin_state is not None else self.begin_state(
            batch_size=batch, dtype=seq[0].dtype, device=seq[0].device)
        nl = len(self.l_cell.state_info())
        l_out, l_states = self.l_cell.unroll(
            length, seq, states[:nl], layout=layout,
            merge_outputs=False, valid_length=valid_length)
        lens = None if valid_length is None else torch.as_tensor(
            valid_length, device=seq[0].device)
        if lens is None:
            r_seq = seq[::-1]
        else:
            r_seq = list(_reverse_seq(torch.stack(seq), lens))
        r_out, r_states = self.r_cell.unroll(
            length, r_seq, states[nl:], layout=layout,
            merge_outputs=False, valid_length=valid_length)
        if lens is None:
            r_out = r_out[::-1]
        else:
            r_out = list(_reverse_seq(torch.stack(r_out), lens))
        outputs = [torch.cat([lo, ro], dim=-1)
                   for lo, ro in zip(l_out, r_out)]
        states = l_states + r_states
        if merge_outputs is False:
            return outputs, states
        return torch.stack(outputs, dim=layout.find("T")), states


class VariationalDropoutCell(ModifierCell):
    """Variational (per-sequence) dropout around a cell (ref rnn_cell.py
    VariationalDropoutCell): ONE mask per sequence for each of inputs /
    states / outputs, resampled by reset(); only under
    ``autograd.is_training()``."""

    def __init__(self, base_cell, drop_inputs=0.0, drop_states=0.0,
                 drop_outputs=0.0):
        super().__init__(base_cell)
        self._di, self._ds, self._do = drop_inputs, drop_states, drop_outputs
        self._mask_i = self._mask_s = self._mask_o = None

    def reset(self):
        super().reset()
        self._mask_i = self._mask_s = self._mask_o = None

    @staticmethod
    def _mask(p, like):
        return npx.dropout(torch.ones_like(like), p=p, mode="always")

    def forward(self, inputs, states):
        if autograd.is_training():
            if self._di > 0.0:
                if self._mask_i is None:
                    self._mask_i = self._mask(self._di, inputs)
                inputs = inputs * self._mask_i
            if self._ds > 0.0:
                if self._mask_s is None:
                    self._mask_s = self._mask(self._ds, states[0])
                states = [states[0] * self._mask_s] + list(states[1:])
        out, next_states = self.base_cell(inputs, states)
        if autograd.is_training() and self._do > 0.0:
            if self._mask_o is None:
                self._mask_o = self._mask(self._do, out)
            out = out * self._mask_o
        return out, next_states


class LSTMPCell(_GatedCell):
    """LSTM with a hidden-state projection (ref rnn_cell.py LSTMPCell:
    the recurrent state is r = W_r·h, dimension projection_size)."""
    _num_gates = 4

    def __init__(self, hidden_size, projection_size, input_size=0,
                 h2r_weight_initializer=None, h2h_weight_initializer=None,
                 dtype=torch.float32, device=None, **kwargs):
        super().__init__(hidden_size, input_size=input_size,
                         h2h_weight_initializer=h2h_weight_initializer,
                         dtype=dtype, device=device, **kwargs)
        self._projection_size = projection_size
        dev = self.i2h_weight.device
        # h2h operates on the PROJECTED state: replace the base parameter
        self.h2h_weight = _empty((self._num_gates * hidden_size,
                                  projection_size), dev, dtype,
                                 h2h_weight_initializer)
        self.h2r_weight = _empty((projection_size, hidden_size), dev, dtype,
                                 h2r_weight_initializer)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._projection_size),
                 "__layout__": "NC"},
                {"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def forward(self, inputs, states):
        i2h, h2h = self._proj(inputs, states)
        g = i2h + h2h
        h = self._hidden_size
        i, f, gg, o = (g[:, :h], g[:, h:2 * h], g[:, 2 * h:3 * h],
                       g[:, 3 * h:])
        c = i.sigmoid() * gg.tanh() + f.sigmoid() * states[1]
        hidden = o.sigmoid() * c.tanh()
        r = _ops.fully_connected(hidden, self.h2r_weight)
        return r, [r, c]


HybridSequentialRNNCell = SequentialRNNCell  # ref alias: all cells hybridize


class _ConvCell(RecurrentCell):
    """The Conv{1,2,3}D RNN / LSTM / GRU cells of the JAX package: not
    ported (the port has only 2-D convolution)."""

    def __init__(self, *args, **kwargs):
        raise MXNetError(f"{type(self).__name__} is not ported; ROADMAP A6, "
                         "long tail (the port has only 2-D convolution)")


class Conv1DRNNCell(_ConvCell):
    """1-D conv RNN cell (not ported; ROADMAP A6)."""


class Conv2DRNNCell(_ConvCell):
    """2-D conv RNN cell (not ported; ROADMAP A6)."""


class Conv3DRNNCell(_ConvCell):
    """3-D conv RNN cell (not ported; ROADMAP A6)."""


class Conv1DLSTMCell(_ConvCell):
    """1-D ConvLSTM (not ported; ROADMAP A6)."""


class Conv2DLSTMCell(_ConvCell):
    """2-D ConvLSTM (not ported; ROADMAP A6)."""


class Conv3DLSTMCell(_ConvCell):
    """3-D ConvLSTM (not ported; ROADMAP A6)."""


class Conv1DGRUCell(_ConvCell):
    """1-D conv GRU (not ported; ROADMAP A6)."""


class Conv2DGRUCell(_ConvCell):
    """2-D conv GRU (not ported; ROADMAP A6)."""


class Conv3DGRUCell(_ConvCell):
    """3-D conv GRU (not ported; ROADMAP A6)."""
