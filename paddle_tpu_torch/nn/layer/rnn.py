"""The recurrent layers (counterpart of ``paddle_tpu/nn/layer/rnn.py``):
``SimpleRNNCell``, ``LSTMCell``, ``GRUCell`` and ``SimpleRNN``, ``LSTM``,
``GRU`` over ``_RNNBase``.

Weights keep the reference's layout and keys: ``[G * H, in]`` input and
``[G * H, H]`` hidden weights with the gates concatenated in the order
``i, f, g, o`` (LSTM) and ``r, z, n`` (GRU), named ``weight_ih_l{k}``,
``weight_hh_l{k}``, ``bias_ih_l{k}``, ``bias_hh_l{k}`` (``_reverse`` for
the backward direction), each drawn from ``Uniform(-1/sqrt(H),
1/sqrt(H))``. The time loop is a Python loop over plain PyTorch operators
on every device (the JAX package's ``lax.scan``; cuDNN's RNN is not
used, so the CPU tests hold the very code the card runs). The input
projection of a whole sequence is one matrix product before the loop.

As in the reference, ``_RNNBase.forward(inputs, initial_states=None)``
starts every direction from zeros whatever ``initial_states`` holds,
ignores ``dropout`` and takes no ``sequence_length`` (``nn.RNN`` and
``nn.BiRNN`` mask by length).
"""

from __future__ import annotations

import math

import torch

from ...amp import cast_inputs
from .. import initializer as I
from .layers import Layer

__all__ = ["SimpleRNN", "LSTM", "GRU", "RNNCellBase", "SimpleRNNCell",
           "LSTMCell", "GRUCell"]

_GATES = {"RNN": 1, "LSTM": 4, "GRU": 3}


def _act(activation):
    return torch.tanh if activation == "tanh" else torch.relu


def _lstm_step(xw, h, c, wh, bh):
    """One LSTM step from the input projection ``xw = x W_ih^T + b_ih``."""
    gates = torch.addmm(xw, h, wh.t()) + bh
    sig = torch.sigmoid(gates)
    i, f, _, o = sig.chunk(4, dim=-1)
    g = torch.tanh(gates.chunk(4, dim=-1)[2])
    c = f * c + i * g
    return o * torch.tanh(c), c


def _gru_step(xw, h, wh, bh):
    """One GRU step: ``r`` and ``z`` from both projections, ``n`` from the
    input's plus ``r`` times the hidden's."""
    gh = torch.addmm(bh, h, wh.t())
    ir, iz, in_ = xw.chunk(3, dim=-1)
    hr, hz, hn = gh.chunk(3, dim=-1)
    r = torch.sigmoid(ir + hr)
    z = torch.sigmoid(iz + hz)
    n = torch.tanh(in_ + r * hn)
    return (1 - z) * n + z * h


class RNNCellBase(Layer):
    pass


class _Cell(RNNCellBase):
    """The cells' parameters: ``weight_ih``, ``weight_hh``, ``bias_ih``,
    ``bias_hh`` for ``gates`` gates."""

    def __init__(self, input_size, hidden_size, gates, weight_ih_attr,
                 weight_hh_attr, bias_ih_attr, bias_hh_attr):
        super().__init__()
        self.hidden_size = hidden_size
        k = 1.0 / math.sqrt(hidden_size)
        init = I.Uniform(-k, k)
        g = gates * hidden_size
        self.weight_ih = self.create_parameter(
            [g, input_size], weight_ih_attr, default_initializer=init)
        self.weight_hh = self.create_parameter(
            [g, hidden_size], weight_hh_attr, default_initializer=init)
        self.bias_ih = self.create_parameter(
            [g], bias_ih_attr, is_bias=True, default_initializer=init)
        self.bias_hh = self.create_parameter(
            [g], bias_hh_attr, is_bias=True, default_initializer=init)

    def _zeros(self, inputs):
        return torch.zeros(inputs.shape[0], self.hidden_size,
                           device=inputs.device)


class SimpleRNNCell(_Cell):
    def __init__(self, input_size, hidden_size, activation="tanh",
                 weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None):
        super().__init__(input_size, hidden_size, 1, weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr)
        self.activation = _act(activation)

    def forward(self, inputs, states=None):
        if states is None:
            states = self._zeros(inputs)
        x, h, wi, wh, bi, bh = cast_inputs(
            "rnn_cell", inputs, states, self.weight_ih, self.weight_hh,
            self.bias_ih, self.bias_hh)
        h = self.activation(x @ wi.t() + bi + h @ wh.t() + bh)
        return h, h


class LSTMCell(_Cell):
    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None):
        super().__init__(input_size, hidden_size, 4, weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr)

    def forward(self, inputs, states=None):
        if states is None:
            z = self._zeros(inputs)
            states = (z, z)
        x, h, c, wi, wh, bi, bh = cast_inputs(
            "lstm_cell", inputs, *states, self.weight_ih, self.weight_hh,
            self.bias_ih, self.bias_hh)
        h, c = _lstm_step(x @ wi.t() + bi, h, c, wh, bh)
        return h, (h, c)


class GRUCell(_Cell):
    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None):
        super().__init__(input_size, hidden_size, 3, weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr)

    def forward(self, inputs, states=None):
        if states is None:
            states = self._zeros(inputs)
        x, h, wi, wh, bi, bh = cast_inputs(
            "gru_cell", inputs, states, self.weight_ih, self.weight_hh,
            self.bias_ih, self.bias_hh)
        h = _gru_step(x @ wi.t() + bi, h, wh, bh)
        return h, h


class _RNNBase(Layer):
    MODE = "RNN"

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.time_major = time_major
        self.dropout = dropout
        self.bidirect = direction in ("bidirect", "bidirectional")
        self.num_directions = 2 if self.bidirect else 1
        self.activation = activation
        g = _GATES[self.MODE] * hidden_size
        k = 1.0 / math.sqrt(hidden_size)
        init = I.Uniform(-k, k)
        for layer in range(num_layers):
            for d in range(self.num_directions):
                in_sz = (input_size if layer == 0
                         else hidden_size * self.num_directions)
                sfx = self._suffix(layer, d)
                for key, shape, attr, bias in (
                        ("weight_ih", [g, in_sz], weight_ih_attr, False),
                        ("weight_hh", [g, hidden_size], weight_hh_attr,
                         False),
                        ("bias_ih", [g], bias_ih_attr, True),
                        ("bias_hh", [g], bias_hh_attr, True)):
                    self.add_parameter(key + sfx, self.create_parameter(
                        shape, attr, is_bias=bias, default_initializer=init))

    @staticmethod
    def _suffix(layer, d):
        return f"_l{layer}" + ("_reverse" if d else "")

    def _direction(self, seq, wi, wh, bi, bh):
        """One direction over ``seq`` ``[T, B, in]`` from zeros: the
        outputs ``[T, B, H]`` and the final (h, c) (c None but for LSTM)."""
        # unbind: one backward node for every step's slice (indexing each
        # step would zero-fill and copy a whole [T, B, G] gradient a step)
        xws = (seq @ wi.t() + bi).unbind(0)
        h = torch.zeros(seq.shape[1], self.hidden_size, dtype=seq.dtype,
                        device=seq.device)
        c = torch.zeros_like(h) if self.MODE == "LSTM" else None
        act = _act(self.activation)
        ys = []
        for xw in xws:
            if self.MODE == "LSTM":
                h, c = _lstm_step(xw, h, c, wh, bh)
            elif self.MODE == "GRU":
                h = _gru_step(xw, h, wh, bh)
            else:
                h = act(torch.addmm(xw, h, wh.t()) + bh)
            ys.append(h)
        return torch.stack(ys), h, c

    def forward(self, inputs, initial_states=None):
        names = [[n + self._suffix(layer, d)
                  for n in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")]
                 for layer in range(self.num_layers)
                 for d in range(self.num_directions)]
        x, *flat = cast_inputs(self.MODE.lower(), inputs, *[
            getattr(self, n) for group in names for n in group])
        out = x if self.time_major else x.transpose(0, 1)
        final_h, final_c = [], []
        idx = 0
        for _ in range(self.num_layers):
            dir_outs = []
            for d in range(self.num_directions):
                ys, h, c = self._direction(out.flip(0) if d else out,
                                           *flat[idx:idx + 4])
                idx += 4
                dir_outs.append(ys.flip(0) if d else ys)
                final_h.append(h)
                final_c.append(c)
            out = torch.cat(dir_outs, dim=-1) if d else dir_outs[0]
        y = out if self.time_major else out.transpose(0, 1)
        h = torch.stack(final_h)
        if self.MODE == "LSTM":
            return y, (h, torch.stack(final_c))
        return y, h


class SimpleRNN(_RNNBase):
    MODE = "RNN"


class LSTM(_RNNBase):
    MODE = "LSTM"


class GRU(_RNNBase):
    MODE = "GRU"
