"""The remaining layer classes (counterpart of
``paddle_tpu/nn/layer/extras.py``): the pixel and channel ops, ``Fold``,
``Unflatten``, ``ZeroPad2D``, the distance, embedding and CTC losses,
``RReLU``, and the cell runners ``RNN`` and ``BiRNN``.

``RNN`` steps any cell over the time axis. With ``sequence_length`` it
merges each step's new state into the old one by ``new * m + old * (1 -
m)`` with ``m = t < length`` and zeroes the masked outputs, in the
reverse direction too; as in the reference, a run that starts without
``initial_states`` takes its first step's state unmasked (so a reversed
run over padding starts from the last, padded step). ``BiRNN`` registers
each cell twice, as ``cell_fw`` / ``cell_bw`` and inside ``_fw`` / ``_bw``;
its state-dict keys are the first names (``cell_fw.weight_ih``, ...), the
reference's.
"""

from __future__ import annotations

import torch

from .. import functional as F
from .common import Pad2D
from .layers import Layer

__all__ = ["PixelUnshuffle", "ChannelShuffle", "Fold", "Unflatten",
           "ZeroPad2D", "HuberLoss", "TripletMarginLoss",
           "PairwiseDistance", "CosineEmbeddingLoss", "CTCLoss", "RReLU",
           "RNN", "BiRNN"]


class PixelUnshuffle(Layer):
    def __init__(self, downscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self._factor = downscale_factor
        self._data_format = data_format

    def forward(self, x):
        return F.pixel_unshuffle(x, self._factor, self._data_format)


class ChannelShuffle(Layer):
    def __init__(self, groups, data_format="NCHW", name=None):
        super().__init__()
        self._groups = groups
        self._data_format = data_format

    def forward(self, x):
        return F.channel_shuffle(x, self._groups, self._data_format)


class Fold(Layer):
    def __init__(self, output_sizes, kernel_sizes, strides=1, paddings=0,
                 dilations=1, name=None):
        super().__init__()
        self._args = (output_sizes, kernel_sizes, strides, paddings,
                      dilations)

    def forward(self, x):
        return F.fold(x, *self._args)


class Unflatten(Layer):
    def __init__(self, axis, shape, name=None):
        super().__init__()
        self._axis = axis
        self._shape = tuple(shape)

    def forward(self, x):
        axis = self._axis % x.dim()
        return x.reshape(tuple(x.shape[:axis]) + self._shape
                         + tuple(x.shape[axis + 1:]))


class ZeroPad2D(Pad2D):
    def __init__(self, padding, data_format="NCHW", name=None):
        super().__init__(padding, mode="constant", value=0.0,
                         data_format=data_format)


class HuberLoss(Layer):
    def __init__(self, reduction="mean", delta=1.0, name=None):
        super().__init__()
        self._reduction = reduction
        self._delta = delta

    def forward(self, input, label):
        return F.huber_loss(input, label, self._delta, self._reduction)


class TripletMarginLoss(Layer):
    def __init__(self, margin=1.0, p=2.0, epsilon=1e-6, swap=False,
                 reduction="mean", name=None):
        super().__init__()
        self._kw = dict(margin=margin, p=p, epsilon=epsilon, swap=swap,
                        reduction=reduction)

    def forward(self, input, positive, negative):
        return F.triplet_margin_loss(input, positive, negative, **self._kw)


class PairwiseDistance(Layer):
    def __init__(self, p=2.0, epsilon=1e-6, keepdim=False, name=None):
        super().__init__()
        self._p, self._eps, self._keepdim = p, epsilon, keepdim

    def forward(self, x, y):
        return F.pairwise_distance(x, y, self._p, self._eps, self._keepdim)


class CosineEmbeddingLoss(Layer):
    def __init__(self, margin=0.0, reduction="mean", name=None):
        super().__init__()
        self._margin, self._reduction = margin, reduction

    def forward(self, input1, input2, label):
        return F.cosine_embedding_loss(input1, input2, label, self._margin,
                                       self._reduction)


class CTCLoss(Layer):
    def __init__(self, blank=0, reduction="mean"):
        super().__init__()
        self._blank, self._reduction = blank, reduction

    def forward(self, log_probs, labels, input_lengths, label_lengths,
                norm_by_times=False):
        return F.ctc_loss(log_probs, labels, input_lengths, label_lengths,
                          self._blank, self._reduction, norm_by_times)


class RReLU(Layer):
    def __init__(self, lower=1.0 / 8.0, upper=1.0 / 3.0, name=None):
        super().__init__()
        self._lower, self._upper = lower, upper

    def forward(self, x):
        return F.rrelu(x, self._lower, self._upper, training=self.training)


def _merge(new, old, m):
    """``new * m + old * (1 - m)`` leaf by leaf (``m`` ``[B]``, broadcast
    over each leaf's trailing axes); ``new`` where there is no ``old``."""
    if old is None:
        return new
    if isinstance(new, (tuple, list)):
        return type(new)(_merge(n, o, m) for n, o in zip(new, old))
    m = m.reshape(m.shape + (1,) * (new.dim() - 1))
    return new * m + old * (1.0 - m)


class RNN(Layer):
    """Steps any ``RNNCellBase`` over the time axis; returns the stacked
    outputs and the final states."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self._reverse = is_reverse
        self._time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        t_axis = 0 if self._time_major else 1
        T = inputs.shape[t_axis]
        steps = range(T - 1, -1, -1) if self._reverse else range(T)
        states = initial_states
        seq = (None if sequence_length is None
               else torch.as_tensor(sequence_length, device=inputs.device))
        outs = []
        for t in steps:
            xt = inputs[t] if self._time_major else inputs[:, t]
            out, new_states = self.cell(xt, states)
            if seq is not None:
                m = (t < seq).float()
                states = _merge(new_states, states, m)
                out = out * m.reshape(m.shape + (1,) * (out.dim() - 1))
            else:
                states = new_states
            outs.append(out)
        if self._reverse:
            outs = outs[::-1]
        return torch.stack(outs, dim=t_axis), states


class BiRNN(Layer):
    """``cell_fw`` forward and ``cell_bw`` backward over the time axis, the
    per-step outputs concatenated on the last axis; returns them and
    (forward final states, backward final states)."""

    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.cell_fw = cell_fw
        self.cell_bw = cell_bw
        self._fw = RNN(cell_fw, is_reverse=False, time_major=time_major)
        self._bw = RNN(cell_bw, is_reverse=True, time_major=time_major)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        st_fw = st_bw = None
        if initial_states is not None:
            st_fw, st_bw = initial_states
        out_fw, fin_fw = self._fw(inputs, st_fw, sequence_length)
        out_bw, fin_bw = self._bw(inputs, st_bw, sequence_length)
        return torch.cat([out_fw, out_bw], dim=-1), (fin_fw, fin_bw)
