"""The loss layers (counterpart of ``paddle_tpu/nn/layer/loss.py``): each
holds its options and calls its ``nn.functional`` loss, whose docstrings
say where the reference's arithmetic is not PyTorch's.
``AdaptiveLogSoftmaxWithLoss`` keeps its parameters in the reference's
order and under its keys: ``head_weight``, ``head_bias`` (with
``head_bias=True``), then ``tail_proj_{i}`` and ``tail_cls_{i}`` per
cluster."""

from __future__ import annotations

import torch

from .. import functional as F
from .layers import Layer

__all__ = [
    "CrossEntropyLoss", "MSELoss", "L1Loss", "NLLLoss", "BCELoss",
    "BCEWithLogitsLoss", "SmoothL1Loss", "KLDivLoss", "MarginRankingLoss",
    "HingeEmbeddingLoss", "SoftMarginLoss", "MultiLabelSoftMarginLoss",
    "PoissonNLLLoss", "GaussianNLLLoss", "MultiMarginLoss",
    "TripletMarginWithDistanceLoss", "AdaptiveLogSoftmaxWithLoss",
]


class CrossEntropyLoss(Layer):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 soft_label=False, axis=-1, use_softmax=True,
                 label_smoothing=0.0, name=None):
        super().__init__()
        self._weight = weight
        self._ignore_index = ignore_index
        self._reduction = reduction
        self._soft_label = soft_label
        self._axis = axis
        self._use_softmax = use_softmax
        self._label_smoothing = label_smoothing

    def forward(self, input, label):
        return F.cross_entropy(
            input, label, weight=self._weight,
            ignore_index=self._ignore_index, reduction=self._reduction,
            soft_label=self._soft_label, axis=self._axis,
            use_softmax=self._use_softmax,
            label_smoothing=self._label_smoothing)


class MSELoss(Layer):
    def __init__(self, reduction="mean"):
        super().__init__()
        self._reduction = reduction

    def forward(self, input, label):
        return F.mse_loss(input, label, self._reduction)


class L1Loss(Layer):
    def __init__(self, reduction="mean", name=None):
        super().__init__()
        self._reduction = reduction

    def forward(self, input, label):
        return F.l1_loss(input, label, self._reduction)


class NLLLoss(Layer):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 name=None):
        super().__init__()
        self._weight = weight
        self._ignore_index = ignore_index
        self._reduction = reduction

    def forward(self, input, label):
        return F.nll_loss(input, label, self._weight, self._ignore_index,
                          self._reduction)


class BCELoss(Layer):
    def __init__(self, weight=None, reduction="mean", name=None):
        super().__init__()
        self._weight = weight
        self._reduction = reduction

    def forward(self, input, label):
        return F.binary_cross_entropy(input, label, self._weight,
                                      self._reduction)


class BCEWithLogitsLoss(Layer):
    def __init__(self, weight=None, reduction="mean", pos_weight=None,
                 name=None):
        super().__init__()
        self._weight = weight
        self._reduction = reduction
        self._pos_weight = pos_weight

    def forward(self, logit, label):
        return F.binary_cross_entropy_with_logits(
            logit, label, self._weight, self._reduction, self._pos_weight)


class SmoothL1Loss(Layer):
    def __init__(self, reduction="mean", delta=1.0, name=None):
        super().__init__()
        self._reduction = reduction
        self._delta = delta

    def forward(self, input, label):
        return F.smooth_l1_loss(input, label, self._reduction, self._delta)


class KLDivLoss(Layer):
    def __init__(self, reduction="mean"):
        super().__init__()
        self._reduction = reduction

    def forward(self, input, label):
        return F.kl_div(input, label, self._reduction)


class MarginRankingLoss(Layer):
    def __init__(self, margin=0.0, reduction="mean", name=None):
        super().__init__()
        self._margin = margin
        self._reduction = reduction

    def forward(self, input, other, label):
        return F.margin_ranking_loss(input, other, label, self._margin,
                                     self._reduction)


class HingeEmbeddingLoss(Layer):
    def __init__(self, margin=1.0, reduction="mean", name=None):
        super().__init__()
        self._margin = margin
        self._reduction = reduction

    def forward(self, input, label):
        return F.hinge_embedding_loss(input, label, self._margin,
                                      self._reduction)


class SoftMarginLoss(Layer):
    def __init__(self, reduction="mean", name=None):
        super().__init__()
        self._reduction = reduction

    def forward(self, input, label):
        return F.soft_margin_loss(input, label, self._reduction)


class MultiLabelSoftMarginLoss(Layer):
    def __init__(self, weight=None, reduction="mean", name=None):
        super().__init__()
        self._weight = weight
        self._reduction = reduction

    def forward(self, input, label):
        return F.multi_label_soft_margin_loss(input, label, self._weight,
                                              self._reduction)


class PoissonNLLLoss(Layer):
    def __init__(self, log_input=True, full=False, epsilon=1e-8,
                 reduction="mean", name=None):
        super().__init__()
        self._args = (log_input, full, epsilon, reduction)

    def forward(self, input, label):
        return F.poisson_nll_loss(input, label, *self._args)


class GaussianNLLLoss(Layer):
    def __init__(self, full=False, epsilon=1e-6, reduction="mean",
                 name=None):
        super().__init__()
        self._args = (full, epsilon, reduction)

    def forward(self, input, label, variance):
        return F.gaussian_nll_loss(input, label, variance, *self._args)


class MultiMarginLoss(Layer):
    def __init__(self, p=1, margin=1.0, weight=None, reduction="mean",
                 name=None):
        super().__init__()
        self._args = (p, margin, weight, reduction)

    def forward(self, input, label):
        return F.multi_margin_loss(input, label, *self._args)


class AdaptiveLogSoftmaxWithLoss(Layer):
    """Adaptive softmax: the head scores the ``cutoffs[0]`` frequent
    classes and one entry per tail cluster; cluster i scores through an
    ``in_features / div_value**(i+1)`` low-rank projection. ``forward``
    returns (the true class's log-probability per sample, the mean
    NLL)."""

    def __init__(self, in_features, n_classes, cutoffs, div_value=4.0,
                 head_bias=False, weight_attr=None, bias_attr=None,
                 name=None):
        super().__init__()
        cutoffs = list(cutoffs)
        if (not cutoffs or sorted(set(cutoffs)) != cutoffs
                or cutoffs[-1] > n_classes - 1 or min(cutoffs) <= 0):
            raise ValueError(
                "cutoffs must be a sorted list of unique positive ints "
                f"< n_classes-1, got {cutoffs} for n_classes={n_classes}")
        self.in_features = in_features
        self.n_classes = n_classes
        self._cutoffs = cutoffs + [n_classes]
        self._div_value = div_value
        shortlist, n_clusters = cutoffs[0], len(cutoffs)
        self.head_weight = self.create_parameter(
            [in_features, shortlist + n_clusters], weight_attr)
        self.head_bias = self.create_parameter(
            [shortlist + n_clusters], bias_attr, is_bias=True) \
            if head_bias else None
        self.tail_weights = []
        for i in range(n_clusters):
            hsz = max(1, int(in_features // (div_value ** (i + 1))))
            osz = self._cutoffs[i + 1] - self._cutoffs[i]
            proj = self.add_parameter(f"tail_proj_{i}", self.create_parameter(
                [in_features, hsz], weight_attr))
            cls_w = self.add_parameter(f"tail_cls_{i}", self.create_parameter(
                [hsz, osz], weight_attr))
            self.tail_weights.append([proj, cls_w])

    def forward(self, input, label):
        return F.adaptive_log_softmax_with_loss(
            input, label, self.head_weight, self.tail_weights,
            self._cutoffs, head_bias=self.head_bias)

    def log_prob(self, input):
        """Every class's log-probability, ``[N, n_classes]``."""
        shortlist = self._cutoffs[0]
        head = input @ self.head_weight
        if self.head_bias is not None:
            head = head + self.head_bias
        head_logp = torch.log_softmax(head, dim=-1)
        parts = [head_logp[:, :shortlist]]
        for ci, (proj, cls_w) in enumerate(self.tail_weights):
            tail_logp = torch.log_softmax((input @ proj) @ cls_w, dim=-1)
            parts.append(head_logp[:, shortlist + ci:shortlist + ci + 1]
                         + tail_logp)
        return torch.cat(parts, dim=-1)

    def predict(self, input):
        return self.log_prob(input).argmax(dim=-1)


class TripletMarginWithDistanceLoss(Layer):
    def __init__(self, distance_function=None, margin=1.0, swap=False,
                 reduction="mean", name=None):
        super().__init__()
        self._args = (distance_function, margin, swap, reduction)

    def forward(self, input, positive, negative):
        return F.triplet_margin_with_distance_loss(input, positive, negative,
                                                   *self._args)
