"""``nn.functional``'s losses (counterpart of the loss section and the
extras' losses of ``paddle_tpu/nn/functional/__init__.py``): ``one_hot``,
``label_smooth``, ``cross_entropy`` with its whole signature,
``softmax_with_cross_entropy``, the binary, regression, ranking, margin,
likelihood, embedding and set losses, ``pairwise_distance``,
``adaptive_log_softmax_with_loss`` and ``ctc_loss``.

Each op casts its tensor inputs with ``amp.cast_inputs`` under the JAX
package's op name (``bce``, ``bce_logits``, ``smooth_l1``, ...: the AMP
lists key on it) and computes the JAX package's arithmetic, where it is
not PyTorch's own loss:

- an index outside ``[-n, n)`` reads NaN and a negative one wraps, as
  ``jnp.take`` / ``jnp.take_along_axis`` do (``_take``);
- ``cross_entropy`` with hard labels and ``reduction="mean"`` returns
  before it applies ``weight``, and masks ``label == ignore_index``
  whatever its sign; ``use_softmax=False`` takes the log of the input
  clipped at 1e-30;
- ``nll_loss`` masks ``ignore_index`` only when it is >= 0 (the default
  -100 reads NaN), and its weighted mean divides by the count of kept
  labels, not by the sum of their weights;
- ``multi_margin_loss`` divides by the class count with the true class's
  term zeroed; ``kl_div`` takes ``label * (log(max(label, 1e-12)) -
  input)``; ``ctc_loss`` runs the log-space alpha recursion over time (not
  ``F.ctc_loss``), and its ``"mean"`` divides each sample by its label
  length before the batch mean;
- the hinges are ``max(0, .)`` with the tie's gradient split in half, as
  ``jnp.maximum``'s.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ...amp import cast_inputs

__all__ = [
    "one_hot", "label_smooth", "cross_entropy", "softmax_with_cross_entropy",
    "binary_cross_entropy", "binary_cross_entropy_with_logits", "mse_loss",
    "square_error_cost", "l1_loss", "nll_loss", "smooth_l1_loss", "kl_div",
    "margin_ranking_loss", "hinge_embedding_loss", "soft_margin_loss",
    "multi_label_soft_margin_loss", "poisson_nll_loss", "gaussian_nll_loss",
    "multi_margin_loss", "triplet_margin_with_distance_loss", "npair_loss",
    "dice_loss", "log_loss", "adaptive_log_softmax_with_loss",
    "sigmoid_focal_loss", "pairwise_distance", "huber_loss",
    "triplet_margin_loss", "cosine_embedding_loss", "ctc_loss"]


def _reduce(val, reduction):
    """The reference's ``_reduce``: any other ``reduction`` returns the
    values as they are."""
    if reduction == "mean":
        return val.mean()
    if reduction == "sum":
        return val.sum()
    return val


def _max0(x):
    """``jnp.maximum(0, x)``: a tie's gradient is split in half."""
    return torch.maximum(x, x.new_zeros(()))


def _take(t, idx, dim):
    """``jnp.take_along_axis(t, idx, dim)`` (``idx`` broadcast to ``t``'s
    rank): a negative index wraps once, an index still outside ``[0, n)``
    reads NaN and passes no gradient."""
    n = t.shape[dim]
    idx = idx.long()
    idx = torch.where(idx < 0, idx + n, idx)
    ok = (idx >= 0) & (idx < n)
    got = t.gather(dim, idx.clamp(0, n - 1))
    return torch.where(ok, got, float("nan"))


def _take1(w, idx):
    """``jnp.take(w, idx)`` of a 1-D ``w``, with ``_take``'s rules."""
    return _take(w, idx.reshape(-1), 0).reshape(idx.shape)


def _log1pexp(x):
    """``log1p(exp(-|x|))``, the stable softplus tail."""
    return torch.log1p(torch.exp(-x.abs()))


def one_hot(x, num_classes, name=None):
    """fp32 ``[..., num_classes]``; an index outside the range gives a row
    of zeros (``jax.nn.one_hot``)."""
    return (x.long()[..., None] == torch.arange(
        num_classes, device=x.device)).float()


def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    (label,) = cast_inputs("label_smooth", label)
    if prior_dist is not None:
        return (1 - epsilon) * label + epsilon * prior_dist
    return (1 - epsilon) * label + epsilon / label.shape[-1]


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    """Softmax cross-entropy. Hard labels (with or without a trailing 1
    axis) score ``-log p[label]`` (with ``label_smoothing``, against the
    smoothed one-hot), a label equal to ``ignore_index`` scores 0, and
    ``"mean"`` divides by the count of the others and ignores ``weight``
    (the reference returns before it weighs); ``"sum"`` and ``"none"``
    weigh each row by ``weight[label]``. Soft labels score ``-sum(label *
    log p)``. ``use_softmax=False`` reads the input as probabilities
    (clipped at 1e-30). Black-listed under AMP."""
    logits, label, weight = cast_inputs("cross_entropy", input, label,
                                        weight)
    if use_softmax:
        logp = torch.log_softmax(logits, dim=axis)
    else:
        logp = torch.log(torch.clamp(logits, min=1e-30))
    k = logits.shape[axis]
    if soft_label:
        lab = label
        if label_smoothing > 0:
            lab = (1 - label_smoothing) * lab + label_smoothing / k
        loss = -(lab * logp).sum(dim=axis)
    else:
        lab = label.squeeze(axis) if label.dim() == logp.dim() else label
        if label_smoothing > 0:
            oh = one_hot(lab, k).to(logp.dtype)
            oh = (1 - label_smoothing) * oh + label_smoothing / k
            loss = -(oh * logp).sum(dim=axis)
        else:
            loss = -_take(logp, lab.unsqueeze(axis), axis).squeeze(axis)
        mask = lab != ignore_index
        loss = torch.where(mask, loss, 0.0)
        if reduction == "mean":
            return loss.sum() / mask.sum().clamp(min=1)
    if weight is not None:
        idx = label.squeeze(axis) if label.dim() == logp.dim() else label
        loss = loss * _take1(weight, idx)
    return _reduce(loss, reduction)


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    """Per-row cross-entropy with the class axis kept (size 1)."""
    loss = cross_entropy(logits, label, soft_label=soft_label,
                         ignore_index=ignore_index, reduction="none",
                         axis=axis).unsqueeze(axis)
    if return_softmax:
        (x,) = cast_inputs("softmax", logits)
        return loss, torch.softmax(x, dim=axis)
    return loss


def binary_cross_entropy(input, label, weight=None, reduction="mean",
                         name=None):
    """``-(t log p + (1 - t) log(1 - p))``, both logs of values clipped at
    1e-12."""
    p, t, weight = cast_inputs("bce", input, label, weight)
    loss = -(t * torch.log(torch.clamp(p, min=1e-12))
             + (1 - t) * torch.log(torch.clamp(1 - p, min=1e-12)))
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None,
                                     name=None):
    """``max(z, 0) - z t + log1p(exp(-|z|))``, times ``(pos_weight - 1) t
    + 1`` and ``weight``."""
    z, t, pos_weight, weight = cast_inputs("bce_logits", logit, label,
                                           pos_weight, weight)
    loss = _max0(z) - z * t + _log1pexp(z)
    if pos_weight is not None:
        loss = loss * ((pos_weight - 1) * t + 1)
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


def mse_loss(input, label, reduction="mean", name=None):
    a, b = cast_inputs("mse_loss", input, label)
    return _reduce((a - b) ** 2, reduction)


def square_error_cost(input, label, name=None):
    a, b = cast_inputs("square_error_cost", input, label)
    return (a - b) ** 2


def l1_loss(input, label, reduction="mean", name=None):
    a, b = cast_inputs("l1_loss", input, label)
    return _reduce((a - b).abs(), reduction)


def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean",
             name=None):
    """``-input[label]`` along the last axis, times ``weight[label]``. Only
    an ``ignore_index`` >= 0 is masked (the reference's test: a label of the
    default -100 reads NaN); then ``"mean"`` divides by the count of kept
    labels, weighted or not."""
    logp, weight = cast_inputs("nll_loss", input, weight)
    lab = label.long()
    loss = -_take(logp, lab[..., None], -1).squeeze(-1)
    if weight is not None:
        loss = loss * _take1(weight, lab)
    if ignore_index >= 0:
        mask = lab != ignore_index
        loss = torch.where(mask, loss, 0.0)
        if reduction == "mean":
            return loss.sum() / mask.sum().clamp(min=1)
    return _reduce(loss, reduction)


def smooth_l1_loss(input, label, reduction="mean", delta=1.0, name=None):
    """``0.5 d^2`` where ``|d| < delta``, else ``delta (|d| - delta / 2)``
    (no division by ``delta``: the reference's Huber form)."""
    a, b = cast_inputs("smooth_l1", input, label)
    d = a - b
    loss = torch.where(d.abs() < delta, 0.5 * d * d,
                       delta * (d.abs() - 0.5 * delta))
    return _reduce(loss, reduction)


def huber_loss(input, label, delta=1.0, reduction="mean", name=None):
    return smooth_l1_loss(input, label, reduction=reduction, delta=delta)


def kl_div(input, label, reduction="mean", name=None):
    """``label * (log(max(label, 1e-12)) - input)``; ``"batchmean"``
    divides the sum by the batch."""
    logp, t = cast_inputs("kl_div", input, label)
    loss = t * (torch.log(torch.clamp(t, min=1e-12)) - logp)
    if reduction == "batchmean":
        return loss.sum() / logp.shape[0]
    return _reduce(loss, reduction)


def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean",
                        name=None):
    a, b, y = cast_inputs("margin_ranking", input, other, label)
    return _reduce(_max0(-y * (a - b) + margin), reduction)


def hinge_embedding_loss(input, label, margin=1.0, reduction="mean",
                         name=None):
    a, y = cast_inputs("hinge_embedding", input, label)
    return _reduce(torch.where(y == 1, a, _max0(margin - a)), reduction)


def soft_margin_loss(input, label, reduction="mean", name=None):
    """``log(1 + exp(-label * input))`` in the stable softplus form."""
    a, y = cast_inputs("soft_margin_loss", input, label)
    z = -y.to(a.dtype) * a
    return _reduce(_max0(z) + _log1pexp(z), reduction)


def multi_label_soft_margin_loss(input, label, weight=None,
                                 reduction="mean", name=None):
    """Per-class sigmoid cross-entropy (times ``weight``), averaged over
    the classes."""
    a, y, weight = cast_inputs("multi_label_soft_margin_loss", input, label,
                               weight)
    y = y.to(a.dtype)
    tail = _log1pexp(a)
    logsig = -(_max0(-a) + tail)
    lognegsig = -(_max0(a) + tail)
    loss = -(y * logsig + (1.0 - y) * lognegsig)
    if weight is not None:
        loss = loss * weight
    return _reduce(loss.mean(dim=-1), reduction)


def poisson_nll_loss(input, label, log_input=True, full=False,
                     epsilon=1e-8, reduction="mean", name=None):
    """``exp(x) - t x`` under ``log_input``, else ``x - t log(x + eps)``;
    ``full`` adds Stirling's ``t log t - t + log(2 pi t) / 2`` where t >
    1."""
    a, t = cast_inputs("poisson_nll_loss", input, label)
    t = t.to(a.dtype)
    if log_input:
        loss = torch.exp(a) - t * a
    else:
        loss = a - t * torch.log(a + epsilon)
    if full:
        stirling = t * torch.log(t) - t + 0.5 * torch.log(2.0 * math.pi * t)
        loss = loss + torch.where(t > 1, stirling, 0.0)
    return _reduce(loss, reduction)


def gaussian_nll_loss(input, label, variance, full=False, epsilon=1e-6,
                      reduction="mean", name=None):
    """``(log v + (x - t)^2 / v) / 2`` with ``v = max(variance, eps)``,
    plus ``log(2 pi) / 2`` when ``full``."""
    a, t, v = cast_inputs("gaussian_nll_loss", input, label, variance)
    v = torch.clamp(v.to(a.dtype), min=epsilon)
    loss = 0.5 * (torch.log(v) + (a - t.to(a.dtype)) ** 2 / v)
    if full:
        loss = loss + 0.5 * float(np.log(2.0 * np.pi))
    return _reduce(loss, reduction)


def multi_margin_loss(input, label, p=1, margin=1.0, weight=None,
                      reduction="mean", name=None):
    """``sum_j max(0, margin - x_y + x_j)^p / C`` over j != y (the true
    class's term zeroed, the count still C), times ``weight[y]``."""
    x, y, weight = cast_inputs("multi_margin_loss", input, label, weight)
    c = x.shape[-1]
    y = y.long()
    h = _max0(margin - _take(x, y[..., None], -1) + x)
    if p != 1:
        h = h ** p
    h = h * (1.0 - one_hot(y, c).to(x.dtype))
    if weight is not None:
        h = h * _take1(weight, y)[..., None]
    return _reduce(h.sum(dim=-1) / c, reduction)


def pairwise_distance(x, y, p=2.0, epsilon=1e-6, keepdim=False, name=None):
    """``(sum (|x - y| + eps)^p)^(1/p)`` over the last axis (the largest
    term at p = inf)."""
    a, b = cast_inputs("pairwise_distance", x, y)
    d = (a - b).abs() + epsilon
    if np.isinf(p):
        return d.amax(dim=-1, keepdim=keepdim)
    return (d ** p).sum(dim=-1, keepdim=keepdim) ** (1.0 / p)


def triplet_margin_with_distance_loss(input, positive, negative,
                                      distance_function=None, margin=1.0,
                                      swap=False, reduction="mean",
                                      name=None):
    """``max(0, d(a, p) - d(a, n) + margin)`` with a caller's distance
    (``pairwise_distance`` by default); ``swap`` takes ``min(d(a, n), d(p,
    n))``."""
    dist = distance_function or pairwise_distance
    dp = dist(input, positive)
    dn = dist(input, negative)
    if swap:
        dn = torch.minimum(dn, dist(positive, negative))
    dp, dn = cast_inputs("triplet_margin_with_distance", dp, dn)
    return _reduce(_max0(dp - dn + margin), reduction)


def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0,
                        epsilon=1e-6, swap=False, reduction="mean",
                        name=None):
    """The triplet hinge over ``(sum (|u - v| + eps)^p)^(1/p)``."""
    a, pos, neg = cast_inputs("triplet_margin", input, positive, negative)

    def dist(u, v):
        return (((u - v).abs() + epsilon) ** p).sum(-1) ** (1.0 / p)
    dp, dn = dist(a, pos), dist(a, neg)
    if swap:
        dn = torch.minimum(dn, dist(pos, neg))
    return _reduce(_max0(dp - dn + margin), reduction)


def cosine_embedding_loss(input1, input2, label, margin=0.0,
                          reduction="mean", name=None):
    """``1 - cos`` for label 1, else ``max(0, cos - margin)``; cos divides
    by ``max(|a| |b|, 1e-12)``."""
    a, b, y = cast_inputs("cosine_embedding", input1, input2, label)
    cos = (a * b).sum(-1) / torch.clamp(
        torch.linalg.norm(a, dim=-1) * torch.linalg.norm(b, dim=-1),
        min=1e-12)
    return _reduce(torch.where(y == 1, 1.0 - cos, _max0(cos - margin)),
                   reduction)


def npair_loss(anchor, positive, labels, l2_reg=0.002, name=None):
    """Softmax cross-entropy over ``anchor @ positive.T`` against
    equal-label targets (rows normalized), plus ``l2_reg / 4`` of the
    embeddings' squared norm per anchor."""
    a, pos, y = cast_inputs("npair_loss", anchor, positive, labels)
    yf = y.reshape(-1).float()
    tgt = (yf[:, None] == yf[None, :]).float()
    tgt = tgt / tgt.sum(dim=1, keepdim=True)
    logp = torch.log_softmax(a @ pos.T, dim=-1)
    ce = (-tgt * logp).sum(dim=-1).mean()
    l2 = ((a * a).sum() + (pos * pos).sum()) / a.shape[0] * (l2_reg * 0.25)
    return ce + l2


def dice_loss(input, label, epsilon=1e-5, name=None):
    """Per sample ``1 - 2 |X and Y| / (|X| + |Y| + eps)`` over the
    probabilities ``input`` ``[..., C]`` and integer labels, averaged."""
    x, y = cast_inputs("dice_loss", input, label)
    c = x.shape[-1]
    yid = y[..., 0] if (y.dim() == x.dim() and y.shape[-1] == 1) else y
    oh = one_hot(yid, c).to(x.dtype)
    red = tuple(range(1, x.dim()))
    inter = (x * oh).sum(dim=red)
    union = x.sum(dim=red) + oh.sum(dim=red)
    return (1.0 - (2.0 * inter) / (union + epsilon)).mean()


def log_loss(input, label, epsilon=1e-4, name=None):
    """``-y log(p + eps) - (1 - y) log(1 - p + eps)``, unreduced."""
    p, y = cast_inputs("log_loss", input, label)
    return -y * torch.log(p + epsilon) - (1.0 - y) * torch.log(
        1.0 - p + epsilon)


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum", name=None):
    """``a_t (1 - p_t)^gamma`` times the sigmoid cross-entropy, divided by
    ``normalizer``."""
    z, t = cast_inputs("sigmoid_focal_loss", logit, label)
    p = torch.sigmoid(z)
    ce = _max0(z) - z * t + _log1pexp(z)
    p_t = p * t + (1 - p) * (1 - t)
    a_t = alpha * t + (1 - alpha) * (1 - t)
    loss = a_t * ((1 - p_t) ** gamma) * ce
    if normalizer is not None:
        loss = loss / normalizer
    return _reduce(loss, reduction)


def adaptive_log_softmax_with_loss(input, label, head_weight, tail_weights,
                                   cutoffs, head_bias=None, name=None):
    """Adaptive softmax: the true class's log-probability per sample, from
    the head (``cutoffs[0]`` frequent classes and one entry per cluster)
    or through its cluster's low-rank tail, and the mean NLL. Every
    cluster's tail is computed densely and the true one selected by mask,
    as in the reference. Raises on a label outside ``[0, cutoffs[-1])``
    (one device read)."""
    cutoffs = list(cutoffs)
    shortlist = cutoffs[0]
    if label.numel():
        lo, hi = int(label.min().item()), int(label.max().item())
        if lo < 0 or hi >= cutoffs[-1]:
            raise ValueError(
                "adaptive_log_softmax_with_loss: label values must be in "
                f"[0, {cutoffs[-1]}), got range [{lo}, {hi}]")
    flat_tails = [w for pair in tail_weights for w in pair]
    x, hw, hb, *tails = cast_inputs("adaptive_log_softmax_with_loss", input,
                                    head_weight, head_bias, *flat_tails)
    head = x @ hw
    if hb is not None:
        head = head + hb
    head_logp = torch.log_softmax(head, dim=-1)
    yv = label.reshape(-1).long()
    in_head = yv < shortlist
    out = torch.where(in_head, _take(
        head_logp, yv.clamp(0, shortlist - 1)[:, None], -1)[:, 0], 0.0)
    lo = shortlist
    for ci in range(len(cutoffs)):
        if ci + 1 >= len(cutoffs):
            break
        hi = cutoffs[ci + 1]
        proj, cls_w = tails[2 * ci], tails[2 * ci + 1]
        tail_logp = torch.log_softmax((x @ proj) @ cls_w, dim=-1)
        in_c = (yv >= lo) & (yv < hi)
        rel = (yv - lo).clamp(0, cls_w.shape[-1] - 1)
        lp = head_logp[:, shortlist + ci] + _take(tail_logp, rel[:, None],
                                                  -1)[:, 0]
        out = torch.where(in_c, lp, out)
        lo = hi
    return out, -out.mean()


_NEG = -1e30


def _lse(*xs):
    """Log-sum-exp over the stacked ``xs`` that keeps -1e30 for an
    all--1e30 column (the recursion's "no path")."""
    stacked = torch.stack(xs, 0)
    m = stacked.amax(0)
    empty = m <= _NEG / 2
    m_safe = torch.where(empty, 0.0, m)
    out = m_safe + torch.log(torch.exp(stacked - m_safe).sum(0))
    return torch.where(empty, _NEG, out)


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False, name=None):
    """CTC over time-major ``log_probs`` ``[T, B, C]`` (log-softmax
    outputs) and ``labels`` ``[B, L]``: the log-space alpha recursion over
    the extended sequence (blank, l1, blank, ..., blank), a step per time
    step; rows past their input length keep their alphas. ``norm_by_times``
    divides each sample by its input length; ``"mean"`` divides each by its
    label length, then takes the batch mean."""
    lp, = cast_inputs("ctc_loss", log_probs)
    T, B, _ = lp.shape
    L = labels.shape[1]
    S = 2 * L + 1
    dev = lp.device
    ilen, llen = input_lengths.long(), label_lengths.long()
    ext = torch.full((B, S), blank, dtype=torch.long, device=dev)
    ext[:, 1::2] = labels.long()
    pos = torch.arange(S, device=dev)[None, :]
    valid_s = pos < (2 * llen[:, None] + 1)
    ext_m2 = torch.cat([torch.full((B, 2), -1, dtype=torch.long,
                                   device=dev), ext[:, :-2]], dim=1)
    can_skip = (ext != blank) & (ext != ext_m2)
    neg1 = torch.full((B, 1), _NEG, dtype=lp.dtype, device=dev)
    neg2 = torch.full((B, 2), _NEG, dtype=lp.dtype, device=dev)

    e0 = lp[0].gather(1, ext)
    alpha = torch.cat([e0[:, :1], torch.where(llen > 0, e0[:, 1], _NEG)[
        :, None], neg2.new_full((B, S - 2), _NEG)], dim=1)
    for t in range(1, T):
        prev1 = torch.cat([neg1, alpha[:, :-1]], dim=1)
        prev2 = torch.where(can_skip, torch.cat([neg2, alpha[:, :-2]],
                                                dim=1), _NEG)
        new = _lse(alpha, prev1, prev2) + lp[t].gather(1, ext)
        new = torch.where(valid_s, new, _NEG)
        alpha = torch.where((t < ilen)[:, None], new, alpha)
    end = 2 * llen
    a_end = alpha.gather(1, end[:, None])[:, 0]
    a_last = alpha.gather(1, (end - 1).clamp(min=0)[:, None])[:, 0]
    a_last = torch.where(llen > 0, a_last, _NEG)
    loss = -_lse(a_end, a_last)
    if norm_by_times:
        loss = loss / ilen.to(loss.dtype).clamp(min=1)
    if reduction == "mean":
        return (loss / llen.to(loss.dtype).clamp(min=1)).mean()
    return _reduce(loss, reduction)
