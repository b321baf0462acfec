"""Metrics (counterpart of ``paddle_tpu/metric``): ``Metric``,
``Accuracy``, ``Precision``, ``Recall``, ``Auc`` and ``accuracy``.

State accumulates on the host in numpy, as in the reference.
``Accuracy.compute`` reads the predictions to the host;
``Accuracy.compute_traced`` computes the ``[N, maxk]`` correctness matrix
with torch ops where the predictions lie, so ``hapi.Model`` brings back
only that small matrix with the loss in its one device read per batch.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import get_device, resolve_device

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc", "accuracy"]


def _np(x):
    return (x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x))


class Metric:
    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        raise NotImplementedError

    def compute(self, *args):
        """Optional preprocessing of the outputs before ``update``."""
        return args


class Accuracy(Metric):
    def __init__(self, topk=(1,), name=None):
        self.topk = (topk,) if isinstance(topk, int) else tuple(topk)
        self.maxk = max(self.topk)
        self._name = name or "acc"
        self.reset()

    def reset(self):
        self.total = np.zeros(len(self.topk))
        self.count = np.zeros(len(self.topk))

    def compute(self, pred, label, *args):
        """The ``[..., maxk]`` correctness matrix, on the host."""
        pred_np = _np(pred)
        label_np = _np(label)
        if label_np.ndim == pred_np.ndim and label_np.shape[-1] == 1:
            label_np = label_np.squeeze(-1)
        topk_idx = np.argsort(-pred_np, axis=-1)[..., :self.maxk]
        return topk_idx == label_np[..., None]

    def compute_traced(self, pred, label, *args):
        """``compute`` in torch ops where ``pred`` lies (a bool tensor):
        the top ``maxk`` classes by a stable descending sort, so a tie
        keeps the lower class first, as the reference's traced sort does."""
        if label.dim() == pred.dim() and label.shape[-1] == 1:
            label = label.squeeze(-1)
        idx = torch.argsort(pred, dim=-1, descending=True, stable=True)
        return idx[..., :self.maxk] == label.unsqueeze(-1)

    def update(self, correct, *args):
        correct = _np(correct)
        flat = correct.reshape(-1, correct.shape[-1])
        n = flat.shape[0]
        for i, k in enumerate(self.topk):
            self.total[i] += flat[:, :k].any(-1).sum()
            self.count[i] += n
        return float(self.total[0] / max(self.count[0], 1))

    def accumulate(self):
        res = [t / max(c, 1) for t, c in zip(self.total, self.count)]
        return res[0] if len(res) == 1 else res

    def name(self):
        if len(self.topk) == 1:
            return self._name
        return [f"{self._name}_top{k}" for k in self.topk]


class Precision(Metric):
    def __init__(self, name="precision"):
        self._name = name
        self.reset()

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        preds = (_np(preds) > 0.5).astype(int).reshape(-1)
        labels = _np(labels).astype(int).reshape(-1)
        self.tp += int(((preds == 1) & (labels == 1)).sum())
        self.fp += int(((preds == 1) & (labels == 0)).sum())

    def accumulate(self):
        denom = self.tp + self.fp
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Recall(Metric):
    def __init__(self, name="recall"):
        self._name = name
        self.reset()

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        preds = (_np(preds) > 0.5).astype(int).reshape(-1)
        labels = _np(labels).astype(int).reshape(-1)
        self.tp += int(((preds == 1) & (labels == 1)).sum())
        self.fn += int(((preds == 0) & (labels == 1)).sum())

    def accumulate(self):
        denom = self.tp + self.fn
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Auc(Metric):
    def __init__(self, curve="ROC", num_thresholds=4095, name="auc"):
        self.num_thresholds = num_thresholds
        self._name = name
        self.reset()

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1)
        self._stat_neg = np.zeros(self.num_thresholds + 1)

    def update(self, preds, labels):
        preds = _np(preds)
        labels = _np(labels).reshape(-1)
        if preds.ndim == 2:
            preds = preds[:, 1]
        preds = preds.reshape(-1)
        bins = np.minimum((preds * self.num_thresholds).astype(int),
                          self.num_thresholds)
        for b, lab in zip(bins, labels):
            if lab:
                self._stat_pos[b] += 1
            else:
                self._stat_neg[b] += 1

    def accumulate(self):
        tot_pos = self._stat_pos.sum()
        tot_neg = self._stat_neg.sum()
        if not tot_pos or not tot_neg:
            return 0.0
        # trapezoids over the thresholds, high to low
        tpr = np.cumsum(self._stat_pos[::-1]) / tot_pos
        fpr = np.cumsum(self._stat_neg[::-1]) / tot_neg
        return float(np.trapezoid(tpr, fpr) if hasattr(np, "trapezoid")
                     else np.trapz(tpr, fpr))

    def name(self):
        return self._name


def accuracy(input, label, k=1, correct=None, total=None, name=None):
    """Top-``k`` accuracy of ``input`` against ``label`` as a float32
    scalar tensor, on ``input``'s device (a tensor) or the current one."""
    pred = _np(input)
    lab = _np(label).reshape(-1)
    topk_idx = np.argsort(-pred, axis=-1)[:, :k]
    correct_mask = (topk_idx == lab[:, None]).any(-1)
    device = (input.device if isinstance(input, torch.Tensor)
              else resolve_device(get_device()))
    return torch.tensor(float(correct_mask.mean()), dtype=torch.float32,
                        device=device)
