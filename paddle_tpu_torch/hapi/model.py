"""``Model``: the Keras-like high-level API (counterpart of
``paddle_tpu/hapi/model.py``).

``prepare`` takes the optimizer, the loss and the metrics; ``fit``,
``evaluate`` and ``predict`` loop over an ``io.DataLoader`` (built from a
``Dataset``) or any iterable of batches, and ``save`` / ``load`` write the
JAX package's checkpoint container (``framework.io``).

``train_batch`` runs ``jit.fused_train_step`` whenever it updates and no
gradients are pending: forward, loss, backward, clipping and the update,
one ``multi_tensor_update`` launch per parameter group. With gradients
accumulating (``accumulate_grad_batches``, or ``update=False``) it runs
eagerly: forward, loss, backward, and ``step`` then ``clear_grad`` when it
updates. ``eval_batch`` and ``predict_batch`` run eagerly under
``torch.no_grad()``. There is no second way to run a batch: an exception
propagates.

A batch reaches the model's device on the calling thread
(``io.to_device``). Each train or eval batch reads the device once: the
loss and every metric's ``compute_traced`` result (``Accuracy``'s
``[N, maxk]`` matrix) come back in one host copy; the logits are not
fetched. A train step's time, samples/s and loss go to
``observability.metrics`` and a ``hapi.train_batch`` host span to
``profiler._hooks``, from values already on the host.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np
import torch

from ..device import get_device, resolve_device
from ..framework.io import load as _load
from ..framework.io import save as _save
from ..io import DataLoader, Dataset, to_device
from ..jit import fused_train_step
from ..metric import Metric
from ..observability import metrics as _obs
from ..profiler import _hooks
from .callbacks import config_callbacks

__all__ = ["Model"]


def _as_list(x) -> list:
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _as_tensor_batch(data, device) -> List[torch.Tensor]:
    """A batch's items as tensors on ``device`` (numpy arrays and CPU
    tensors through pinned memory, without blocking)."""
    return [to_device(d if isinstance(d, torch.Tensor)
                      else np.asarray(d), device) for d in _as_list(data)]


_NP_TYPES = {torch.bool: np.bool_, torch.uint8: np.uint8,
             torch.int32: np.int32, torch.int64: np.int64,
             torch.float32: np.float32, torch.float64: np.float64}


def _fetch(tensors: List[torch.Tensor]) -> List[np.ndarray]:
    """Host copies of ``tensors`` in one device read: each is flattened to
    float64 (exact for the bools, integers and fp32 values it carries),
    the pieces are joined on the device and copied back together, then
    split, reshaped and cast back to their types (bf16 and fp16 to
    fp32)."""
    if not tensors:
        return []
    host = torch.cat([t.detach().reshape(-1).to(torch.float64)
                      for t in tensors]).cpu().numpy()
    out, off = [], 0
    for t in tensors:
        n = t.numel()
        out.append(host[off:off + n].reshape(tuple(t.shape)).astype(
            _NP_TYPES.get(t.dtype, np.float32)))
        off += n
    return out


class Model:
    def __init__(self, network, inputs=None, labels=None):
        self.network = network
        self._optimizer = None
        self._loss = None
        self._metrics: List[Metric] = []
        self.stop_training = False
        self._fused_step = None
        self._n_inputs = 0
        self._pre_counts: List[int] = []

    # -- setup ---------------------------------------------------------------
    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None):
        self._optimizer = optimizer
        self._loss = loss
        if metrics is None:
            self._metrics = []
        elif isinstance(metrics, Metric):
            self._metrics = [metrics]
        else:
            self._metrics = list(metrics)
        # the step closes over the optimizer, the loss and the metrics
        self._fused_step = None
        return self

    # -- single batches ------------------------------------------------------
    def _compute_loss(self, outputs, labels):
        if self._loss is None:
            raise ValueError("Model.prepare(loss=...) was not called")
        return self._loss(*_as_list(outputs), *_as_list(labels))

    def _traced_pres(self, outs, labels):
        """Each metric's ``compute_traced`` results on the device, flat,
        with each metric's count (0 for a metric without one)."""
        pres, counts = [], []
        for m in self._metrics:
            fn = getattr(m, "compute_traced", None)
            if fn is None:
                counts.append(0)
                continue
            pre = _as_list(fn(*outs, *labels))
            counts.append(len(pre))
            pres.extend(pre)
        return pres, counts

    def _loss_and_outs(self, *args):
        """The fused step's function: (loss, *outputs, *metric results)."""
        n = self._n_inputs
        outs = _as_list(self.network(*args[:n]))
        labels = list(args[n:])
        loss = self._compute_loss(outs, labels)
        with torch.no_grad():
            pres, self._pre_counts = self._traced_pres(outs, labels)
        return (loss, *outs, *pres)

    def _finish(self, loss, outs, labels, pres, counts):
        """One device read for the loss and the metric results, then the
        metrics' updates on the host."""
        host = _fetch([loss.reshape(()).float(), *pres])
        metrics = self._update_metrics(outs, labels, host[1:], counts)
        loss_f = float(host[0])
        return ([loss_f], metrics) if metrics else [loss_f]

    def _record_train_step(self, t0_ns: int, inputs, loss_val) -> None:
        """A step's telemetry: the step-time histogram, samples/s and loss
        gauges, and a host span; every input is a host value."""
        t1_ns = _hooks.now_ns()
        _hooks.emit("hapi.train_batch", t0_ns, t1_ns, kind="train")
        dt = (t1_ns - t0_ns) / 1e9
        _obs.histogram("train.step_time_s").observe(dt)
        _obs.counter("train.steps").inc()
        _obs.gauge("train.loss").set(float(loss_val))
        bs = int(inputs[0].shape[0]) if inputs and inputs[0].dim() else 0
        if bs and dt > 0:
            _obs.gauge("train.samples_per_s").set(bs / dt)

    def train_batch(self, inputs, labels=None, update=True):
        t0_ns = _hooks.now_ns()
        self.network.train()
        device = resolve_device(get_device())
        inputs = _as_tensor_batch(inputs, device)
        labels = (_as_tensor_batch(labels, device) if labels is not None
                  else [])
        opt = self._optimizer
        updates = update and opt is not None
        if updates and all(p.grad is None for p in opt._params()):
            if self._fused_step is None:
                self._fused_step = fused_train_step(
                    self._loss_and_outs, opt, model=self.network,
                    has_aux=True)
            self._n_inputs = len(inputs)
            loss, *rest = self._fused_step(*inputs, *labels)
            counts = self._pre_counts
            n_out = len(rest) - sum(counts)
            outs, pres = rest[:n_out], rest[n_out:]
        else:
            outs = _as_list(self.network(*inputs))
            loss = self._compute_loss(outs, labels)
            loss.backward()
            if updates:
                opt.step()
                opt.clear_grad()
            with torch.no_grad():
                pres, counts = self._traced_pres(outs, labels)
        res = self._finish(loss, outs, labels, pres, counts)
        if updates:
            self._record_train_step(t0_ns, inputs,
                                    (res[0] if isinstance(res, tuple)
                                     else res)[0])
        return res

    def eval_batch(self, inputs, labels=None):
        self.network.eval()
        device = resolve_device(get_device())
        inputs = _as_tensor_batch(inputs, device)
        labels = (_as_tensor_batch(labels, device) if labels is not None
                  else [])
        with torch.no_grad():
            outs = _as_list(self.network(*inputs))
            loss = self._compute_loss(outs, labels)
            pres, counts = self._traced_pres(outs, labels)
        return self._finish(loss, outs, labels, pres, counts)

    def predict_batch(self, inputs):
        self.network.eval()
        inputs = _as_tensor_batch(inputs, resolve_device(get_device()))
        with torch.no_grad():
            outs = _as_list(self.network(*inputs))
        return _fetch(outs)

    def _update_metrics(self, outs, labels, pres_host, counts):
        """Each metric's update from its fetched results, or, for a metric
        without ``compute_traced``, from its ``compute`` on the outputs."""
        results = []
        pres_host = list(pres_host)
        for m, c in zip(self._metrics, counts):
            if c:
                pre = [pres_host.pop(0) for _ in range(c)]
            else:
                pre = _as_list(m.compute(*outs, *labels))
            m.update(*pre)
            results.append(m.accumulate())
        return results

    # -- loops ---------------------------------------------------------------
    def _build_loader(self, data, batch_size, shuffle, num_workers):
        if isinstance(data, Dataset):
            return DataLoader(data, batch_size=batch_size, shuffle=shuffle,
                              num_workers=num_workers)
        return data  # a DataLoader or any iterable of batches

    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1, verbose=2,
            drop_last=False, shuffle=True, num_workers=0, callbacks=None,
            accumulate_grad_batches=1, num_iters=None):
        loader = self._build_loader(train_data, batch_size, shuffle,
                                    num_workers)
        try:
            steps = len(loader)
        except TypeError:
            steps = None
        cbks = config_callbacks(
            callbacks, model=self, epochs=epochs, steps=steps,
            log_freq=log_freq, verbose=verbose, save_freq=save_freq,
            save_dir=save_dir, metrics=self._metric_names())
        self.stop_training = False
        cbks.on_train_begin()
        it = 0
        logs = {}
        for epoch in range(epochs):
            cbks.on_epoch_begin(epoch)
            for m in self._metrics:
                m.reset()
            logs = {}
            for step, batch in enumerate(loader):
                cbks.on_train_batch_begin(step)
                inputs, labels = self._split_batch(batch)
                update = (step + 1) % accumulate_grad_batches == 0
                logs = self._make_logs(self.train_batch(inputs, labels,
                                                        update=update))
                cbks.on_train_batch_end(step, logs)
                it += 1
                if num_iters is not None and it >= num_iters:
                    break
            cbks.on_epoch_end(epoch, logs)
            if eval_data is not None and (epoch + 1) % eval_freq == 0:
                self.evaluate(eval_data, batch_size=batch_size, verbose=0,
                              num_workers=num_workers, callbacks=cbks)
            if self.stop_training or (num_iters is not None
                                      and it >= num_iters):
                break
        cbks.on_train_end(logs)
        for c in cbks.callbacks:
            if type(c).__name__ == "History":
                return c.history
        return None

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, num_samples=None):
        loader = self._build_loader(eval_data, batch_size, False,
                                    num_workers)
        if callbacks is None:
            callbacks = config_callbacks(
                None, model=self, verbose=verbose, log_freq=log_freq,
                metrics=self._metric_names())
        for m in self._metrics:
            m.reset()
        callbacks.on_eval_begin()
        logs = {}
        for step, batch in enumerate(loader):
            callbacks.on_eval_batch_begin(step)
            inputs, labels = self._split_batch(batch)
            logs = self._make_logs(self.eval_batch(inputs, labels))
            callbacks.on_eval_batch_end(step, logs)
        callbacks.on_eval_end(logs)
        return logs

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, verbose=1, callbacks=None):
        loader = self._build_loader(test_data, batch_size, False,
                                    num_workers)
        outputs = []
        for batch in loader:
            inputs, _ = self._split_batch(batch, has_labels=False)
            outputs.append(self.predict_batch(inputs))
        if stack_outputs:
            return [np.concatenate([o[i] for o in outputs])
                    for i in range(len(outputs[0]))]
        return outputs

    @staticmethod
    def _split_batch(batch, has_labels=True):
        if isinstance(batch, (list, tuple)):
            if has_labels and len(batch) >= 2:
                return list(batch[:-1]), [batch[-1]]
            return list(batch), []
        return [batch], []

    def _make_logs(self, res):
        logs = {}
        if isinstance(res, tuple):
            losses, metrics = res
            logs["loss"] = losses[0] if len(losses) == 1 else losses
            for m, v in zip(self._metrics, metrics):
                names = m.name()
                logs[names if isinstance(names, str) else names[0]] = v
        else:
            logs["loss"] = res[0] if len(res) == 1 else res
        return logs

    def _metric_names(self):
        names = ["loss"]
        for m in self._metrics:
            n = m.name()
            names.extend([n] if isinstance(n, str) else n)
        return names

    # -- persistence ---------------------------------------------------------
    def save(self, path, training=True):
        _save(self.network.state_dict(), path + ".pdparams")
        if training and self._optimizer is not None:
            _save(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        params = path if path.endswith(".pdparams") else path + ".pdparams"
        self.network.set_state_dict(_load(params))
        opt_path = path + ".pdopt"
        if (not reset_optimizer and self._optimizer is not None
                and os.path.exists(opt_path)):
            self._optimizer.set_state_dict(_load(opt_path))

    def parameters(self, *args, **kwargs):
        return self.network.parameters(*args, **kwargs)

    def summary(self, input_size=None, dtype=None):
        params = self.network.parameters()
        total = sum(p.numel() for p in params)
        trainable = sum(p.numel() for p in params if p.requires_grad)
        print("\n".join([repr(self.network), f"Total params: {total:,}",
                         f"Trainable params: {trainable:,}"]))
        return {"total_params": total, "trainable_params": trainable}
