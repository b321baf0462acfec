"""``Model.fit``'s callbacks (counterpart of
``paddle_tpu/hapi/callbacks.py``): ``History``, ``ProgBarLogger``,
``ModelCheckpoint``, ``LRScheduler`` (steps the optimizer's scheduler by
step or by epoch), ``EarlyStopping``, ``VisualDL`` (JSON lines under
``log_dir``), ``ReduceLROnPlateau`` and ``config_callbacks``. Every
decision reads the host logs the model already fetched."""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List

import numpy as np

from ..optimizer.lr import LRScheduler as Sched

__all__ = ["Callback", "ProgBarLogger", "ModelCheckpoint", "EarlyStopping",
           "LRScheduler", "History", "VisualDL", "ReduceLROnPlateau",
           "config_callbacks"]


class Callback:
    def __init__(self):
        self.model = None
        self.params = {}

    def set_model(self, model):
        self.model = model

    def set_params(self, params):
        self.params = params or {}

    def on_train_begin(self, logs=None): ...
    def on_train_end(self, logs=None): ...
    def on_eval_begin(self, logs=None): ...
    def on_eval_end(self, logs=None): ...
    def on_predict_begin(self, logs=None): ...
    def on_predict_end(self, logs=None): ...
    def on_epoch_begin(self, epoch, logs=None): ...
    def on_epoch_end(self, epoch, logs=None): ...
    def on_train_batch_begin(self, step, logs=None): ...
    def on_train_batch_end(self, step, logs=None): ...
    def on_eval_batch_begin(self, step, logs=None): ...
    def on_eval_batch_end(self, step, logs=None): ...
    def on_predict_batch_begin(self, step, logs=None): ...
    def on_predict_batch_end(self, step, logs=None): ...


class CallbackList:
    def __init__(self, callbacks: List[Callback]):
        self.callbacks = callbacks

    def set_model(self, model):
        for c in self.callbacks:
            c.set_model(model)

    def set_params(self, params):
        for c in self.callbacks:
            c.set_params(params)

    def __getattr__(self, name):
        if name.startswith("on_"):
            def dispatch(*args, **kwargs):
                for c in self.callbacks:
                    getattr(c, name)(*args, **kwargs)

            return dispatch
        raise AttributeError(name)


class History(Callback):
    def on_train_begin(self, logs=None):
        self.history: Dict[str, list] = {}

    def on_epoch_end(self, epoch, logs=None):
        for k, v in (logs or {}).items():
            self.history.setdefault(k, []).append(v)


class ProgBarLogger(Callback):
    def __init__(self, log_freq=1, verbose=2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch
        self.steps = self.params.get("steps")
        self._start = time.time()
        if self.verbose:
            print(f"Epoch {epoch + 1}/{self.params.get('epochs', '?')}")

    def _fmt(self, logs):
        items = []
        for k, v in (logs or {}).items():
            if isinstance(v, (list, tuple, np.ndarray)):
                v = np.asarray(v).reshape(-1)
                items.append(f"{k}: " + "/".join(f"{x:.4f}" for x in v))
            elif isinstance(v, float):
                items.append(f"{k}: {v:.4f}")
            else:
                items.append(f"{k}: {v}")
        return " - ".join(items)

    def on_train_batch_end(self, step, logs=None):
        if self.verbose > 1 and step % self.log_freq == 0:
            print(f"step {step + 1}/{self.steps or '?'} - {self._fmt(logs)}")

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            dt = time.time() - self._start
            print(f"Epoch {epoch + 1} done ({dt:.1f}s) - {self._fmt(logs)}")

    def on_eval_end(self, logs=None):
        if self.verbose:
            print(f"Eval - {self._fmt(logs)}")


class ModelCheckpoint(Callback):
    def __init__(self, save_freq=1, save_dir=None):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.save_dir and self.model and epoch % self.save_freq == 0:
            path = os.path.join(self.save_dir, str(epoch))
            self.model.save(path)

    def on_train_end(self, logs=None):
        if self.save_dir and self.model:
            self.model.save(os.path.join(self.save_dir, "final"))


class LRScheduler(Callback):
    def __init__(self, by_step=True, by_epoch=False):
        super().__init__()
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        opt = getattr(self.model, "_optimizer", None)
        if opt is not None and isinstance(opt._learning_rate, Sched):
            return opt._learning_rate
        return None

    def on_train_batch_end(self, step, logs=None):
        if self.by_step:
            s = self._sched()
            if s is not None:
                s.step()

    def on_epoch_end(self, epoch, logs=None):
        if self.by_epoch:
            s = self._sched()
            if s is not None:
                s.step()


class EarlyStopping(Callback):
    def __init__(self, monitor="loss", mode="auto", patience=0, verbose=1,
                 min_delta=0, baseline=None, save_best_model=True):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        self.save_best_model = save_best_model
        if mode == "auto":
            mode = "max" if "acc" in monitor else "min"
        self.mode = mode
        self.stopped_epoch = 0

    def on_train_begin(self, logs=None):
        self.wait = 0
        self.best = self.baseline if self.baseline is not None else (
            -np.inf if self.mode == "max" else np.inf)
        self.model.stop_training = False

    def on_eval_end(self, logs=None):
        cur = (logs or {}).get(self.monitor)
        if cur is None:
            return
        if isinstance(cur, (list, tuple, np.ndarray)):
            cur = float(np.asarray(cur).reshape(-1)[0])
        improved = (cur > self.best + self.min_delta if self.mode == "max"
                    else cur < self.best - self.min_delta)
        if improved:
            self.best = cur
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.model.stop_training = True


class VisualDL(Callback):
    """Scalar logger (VisualDL is Paddle's TensorBoard): the scalar stream
    as JSON lines in ``log_dir/vdlrecords.jsonl``, one record per step or
    evaluation: ``{"tag", "step", "value", "wall_time"}``."""

    def __init__(self, log_dir="./log"):
        super().__init__()
        self.log_dir = log_dir
        self._fh = None
        self._step = 0

    def _write(self, tag, value, step):
        if self._fh is None:
            os.makedirs(self.log_dir, exist_ok=True)
            self._fh = open(os.path.join(self.log_dir, "vdlrecords.jsonl"),
                            "a")
        try:
            value = float(np.asarray(value).reshape(-1)[0])
        except (TypeError, ValueError):
            return
        self._fh.write(json.dumps({"tag": tag, "step": step,
                                   "value": value,
                                   "wall_time": time.time()}) + "\n")
        self._fh.flush()

    def on_train_batch_end(self, step, logs=None):
        self._step += 1
        for k, v in (logs or {}).items():
            self._write(f"train/{k}", v, self._step)

    def on_eval_end(self, logs=None):
        for k, v in (logs or {}).items():
            self._write(f"eval/{k}", v, self._step)

    def on_train_end(self, logs=None):
        if self._fh is not None:
            self._fh.close()
            self._fh = None


class ReduceLROnPlateau(Callback):
    """Cut the optimizer's learning rate by ``factor`` when the monitored
    evaluation metric has not improved for ``patience`` evaluations (an
    optimizer with a scheduler keeps its rate)."""

    def __init__(self, monitor="loss", factor=0.1, patience=10, verbose=1,
                 mode="auto", min_delta=1e-4, cooldown=0, min_lr=0.0):
        super().__init__()
        self.monitor = monitor
        self.factor = factor
        self.patience = patience
        self.verbose = verbose
        if mode == "auto":
            mode = "max" if "acc" in monitor else "min"
        self.mode = mode
        self.min_delta = abs(min_delta)
        self.cooldown = cooldown
        self.min_lr = min_lr

    def on_train_begin(self, logs=None):
        self.wait = 0
        self.cooldown_counter = 0
        self.best = -np.inf if self.mode == "max" else np.inf

    def on_eval_end(self, logs=None):
        cur = (logs or {}).get(self.monitor)
        if cur is None:
            return
        if isinstance(cur, (list, tuple, np.ndarray)):
            cur = float(np.asarray(cur).reshape(-1)[0])
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.wait = 0
        improved = (cur > self.best + self.min_delta if self.mode == "max"
                    else cur < self.best - self.min_delta)
        if improved:
            self.best = cur
            self.wait = 0
        elif self.cooldown_counter <= 0:
            self.wait += 1
            if self.wait >= self.patience:
                opt = getattr(self.model, "_optimizer", None)
                if opt is not None:
                    if not isinstance(opt._learning_rate, Sched):
                        new_lr = max(opt.get_lr() * self.factor, self.min_lr)
                        opt.set_lr(new_lr)
                        if self.verbose:
                            print(f"ReduceLROnPlateau: lr -> {new_lr:.2e}")
                self.cooldown_counter = self.cooldown
                self.wait = 0


def config_callbacks(callbacks=None, model=None, epochs=None, steps=None,
                     log_freq=1, verbose=2, save_freq=1, save_dir=None,
                     metrics=None, mode="train"):
    cbks = list(callbacks or [])
    if not any(isinstance(c, ProgBarLogger) for c in cbks) and verbose:
        cbks.append(ProgBarLogger(log_freq, verbose=verbose))
    if not any(isinstance(c, LRScheduler) for c in cbks):
        cbks.append(LRScheduler())
    if save_dir and not any(isinstance(c, ModelCheckpoint) for c in cbks):
        cbks.append(ModelCheckpoint(save_freq, save_dir))
    if not any(isinstance(c, History) for c in cbks):
        cbks.append(History())
    clist = CallbackList(cbks)
    clist.set_model(model)
    clist.set_params({
        "epochs": epochs, "steps": steps, "verbose": verbose,
        "metrics": metrics or [],
    })
    return clist
