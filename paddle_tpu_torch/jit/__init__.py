"""``fused_train_step``: one training step (forward, loss, backward,
optimizer update) per call.

Counterpart of ``paddle_tpu/jit/__init__.py``'s ``FusedTrainStep``. The
JAX package traces the step into one XLA program; here the step runs
eagerly, in the same order: clear the grads, run the caller's ``loss_fn``
(the loss in fp32), backward, cast the grads to the params' types and fold
in L2 decay, ``opt.apply_updates`` (one ``multi_tensor_update`` launch per
group), and count the step. BatchNorm's running statistics update in the
forward, as the traced program's buffer writes do. Everything runs where
the model's parameters lie. Capturing the step in a CUDA graph is later
work.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

__all__ = ["FusedTrainStep", "fused_train_step"]


class FusedTrainStep:
    """``step = fused_train_step(loss_fn, optimizer)``; ``loss = step(x,
    y)`` updates the parameters and the optimizer state in place and
    returns the loss (detached, fp32), with ``loss_fn``'s other outputs
    after it when ``has_aux``."""

    def __init__(self, loss_fn: Callable, optimizer, model=None,
                 has_aux: bool = False):
        # ``model`` is accepted for the JAX package's signature: eager
        # BatchNorm writes its statistics itself, so the step needs no
        # buffer list
        self._loss_fn = loss_fn
        self._opt = optimizer
        self._has_aux = has_aux

    def __call__(self, *inputs):
        opt = self._opt
        params = opt._params()
        for p in params:
            p.grad = None
        out = self._loss_fn(*inputs)
        loss, aux = (out[0], tuple(out[1:])) if self._has_aux else (out, ())
        loss = loss.float()
        loss.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        with torch.no_grad():
            opt._update(params, grads, opt.get_lr(), opt._step_count + 1)
        opt._step_count += 1
        loss = loss.detach()
        if self._has_aux:
            return (loss,) + tuple(a.detach() for a in aux)
        return loss


def fused_train_step(loss_fn=None, optimizer=None,
                     model: Optional[object] = None,
                     has_aux: bool = False) -> FusedTrainStep:
    """Build a training step function (see ``FusedTrainStep``)."""
    return FusedTrainStep(loss_fn, optimizer, model, has_aux=has_aux)
