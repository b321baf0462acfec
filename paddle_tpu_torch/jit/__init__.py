"""``fused_train_step``: one training step (forward, loss, backward,
optimizer update) per call.

Counterpart of ``paddle_tpu/jit/__init__.py``'s ``FusedTrainStep``. The
JAX package traces the step into one XLA program; here the step runs
eagerly, in the same order: run the caller's ``loss_fn`` (the loss in
fp32), backward (into the step: like the traced step, it leaves no
``.grad`` behind), clip the grads (the optimizer's ``grad_clip``), cast
them to the params' types and fold in L2 decay, ``opt.apply_updates`` (one
``multi_tensor_update`` launch per group, at the learning rate
``opt.get_lr()`` reads on this call), and count the step. BatchNorm's
running statistics update in the forward, as the traced program's buffer
writes do. Everything runs where the model's parameters lie. Capturing the
step in a CUDA graph is later work.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

__all__ = ["FusedTrainStep", "fused_train_step", "to_static"]


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
        out = self._loss_fn(*inputs)
        loss, aux = (out[0], tuple(out[1:])) if self._has_aux else (out, ())
        loss = loss.float()
        # a caller that checks for pending grads (hapi.Model) sees none
        grads = [g if g is not None else torch.zeros_like(p)
                 for p, g in zip(params, torch.autograd.grad(
                     loss, params, allow_unused=True))]
        with torch.no_grad():
            grads = opt._clip(params, grads)
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


def to_static(function=None, input_spec=None, build_strategy=None,
              full_graph=False, backend=None, **kwargs):
    """Not ported yet: ``jit.to_static`` (and ``static`` and
    ``enable_static``) wait for ROADMAP Queue A item 8."""
    raise NotImplementedError(
        "paddle_tpu_torch.jit.to_static is not ported yet (ROADMAP Queue A "
        "item 8: compile, analysis and profiler paths)")
