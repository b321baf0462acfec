"""Eager autograd on torch's engine.

Port of ``paddle_tpu/core/autograd.py``. The JAX package records a tape of
``jax.vjp`` closures and walks it in ``run_backward``; the port's tensors
are torch tensors, so torch's autograd records the graph and runs the
reverse pass. What this module keeps of the reference:

* ``no_grad`` / ``enable_grad`` / ``set_grad_enabled`` / ``is_grad_enabled``
  (torch's, which work as context managers and decorators, as Paddle's do);
* ``saved_tensors_hooks(pack, unpack)`` (torch's: ``pack`` sees each tensor
  the graph saves for backward, ``unpack`` restores it);
* ``backward(tensors, grad_tensors, retain_graph)`` with the reference's
  leaf rules: gradients accumulate into ``.grad`` of every leaf that does not
  stop gradients (``requires_grad``), summed over its uses; a tensor hook
  (``register_hook``) may rewrite an intermediate's gradient, and on a leaf
  runs before accumulation; a tensor of more than one element needs its
  ``grad_tensors`` entry (``ValueError``); a second pass through a freed
  graph raises ``RuntimeError``;
* ``register_backward_end_callback``: callbacks that run when a
  ``backward`` (this function, or ``Tensor.backward`` on a port tensor)
  ends, never after a ``grad`` capture pass.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence

import torch

__all__ = ["no_grad", "enable_grad", "set_grad_enabled", "is_grad_enabled",
           "saved_tensors_hooks", "backward", "register_backward_end_callback",
           "unregister_backward_end_callback"]

no_grad = torch.no_grad
enable_grad = torch.enable_grad
set_grad_enabled = torch.set_grad_enabled
is_grad_enabled = torch.is_grad_enabled
saved_tensors_hooks = torch.autograd.graph.saved_tensors_hooks

_backward_end_callbacks: List[Any] = []


def register_backward_end_callback(fn) -> None:
    _backward_end_callbacks.append(fn)


def unregister_backward_end_callback(fn) -> None:
    try:
        _backward_end_callbacks.remove(fn)
    except ValueError:
        pass


def _seed(t: torch.Tensor, g):
    if g is None:
        if t.numel() != 1:
            raise ValueError(
                "backward() on a non-scalar tensor requires grad_tensors "
                f"(shape {list(t.shape)})")
        return torch.ones_like(t)
    if not isinstance(g, torch.Tensor):
        g = torch.as_tensor(g, dtype=t.dtype, device=t.device)
    return g


def backward(tensors: Sequence[torch.Tensor],
             grad_tensors: Optional[Sequence[Any]] = None,
             retain_graph: bool = False) -> None:
    """The reverse pass from ``tensors`` into the leaves' ``.grad``
    (``egr::Backward``). A tensor that stops gradients contributes nothing
    (the reference skips it: it has no node)."""
    tensors = list(tensors)
    if grad_tensors is None:
        grad_tensors = [None] * len(tensors)
    roots, seeds = [], []
    for t, g in zip(tensors, grad_tensors):
        g = _seed(t, g)
        if t.requires_grad:
            roots.append(t)
            seeds.append(g)
    if roots:
        torch.autograd.backward(roots, seeds, retain_graph=retain_graph)
    for fn in list(_backward_end_callbacks):
        fn()
