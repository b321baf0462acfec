"""``paddle.autograd``: ``backward``, ``grad``, ``PyLayer`` and the
functional transforms (port of ``paddle_tpu/autograd/__init__.py``).

``PyLayer`` runs on ``torch.autograd.Function``: ``forward(ctx, *args)``
runs without recording, ``backward(ctx, *grads)`` returns one gradient per
tensor input (or per input that needs one). ``jacobian``, ``hessian``,
``jvp`` and ``vjp`` are ``torch.autograd.functional``'s, with the
reference's result layouts: ``jacobian`` of several inputs is a tuple over
the inputs, each mirroring the output structure. Unlike the reference,
``grad`` / ``jacobian`` / ``hessian`` take ``create_graph=True`` (torch's
engine differentiates twice); results are otherwise detached.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from ..core import autograd as _engine
from ..core.autograd import (enable_grad, is_grad_enabled, no_grad,
                             saved_tensors_hooks, set_grad_enabled)
from ..core.tensor import as_port_tensor
from ..enforce import InvalidArgumentError

__all__ = [
    "backward",
    "grad",
    "PyLayer",
    "PyLayerContext",
    "no_grad",
    "saved_tensors_hooks",
    "enable_grad",
    "is_grad_enabled",
    "set_grad_enabled",
    "jacobian",
    "hessian",
    "jvp",
    "vjp",
]


def _as_list(x):
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


def backward(tensors, grad_tensors=None, retain_graph=False):
    _engine.backward(_as_list(tensors), _as_list(grad_tensors) or None,
                     retain_graph)


def grad(outputs, inputs, grad_outputs=None,
         retain_graph: Optional[bool] = None, create_graph: bool = False,
         only_inputs: bool = True, allow_unused: bool = False,
         no_grad_vars=None) -> List[Optional[torch.Tensor]]:
    """``paddle.grad``: gradients of ``outputs`` with respect to
    ``inputs``, without touching any ``.grad``. An input the outputs do not
    reach raises unless ``allow_unused`` (then its entry is None); the
    graph is kept unless ``retain_graph=False``."""
    outputs = _as_list(outputs)
    inputs = _as_list(inputs)
    gouts = _as_list(grad_outputs) or [None] * len(outputs)
    retain = True if retain_graph is None else retain_graph
    live = [(o, _engine._seed(o, g)) for o, g in zip(outputs, gouts)
            if o.requires_grad]
    diff = [i for i, t in enumerate(inputs) if t.requires_grad]
    raw = [None] * len(inputs)
    if live and diff:
        got = torch.autograd.grad(
            [o for o, _ in live], [inputs[i] for i in diff],
            [s for _, s in live], retain_graph=retain or create_graph,
            create_graph=create_graph, allow_unused=True)
        for i, g in zip(diff, got):
            raw[i] = g
    result = []
    for t, g in zip(inputs, raw):
        if g is None:
            if not allow_unused:
                raise InvalidArgumentError(
                    "Input tensor is unreachable from outputs (pass "
                    "allow_unused=True to get None).")
            result.append(None)
        else:
            result.append(as_port_tensor(g if create_graph else g.detach()))
    return result


class PyLayerContext:
    """Context passed to PyLayer.forward/backward."""

    def __init__(self):
        self._saved: tuple = ()
        self.not_inplace_tensors = ()

    def save_for_backward(self, *tensors):
        self._saved = tensors

    @property
    def saved_tensor(self):
        return self._saved

    def saved_tensors(self):
        return self._saved


_FUNCTIONS = {}


def _function_for(cls):
    """The ``torch.autograd.Function`` that runs PyLayer ``cls``."""
    fn = _FUNCTIONS.get(cls)
    if fn is not None:
        return fn

    class _Fn(torch.autograd.Function):
        @staticmethod
        def forward(fctx, pctx, kwargs, *args):
            fctx.pctx = pctx
            fctx.tensor_pos = [i for i, a in enumerate(args)
                               if isinstance(a, torch.Tensor)]
            out = cls.forward(pctx, *args, **kwargs)
            return tuple(out) if isinstance(out, list) else out

        @staticmethod
        def backward(fctx, *grads):
            grads = [None if g is None else as_port_tensor(g) for g in grads]
            gin = cls.backward(fctx.pctx, *grads)
            gin = (gin,) if gin is None or isinstance(gin, torch.Tensor) \
                else tuple(gin)
            needs = fctx.needs_input_grad[2:]
            pos = fctx.tensor_pos
            if len(gin) != len(pos):  # one per input that needs a gradient
                pos = [i for i in pos if needs[i]]
            result = [None] * len(needs)
            for i, g in zip(pos, gin):
                result[i] = g
            return (None, None, *result)

    _Fn.__name__ = cls.__name__
    _FUNCTIONS[cls] = _Fn
    return _Fn


class PyLayer:
    """User-defined differentiable op (``paddle.autograd.PyLayer``):
    subclass with ``forward(ctx, *args)`` and ``backward(ctx, *grads)``
    static methods and call ``MyOp.apply(*args)``."""

    @staticmethod
    def forward(ctx, *args, **kwargs):
        raise NotImplementedError

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError

    @classmethod
    def apply(cls, *args, **kwargs):
        return _function_for(cls).apply(PyLayerContext(), kwargs, *args)


# ---------------------------------------------------------------------------
# Functional autograd API (reference: paddle.autograd.jacobian / hessian /
# jvp / vjp), on torch.autograd.functional.
# ---------------------------------------------------------------------------

def _tuple_out(func):
    def wrapped(*args):
        out = func(*args)
        return tuple(out) if isinstance(out, list) else out

    return wrapped


def _inputs(xs):
    single = isinstance(xs, torch.Tensor)
    return (xs if single else tuple(xs)), single


def _port(tree):
    if isinstance(tree, torch.Tensor):
        return as_port_tensor(tree.detach())
    return tuple(_port(t) for t in tree)


def jacobian(func, xs, create_graph=False, allow_unused=False):
    """J[i][j] = d out_i / d x_j: a tensor for one input and one output,
    else a tuple over the inputs, each mirroring the output structure
    (unused inputs give zero blocks)."""
    inputs, single = _inputs(xs)
    jac = torch.autograd.functional.jacobian(_tuple_out(func), inputs,
                                             create_graph=create_graph)
    if not single and isinstance(jac[0], tuple):
        # torch: outputs x inputs; the reference: inputs x outputs
        jac = tuple(zip(*jac))
    return jac if create_graph else _port(jac)


def hessian(func, xs, create_graph=False, allow_unused=False):
    """H = d^2 f / dx^2 of a scalar ``func``: a tensor for one input, else
    a tuple of tuples."""
    inputs, _ = _inputs(xs)
    hes = torch.autograd.functional.hessian(func, inputs,
                                            create_graph=create_graph)
    return hes if create_graph else _port(hes)


def jvp(func, xs, v=None):
    """(outputs, Jv): forward-mode directional derivative (v defaults to
    ones)."""
    inputs, single = _inputs(xs)
    if v is None:
        v = (torch.ones_like(inputs) if single
             else tuple(torch.ones_like(x) for x in inputs))
    elif not single:
        v = tuple(v) if isinstance(v, (list, tuple)) else (v,)
    out, tangent = torch.autograd.functional.jvp(_tuple_out(func), inputs, v)
    return _port(out), _port(tangent)


def vjp(func, xs, v=None):
    """(outputs, vJ): reverse-mode vector-Jacobian product (v defaults to
    ones, and must match the output structure)."""
    inputs, single = _inputs(xs)
    f = _tuple_out(func)
    if v is None:
        with torch.no_grad():
            out = f(*(inputs,) if single else inputs)
        v = (torch.ones_like(out) if isinstance(out, torch.Tensor)
             else tuple(torch.ones_like(o) for o in out))
    else:
        cv = _as_list(v)
        with torch.no_grad():
            out = f(*(inputs,) if single else inputs)
        n_out = len(out) if isinstance(out, tuple) else 1
        if len(cv) != n_out:
            raise InvalidArgumentError(
                f"vjp: v has {len(cv)} cotangents but func returns "
                f"{n_out} output(s) — v must match the OUTPUT structure")
        v = cv[0] if n_out == 1 else tuple(cv)
    out, g = torch.autograd.functional.vjp(f, inputs, v)
    return _port(out), _port(g)
