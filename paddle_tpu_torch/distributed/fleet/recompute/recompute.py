"""Activation recomputation (gradient checkpointing).

Port of ``paddle_tpu/distributed/fleet/recompute/recompute.py``: the
forward runs without keeping its activations; the backward restores the
random generators' state of the forward (the CPU's and every card's the
port's ops draw from), replays the forward with autograd on detached
inputs and back-propagates through the replay, into the inputs and into
every parameter the function uses (the reference's reentrant form, a
``torch.autograd.Function`` here). ``recompute_sequential`` splits a
``Sequential`` into ``segments`` chunks, each recomputed as a unit.
"""

from __future__ import annotations

import torch

from ....framework import random as frandom

__all__ = ["recompute", "recompute_sequential"]


def _rng_states():
    states = {torch.device("cpu"): frandom.get_rng_state()}
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            d = torch.device("cuda", i)
            states[d] = frandom.generator(d).get_state()
    return states


def _set_rng_states(states):
    for d, st in states.items():
        frandom.generator(d).set_state(st)


class _Recompute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, function, preserve_rng, _anchor, *args):
        ctx.function = function
        ctx.preserve_rng = preserve_rng
        ctx.rng = _rng_states() if preserve_rng else None
        tensors = [a for a in args if isinstance(a, torch.Tensor)]
        ctx.save_for_backward(*tensors)
        ctx.args = [None if isinstance(a, torch.Tensor) else a for a in args]
        with torch.no_grad():
            out = function(*args)
        return out

    @staticmethod
    def backward(ctx, *grads):
        saved = iter(ctx.saved_tensors)
        args = [next(saved) if a is None else a for a in ctx.args]
        inputs = [a.detach().requires_grad_(a.requires_grad)
                  if isinstance(a, torch.Tensor) else a for a in args]
        outer = _rng_states() if ctx.preserve_rng else None
        if ctx.preserve_rng:
            _set_rng_states(ctx.rng)
        try:
            with torch.enable_grad():
                out = ctx.function(*inputs)
        finally:
            if ctx.preserve_rng:
                _set_rng_states(outer)
        outs = out if isinstance(out, tuple) else (out,)
        pairs = [(o, g) for o, g in zip(outs, grads)
                 if isinstance(o, torch.Tensor) and o.requires_grad
                 and g is not None]
        if pairs:
            torch.autograd.backward([o for o, _ in pairs],
                                    [g for _, g in pairs])
        return (None, None, None) + tuple(
            a.grad if isinstance(a, torch.Tensor) else None for a in inputs)


def recompute(function, *args, **kwargs):
    """``function(*args)`` whose activations are recomputed in backward
    (``preserve_rng_state`` True by default; ``use_reentrant`` is taken
    and ignored)."""
    preserve_rng = kwargs.pop("preserve_rng_state", True)
    kwargs.pop("use_reentrant", None)
    if kwargs:
        raise ValueError(f"unsupported kwargs to recompute: {sorted(kwargs)}")
    # the anchor requires grad, so the backward runs (and reaches the
    # parameters the function uses) also when no input requires grad
    anchor = torch.empty(0, requires_grad=torch.is_grad_enabled())
    return _Recompute.apply(function, preserve_rng, anchor, *args)


def recompute_sequential(ctx: dict, functions, *args, **kwargs):
    """``functions`` (a ``Sequential`` or a list of layers) in
    ``ctx["segments"]`` chunks, each recomputed as a unit."""
    segments = int(ctx.get("segments", 1)) if isinstance(ctx, dict) \
        else int(ctx)
    if isinstance(functions, torch.nn.Module):
        layers = list(functions.children()) or [functions]
    else:
        layers = list(functions)
    n = len(layers)
    per = max(n // max(segments, 1), 1)

    def run_chunk(chunk):
        def f(*xs):
            x = xs[0] if len(xs) == 1 else xs
            for layer in chunk:
                x = layer(x)
            return x
        return f

    x = args
    for i in range(0, n, per):
        x = recompute(run_chunk(layers[i:i + per]),
                      *(x if isinstance(x, tuple) else (x,)), **kwargs)
    return x
