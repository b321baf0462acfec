"""``summary`` and ``flops``: model introspection (counterpart of
``paddle_tpu/hapi/model_summary.py``).

Both run one forward of a zero input (in eval mode, without gradients) on
the current device, with a forward hook on every sublayer: ``summary``
prints each sublayer's output shape and parameter count, ``flops`` counts
``Conv2D`` and ``Linear`` multiply-accumulates times 2 (NCHW outputs), or a
user rule per layer type.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..device import get_device, resolve_device

__all__ = ["summary", "flops"]


def _zeros(size, dtype="float32") -> torch.Tensor:
    shape = [d if d and d > 0 else 1 for d in size]
    return torch.from_numpy(np.zeros(shape, dtype)).to(
        resolve_device(get_device()))


def _run_hooked(net, hooks, args):
    """``net(*args)`` in eval mode without gradients, ``hooks`` (a list
    of (layer, hook)) registered for the call only."""
    handles = [layer.register_forward_hook(h) for layer, h in hooks]
    was_training = net.training
    net.eval()
    try:
        with torch.no_grad():
            net(*args)
    finally:
        net.train(was_training)
        for h in handles:
            h.remove()


def _sublayers(net):
    return [m for name, m in net.named_modules() if name]


def summary(net, input_size=None, dtypes=None, input=None):
    """Print a per-layer table; returns ``{"total_params",
    "trainable_params"}``."""
    rows: List[Dict] = []

    def hook(layer, inputs, outputs):
        out = outputs[0] if isinstance(outputs, (list, tuple)) else outputs
        rows.append({"name": f"{type(layer).__name__}-{len(rows) + 1}",
                     "shape": list(getattr(out, "shape", [])),
                     "params": sum(p.numel() for p in
                                   layer.parameters(include_sublayers=False))})

    if input is not None:
        args = input if isinstance(input, (list, tuple)) else [input]
    else:
        sizes = input_size if isinstance(input_size, list) else [input_size]
        dts = dtypes or ["float32"] * len(sizes)
        args = [_zeros(size, dt) for size, dt in zip(sizes, dts)]
    _run_hooked(net, [(m, hook) for m in _sublayers(net)], args)

    params = net.parameters()
    total = sum(p.numel() for p in params)
    trainable = sum(p.numel() for p in params if p.requires_grad)
    name_w = max([len(r["name"]) for r in rows] + [10]) + 2
    line = "-" * (name_w + 40)
    print(line)
    print(f"{'Layer (type)':<{name_w}}{'Output Shape':<24}{'Param #':>12}")
    print(line)
    for r in rows:
        print(f"{r['name']:<{name_w}}{str(r['shape']):<24}"
              f"{r['params']:>12,}")
    print(line)
    print(f"Total params: {total:,}")
    print(f"Trainable params: {trainable:,}")
    print(f"Non-trainable params: {total - trainable:,}")
    print(line)
    return {"total_params": total, "trainable_params": trainable}


def flops(net, input_size, custom_ops=None, print_detail=False) -> int:
    """Forward FLOPs of ``net`` on a zero input of ``input_size``:
    multiply-accumulates of every ``Conv2D`` and ``Linear`` times 2, or
    ``custom_ops[type](layer, inputs, outputs)`` for a layer type it
    names."""
    from ..nn.layer.common import Linear
    from ..nn.layer.conv import Conv2D

    total = [0]

    def conv_hook(layer, inputs, outputs):
        out = outputs[0] if isinstance(outputs, (list, tuple)) else outputs
        oc, ic, kh, kw = layer.weight.shape
        oh, ow = out.shape[-2], out.shape[-1]
        total[0] += 2 * oh * ow * oc * ic * kh * kw * out.shape[0]

    def linear_hook(layer, inputs, outputs):
        out = outputs[0] if isinstance(outputs, (list, tuple)) else outputs
        batch = int(np.prod(out.shape[:-1]))
        total[0] += 2 * batch * layer.weight.shape[0] * layer.weight.shape[1]

    def custom(fn):
        def hook(layer, inputs, outputs):
            total[0] += fn(layer, inputs, outputs)
        return hook

    hooks = []
    for sub in _sublayers(net):
        if custom_ops and type(sub) in custom_ops:  # user rules win
            hooks.append((sub, custom(custom_ops[type(sub)])))
        elif isinstance(sub, Conv2D):
            hooks.append((sub, conv_hook))
        elif isinstance(sub, Linear):
            hooks.append((sub, linear_hook))
    _run_hooked(net, hooks, [_zeros(input_size)])
    if print_detail:
        print(f"Total FLOPs: {total[0]:,}")
    return int(total[0])
