"""Op dispatch: the per-op wrapper every registered op runs through.

Port of ``paddle_tpu/ops/dispatch.py``. The JAX package's ``run_op``
unwraps its tensors, records a ``jax.vjp`` node for autograd and rewraps
the outputs; the port's ops take and return torch tensors and torch's
autograd records the graph, so what ``run_op`` keeps is the rest of the
reference's per-op work:

* the AMP cast by op name (``amp.cast_inputs``: white-listed ops run in the
  low-precision type, black-listed ones in fp32, O2 casts every other op's
  fp32 inputs down);
* ``FLAGS_check_nan_inf``: each floating output is scanned, and an op whose
  output holds a NaN or an Inf raises ``FloatingPointError`` with the op's
  name; the scan reads the device only while the flag is on;
* a host span per op (``profiler._hooks``) while a collector is active.

Static-graph recording waits for the port of ``jit.to_static`` and
``static`` (ROADMAP Queue A item 8): ``enable_static`` raises until then,
so no op is ever recorded.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import torch

from .. import flags
from ..amp import cast_inputs
from ..profiler import _hooks as _phooks

__all__ = ["run_op"]

_NAN_FLAG = flags._REGISTRY["check_nan_inf"]


def _check_nan_inf(name: str, outs: Sequence[Any]) -> None:
    for i, a in enumerate(outs):
        if not isinstance(a, torch.Tensor) or not (
                a.is_floating_point() or a.is_complex()):
            continue
        if not bool(torch.isfinite(a).all()):
            raise FloatingPointError(
                f"Operator '{name}' output #{i} contains NaN/Inf "
                f"(shape {list(a.shape)}, dtype {a.dtype}). "
                "Set FLAGS_check_nan_inf=0 to disable this check.")


def _run(name: str, fn: Callable, tensors):
    out = fn(*cast_inputs(name, *tensors))
    if _NAN_FLAG.value:
        _check_nan_inf(name, out if isinstance(out, (tuple, list))
                       else (out,))
    return out


def run_op(name: str, fn: Callable, *tensors: torch.Tensor):
    """``fn(*tensors)`` after op ``name``'s AMP cast, with the NaN/Inf
    check and the profiler span."""
    if _phooks.COLLECTORS:
        t0 = _phooks.now_ns()
        try:
            return _run(name, fn, tensors)
        finally:
            _phooks.emit(name, t0, _phooks.now_ns())
    return _run(name, fn, tensors)
