"""Automatic mixed precision: ``auto_cast`` with the JAX package's op
lists, O2 ``decorate`` and ``GradScaler``.

Counterpart of ``paddle_tpu/amp/__init__.py``, with its own copy of the op
lists. The cast rule of ``paddle_tpu/ops/dispatch.py`` (``run_op``) lives
here as ``cast_inputs``, which the port's functional ops call with their
op names: under O1 a white-listed op runs in the low-precision type; under
O2 every op outside the black and mixed-I/O lists casts its fp32 inputs
down; a black-listed op (``cross_entropy``, the norms, reductions) casts
low-precision inputs up to fp32. A mixed-I/O op (``batch_norm``) is left
alone: it computes in fp32 and returns the input's type itself.
``torch.autocast`` has other lists and semantics, so it is not used.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional, Set

import torch

from ..device import get_device, resolve_device

__all__ = ["auto_cast", "autocast", "decorate", "GradScaler", "amp_state",
           "cast_inputs", "WHITE_LIST", "MIXED_IO_LIST", "BLACK_LIST"]

# ops on the tensor cores: always worth low precision (the JAX package's
# white list)
WHITE_LIST: Set[str] = {
    "matmul", "mm", "bmm", "linear", "conv1d", "conv2d", "conv3d",
    "conv1d_transpose", "conv2d_transpose", "conv3d_transpose", "einsum",
    "addmm", "scaled_dot_product_attention", "embedding",
}
# ops that manage their precision inside: low-precision activations, fp32
# parameters and statistics
MIXED_IO_LIST: Set[str] = {"batch_norm"}
# numerically sensitive ops kept in fp32
BLACK_LIST: Set[str] = {
    "exp", "log", "log2", "log10", "log1p", "logsumexp", "softmax",
    "log_softmax", "cross_entropy", "bce", "bce_logits", "nll_loss", "kl_div",
    "layer_norm", "rms_norm", "group_norm", "instance_norm",
    "sum", "mean", "norm", "cumsum", "softmax_with_cross_entropy",
}

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float32": torch.float32}
_LOW = (torch.bfloat16, torch.float16)


def _dtype(dtype) -> torch.dtype:
    return dtype if isinstance(dtype, torch.dtype) else _DTYPES[str(dtype)]


class _AmpState(threading.local):
    def __init__(self):
        self.enabled = False
        self.dtype = torch.bfloat16
        self.level = "O1"
        self.white = WHITE_LIST
        self.black = BLACK_LIST


amp_state = _AmpState()


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16", use_promote=True):
    """O1: white-listed ops run in low precision; O2: every op but the
    black and mixed-I/O lists."""
    prev = (amp_state.enabled, amp_state.dtype, amp_state.level,
            amp_state.white, amp_state.black)
    amp_state.enabled = bool(enable)
    amp_state.dtype = _dtype(dtype)
    amp_state.level = level
    white, black = set(WHITE_LIST), set(BLACK_LIST)
    if custom_white_list:
        white |= set(custom_white_list)
        black -= set(custom_white_list)
    if custom_black_list:
        black |= set(custom_black_list)
        white -= set(custom_black_list)
    amp_state.white, amp_state.black = white, black
    try:
        yield
    finally:
        (amp_state.enabled, amp_state.dtype, amp_state.level,
         amp_state.white, amp_state.black) = prev


autocast = auto_cast


def cast_inputs(name: str, *tensors: Optional[torch.Tensor]):
    """The inputs of op ``name`` as the active ``auto_cast`` casts them
    (a tuple, None entries kept). The casts are autograd operations, so a
    gradient comes back in its input's type."""
    if not amp_state.enabled or name in MIXED_IO_LIST:
        return tensors
    if name in amp_state.black:
        src, dst = _LOW, torch.float32
    elif name in amp_state.white or amp_state.level == "O2":
        src, dst = (torch.float32,), amp_state.dtype
    else:
        return tensors
    return tuple(t.to(dst) if t is not None and t.dtype in src else t
                 for t in tensors)


def decorate(models, optimizers=None, level="O2", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """O2: cast every floating parameter of ``models`` to ``dtype``; an
    Adam-family optimizer (one with ``_multi_precision``) switches to fp32
    moments with an fp32 master, and state it already holds is upgraded.
    Momentum has no master: its velocity follows the (now low-precision)
    params."""
    dt = _dtype(dtype)
    single_model = not isinstance(models, (list, tuple))
    model_list = [models] if single_model else list(models)
    if level == "O2":
        with torch.no_grad():
            for m in model_list:
                for p in m.parameters():
                    if p.is_floating_point():
                        p.data = p.data.to(dt)
    if optimizers is None:
        return models if single_model else model_list
    single_opt = not isinstance(optimizers, (list, tuple))
    opt_list = [optimizers] if single_opt else list(optimizers)
    for o in opt_list:
        if hasattr(o, "_multi_precision") and not o._multi_precision:
            o._multi_precision = True
            by_id = {id(p): p for p in (o._parameter_list or [])}
            for pid, st in o._accumulators.items():
                p = by_id.get(pid)
                if p is None:
                    continue
                for k, v in list(st.items()):
                    st[k] = v.float()
                st.setdefault("master", p.detach().float())
    return (models if single_model else model_list,
            optimizers if single_opt else opt_list)


class GradScaler:
    """Dynamic loss scaling: ``scale`` the loss, ``step`` unscales the
    grads with one device-to-host read of the found-inf flag and skips the
    optimizer's step on an overflow, ``update`` moves the scale."""

    def __init__(self, enable=True, init_loss_scaling=65536.0,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=2000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling) if enable else 1.0
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        self._unscaled = False

    def scale(self, var: torch.Tensor) -> torch.Tensor:
        return var * self._scale if self._enable else var

    def unscale_(self, optimizer):
        """Unscale every grad in place and set ``found_inf`` with one
        device-to-host read for the whole list."""
        if not self._enable or self._unscaled:
            return
        self._unscaled = True
        inv = 1.0 / self._scale
        found = None
        for p in optimizer._params():
            if p.grad is not None:
                p.grad.mul_(inv)
                bad = ~torch.isfinite(p.grad).all()
                found = bad if found is None else found | bad
        self._found_inf = False if found is None else bool(found.item())

    def step(self, optimizer):
        """Unscale, then step unless a grad overflowed (the scale's
        dynamics belong to ``update``)."""
        if not self._enable:
            optimizer.step()
            return
        self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()

    def minimize(self, optimizer, scaled_loss):
        """Backward from ``scaled_loss``, ``step`` and ``update``."""
        scaled_loss.backward()
        self.step(optimizer)
        self.update()

    def update(self):
        self._unscaled = False
        if not (self._enable and self._dynamic):
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every:
                self._scale *= self._incr_ratio
                self._good_steps = 0
        self._found_inf = False

    def is_enable(self) -> bool:
        return self._enable

    def get_loss_scaling(self) -> torch.Tensor:
        """The loss scale as a tensor on the current device."""
        return torch.tensor(self._scale, dtype=torch.float32,
                            device=resolve_device(get_device()))

    def state_dict(self):
        return {"scale": self._scale, "good_steps": self._good_steps,
                "bad_steps": self._bad_steps}

    def load_state_dict(self, state):
        self._scale = state.get("scale", self._scale)
        self._good_steps = state.get("good_steps", 0)
        self._bad_steps = state.get("bad_steps", 0)


from . import debugging  # noqa: E402,F401
