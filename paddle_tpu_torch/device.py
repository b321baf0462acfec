"""Device resolution for the port's entry points.

Entry points (``init_params``, ``generate``, ``ServingEngine``, layer and
model construction) run on the card unless the caller names another
device, with a ``device=`` argument or, for layers, with ``set_device``
(the counterpart of ``paddle.set_device``). There is no silent CPU
fallback: asking for CUDA where there is none raises.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device", "set_device", "get_device"]

_current = ["cuda"]  # the device layers build their parameters on


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and no
    CUDA device is present."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' explicitly to run "
                "the plain PyTorch path on the CPU")
        if dev.index is None:  # tensors report their device with an index
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def set_device(device) -> str:
    """Set the device new layers build their parameters and buffers on
    (default ``"cuda"``); returns the previous one, so a caller can
    restore it."""
    torch.device(device)  # validates the name
    prev, _current[0] = _current[0], str(device)
    return prev


def get_device() -> str:
    """The device new layers build on, as ``set_device`` left it."""
    return _current[0]
