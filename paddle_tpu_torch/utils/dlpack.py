"""``paddle.utils.dlpack``: zero-copy tensor exchange by the DLPack
protocol (port of ``paddle_tpu/utils/dlpack.py``). ``torch.utils.dlpack``
carries the exchange; this module adds the port's ``Tensor`` and the
reference's calling convention: ``from_dlpack`` takes a capsule from
``to_dlpack`` or a producer with ``__dlpack__`` (a numpy array, a torch
tensor) and returns a ``Tensor`` that shares the producer's memory."""

from __future__ import annotations

import torch
import torch.utils.dlpack

from ..core.tensor import as_port_tensor

__all__ = ["to_dlpack", "from_dlpack"]


def to_dlpack(x):
    """A port ``Tensor`` or any tensor (or array) -> a DLPack capsule,
    consumable once (the DLPack contract)."""
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(x)
    return torch.utils.dlpack.to_dlpack(t.detach())


def from_dlpack(ext):
    """A DLPack capsule or a ``__dlpack__`` producer -> a ``Tensor`` on the
    producer's memory (no copy)."""
    return as_port_tensor(torch.utils.dlpack.from_dlpack(ext))
