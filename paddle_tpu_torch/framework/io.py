"""``save`` / ``load``: the JAX package's checkpoint container.

Counterpart of ``paddle_tpu/framework/io.py``, writing the same format: a
pickle of ``{"magic": "paddle_tpu.save.v1", "obj": ...}`` whose tensors
are ``{"__tensor__": True, "data": <numpy array>, "stop_gradient": ...,
"name": ...}``. A checkpoint written by either package loads in the other.
bf16 tensors cross as ``ml_dtypes.bfloat16`` arrays, the JAX package's
numpy type for them. ``load`` places tensors on the current device
(``device.get_device()``), or returns numpy with ``return_numpy``.
"""

from __future__ import annotations

import os
import pickle
from typing import Any

import numpy as np
import torch

from ..device import get_device, resolve_device

__all__ = ["save", "load"]

_MAGIC = "paddle_tpu.save.v1"


def _bf16():
    try:
        import ml_dtypes
    except ImportError as e:
        raise TypeError("a bfloat16 tensor crosses as an ml_dtypes.bfloat16 "
                        "array, and ml_dtypes is not installed") from e
    return ml_dtypes.bfloat16


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_bf16())
    return t.numpy()


def _from_numpy(a: np.ndarray, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a).copy())
    return t.to(device)


def _to_storable(obj: Any) -> Any:
    if isinstance(obj, torch.Tensor):
        return {"__tensor__": True, "data": _to_numpy(obj),
                "stop_gradient": not obj.requires_grad,
                "name": getattr(obj, "name", None)}
    if isinstance(obj, dict):
        return {k: _to_storable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_storable(v) for v in obj)
    return obj


def _from_storable(obj: Any, device, return_numpy: bool) -> Any:
    if isinstance(obj, dict):
        if obj.get("__tensor__"):
            return (obj["data"] if return_numpy
                    else _from_numpy(obj["data"], device))
        return {k: _from_storable(v, device, return_numpy)
                for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_from_storable(v, device, return_numpy)
                         for v in obj)
    return obj


def save(obj: Any, path: str, protocol: int = 4) -> None:
    """Save a (possibly nested) object holding tensors to ``path``."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    payload = {"magic": _MAGIC, "obj": _to_storable(obj)}
    with open(path, "wb") as f:
        pickle.dump(payload, f, protocol=protocol)


def load(path: str, return_numpy: bool = False) -> Any:
    """Load what ``save`` (of either package) wrote: tensors on the
    current device, or numpy arrays with ``return_numpy``. A pickle
    without the container's magic is returned as it is. Unpickling runs
    code the file names: load only checkpoints this program wrote."""
    with open(path, "rb") as f:
        payload = pickle.load(f)
    if not (isinstance(payload, dict) and payload.get("magic") == _MAGIC):
        return payload
    device = None if return_numpy else resolve_device(get_device())
    return _from_storable(payload["obj"], device, return_numpy)
