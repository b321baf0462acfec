"""Data types: Paddle's dtype names over ``torch.dtype``.

Port of ``paddle_tpu/core/dtype.py``. The names (``float32``, ``int64``,
``bool_``, ...) are the ``torch.dtype`` objects themselves, so a port
tensor's ``.dtype`` compares equal to ``paddle_tpu_torch.float32``.
``convert_dtype`` takes a name, a numpy dtype or a torch dtype. Unlike the
JAX package, which runs with 64-bit types off, the port keeps int64 and
float64 when they are asked for: ``convert_dtype("int64")`` is
``torch.int64``, where the reference gives int32.
"""

from __future__ import annotations

from typing import Any, Union

import numpy as np
import torch

__all__ = [
    "iinfo",
    "finfo",
    "dtype",
    "float16",
    "bfloat16",
    "float32",
    "float64",
    "int8",
    "uint8",
    "int16",
    "int32",
    "int64",
    "bool_",
    "complex64",
    "complex128",
    "convert_dtype",
    "is_floating_dtype",
    "is_integer_dtype",
]

float16 = torch.float16
bfloat16 = torch.bfloat16
float32 = torch.float32
float64 = torch.float64
int8 = torch.int8
uint8 = torch.uint8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
bool_ = torch.bool
complex64 = torch.complex64
complex128 = torch.complex128

dtype = torch.dtype  # ``paddle.dtype`` analog

_NAME_MAP = {
    "float16": float16,
    "fp16": float16,
    "half": float16,
    "bfloat16": bfloat16,
    "bf16": bfloat16,
    "float32": float32,
    "fp32": float32,
    "float": float32,
    "float64": float64,
    "fp64": float64,
    "double": float64,
    "int8": int8,
    "uint8": uint8,
    "int16": int16,
    "int32": int32,
    "int": int32,
    "int64": int64,
    "long": int64,
    "bool": bool_,
    "complex64": complex64,
    "complex128": complex128,
}

_FROM_NUMPY = {np.dtype(k): v for k, v in (
    ("float16", float16), ("float32", float32), ("float64", float64),
    ("int8", int8), ("uint8", uint8), ("int16", int16), ("int32", int32),
    ("int64", int64), ("bool", bool_), ("complex64", complex64),
    ("complex128", complex128))}


def convert_dtype(dt: Union[str, Any]) -> Any:
    """Normalize a dtype spec (name, numpy dtype or scalar type, torch
    dtype) to a ``torch.dtype``."""
    if dt is None:
        return None
    if isinstance(dt, torch.dtype):
        return dt
    if isinstance(dt, str):
        key = dt.lower()
        if key in _NAME_MAP:
            return _NAME_MAP[key]
        raise ValueError(f"Unknown dtype name {dt!r}")
    if dt is bool:
        return bool_
    if dt is int:
        return int64
    if dt is float:
        return float32
    try:
        npdt = np.dtype(dt)
    except TypeError:
        raise ValueError(f"Cannot convert {dt!r} to a dtype")
    if npdt.name == "bfloat16":
        return bfloat16
    if npdt not in _FROM_NUMPY:
        raise ValueError(f"Cannot convert {dt!r} to a dtype")
    return _FROM_NUMPY[npdt]


def is_floating_dtype(dt: Any) -> bool:
    return convert_dtype(dt).is_floating_point


def is_differentiable_dtype(dt: Any) -> bool:
    """Float or complex: dtypes whose tensors can carry gradients."""
    d = convert_dtype(dt)
    return d.is_floating_point or d.is_complex


def is_integer_dtype(dt: Any) -> bool:
    d = convert_dtype(dt)
    return not (d.is_floating_point or d.is_complex or d == torch.bool)


class iinfo:
    """Integer dtype info (reference: ``paddle.iinfo``)."""

    def __init__(self, dtype):
        info = torch.iinfo(convert_dtype(dtype))
        self.min = int(info.min)
        self.max = int(info.max)
        self.bits = int(info.bits)
        self.dtype = str(info.dtype)


class finfo:
    """Floating dtype info, bfloat16 included (reference:
    ``paddle.finfo``)."""

    def __init__(self, dtype):
        dt = convert_dtype(dtype)
        info = torch.finfo(dt)
        self.min = float(info.min)
        self.max = float(info.max)
        self.eps = float(info.eps)
        self.tiny = float(info.smallest_normal)
        self.smallest_normal = self.tiny
        # in the dtype itself, as numpy's finfo gives it
        self.resolution = float(torch.tensor(info.resolution, dtype=dt))
        self.bits = int(info.bits)
        self.dtype = str(dt).replace("torch.", "")
