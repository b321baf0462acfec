"""Typed global flag registry.

Port of ``paddle_tpu/flags.py`` (Paddle's gflags-style ``FLAGS_*``):
flags are declared with a type and a default, overridable at import time
from ``FLAGS_*`` environment variables, and read and set at run time with
``get_flags`` / ``set_flags``. The port keeps the JAX package's flag names,
so scripts that set them run unchanged; the kernel switches
(``use_pallas_kernels`` and the like) are read by nothing here: the port
has one hand-written kernel per path and no switch between them.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, List, Optional, Union

__all__ = ["define_flag", "get_flags", "set_flags", "flag_names"]


@dataclass
class _Flag:
    name: str
    default: Any
    type: type
    help: str
    value: Any
    on_change: Optional[Callable[[Any], None]] = None


_REGISTRY: Dict[str, _Flag] = {}
_LOCK = threading.Lock()


def _parse(type_: type, raw: str) -> Any:
    if type_ is bool:
        return raw.lower() in ("1", "true", "yes", "on")
    return type_(raw)


def define_flag(
    name: str,
    default: Any,
    help: str = "",
    type: Optional[type] = None,
    on_change: Optional[Callable[[Any], None]] = None,
) -> None:
    """Register a global flag. ``FLAGS_<name>`` env var overrides the default."""
    type_ = type or __builtins__["type"](default) if isinstance(__builtins__, dict) else (type or default.__class__)
    with _LOCK:
        env = os.environ.get("FLAGS_" + name)
        value = _parse(type_, env) if env is not None else default
        _REGISTRY[name] = _Flag(name, default, type_, help, value, on_change)
        if env is not None and on_change is not None:
            on_change(value)


def get_flags(flags: Union[str, Iterable[str], None] = None) -> Dict[str, Any]:
    """Return {flag_name: value}. ``flags=None`` returns all flags."""
    with _LOCK:
        if flags is None:
            names: List[str] = list(_REGISTRY)
        elif isinstance(flags, str):
            names = [flags]
        else:
            names = list(flags)
        out = {}
        for n in names:
            if n not in _REGISTRY:
                raise ValueError(f"Unknown flag {n!r}; known flags: {sorted(_REGISTRY)}")
            out[n] = _REGISTRY[n].value
        return out


def set_flags(flags: Dict[str, Any]) -> None:
    """Set flag values at runtime (``paddle.set_flags`` analog)."""
    with _LOCK:
        for n, v in flags.items():
            if n not in _REGISTRY:
                raise ValueError(f"Unknown flag {n!r}; known flags: {sorted(_REGISTRY)}")
            f = _REGISTRY[n]
            f.value = _parse(f.type, v) if isinstance(v, str) and f.type is not str else f.type(v)
    for n in flags:
        f = _REGISTRY[n]
        if f.on_change is not None:
            f.on_change(f.value)


def flag_names() -> List[str]:
    with _LOCK:
        return sorted(_REGISTRY)


# ---------------------------------------------------------------------------
# Core flags (the JAX package's names, defaults and help texts).
# ---------------------------------------------------------------------------
define_flag("check_nan_inf", False, "Scan every op output for NaN/Inf and raise with the op name.", bool)
define_flag("benchmark", False, "Block on every op for accurate per-op timing.", bool)
define_flag("cudnn_deterministic", False, "Deterministic kernel selection (deterministic algorithms).", bool)
define_flag("eager_delete_tensor_gb", 0.0, "Compat: GC threshold; the caching allocator manages memory so this is advisory.", float)
define_flag("allocator_strategy", "auto_growth", "Compat: allocator strategy name (the caching allocator owns allocation).", str)
define_flag("use_pallas_kernels", True, "Kept for scripts that set it; the port reads nothing of it.", bool)
define_flag("use_ragged_decode", True, "Kept for scripts that set it; the port reads nothing of it.", bool)
define_flag("use_tick_fusion", True, "Kept for scripts that set it; the port reads nothing of it.", bool)
define_flag("use_paged_attention", True, "Kept for scripts that set it; the port reads nothing of it.", bool)
define_flag("use_pallas_fused_update", True, "Kept for scripts that set it; the port reads nothing of it.", bool)
define_flag("use_quant_matmul", True, "Kept for scripts that set it; the port reads nothing of it.", bool)
define_flag("log_level", "WARNING", "Python logging level for paddle_tpu_torch.", str)
