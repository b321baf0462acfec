"""Op schema registry.

Port of ``paddle_tpu/ops/registry.py`` (the counterpart of Paddle's YAML
op definitions): the single source from which ``_C_ops`` is projected and
introspection (signature, differentiability) is served. The op modules
register their public functions with ``@register_op``; ``all_ops()`` lists
the JAX package's names.
"""

from __future__ import annotations

import inspect
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

__all__ = ["OpDef", "register_op", "get_op", "all_ops", "OPS"]


@dataclass
class OpDef:
    name: str
    fn: Callable
    signature: inspect.Signature
    differentiable: bool = True
    tags: List[str] = field(default_factory=list)
    doc: str = ""


OPS: Dict[str, OpDef] = {}


def register_op(name: Optional[str] = None, differentiable: bool = True, tags: Optional[List[str]] = None):
    """Register a public op wrapper into the schema registry."""

    def deco(fn: Callable) -> Callable:
        op_name = name or fn.__name__
        OPS[op_name] = OpDef(
            name=op_name,
            fn=fn,
            signature=inspect.signature(fn),
            differentiable=differentiable,
            tags=tags or [],
            doc=(fn.__doc__ or "").strip().split("\n")[0],
        )
        return fn

    return deco


def get_op(name: str) -> OpDef:
    if name not in OPS:
        raise KeyError(f"Op {name!r} is not registered ({len(OPS)} ops known)")
    return OPS[name]


def all_ops() -> List[str]:
    return sorted(OPS)
