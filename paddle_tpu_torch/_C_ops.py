"""``paddle._C_ops``-style namespace (port of ``paddle_tpu/_C_ops.py``).

The op registry is the dispatch table, so this module projects it as
attributes, for code written against ``_C_ops.matmul(x, y, False, False)``:
``final_state_<op>`` is ``<op>``, and ``<op>_`` runs ``<op>`` and writes
the result into its first argument (the in-place form; on a tensor inside
an autograd graph it raises, as the reference's does).
"""

from __future__ import annotations

import sys as _sys
from types import ModuleType as _ModuleType

from .core.tensor import inplace_set as _inplace_set
from .ops.registry import OPS as _OPS


class _COpsModule(_ModuleType):
    def __getattr__(self, name):
        key = name
        if key.startswith("final_state_"):
            key = key[len("final_state_"):]
        inplace = key.endswith("_") and key[:-1] in _OPS
        if inplace:
            key = key[:-1]
        if key in _OPS:
            fn = _OPS[key].fn
            if inplace:
                def _inplace(x, *args, _fn=fn, **kw):
                    return _inplace_set(x, _fn(x, *args, **kw))

                return _inplace
            return fn
        raise AttributeError(f"_C_ops has no op {name!r}")

    def __dir__(self):
        return sorted(_OPS)


_sys.modules[__name__].__class__ = _COpsModule
