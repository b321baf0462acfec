"""Host-span collection: the channel the serving scheduler emits its
``serving.segment`` spans and request phases through.

Port of ``paddle_tpu/profiler/_hooks.py``. A collector is any object with
``_host_event(name, start_ns, end_ns, kind)``; while none is registered in
``COLLECTORS`` an ``emit`` walks an empty list, so the spans cost two
clock reads.
"""

from __future__ import annotations

import contextlib
import time
from typing import List

__all__ = ["COLLECTORS", "active", "now_ns", "emit", "span"]

# registered collectors (a stack: nested collectors each get every span)
COLLECTORS: List[object] = []


def active() -> bool:
    return bool(COLLECTORS)


def now_ns() -> int:
    return time.perf_counter_ns()


def emit(name: str, start_ns: int, end_ns: int, kind: str = "op") -> None:
    for c in COLLECTORS:
        c._host_event(name, start_ns, end_ns, kind)


@contextlib.contextmanager
def span(name: str, kind: str = "op"):
    """A timed host span around the block, emitted when it ends."""
    t0 = now_ns()
    try:
        yield
    finally:
        if COLLECTORS:
            emit(name, t0, now_ns(), kind)
