"""Flight recorder: a bounded ring of recent structured events.

Port of ``paddle_tpu/observability/flight.py``. The serving stack knows
every moment worth a postmortem (an admission, a backpressure deferral, a
prefix-cache eviction, a tier transfer) when the host handles it; the
recorder keeps the last N of them, one deque append each, and dumps them
on demand (``dump()``), on an exception (``dump_on_exception`` /
``install_excepthook``) or at exit (SIGTERM and ``atexit``). Events carry
host data only. ``LISTENERS`` observe every append: the journal
subscribes there, so it holds every flight event.
"""

from __future__ import annotations

import atexit
import collections
import contextlib
import json
import signal
import sys
import threading
import time
from typing import List, Optional

__all__ = ["FlightRecorder", "FLIGHT", "LISTENERS", "record", "events",
           "dump", "dump_on_exception", "install_excepthook",
           "set_capacity", "clear"]

# ``fn(kind, data)`` after every ring append
LISTENERS: List = []


class FlightRecorder:
    """Bounded ring buffer of (seq, wall_time_s, kind, data) events."""

    def __init__(self, capacity: int = 2048):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self._buf = collections.deque(maxlen=int(capacity))
        self._seq = 0
        self.dropped_events = 0        # evicted by the ring's wrap
        self._lock = threading.Lock()  # resize only

    @property
    def capacity(self) -> int:
        return self._buf.maxlen

    def set_capacity(self, capacity: int) -> None:
        """Resize, keeping the newest events."""
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        with self._lock:
            self._buf = collections.deque(self._buf, maxlen=int(capacity))

    def record(self, kind: str, **data) -> None:
        from .metrics import _STATE, counter

        if not _STATE.enabled:
            return
        if len(self._buf) == self._buf.maxlen:
            # a wrap evicts silently otherwise: count it, so a quiet run
            # and a ring too small for the storm read differently
            self.dropped_events += 1
            counter("flight.dropped_events",
                    "flight-ring events evicted by wrap").inc()
        self._seq += 1
        self._buf.append((self._seq, time.time(), kind, data))
        if LISTENERS:
            for fn in LISTENERS:
                fn(kind, data)

    def events(self, kind: Optional[str] = None,
               rid: Optional[int] = None) -> List[dict]:
        """Oldest-first view of the ring, optionally filtered by ``kind``
        and the event's ``rid``. ``seq`` is monotonic: a gap means the
        ring evicted."""
        return [{"seq": s, "t": t, "kind": k, **d}
                for s, t, k, d in list(self._buf)
                if (kind is None or k == kind)
                and (rid is None or d.get("rid") == rid)]

    def __len__(self) -> int:
        return len(self._buf)

    def clear(self) -> None:
        self._buf.clear()

    def dump(self, path: Optional[str] = None, reason: str = "on_demand"
             ) -> List[dict]:
        """The event list; with ``path`` also written as JSON
        ({"reason", "dumped_at", "capacity", "events"})."""
        evs = self.events()
        if path is not None:
            with open(path, "w") as f:
                json.dump({"reason": reason, "dumped_at": time.time(),
                           "capacity": self.capacity, "events": evs},
                          f, indent=1, default=str)
        return evs


FLIGHT = FlightRecorder()


def record(kind: str, **data) -> None:
    FLIGHT.record(kind, **data)


def events(kind: Optional[str] = None,
           rid: Optional[int] = None) -> List[dict]:
    return FLIGHT.events(kind, rid=rid)


def dump(path: Optional[str] = None, reason: str = "on_demand"):
    return FLIGHT.dump(path, reason=reason)


def set_capacity(capacity: int) -> None:
    FLIGHT.set_capacity(capacity)


def clear() -> None:
    FLIGHT.clear()


@contextlib.contextmanager
def dump_on_exception(path: str):
    """An exception escaping the block dumps the ring to ``path`` (tagged
    with the exception) and propagates."""
    try:
        yield FLIGHT
    except BaseException as e:
        FLIGHT.record("exception", type=type(e).__name__, message=str(e))
        FLIGHT.dump(path, reason=f"exception: {type(e).__name__}")
        raise


_HOOK_INSTALLED = [False]
_EXIT_HOOKS_INSTALLED = [False]
_EXIT_DUMPED = [False]


def _exit_dump(path: str, reason: str) -> None:
    """Write the ring once per process, whichever exit path fires first
    (a SIGTERM handler and ``atexit`` can both run on one kill)."""
    if _EXIT_DUMPED[0]:
        return
    _EXIT_DUMPED[0] = True
    try:
        FLIGHT.record("process_exit", reason=reason)
        FLIGHT.dump(path, reason=reason)
    except Exception:
        pass   # a failing postmortem must not mask the exit itself


def _install_exit_hooks(path: str) -> None:
    """Postmortems for orderly exits: ``atexit`` dumps the ring at any
    interpreter exit; a SIGTERM handler dumps it and then delegates to
    the previous handler, or re-raises the default action. The handler
    is installed from the main thread only (the signal module's rule)."""
    if _EXIT_HOOKS_INSTALLED[0]:
        return
    atexit.register(_exit_dump, path, "atexit")
    try:
        prev = signal.getsignal(signal.SIGTERM)

        def on_sigterm(signum, frame):
            _exit_dump(path, "sigterm")
            if callable(prev) and prev not in (signal.SIG_IGN,
                                               signal.SIG_DFL):
                prev(signum, frame)
            elif prev == signal.SIG_DFL:
                signal.signal(signal.SIGTERM, signal.SIG_DFL)
                signal.raise_signal(signal.SIGTERM)

        signal.signal(signal.SIGTERM, on_sigterm)
    except ValueError:
        pass   # not the main thread: atexit only
    _EXIT_HOOKS_INSTALLED[0] = True


def install_excepthook(path: str, exit_dump: bool = True) -> None:
    """Chain onto ``sys.excepthook`` so an uncaught exception dumps the
    ring to ``path`` first; with ``exit_dump`` also register the atexit
    and SIGTERM dumps."""
    if exit_dump:
        _install_exit_hooks(path)
    if _HOOK_INSTALLED[0]:
        return
    prev = sys.excepthook

    def hook(etype, value, tb):
        try:
            FLIGHT.record("exception", type=etype.__name__,
                          message=str(value))
            FLIGHT.dump(path, reason=f"uncaught: {etype.__name__}")
            _EXIT_DUMPED[0] = True   # the crash dump is the postmortem
        finally:
            prev(etype, value, tb)

    sys.excepthook = hook
    _HOOK_INSTALLED[0] = True
