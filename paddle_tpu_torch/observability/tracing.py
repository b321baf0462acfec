"""Per-request and per-step spans over ``profiler._hooks``.

Port of ``paddle_tpu/observability/tracing.py``. The scheduler stamps each
request's lifecycle (arrival, admit, first token, finish) at the segment
read that surfaced each event; ``emit_request_trace`` replays those host
stamps as spans (``request.queue_wait`` / ``request.prefill`` /
``request.decode`` / ``request.e2e``), so an outlier decomposes in the
same timeline as the segments. Nothing here reads a clock of its own or
the device, and with no collector registered nothing is emitted.
"""

from __future__ import annotations

from ..profiler import _hooks

__all__ = ["span", "step_span", "emit_request_trace",
           "emit_journey_trace", "active"]

span = _hooks.span          # the timed host span
active = _hooks.active


def step_span(name: str = "train.step"):
    """Timed span around one training step (kind ``train``)."""
    return _hooks.span(name, kind="train")


def _ns(t_s: float) -> int:
    return int(t_s * 1e9)


def emit_request_trace(rid: int, arrival_s: float, admit_s: float,
                       first_token_s: float, finish_s: float,
                       prefix_hit_len: int = 0) -> None:
    """One finished request's lifecycle as host spans, from its
    ``perf_counter`` stamps (zero-length phases are skipped). The rid and
    the prefix reuse ride in the span name."""
    if not _hooks.COLLECTORS:
        return
    tag = f"req{rid}" + (f"+prefix{prefix_hit_len}" if prefix_hit_len
                         else "")
    kind = "serving.request"
    if admit_s > arrival_s > 0:
        _hooks.emit(f"request.queue_wait[{tag}]", _ns(arrival_s),
                    _ns(admit_s), kind=kind)
    if first_token_s > admit_s > 0:
        _hooks.emit(f"request.prefill[{tag}]", _ns(admit_s),
                    _ns(first_token_s), kind=kind)
    if finish_s > first_token_s > 0:
        _hooks.emit(f"request.decode[{tag}]", _ns(first_token_s),
                    _ns(finish_s), kind=kind)
    if finish_s > arrival_s > 0:
        _hooks.emit(f"request.e2e[{tag}]", _ns(arrival_s), _ns(finish_s),
                    kind=kind)


def emit_journey_trace(journey: dict) -> None:
    """A journal request journey (``journal.request_journey``) as spans,
    one a causal hop (``journey.<kind>[req<rid>@r<rank>]``), stamped with
    the records' write times."""
    if not _hooks.COLLECTORS:
        return
    evs = journey.get("events") or []
    rid = journey.get("rid")
    for a, b in zip(evs, evs[1:]):
        if b["t"] <= a["t"]:
            continue
        _hooks.emit(f"journey.{b['kind']}[req{rid}@r{b['rank']}]",
                    _ns(a["t"]), _ns(b["t"]), kind="serving.journey")
