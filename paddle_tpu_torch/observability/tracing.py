"""Per-request and per-step spans over ``profiler._hooks``.

Port of ``paddle_tpu/observability/tracing.py``. The scheduler stamps each
request's lifecycle (arrival, admit, first token, finish) at the segment
read that surfaced each event; ``emit_request_trace`` replays those host
stamps as spans (``request.queue_wait`` / ``request.prefill`` /
``request.decode`` / ``request.e2e``), so an outlier decomposes in the
same timeline as the segments; ``emit_journey_trace`` and
``emit_scaling_trace`` do the same for a journal's request journey and an
autoscaler's decisions. Nothing here reads a clock of its own or the
device, and with no collector registered nothing is emitted.
"""

from __future__ import annotations

from ..profiler import _hooks

__all__ = ["span", "step_span", "emit_request_trace",
           "emit_journey_trace", "emit_scaling_trace", "active"]

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


def emit_scaling_trace(records: list) -> None:
    """An elastic episode's scaling timeline as spans, from its
    ``scale_decision`` records (``journal.tail(kind="scale_decision")`` or
    an autoscaler's ``decision_log``), stamped with their ``t``:
    ``scaling.drain[r<idx>]``, each replica's scale_down to drain_complete
    window, and ``scaling.<action>→<action>[...]``, consecutive decisions
    as intervals (how long each fleet size held)."""
    if not _hooks.COLLECTORS or not records:
        return
    recs = sorted(records, key=lambda r: r["t"])
    drain_open: dict = {}
    for r in recs:
        if r["action"] == "scale_down":
            drain_open[r["replica"]] = r["t"]
        elif r["action"] == "drain_complete":
            t0 = drain_open.pop(r["replica"], None)
            if t0 is not None and r["t"] > t0:
                _hooks.emit(f"scaling.drain[r{r['replica']}]",
                            _ns(t0), _ns(r["t"]),
                            kind="serving.scaling")
    for a, b in zip(recs, recs[1:]):
        if b["t"] <= a["t"]:
            continue
        tag = f"r{a['replica']}" if a.get("replica") is not None else ""
        _hooks.emit(
            f"scaling.{a['action']}→{b['action']}[{tag}]",
            _ns(a["t"]), _ns(b["t"]), kind="serving.scaling")
