"""SLO monitor: error-budget ledgers and multi-window burn-rate alerting
over the serving loop's host stamps.

Port of ``paddle_tpu/observability/slo.py``.

* An ``Objective`` declares, per priority class, latency targets (TTFT,
  end-to-end, and time between tokens) and a compliance ratio (0.99: 1 %
  of requests may miss); ``1 - compliance`` is the error budget.
* Every outcome the scheduler stamps on the host is classified against
  its class's objective: ``note_ttft`` at the first-token stamp,
  ``note_e2e`` at the finish stamp. Host floats only.
* The burn rate over a window is the observed violation rate over the
  allowed one. Windows count segments (``end_segment()`` closes one
  bucket a segment), so a synthetic outcome stream drives the rules
  deterministically.
* Alerts need the fast and the slow window both over a threshold:
  ``warn_burn`` raises ok to warning, ``page_burn`` to page. A level
  drops only after ``clear_after`` calm segments.

Each change emits an ``slo_alert`` flight event; the gauges
``slo.burn_rate[class<p>]`` and ``slo.budget_remaining[class<p>]`` update
every segment. Pass ``slo_monitor=`` to ``OnlineScheduler`` /
``SLOScheduler``, or ``install()`` the monitor so every engine segment
drives ``end_segment`` through ``serving.SEGMENT_HOOKS``.
"""

from __future__ import annotations

import collections
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from . import flight as _flight
from . import metrics as _metrics

__all__ = ["Objective", "SLOMonitor", "install", "uninstall"]

_LEVELS = ("ok", "warning", "page")
_LEVEL_RANK = {lvl: i for i, lvl in enumerate(_LEVELS)}


@dataclass(frozen=True)
class Objective:
    """Per-priority-class (or per-pool) service-level objective.

    ``compliance`` is the target fraction of outcomes meeting their
    latency bound; ``1 - compliance`` is the error budget. A ``None``
    target skips that dimension (a batch class often has no TTFT
    objective). ``tbt_target_s`` bounds the mean
    time-between-tokens of a finished request — the decode pool's
    owned objective in a disaggregated fleet, where TTFT belongs to
    the prefill pool."""
    ttft_target_s: Optional[float] = None
    e2e_target_s: Optional[float] = None
    tbt_target_s: Optional[float] = None
    compliance: float = 0.99

    def __post_init__(self):
        if not 0.0 < self.compliance < 1.0:
            raise ValueError(f"compliance must be in (0, 1), got "
                             f"{self.compliance}")
        if (self.ttft_target_s is None and self.e2e_target_s is None
                and self.tbt_target_s is None):
            raise ValueError("objective needs at least one latency target")


class _ClassState:
    """One priority class's ledger + window buckets + alert machine."""

    __slots__ = ("objective", "window", "cur_good", "cur_bad",
                 "outcomes", "violations", "level", "clear_streak",
                 "burn_fast", "burn_slow")

    def __init__(self, objective: Objective, slow_window: int):
        self.objective = objective
        # per-segment (good, bad) buckets, newest last; the slow window
        # bounds retention
        self.window = collections.deque(maxlen=int(slow_window))
        self.cur_good = 0
        self.cur_bad = 0
        self.outcomes = 0          # cumulative, whole serve
        self.violations = 0
        self.level = "ok"
        self.clear_streak = 0
        self.burn_fast = 0.0
        self.burn_slow = 0.0

    def budget_remaining(self) -> float:
        """Fraction of the serve-lifetime error budget left: 1.0 with
        no violations, 0.0 when violations have consumed exactly
        ``(1 - compliance) * outcomes``, negative when overspent."""
        if not self.outcomes:
            return 1.0
        allowed = (1.0 - self.objective.compliance) * self.outcomes
        return 1.0 - self.violations / allowed if allowed else 0.0

    def _burn(self, n_segments: int) -> float:
        """Burn rate over the newest ``n_segments`` buckets."""
        good = bad = 0
        for g, b in list(self.window)[-n_segments:]:
            good += g
            bad += b
        total = good + bad
        if not total:
            return 0.0
        rate = bad / total
        return rate / (1.0 - self.objective.compliance)


class SLOMonitor:
    """Error-budget ledgers + burn-rate alerting for priority classes.

    ``objectives``: {priority_class: Objective}. Outcomes for classes
    without a declared objective are ignored (no objective, no budget).
    ``fast_window``/``slow_window``: alert windows in SEGMENTS.
    ``warn_burn``/``page_burn``: burn-rate thresholds (1.0 = spending
    the budget exactly on schedule). ``clear_after``: consecutive
    calm segments required before an alert level drops (hysteresis).
    """

    # accept-drift defaults: a sustained fast-
    # EWMA drop of >= `drop` below the slow baseline over `sustain`
    # consecutive segments is a warning — the burn rules' two-signal shape
    # (fast reacts, sustained-streak suppresses blips) applied to the
    # speculative acceptance rate, the one serving signal that degrades
    # SILENTLY (tokens stay correct, throughput quietly halves).
    _ACCEPT_DRIFT_DEFAULTS = {"drop": 0.25, "sustain": 4,
                              "min_segments": 8, "fast_alpha": 0.5,
                              "slow_alpha": 0.05}

    def __init__(self, objectives: Dict[int, Objective],
                 fast_window: int = 4, slow_window: int = 16,
                 warn_burn: float = 2.0, page_burn: float = 8.0,
                 clear_after: int = 4,
                 accept_drift: Optional[dict] = None,
                 pool_objectives: Optional[Dict[str, Objective]] = None):
        if not objectives and not pool_objectives:
            raise ValueError("SLOMonitor needs at least one objective")
        if not 0 < fast_window <= slow_window:
            raise ValueError(f"need 0 < fast_window <= slow_window, got "
                             f"{fast_window}/{slow_window}")
        if not 0 < warn_burn <= page_burn:
            raise ValueError(f"need 0 < warn_burn <= page_burn, got "
                             f"{warn_burn}/{page_burn}")
        self.objectives = dict(objectives)
        self.fast_window = int(fast_window)
        self.slow_window = int(slow_window)
        self.warn_burn = float(warn_burn)
        self.page_burn = float(page_burn)
        self.clear_after = int(clear_after)
        self.accept_drift = (dict(self._ACCEPT_DRIFT_DEFAULTS,
                                  **accept_drift)
                             if accept_drift is not None else None)
        if self.accept_drift is not None:
            if not 0.0 < self.accept_drift["drop"] < 1.0:
                raise ValueError(f"accept_drift drop must be in (0, 1), "
                                 f"got {self.accept_drift['drop']}")
        # per-pool objectives — in a disaggregated
        # fleet TTFT is the prefill pool's objective and TBT the decode
        # pool's; each pool gets its own ledger/windows/alert machine,
        # fed by the pool-tagged note hooks below and evaluated by the
        # same multi-window burn rules as the priority classes
        self.pool_objectives = dict(pool_objectives or {})
        self.segment_no = 0
        self.alert_log: List[dict] = []
        self._classes = {p: _ClassState(o, slow_window)
                         for p, o in self.objectives.items()}
        self._pools = {n: _ClassState(o, slow_window)
                       for n, o in self.pool_objectives.items()}
        self._reset_drift()

    def _reset_drift(self) -> None:
        self._acc_fast: Optional[float] = None
        self._acc_base: Optional[float] = None
        self._acc_streak = 0
        self._acc_clear = 0
        self._acc_n = 0
        self.drift_level = "ok"
        self.drift_log: List[dict] = []

    # --- outcome intake (host floats from the scheduler's stamps) --------
    @staticmethod
    def _note(cs: Optional[_ClassState], value_s: float,
              target_s: Optional[float]) -> None:
        if cs is None or target_s is None:
            return
        ok = value_s <= target_s
        if ok:
            cs.cur_good += 1
        else:
            cs.cur_bad += 1
            cs.violations += 1
        cs.outcomes += 1

    def note_ttft(self, priority: int, ttft_s: float) -> None:
        """One first-token outcome (call at the first-token host stamp)."""
        cs = self._classes.get(priority)
        if cs is not None:
            self._note(cs, float(ttft_s), cs.objective.ttft_target_s)

    def note_e2e(self, priority: int, e2e_s: float) -> None:
        """One end-to-end outcome (call at the finish host stamp)."""
        cs = self._classes.get(priority)
        if cs is not None:
            self._note(cs, float(e2e_s), cs.objective.e2e_target_s)

    def note_pool_ttft(self, pool: Optional[str], ttft_s: float) -> None:
        """One first-token outcome attributed to ``pool`` (the
        disaggregated router feeds this at the stamp of ``note_ttft``
        — a first token can only land on a prefill replica, so the
        prefill pool owns the TTFT budget). No-op for untagged pools."""
        cs = self._pools.get(pool)
        if cs is not None:
            self._note(cs, float(ttft_s), cs.objective.ttft_target_s)

    def note_pool_tbt(self, pool: Optional[str], tbt_s: float) -> None:
        """One finished request's mean time-between-tokens attributed
        to ``pool`` ((finish - first_token) / (n_tokens - 1), host
        arithmetic on stamps already taken) — the decode pool's owned
        objective. No-op for untagged pools."""
        cs = self._pools.get(pool)
        if cs is not None:
            self._note(cs, float(tbt_s), cs.objective.tbt_target_s)

    def note_accept_rate(self, rate: float) -> None:
        """One segment's speculative acceptance rate (accepted/proposed
        — the schedulers feed it from the segment result's spec stats,
        host arithmetic on the already-fetched event log). Drift
        rule: a fast EWMA that stays >= ``drop``
        below the slow baseline for ``sustain`` consecutive segments
        raises a WARNING-level ``accept_drift`` alert (flight +
        journal); the hysteretic clear mirrors the burn-rate rules.
        No-op unless ``accept_drift=`` was configured."""
        cfg = self.accept_drift
        if cfg is None:
            return
        r = float(rate)
        fa, sa = cfg["fast_alpha"], cfg["slow_alpha"]
        self._acc_fast = (r if self._acc_fast is None
                          else fa * r + (1.0 - fa) * self._acc_fast)
        self._acc_base = (r if self._acc_base is None
                          else sa * r + (1.0 - sa) * self._acc_base)
        self._acc_n += 1
        _metrics.gauge("slo.accept_rate_ewma").set(self._acc_fast)
        _metrics.gauge("slo.accept_rate_baseline").set(self._acc_base)
        if self._acc_n < cfg["min_segments"]:
            return
        dropped = self._acc_fast < (1.0 - cfg["drop"]) * self._acc_base
        if dropped:
            self._acc_streak += 1
            self._acc_clear = 0
        else:
            self._acc_streak = 0
        if dropped and self._acc_streak >= cfg["sustain"] \
                and self.drift_level == "ok":
            self.drift_level = "warning"
            rec = {"segment": self.segment_no, "level": "warning",
                   "prev": "ok", "fast": round(self._acc_fast, 4),
                   "baseline": round(self._acc_base, 4),
                   "streak": self._acc_streak}
            self.drift_log.append(rec)
            _metrics.counter("slo.accept_drift_alerts").inc()
            _flight.record("accept_drift", **rec)
        elif not dropped and self.drift_level == "warning":
            self._acc_clear += 1
            if self._acc_clear >= self.clear_after:
                self.drift_level = "ok"
                rec = {"segment": self.segment_no, "level": "ok",
                       "prev": "warning",
                       "fast": round(self._acc_fast, 4),
                       "baseline": round(self._acc_base, 4)}
                self.drift_log.append(rec)
                _flight.record("accept_drift", **rec)
                self._acc_clear = 0

    # --- per-segment evaluation ------------------------------------------
    def _target_level(self, cs: _ClassState) -> str:
        if (cs.burn_fast >= self.page_burn
                and cs.burn_slow >= self.page_burn):
            return "page"
        if (cs.burn_fast >= self.warn_burn
                and cs.burn_slow >= self.warn_burn):
            return "warning"
        return "ok"

    def end_segment(self) -> None:
        """Close this segment's outcome bucket and run the alert rules.
        Call once per serving segment (the schedulers do; ``install()``
        routes every engine segment here for ambient attachment)."""
        self.segment_no += 1
        for p, cs in self._classes.items():
            self._eval_one(p, f"class{p}", cs)
        # pool ledgers advance on the same segment clock — the
        # disaggregated fleet's prefill-TTFT / decode-TBT budgets burn
        # and page under the identical multi-window rules
        for n, cs in self._pools.items():
            self._eval_one(f"pool:{n}", f"pool_{n}", cs)

    def _eval_one(self, key, label: str, cs: _ClassState) -> None:
        cs.window.append((cs.cur_good, cs.cur_bad))
        cs.cur_good = cs.cur_bad = 0
        cs.burn_fast = cs._burn(self.fast_window)
        cs.burn_slow = cs._burn(self.slow_window)
        target = self._target_level(cs)
        if _LEVEL_RANK[target] > _LEVEL_RANK[cs.level]:
            self._transition(key, cs, target)       # escalate immediately
            cs.clear_streak = 0
        elif _LEVEL_RANK[target] < _LEVEL_RANK[cs.level]:
            cs.clear_streak += 1                    # hysteretic clear
            if cs.clear_streak >= self.clear_after:
                self._transition(key, cs, target)
                cs.clear_streak = 0
        else:
            cs.clear_streak = 0
        _metrics.gauge(f"slo.burn_rate[{label}]").set(cs.burn_fast)
        _metrics.gauge(f"slo.budget_remaining[{label}]").set(
            cs.budget_remaining())

    def _transition(self, key, cs: _ClassState, level: str) -> None:
        prev, cs.level = cs.level, level
        rec = {"segment": self.segment_no, "cls": key,
               "level": level, "prev": prev,
               "burn_fast": round(cs.burn_fast, 3),
               "burn_slow": round(cs.burn_slow, 3),
               "budget_remaining": round(cs.budget_remaining(), 4)}
        self.alert_log.append(rec)
        if _LEVEL_RANK[level] > _LEVEL_RANK[prev]:
            _metrics.counter("slo.alerts").inc()
            _metrics.counter(f"slo.alerts[{level}]").inc()
        _flight.record("slo_alert", **rec)

    # --- introspection ----------------------------------------------------
    def state(self, priority: int) -> str:
        return self._classes[priority].level

    def budget_remaining(self, priority: int) -> float:
        return self._classes[priority].budget_remaining()

    def pool_state(self, pool: str) -> str:
        return self._pools[pool].level

    def pool_budget_remaining(self, pool: str) -> float:
        return self._pools[pool].budget_remaining()

    def worst_level(self) -> str:
        return max((cs.level for cs in list(self._classes.values())
                    + list(self._pools.values())),
                   key=lambda lvl: _LEVEL_RANK[lvl], default="ok")

    # with an autoscaler attached the monitor becomes a
    # DECIDER (its burn levels are scale-up inputs), so its config rides
    # the journal header and replay rebuilds it from this round trip.
    def describe(self) -> dict:
        """Rebuildable config snapshot for the journal header."""
        def _obj(o: Objective) -> dict:
            return {"ttft_target_s": o.ttft_target_s,
                    "e2e_target_s": o.e2e_target_s,
                    "tbt_target_s": o.tbt_target_s,
                    "compliance": o.compliance}
        return {"objectives": {str(p): _obj(o)
                               for p, o in self.objectives.items()},
                "pool_objectives": {n: _obj(o) for n, o
                                    in self.pool_objectives.items()},
                "fast_window": self.fast_window,
                "slow_window": self.slow_window,
                "warn_burn": self.warn_burn,
                "page_burn": self.page_burn,
                "clear_after": self.clear_after,
                "accept_drift": (dict(self.accept_drift)
                                 if self.accept_drift is not None
                                 else None)}

    @classmethod
    def from_description(cls, d: dict) -> "SLOMonitor":
        pools = {n: Objective(**v)
                 for n, v in (d.get("pool_objectives") or {}).items()}
        return cls({int(p): Objective(**v)
                    for p, v in (d.get("objectives") or {}).items()},
                   fast_window=d["fast_window"],
                   slow_window=d["slow_window"],
                   warn_burn=d["warn_burn"], page_burn=d["page_burn"],
                   clear_after=d["clear_after"],
                   accept_drift=d.get("accept_drift"),
                   pool_objectives=pools or None)

    def report(self) -> dict:
        """The ``/slo`` endpoint's payload: per-class budget/burn state
        plus the full alert timeline — all host data."""
        return {
            "segments": self.segment_no,
            "windows": {"fast": self.fast_window,
                        "slow": self.slow_window},
            "thresholds": {"warn_burn": self.warn_burn,
                           "page_burn": self.page_burn,
                           "clear_after": self.clear_after},
            "worst_level": self.worst_level(),
            "classes": {
                str(p): {
                    "state": cs.level,
                    "objective": {
                        "ttft_target_s": cs.objective.ttft_target_s,
                        "e2e_target_s": cs.objective.e2e_target_s,
                        "compliance": cs.objective.compliance},
                    "outcomes": cs.outcomes,
                    "violations": cs.violations,
                    "budget_remaining": round(cs.budget_remaining(), 4),
                    "burn_fast": round(cs.burn_fast, 3),
                    "burn_slow": round(cs.burn_slow, 3),
                } for p, cs in sorted(self._classes.items())},
            # the per-pool ledgers (empty for homogeneous fleets)
            "pools": {
                n: {
                    "state": cs.level,
                    "objective": {
                        "ttft_target_s": cs.objective.ttft_target_s,
                        "e2e_target_s": cs.objective.e2e_target_s,
                        "tbt_target_s": cs.objective.tbt_target_s,
                        "compliance": cs.objective.compliance},
                    "outcomes": cs.outcomes,
                    "violations": cs.violations,
                    "budget_remaining": round(cs.budget_remaining(), 4),
                    "burn_fast": round(cs.burn_fast, 3),
                    "burn_slow": round(cs.burn_slow, 3),
                } for n, cs in sorted(self._pools.items())},
            "alerts": list(self.alert_log),
            "accept_drift": (None if self.accept_drift is None else {
                "level": self.drift_level,
                "fast": self._acc_fast, "baseline": self._acc_base,
                "segments_seen": self._acc_n,
                "config": dict(self.accept_drift),
                "alerts": list(self.drift_log)}),
        }

    def reset(self) -> None:
        """Zero ledgers/windows/alert state (warm-run isolation)."""
        self.segment_no = 0
        self.alert_log = []
        self._classes = {p: _ClassState(o, self.slow_window)
                         for p, o in self.objectives.items()}
        self._pools = {n: _ClassState(o, self.slow_window)
                       for n, o in self.pool_objectives.items()}
        self._reset_drift()


# ---------------------------------------------------------------------------
# Ambient attachment: every ServingEngine segment's end drives the
# monitor, with no scheduler in the loop (host ints only).
# ---------------------------------------------------------------------------

_INSTALLED: List[tuple] = []


def install(monitor: SLOMonitor) -> None:
    """Attach ``monitor`` process-wide: every engine segment (any
    engine, any path) advances its windows via ``serving.SEGMENT_HOOKS``.
    Idempotent per monitor; pair with :func:`uninstall`."""
    from ..inference import serving as _serving

    for m, _ in _INSTALLED:
        if m is monitor:
            return

    def hook(steps: int, new_tokens: int, finished: int) -> None:
        monitor.end_segment()

    _serving.SEGMENT_HOOKS.append(hook)
    _INSTALLED.append((monitor, hook))


def uninstall(monitor: Optional[SLOMonitor] = None) -> None:
    """Detach ``monitor`` (or every installed monitor when ``None``)."""
    from ..inference import serving as _serving

    keep = []
    for m, hook in _INSTALLED:
        if monitor is None or m is monitor:
            if hook in _serving.SEGMENT_HOOKS:
                _serving.SEGMENT_HOOKS.remove(hook)
        else:
            keep.append((m, hook))
    _INSTALLED[:] = keep
