"""Elastic fleet autoscaling as an observable control loop.

Port of ``paddle_tpu/inference/autoscaler.py``. One policy scales a
``FleetRouter``'s replicas (or one pool of a ``DisaggRouter``) between
``min_replicas`` and ``max_replicas``:

* **Scale-up signals**: queue pressure (the summed intake depth of the
  replicas taking traffic), the ``SLOMonitor``'s worst burn level and the
  ``CapacityMonitor``'s level; any firing signal asks for one replica more.
* **Chip fit before warmup**: with ``hbm_bytes`` set, a candidate must fit
  first (``analysis.memory.chip_fit``: weights + its provisioned pool + a
  peak transient against the budget); a refusal is a journaled decision
  with the verdict attached, and the candidate is never tried again.
* **Warmup before traffic**: the candidate's program space runs
  (``ServingEngine.aot_warmup``, under its pool's envelope on a
  ``DisaggRouter``) before it joins the dispatch candidates, so a scale-up
  never meets a key it has not run.
* **Polite drain on scale-down**: the victim stops admitting, its queued
  requests requeue onto the survivors (``failover_requeue`` records), its
  live slots finish in place (no request is stranded) and its cached
  prefixes move to the survivors' host tiers (``export_host`` ->
  ``import_host``, hottest first with a cache directory).
* **Every decision is journaled**: a ``scale_decision`` record carries the
  whole input vector (burn rate, capacity level, queue depths, per-replica
  pages free, health and lifecycle), the chip-fit verdict and the warmup's
  key count, the action and a reason. Every clock read goes through
  ``journal.now()``, so an episode replays bit-exactly
  (``observability.replay``; the journal header carries this policy's
  config and its monitors').

Lifecycle, per replica, beside its health::

    offline --scale_up (chip fit)--> warming --aot_warmup--> serving
    serving --scale_down--> draining --(no live slot, no queue)--> offline

``install`` / ``uninstall`` attach an unbound policy to
``serving.SEGMENT_HOOKS``, where it only counts segments.
"""

from __future__ import annotations

from typing import List, Optional

from ..observability import journal as _journal
from ..observability import metrics as _metrics

__all__ = ["Autoscaler", "install", "uninstall"]

_LEVELS_FIRING = ("warning", "page")


class Autoscaler:
    """One scaling policy over a ``FleetRouter``'s replicas (``pool=None``)
    or one pool of a ``DisaggRouter`` (``pool="prefill"`` / ``"decode"``:
    one policy per pool, each seeing only its pool).

    ``initial_replicas`` of the managed replicas start ``serving``, the
    rest ``offline`` as warm standbys (built, weights resident: a scale-up
    pays the warmup, not a build). ``hbm_bytes`` turns the chip fit on;
    None leaves it off."""

    def __init__(self, *, min_replicas: int = 1,
                 max_replicas: Optional[int] = None,
                 initial_replicas: Optional[int] = None,
                 pool: Optional[str] = None,
                 queue_high: int = 8, queue_low: int = 0,
                 scale_on_slo: bool = True,
                 scale_on_capacity: bool = True,
                 scale_down_after: int = 3, cooldown_s: float = 0.0,
                 hbm_bytes: Optional[int] = None,
                 weights_bytes: Optional[int] = None,
                 transient_bytes: Optional[int] = None):
        if min_replicas < 1:
            raise ValueError(f"min_replicas must be >= 1, got "
                             f"{min_replicas}")
        if max_replicas is not None and max_replicas < min_replicas:
            raise ValueError(f"max_replicas {max_replicas} < "
                             f"min_replicas {min_replicas}")
        if queue_low > queue_high:
            raise ValueError(f"queue_low {queue_low} > queue_high "
                             f"{queue_high}")
        self.min_replicas = int(min_replicas)
        self.max_replicas = (int(max_replicas)
                             if max_replicas is not None else None)
        self.initial_replicas = (int(initial_replicas)
                                 if initial_replicas is not None else None)
        self.pool = pool
        self.queue_high = int(queue_high)
        self.queue_low = int(queue_low)
        self.scale_on_slo = bool(scale_on_slo)
        self.scale_on_capacity = bool(scale_on_capacity)
        self.scale_down_after = int(scale_down_after)
        self.cooldown_s = float(cooldown_s)
        self.hbm_bytes = int(hbm_bytes) if hbm_bytes is not None else None
        self.weights_bytes = (int(weights_bytes)
                              if weights_bytes is not None else None)
        self.transient_bytes = (int(transient_bytes)
                                if transient_bytes is not None else None)
        self.fleet = None
        self.desired = 0
        self._zero_counters()

    def _zero_counters(self) -> None:
        self.scale_ups = 0
        self.scale_downs = 0
        self.refusals = 0
        self.drains_completed = 0
        self.warmup_s_total = 0.0
        self.segments_observed = 0          # unbound (installed) mode
        self.last_decision: Optional[dict] = None
        self.decision_log: List[dict] = []
        self._unfit: set = set()
        self._calm_streak = 0
        self._last_action_t: Optional[float] = None

    # --- attachment -------------------------------------------------------
    def bind(self, fleet) -> None:
        """Attach to a router (``FleetRouter.__init__`` calls it): check
        the managed replicas and set their initial lifecycles."""
        self.fleet = fleet
        reps = self._managed()
        if not reps:
            raise ValueError(
                f"autoscaler (pool={self.pool!r}) manages no replicas")
        if self.max_replicas is None:
            self.max_replicas = len(reps)
        if self.max_replicas > len(reps):
            raise ValueError(
                f"max_replicas {self.max_replicas} exceeds the "
                f"{len(reps)} built replicas (the elastic model is warm "
                f"standbys, not engine construction mid-serve)")
        if self.initial_replicas is None:
            self.initial_replicas = self.min_replicas
        if not (self.min_replicas <= self.initial_replicas
                <= self.max_replicas):
            raise ValueError(
                f"initial_replicas {self.initial_replicas} outside "
                f"[{self.min_replicas}, {self.max_replicas}]")
        self._apply_initial()

    def _apply_initial(self) -> None:
        self.desired = self.initial_replicas
        for i, r in enumerate(self._managed()):
            r.lifecycle = ("serving" if i < self.initial_replicas
                           else "offline")

    def reset(self) -> None:
        """Zero the counters and set the initial lifecycles again (the
        fleet's ``reset()`` calls it)."""
        self._zero_counters()
        if self.fleet is not None:
            self._apply_initial()

    def describe(self) -> dict:
        """The config the journal header records; replay rebuilds the
        policy, and its initial lifecycles, from it."""
        return {"min_replicas": self.min_replicas,
                "max_replicas": self.max_replicas,
                "initial_replicas": self.initial_replicas,
                "pool": self.pool,
                "queue_high": self.queue_high,
                "queue_low": self.queue_low,
                "scale_on_slo": self.scale_on_slo,
                "scale_on_capacity": self.scale_on_capacity,
                "scale_down_after": self.scale_down_after,
                "cooldown_s": self.cooldown_s,
                "hbm_bytes": self.hbm_bytes,
                "weights_bytes": self.weights_bytes,
                "transient_bytes": self.transient_bytes}

    @classmethod
    def from_description(cls, d: dict) -> "Autoscaler":
        return cls(**d)

    # --- state views ------------------------------------------------------
    def _managed(self) -> list:
        reps = self.fleet._replicas
        if self.pool is not None:
            reps = [r for r in reps if r.pool == self.pool]
        return reps

    @property
    def actual(self) -> int:
        """Replicas taking traffic now."""
        if self.fleet is None:
            return 0
        return sum(1 for r in self._managed() if r.lifecycle == "serving")

    @property
    def drain_inflight(self) -> int:
        if self.fleet is None:
            return 0
        return sum(1 for r in self._managed()
                   if r.lifecycle == "draining")

    def _signals(self) -> dict:
        """The scalars the decision rules compare."""
        reps = self._managed()
        serving = [r for r in reps
                   if r.lifecycle == "serving" and r.health != "dead"]
        queue_sum = sum(r.queue_depth for r in serving)
        slo_level, burn = "ok", None
        mon = self.fleet.slo_monitor
        if mon is not None:
            slo_level = mon.worst_level()
            states = list(mon._classes.values()) + list(mon._pools.values())
            burn = max((max(cs.burn_fast, cs.burn_slow) for cs in states),
                       default=0.0)
        cmon = getattr(self.fleet, "capacity_monitor", None)
        cap_level = cmon.level if cmon is not None else "ok"
        return {"queue_sum": queue_sum, "n_serving": len(serving),
                "slo_level": slo_level,
                "burn": round(burn, 6) if burn is not None else None,
                "capacity_level": cap_level}

    def _snapshot(self, sig: dict) -> dict:
        """The whole input vector of a ``scale_decision`` record."""
        reps = self._managed()
        return dict(sig,
                    queue_depths={str(r.idx): r.queue_depth for r in reps},
                    pages_free={str(r.idx): (r.engine.pager.pages_free
                                             if r.engine.paged else None)
                                for r in reps},
                    health={str(r.idx): r.health for r in reps},
                    lifecycle={str(r.idx): r.lifecycle for r in reps},
                    backpressure=self.fleet.backpressure_events)

    # --- the control step (one call per serve-loop turn) ------------------
    def step(self, now: float, final: bool = False) -> None:
        """Evaluate once on the loop's clock reading. ``final`` (after the
        serve loop) only completes drains."""
        for r in self._managed():
            if r.lifecycle == "draining" and not r.busy:
                self._finish_drain(r, now)
        sig = self._signals()
        self._gauges(sig)
        if final:
            return
        up = []
        if sig["queue_sum"] >= self.queue_high:
            up.append(f"queue depth {sig['queue_sum']} >= "
                      f"{self.queue_high}")
        if self.scale_on_slo and sig["slo_level"] in _LEVELS_FIRING:
            up.append(f"slo burn {sig['slo_level']} "
                      f"(burn={sig['burn']})")
        if self.scale_on_capacity and sig["capacity_level"] in \
                _LEVELS_FIRING:
            up.append(f"capacity {sig['capacity_level']}")
        calm = (not up and sig["queue_sum"] <= self.queue_low
                and sig["slo_level"] == "ok"
                and sig["capacity_level"] == "ok")
        self._calm_streak = self._calm_streak + 1 if calm else 0
        if (self._last_action_t is not None
                and now - self._last_action_t < self.cooldown_s):
            return
        if up:
            self._scale_up(now, sig, "; ".join(up))
        elif (self._calm_streak >= self.scale_down_after
              and sig["n_serving"] > self.min_replicas):
            self._scale_down(now, sig)

    def _gauges(self, sig: dict) -> None:
        sfx = f".{self.pool}" if self.pool else ""
        _metrics.gauge(f"autoscaler.desired{sfx}").set(self.desired)
        _metrics.gauge(f"autoscaler.actual{sfx}").set(sig["n_serving"])
        _metrics.gauge(f"autoscaler.drain_inflight{sfx}").set(
            self.drain_inflight)

    # --- actions ----------------------------------------------------------
    def _scale_up(self, now: float, sig: dict, why: str) -> None:
        cands = [r for r in self._managed()
                 if r.lifecycle == "offline" and r.health != "dead"
                 and r.idx not in self._unfit]
        active = sum(1 for r in self._managed()
                     if r.lifecycle in ("serving", "warming"))
        if not cands or active >= self.max_replicas:
            return
        cand = min(cands, key=lambda r: r.idx)
        fit = self._chip_fit(cand)
        if fit is not None and not fit["fits"]:
            self._unfit.add(cand.idx)
            self.refusals += 1
            self._decide(
                now, "refuse", cand, sig,
                reason=f"chip_fit refused replica {cand.idx}: envelope "
                       f"{fit['envelope_bytes']} B > hbm "
                       f"{fit['hbm_bytes']} B ({why})",
                fit=fit)
            self._last_action_t = now
            return
        self.desired = min(self.desired + 1, self.max_replicas)
        self.scale_ups += 1
        sfx = f".{self.pool}" if self.pool else ""
        _metrics.counter(f"autoscaler.scale_ups{sfx}").inc()
        self._decide(now, "scale_up", cand, sig,
                     reason=f"add replica {cand.idx}: {why}",
                     fit=fit, warmup=self._warmup_estimate(cand))
        warm = self.fleet._activate_replica(cand)
        self.warmup_s_total += warm["seconds"]
        self._last_action_t = now
        self._calm_streak = 0

    def _scale_down(self, now: float, sig: dict) -> None:
        serving = [r for r in self._managed()
                   if r.lifecycle == "serving" and r.health == "healthy"]
        if len(serving) <= max(self.min_replicas, 1):
            return
        can = getattr(self.fleet, "canary", None)
        if can is not None:
            # the canary replica carries the comparison population: never
            # the drain victim
            serving = [r for r in serving if r.idx != can.replica]
            if len(serving) < 2:
                return
        # the least loaded (fewest requeues to pay), ties to the highest
        # index: scale-downs peel replicas off in reverse scale-up order
        victim = min(serving, key=lambda r: (r.load, -r.idx))
        self.desired = max(self.desired - 1, self.min_replicas)
        self.scale_downs += 1
        sfx = f".{self.pool}" if self.pool else ""
        _metrics.counter(f"autoscaler.scale_downs{sfx}").inc()
        self._decide(
            now, "scale_down", victim, sig,
            reason=f"drain replica {victim.idx}: calm for "
                   f"{self._calm_streak} evaluations (queue "
                   f"{sig['queue_sum']} <= {self.queue_low}, slo ok, "
                   f"capacity ok), {len(serving)} serving > min "
                   f"{self.min_replicas}")
        self.fleet._begin_drain(victim, now)
        self._last_action_t = now
        self._calm_streak = 0

    def _finish_drain(self, rep, now: float) -> None:
        info = self.fleet._finalize_drain(rep)
        self.drains_completed += 1
        self._decide(
            now, "drain_complete", rep, self._signals(),
            reason=f"replica {rep.idx} drained: "
                   f"{info.get('requeued', 0)} requeued, "
                   f"{info.get('prefixes_migrated', 0)} prefixes "
                   f"migrated, 0 stranded")

    def _decide(self, now: float, action: str, rep, sig: dict, *,
                reason: str, fit: Optional[dict] = None,
                warmup: Optional[dict] = None) -> None:
        rec = {"action": action, "pool": self.pool,
               "replica": rep.idx if rep is not None else None,
               "reason": reason, "desired": self.desired,
               "actual": self.actual, "inputs": self._snapshot(sig),
               "fit": fit, "warmup": warmup}
        _journal.record("scale_decision", **rec)
        self.last_decision = dict(rec, t=now)
        self.decision_log.append(self.last_decision)

    # --- chip fit and the warmup estimate ---------------------------------
    def _chip_fit(self, rep) -> Optional[dict]:
        """The candidate's fit against ``hbm_bytes``; None when no budget
        is set or the replica is not paged (no pool to price)."""
        if self.hbm_bytes is None or not rep.engine.paged:
            return None
        from ..analysis import memory as _memory

        fit = _memory.chip_fit(
            rep.engine.cfg,
            params=(rep.engine.params
                    if self.weights_bytes is None else None),
            pool=rep.engine.pager, hbm_bytes=self.hbm_bytes,
            weights_bytes=self.weights_bytes,
            transient_bytes=self.transient_bytes)
        return {k: fit[k] for k in
                ("fits", "hbm_bytes", "weights_bytes", "pool_bytes",
                 "transient_bytes", "envelope_bytes", "headroom_bytes",
                 "headroom_pages", "utilization")}

    def _warmup_estimate(self, rep) -> dict:
        """What a scale-up's warmup will run: the enumerated keys and
        their families (a function of geometry and envelope; the measured
        seconds ride the ``replica_warmed`` flight record, off the
        decision stream)."""
        env = self.fleet._warmup_envelope_for(rep)
        space = rep.engine.program_space(env)
        return {"keys": sum(len(v) for v in space.values()),
                "families": sorted(space)}

    # --- unbound mode and the report ---------------------------------------
    def observe_segment(self) -> None:
        self.segments_observed += 1

    def report(self) -> dict:
        """This policy's section of a fleet report."""
        out = {"pool": self.pool, "desired": self.desired,
               "actual": self.actual,
               "drain_inflight": self.drain_inflight,
               "min_replicas": self.min_replicas,
               "max_replicas": self.max_replicas,
               "scale_ups": self.scale_ups,
               "scale_downs": self.scale_downs,
               "refusals": self.refusals,
               "drains_completed": self.drains_completed,
               "warmup_s_total": round(self.warmup_s_total, 6),
               "segments_observed": self.segments_observed,
               "last_decision": self.last_decision,
               "decisions": len(self.decision_log)}
        if self.fleet is not None:
            out["lifecycles"] = {str(r.idx): r.lifecycle
                                 for r in self._managed()}
            out["drains"] = {
                str(r.idx): dict(r.drain,
                                 requests_remaining=r.load)
                for r in self._managed()
                if r.lifecycle == "draining" and r.drain is not None}
        return out


# ---------------------------------------------------------------------------
# Unbound attachment: a policy counting every engine segment through
# ``serving.SEGMENT_HOOKS`` (host counting only, no decision).
# ---------------------------------------------------------------------------

_INSTALLED: List[tuple] = []


def install(asc: Autoscaler) -> None:
    """Attach ``asc`` process-wide as a segment observer (idempotent per
    policy; pair with ``uninstall``)."""
    from . import serving as _serving

    for a, _ in _INSTALLED:
        if a is asc:
            return

    def hook(steps: int, new_tokens: int, finished: int) -> None:
        asc.observe_segment()

    _serving.SEGMENT_HOOKS.append(hook)
    _INSTALLED.append((asc, hook))


def uninstall(asc: Optional[Autoscaler] = None) -> None:
    """Detach ``asc`` (every installed policy when None)."""
    from . import serving as _serving

    keep = []
    for a, hook in _INSTALLED:
        if asc is None or a is asc:
            if hook in _serving.SEGMENT_HOOKS:
                _serving.SEGMENT_HOOKS.remove(hook)
        else:
            keep.append((a, hook))
    _INSTALLED[:] = keep
