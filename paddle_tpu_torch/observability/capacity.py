"""Capacity observability: page-level metering of the KV pool, per-request
resource attribution, and predictive exhaustion alerting.

Port of ``paddle_tpu/observability/capacity.py``. The page allocator's
bookkeeping is host-side (a free list and numpy refcounts), so every
signal here is computed without a device read:

* ``PoolMonitor``: one pool's observer on ``paged_kv.POOL_HOOKS`` (every
  alloc, retain and release, the prefix cache's retains and releases, and
  the host tier's transfers): an occupancy timeline (decimated, bounded),
  the high-water mark with a ``pool_high_water`` flight event, the
  page-seconds integral, and ``snapshot()``: free / live / cache-held /
  reclaimable / trash pages, the copy-on-write sharing ratio, per-slot
  residency, and the tier section.
* The per-request meter: ``Request.page_seconds`` (reserve to release,
  across preemptions), ``meter_ticks`` (weight streams the request was
  live for) and ``meter_streams`` (its fair share of them: over a serve
  the shares sum to the segment steps). ``attribute_request`` and
  ``aggregate_meters`` join them with ``perf.serving_ledger``'s bytes and
  FLOPs per request and per priority class.
* ``CapacityMonitor``: time-to-exhaustion alerting in ``slo.py``'s shape:
  fast and slow segment windows of fresh-page demand, ``(free +
  reclaimable) / demand`` in segments, ok / warning / page with immediate
  escalation and hysteretic clear. The scheduler evaluates it before each
  paged dispatch (``begin_segment``), so the alert leads the first page
  backpressure. Host-tier pages are a second availability axis
  (``avail_by_tier``).
* ``capacity_plan``: the pool size and replica count for a trace, from
  the pages a request spans times Little's-law concurrency, and offered
  tok/s over one replica's.

With chunked prefill the replay skips non-final chunk steps, so
``meter_streams`` attributes those streams to no one: the streams-equal-
steps identity holds for the plain paged family.
"""

from __future__ import annotations

import collections
import math
import time
from typing import Dict, List, Optional

from . import flight as _flight
from . import metrics as _metrics

__all__ = ["PoolMonitor", "CapacityMonitor", "attribute_request",
           "aggregate_meters", "capacity_plan", "install", "uninstall"]

_LEVELS = ("ok", "warning", "page")
_LEVEL_RANK = {lvl: i for i, lvl in enumerate(_LEVELS)}


# ---------------------------------------------------------------------------
# pool monitor: the allocator/cache event observer
# ---------------------------------------------------------------------------


class PoolMonitor:
    """Observe ONE paged pool through ``paged_kv.POOL_HOOKS``.

    ``pager`` is the ``PagedKVCache`` whose allocator's events this
    monitor keeps (events from other engines' allocators in the same
    process are filtered out by identity: engines sharing a process
    keep their observers apart). ``prefix_cache`` (optional, the
    pool's ``PagedPrefixCache``) enables the cache-held/reclaimable
    breakdown. ``high_water_frac`` declares the occupancy fraction
    whose first crossing emits a ``pool_high_water`` flight event
    (hysteretic re-arm ``rearm_margin`` below it, so churn at the line
    cannot storm the ring). Attach/detach explicitly (or use the
    context manager) — constructing one costs nothing."""

    def __init__(self, pager, prefix_cache=None,
                 high_water_frac: float = 0.9,
                 rearm_margin: float = 0.05,
                 timeline_cap: int = 256):
        if not 0.0 < high_water_frac <= 1.0:
            raise ValueError(f"high_water_frac must be in (0, 1], got "
                             f"{high_water_frac}")
        self.pager = pager
        self.prefix_cache = prefix_cache
        self.high_water_frac = float(high_water_frac)
        self.rearm_margin = float(rearm_margin)
        self.timeline_cap = int(timeline_cap)
        self.events = 0
        self.cache_retains = 0            # PagedPrefixCache inserts
        self.cache_releases = 0           # PagedPrefixCache evictions
        # tier traffic observed through the
        # same POOL_HOOKS broadcast — event counts and page totals per
        # direction (stage / spill / restore / import)
        self.tier_events: Dict[str, int] = {}
        self.tier_pages: Dict[str, int] = {}
        self.high_water_pages = 0
        self.high_water_events = 0
        self._hw_armed = True
        # stride-decimated (event_no, pages_used) timeline: bounded
        # memory whatever the serve length, always covering the whole
        # run (when full, every other point drops and the stride
        # doubles — the classic streaming-decimation trick)
        self.timeline: List[tuple] = []
        self._stride = 1
        # ∫ pages_used dt over the observed event stream — the
        # allocator-log side of the page-seconds identity (with no
        # prefix cache and no forks every held page belongs to exactly
        # one request, so Σ request.page_seconds == this integral)
        self.page_seconds_integral = 0.0
        self._last_t: Optional[float] = None
        self._last_used = 0
        self._attached = False

    # --- lifecycle --------------------------------------------------------
    def attach(self) -> "PoolMonitor":
        from ..inference import paged_kv as _pk

        if not self._attached:
            _pk.POOL_HOOKS.append(self._on_event)
            self._attached = True
            # open the integral at attach so a pool that is already
            # partially occupied integrates from here, not from zero
            self._last_t = time.perf_counter()
            self._last_used = self.pager.allocator.pages_used
        return self

    def detach(self) -> None:
        from ..inference import paged_kv as _pk

        if self._attached:
            if self._on_event in _pk.POOL_HOOKS:
                _pk.POOL_HOOKS.remove(self._on_event)
            self._attached = False

    def __enter__(self) -> "PoolMonitor":
        return self.attach()

    def __exit__(self, *exc) -> None:
        self.detach()

    # --- the event intake (host ints only) --------------------------------
    def _on_event(self, event: str, n: int, alloc) -> None:
        if alloc is not self.pager.allocator:
            return
        t = time.perf_counter()
        if self._last_t is not None:
            self.page_seconds_integral += self._last_used * (t - self._last_t)
        self._last_t = t
        used = alloc.pages_used
        self._last_used = used
        self.events += 1
        if event == "cache_retain":
            self.cache_retains += 1
        elif event == "cache_release":
            self.cache_releases += 1
        elif event.startswith("tier_"):
            d = event[len("tier_"):]
            self.tier_events[d] = self.tier_events.get(d, 0) + 1
            self.tier_pages[d] = self.tier_pages.get(d, 0) + int(n)
        if used > self.high_water_pages:
            self.high_water_pages = used
            _metrics.gauge("capacity.high_water_pages").set(used)
        occ = used / max(1, alloc.num_pages - 1)
        _metrics.gauge("capacity.pages_free").set(alloc.pages_free)
        _metrics.gauge("capacity.occupancy").set(occ)
        if self._hw_armed and occ >= self.high_water_frac:
            self._hw_armed = False
            self.high_water_events += 1
            _metrics.counter("capacity.high_water_events").inc()
            _flight.record("pool_high_water",
                           occupancy=round(occ, 4), pages_used=used,
                           pages_free=alloc.pages_free,
                           frac=self.high_water_frac)
        elif not self._hw_armed \
                and occ < self.high_water_frac - self.rearm_margin:
            self._hw_armed = True
        if self.events % self._stride == 0:
            self.timeline.append((self.events, used))
            if len(self.timeline) > self.timeline_cap:
                self.timeline = self.timeline[::2]
                self._stride *= 2

    # --- on-demand breakdown (host numpy scans; pools are small) ----------
    def snapshot(self) -> dict:
        """The full pool breakdown, computed from host state at call
        time. ``pages_free + live_only + shared + reclaimable`` tiles
        the usable pool exactly when no dispatched segment is in flight
        (mid-flight reservations are counted under ``live``: the pages
        belong to picked requests the slot mirrors haven't bound yet —
        ``reserved_unbound`` names that remainder)."""
        alloc = self.pager.allocator
        used = alloc.pages_used
        slot_set = {p for pages in self.pager.slot_pages for p in pages}
        cache_set = set()
        if self.prefix_cache is not None:
            cache_set = {p for ent in self.prefix_cache._entries.values()
                         for p in ent.pages}
        reclaimable = len(cache_set - slot_set)
        virtual = int(alloc._ref.sum())
        residency = collections.Counter(
            len(pages) for pages in self.pager.slot_pages if pages)
        return {
            "num_pages": alloc.num_pages - 1,        # usable (sans trash)
            "page_size": self.pager.page_size,
            "pages_free": alloc.pages_free,
            "pages_used": used,
            "live_pages": len(slot_set),
            "cache_held_pages": len(cache_set),
            "reclaimable_pages": reclaimable,
            "reserved_unbound_pages": used - len(slot_set | cache_set),
            "trash_pages": 1,
            "occupancy": round(used / max(1, alloc.num_pages - 1), 4),
            "high_water_pages": self.high_water_pages,
            "high_water_occupancy": round(
                self.high_water_pages / max(1, alloc.num_pages - 1), 4),
            "high_water_events": self.high_water_events,
            "cow_virtual_pages": virtual,
            "cow_ratio": round(virtual / used, 4) if used else 1.0,
            "slot_residency": {str(k): v
                               for k, v in sorted(residency.items())},
            "events": self.events,
            "cache_retains": self.cache_retains,
            "cache_releases": self.cache_releases,
            "page_seconds_integral": round(self.page_seconds_integral, 6),
            "timeline_stride": self._stride,
            "timeline": list(self.timeline),
            **self._tier_section(),
        }

    def _tier_section(self) -> dict:
        """The tier breakdown, when the attached cache has a host
        tier: host-resident pages + observed transfer traffic (empty
        dict otherwise)."""
        tier = (getattr(self.prefix_cache, "host_tier", None)
                if self.prefix_cache is not None else None)
        if tier is None and not self.tier_events:
            return {}
        out = {"events": dict(self.tier_events),
               "pages": dict(self.tier_pages)}
        if tier is not None:
            out.update(tier.stats())
            out["spillable_pages"] = self.prefix_cache.spillable_pages()
        return {"tiers": out}

    def reclaimable(self) -> int:
        if self.prefix_cache is None:
            return 0
        return self.prefix_cache.reclaimable_pages()


# ---------------------------------------------------------------------------
# per-request resource attribution (the meter join)
# ---------------------------------------------------------------------------


def attribute_request(req, ledger: Optional[dict] = None,
                      page_size: Optional[int] = None) -> dict:
    """One request's resource bill from its meter fields, joined with
    the analytic ledger when given (``perf.serving_ledger``): HBM bytes
    streamed = fair-share weight streams × bytes/stream + the KV rows
    this request's own ticks read (ledger ``avg_pos`` arithmetic),
    prefill FLOPs from the prompt span. Host arithmetic only."""
    out = {
        "rid": req.rid,
        "priority": req.priority,
        "prompt_tokens": int(len(req.prompt)),
        "gen_tokens": len(req.tokens),
        "pages_reserved": req.pages_reserved,
        "page_seconds": round(req.page_seconds, 6),
        "ticks": req.meter_ticks,
        "streams": round(req.meter_streams, 4),
        "spec_effective_tok_per_tick": (
            round(len(req.tokens) / req.meter_ticks, 4)
            if req.meter_ticks else None),
    }
    if page_size:
        out["page_tokens_reserved"] = req.pages_reserved * int(page_size)
    if ledger is not None:
        wb = ledger["weight_bytes_per_tick"]
        # per-slot KV bytes/tick at the ledger's avg_pos (the decode-tick term,
        # divided back to one slot since kv_bytes is batch-scaled)
        kv_slot = ledger["kv_bytes_per_tick"] / max(1, ledger["batch"])
        out["hbm_bytes"] = int(req.meter_streams * wb
                               + req.meter_ticks * kv_slot)
        out["prefill_flops"] = int(ledger["flops_per_token"]
                                   * len(req.prompt))
    return out


def aggregate_meters(reqs, ledger: Optional[dict] = None,
                     page_size: Optional[int] = None) -> dict:
    """Per-priority-class aggregation of the request meters — the
    ``OnlineReport.meter`` section (and the accounting substrate
    per-tenant billing would read)."""
    classes: Dict[int, dict] = {}
    totals = {"n": 0, "page_seconds": 0.0, "ticks": 0, "streams": 0.0,
              "hbm_bytes": 0, "prefill_flops": 0}
    for r in reqs:
        a = attribute_request(r, ledger=ledger, page_size=page_size)
        c = classes.setdefault(r.priority, {
            "n": 0, "page_seconds": 0.0, "ticks": 0, "streams": 0.0,
            "hbm_bytes": 0, "prefill_flops": 0})
        for agg in (c, totals):
            agg["n"] += 1
            agg["page_seconds"] += a["page_seconds"]
            agg["ticks"] += a["ticks"]
            agg["streams"] += a["streams"]
            agg["hbm_bytes"] += a.get("hbm_bytes", 0)
            agg["prefill_flops"] += a.get("prefill_flops", 0)
    for agg in list(classes.values()) + [totals]:
        agg["page_seconds"] = round(agg["page_seconds"], 6)
        agg["streams"] = round(agg["streams"], 4)
    return {"per_class": {str(p): c for p, c in sorted(classes.items())},
            "total": totals,
            "ledger_joined": ledger is not None}


# ---------------------------------------------------------------------------
# predictive exhaustion alerting
# ---------------------------------------------------------------------------


class CapacityMonitor:
    """Time-to-exhaustion alerting over the page pool, in slo.py's
    shape: segment-counted windows, ok→warning→page with immediate
    escalation and hysteretic clear.

    Intake (all host ints, fed from state the serve loop already
    holds):

    * :meth:`note_admission` — fresh pages reserved (shared prefix
      pages excluded: they consume no free pages);
    * :meth:`observe_pool` — the current ``(pages_free, reclaimable)``;
    * :meth:`begin_segment` — evaluate the alert rules against the
      CURRENT availability and the demand EWMFs of CLOSED buckets.
      The scheduler calls this before each dispatch, which is what
      makes the page LEAD the first pages-backpressure deferral;
    * :meth:`close_segment` — push the open demand bucket into the
      windows.

    Time-to-exhaustion = (free + reclaimable) / demand, in SEGMENTS:
    ``demand_fast`` is the mean fresh-page demand over the newest
    ``fast_window`` buckets, ``demand_slow`` over ``slow_window`` —
    page fires only when BOTH estimates fall under ``page_horizon``
    (the fast window gives reaction time, the slow one suppresses a
    one-segment burst), warning likewise under ``warn_horizon``.
    ``ledger`` (optional ``perf.serving_ledger``) rides into
    :func:`aggregate_meters` for the byte/FLOP join of the report's
    meter section."""

    def __init__(self, fast_window: int = 2, slow_window: int = 8,
                 warn_horizon: float = 16.0, page_horizon: float = 6.0,
                 clear_after: int = 4, ledger: Optional[dict] = None):
        if not 0 < fast_window <= slow_window:
            raise ValueError(f"need 0 < fast_window <= slow_window, got "
                             f"{fast_window}/{slow_window}")
        if not 0 < page_horizon <= warn_horizon:
            raise ValueError(f"need 0 < page_horizon <= warn_horizon, "
                             f"got {page_horizon}/{warn_horizon}")
        self.fast_window = int(fast_window)
        self.slow_window = int(slow_window)
        self.warn_horizon = float(warn_horizon)
        self.page_horizon = float(page_horizon)
        self.clear_after = int(clear_after)
        self.ledger = ledger
        self._reset_state()

    def _reset_state(self) -> None:
        self.segment_no = 0
        self.level = "ok"
        self.clear_streak = 0
        self.alert_log: List[dict] = []
        self._window = collections.deque(maxlen=self.slow_window)
        self._cur_pages = 0
        self._cur_admits = 0
        self.pages_admitted_total = 0
        self.admitted_total = 0
        self.pool_events = 0
        self._free = 0
        self._reclaimable = 0
        # the tier dimension of the availability term —
        # host-resident staged pages (None until a tiered feed reports)
        self._host_pages: Optional[int] = None
        self.tte_fast = math.inf
        self.tte_slow = math.inf
        self.demand_fast = 0.0
        self.demand_slow = 0.0

    # --- intake -----------------------------------------------------------
    def note_admission(self, pages: int, admitted: int = 1) -> None:
        self._cur_pages += int(pages)
        self._cur_admits += int(admitted)
        self.pages_admitted_total += int(pages)
        self.admitted_total += int(admitted)
        self.pool_events += 1

    def observe_pool(self, pages_free: int, reclaimable: int = 0,
                     host_pages: Optional[int] = None) -> None:
        self._free = int(pages_free)
        self._reclaimable = int(reclaimable)
        if host_pages is not None:
            self._host_pages = int(host_pages)
        self.pool_events += 1

    # --- evaluation -------------------------------------------------------
    def _demand(self, n: int) -> float:
        buckets = list(self._window)[-n:]
        return sum(buckets) / len(buckets) if buckets else 0.0

    def begin_segment(self, pages_free: Optional[int] = None,
                      reclaimable: Optional[int] = None,
                      host_pages: Optional[int] = None) -> str:
        """Run the alert rules against the CURRENT availability —
        call before dispatching the segment. Returns the level.

        Tier dimension: the HBM time-to-exhaustion keeps its
        meaning (free + reclaimable — with a spill tier, 'reclaimable'
        pages demote instead of dying, so the term is unchanged while
        its COST changed); ``host_pages`` rides the report/gauge as the
        second availability axis the autoscaler and the /capacity
        scrape read."""
        if pages_free is not None:
            self._free = int(pages_free)
        if reclaimable is not None:
            self._reclaimable = int(reclaimable)
        if host_pages is not None:
            self._host_pages = int(host_pages)
            _metrics.gauge("capacity.host_pages").set(self._host_pages)
        avail = self._free + self._reclaimable
        self.demand_fast = self._demand(self.fast_window)
        self.demand_slow = self._demand(self.slow_window)
        self.tte_fast = (avail / self.demand_fast
                         if self.demand_fast > 0 else math.inf)
        self.tte_slow = (avail / self.demand_slow
                         if self.demand_slow > 0 else math.inf)
        _metrics.gauge("capacity.tte_fast_segments").set(
            min(self.tte_fast, 1e9))
        _metrics.gauge("capacity.tte_slow_segments").set(
            min(self.tte_slow, 1e9))
        _metrics.gauge("capacity.avail_pages").set(avail)
        if (self.tte_fast <= self.page_horizon
                and self.tte_slow <= self.page_horizon):
            target = "page"
        elif (self.tte_fast <= self.warn_horizon
                and self.tte_slow <= self.warn_horizon):
            target = "warning"
        else:
            target = "ok"
        if _LEVEL_RANK[target] > _LEVEL_RANK[self.level]:
            self._transition(target)          # escalate immediately
            self.clear_streak = 0
        elif _LEVEL_RANK[target] < _LEVEL_RANK[self.level]:
            self.clear_streak += 1            # hysteretic clear
            if self.clear_streak >= self.clear_after:
                self._transition(target)
                self.clear_streak = 0
        else:
            self.clear_streak = 0
        return self.level

    def close_segment(self) -> None:
        """Close the open demand bucket (call once per segment, after
        the fetch distributed its admissions)."""
        self.segment_no += 1
        self._window.append(self._cur_pages)
        self._cur_pages = 0
        self._cur_admits = 0

    def note_segment(self, admitted: int, pages: int,
                     pages_free: Optional[int] = None,
                     reclaimable: Optional[int] = None) -> None:
        """Convenience one-shot: note + observe + close (for callers
        without a pre-dispatch hook; the alert then trails by one
        segment — the scheduler uses the split calls instead)."""
        self.note_admission(pages, admitted)
        if pages_free is not None:
            self.observe_pool(pages_free, reclaimable or 0)
        self.close_segment()

    def _transition(self, level: str) -> None:
        prev, self.level = self.level, level
        rec = {"segment": self.segment_no, "level": level, "prev": prev,
               "tte_fast": (round(self.tte_fast, 3)
                            if math.isfinite(self.tte_fast) else None),
               "tte_slow": (round(self.tte_slow, 3)
                            if math.isfinite(self.tte_slow) else None),
               "avail_pages": self._free + self._reclaimable,
               "demand_fast": round(self.demand_fast, 3)}
        self.alert_log.append(rec)
        if _LEVEL_RANK[level] > _LEVEL_RANK[prev]:
            _metrics.counter("capacity.alerts").inc()
            _metrics.counter(f"capacity.alerts[{level}]").inc()
        _flight.record("capacity_alert", **rec)

    # --- introspection ----------------------------------------------------
    def report(self) -> dict:
        """The ``/capacity`` endpoint's monitor section."""
        return {
            "segments": self.segment_no,
            "level": self.level,
            "windows": {"fast": self.fast_window,
                        "slow": self.slow_window},
            "horizons": {"warn": self.warn_horizon,
                         "page": self.page_horizon,
                         "clear_after": self.clear_after,
                         "unit": "segments"},
            "avail_pages": self._free + self._reclaimable,
            "pages_free": self._free,
            "reclaimable_pages": self._reclaimable,
            # the per-tier availability view — host
            # pages are reclaimable AT RESTORE COST, so they report as
            # their own axis instead of inflating the HBM horizon
            "avail_by_tier": {
                "hbm": self._free + self._reclaimable,
                "host": self._host_pages,
            },
            "demand_fast": round(self.demand_fast, 3),
            "demand_slow": round(self.demand_slow, 3),
            "tte_fast_segments": (round(self.tte_fast, 3)
                                  if math.isfinite(self.tte_fast)
                                  else None),
            "tte_slow_segments": (round(self.tte_slow, 3)
                                  if math.isfinite(self.tte_slow)
                                  else None),
            "pages_admitted_total": self.pages_admitted_total,
            "admitted_total": self.admitted_total,
            "alerts": list(self.alert_log),
        }

    def reset(self) -> None:
        """Zero windows/alert state (warm-run isolation)."""
        self._reset_state()

    # with an autoscaler attached the monitor becomes a
    # DECIDER (``capacity_alert`` is a scale-up input), so its config
    # rides the journal header and replay rebuilds it from this.
    def describe(self) -> dict:
        """Rebuildable config snapshot for the journal header."""
        return {"fast_window": self.fast_window,
                "slow_window": self.slow_window,
                "warn_horizon": self.warn_horizon,
                "page_horizon": self.page_horizon,
                "clear_after": self.clear_after}

    @classmethod
    def from_description(cls, d: dict) -> "CapacityMonitor":
        return cls(**d)


# ---------------------------------------------------------------------------
# capacity planner: pages-free arithmetic x replica scaling
# ---------------------------------------------------------------------------


def capacity_plan(trace_stats: dict, ledger: Optional[dict] = None, *,
                  page_size: int, slots: int,
                  measured: Optional[dict] = None,
                  headroom: float = 0.0,
                  cfg=None, params=None, quant: Optional[str] = None,
                  hbm_bytes: Optional[int] = None,
                  mesh_devices: int = 1,
                  transient_bytes: Optional[int] = None) -> dict:
    """Answer "what pool size / how many replicas for this trace".

    ``trace_stats``: ``mean_prompt_tokens``, ``mean_new_tokens``, and
    either ``rate_req_s`` (Little's-law concurrency ``λ·W``) or
    ``concurrency`` directly (``None`` rate ⇒ saturated: concurrency =
    ``slots``). ``mean_service_s`` (a measured ``W``) sharpens the
    concurrency estimate; without it ``W ≈ (G+1) · per_tick_s`` (each
    live slot retires one token per tick).

    ``measured``: ``per_tick_s`` (measured seconds/segment-step) and
    ``slot_occupancy`` (useful slot-ticks fraction) from a probe serve;
    without them the analytic ``tick_floor_s`` from ``ledger``
    prices the ticks (the chip-ceiling what-if).

    The two joins:

    * **pool arithmetic** — a request spans exactly
      ``ceil((S+G−1)/p)`` pages (generation length fixed at
      admission), so pool high-water ≈ concurrency × span and the
      recommended pool adds ``headroom`` plus the trash page;
    * **replica scaling** — offered tok/s = λ·E[G] against one
      replica's capacity ``occupancy × slots / per_tick_s`` gives the
      replica count at ``headroom`` utilisation margin.

    ``chip_fit`` (the static HBM envelope of a replica) is not part of
    the port: passing ``hbm_bytes`` raises.
    """
    S = float(trace_stats["mean_prompt_tokens"])
    G = float(trace_stats["mean_new_tokens"])
    rate = trace_stats.get("rate_req_s")
    span_pages = max(1, -(-int(math.ceil(S + G - 1)) // int(page_size)))
    meas = measured or {}
    per_tick_s = meas.get("per_tick_s")
    if per_tick_s is None and ledger is not None:
        per_tick_s = ledger["tick_floor_s"]
    occupancy = float(meas.get("slot_occupancy", 1.0))
    tok_s_replica = (occupancy * slots / per_tick_s
                     if per_tick_s else None)
    service_s = trace_stats.get("mean_service_s")
    if service_s is None and per_tick_s is not None:
        service_s = (G + 1.0) * per_tick_s
    if "concurrency" in trace_stats:
        concurrency = float(trace_stats["concurrency"])
    elif rate is None:
        concurrency = float(slots)            # saturated: slots bind
    else:
        concurrency = min(float(slots), float(rate) * (service_s or 0.0))
    high_water_pages = int(math.ceil(concurrency * span_pages))
    pool_pages = int(math.ceil(high_water_pages * (1.0 + headroom))) + 1
    offered_tok_s = (float(rate) * G if rate is not None
                     else tok_s_replica)
    replicas = 1
    if offered_tok_s is not None and tok_s_replica:
        replicas = max(1, int(math.ceil(
            offered_tok_s / (tok_s_replica * (1.0 - headroom)))))
    predicted_tok_s = (min(offered_tok_s, replicas * tok_s_replica)
                       if offered_tok_s is not None and tok_s_replica
                       else tok_s_replica)
    if hbm_bytes is not None:
        raise NotImplementedError(
            "capacity_plan(hbm_bytes=...): the chip-fit envelope is not "
            "ported")
    chip_fit = None
    return {
        "arithmetic": "SCALING §3f pages-free x §3g replica scaling",
        "span_pages": span_pages,
        "span_rows": int(math.ceil(S + G - 1)),
        "page_size": int(page_size),
        "slots": int(slots),
        "service_s": (round(service_s, 4)
                      if service_s is not None else None),
        "concurrency": round(concurrency, 3),
        "predicted_high_water_pages": high_water_pages,
        "pool_pages": pool_pages,            # recommended (headroom+trash)
        "headroom": headroom,
        "tok_s_replica": (round(tok_s_replica, 2)
                          if tok_s_replica else None),
        "offered_tok_s": (round(offered_tok_s, 2)
                          if offered_tok_s is not None else None),
        "replicas": replicas,
        "predicted_tok_s": (round(predicted_tok_s, 2)
                            if predicted_tok_s is not None else None),
        "chip_fit": chip_fit,
    }


# ---------------------------------------------------------------------------
# Ambient attachment: every allocator event
# and every engine segment feed the monitor through POOL_HOOKS /
# SEGMENT_HOOKS — no scheduler, no engine reference, host ints only.
# The attachment proves hazard-neutrality (budgets bit-identical
# --capacity on|off); the schedulers provide the pool-aware feed.
# ---------------------------------------------------------------------------

_INSTALLED: List[tuple] = []


def install(monitor: CapacityMonitor) -> None:
    from ..inference import paged_kv as _pk
    from ..inference import serving as _serving

    for m, _, _ in _INSTALLED:
        if m is monitor:
            return

    def pool_hook(event: str, n: int, alloc) -> None:
        if event == "alloc":
            monitor.note_admission(n, admitted=0)
        monitor.observe_pool(alloc.pages_free)

    def seg_hook(steps: int, new_tokens: int, finished: int) -> None:
        monitor.begin_segment()
        monitor.close_segment()

    _pk.POOL_HOOKS.append(pool_hook)
    _serving.SEGMENT_HOOKS.append(seg_hook)
    _INSTALLED.append((monitor, pool_hook, seg_hook))


def uninstall(monitor: Optional[CapacityMonitor] = None) -> None:
    from ..inference import paged_kv as _pk
    from ..inference import serving as _serving

    keep = []
    for m, ph, sh in _INSTALLED:
        if monitor is None or m is monitor:
            if ph in _pk.POOL_HOOKS:
                _pk.POOL_HOOKS.remove(ph)
            if sh in _serving.SEGMENT_HOOKS:
                _serving.SEGMENT_HOOKS.remove(sh)
        else:
            keep.append((m, ph, sh))
    _INSTALLED[:] = keep
