"""Fleet router: N ``ServingEngine`` replicas behind one ``serve(trace)``.

Port of ``paddle_tpu/inference/fleet.py``. Each replica is an independent
engine with its OWN prefix cache and its OWN metrics registry:

* **Prefix-affinity dispatch.** The router hashes each request's
  block-aligned strict prompt prefix (the prefix caches' alignment rule)
  to a preferred replica (crc32, stable across processes), so requests
  sharing a prefix land on the replica whose cache already holds it.
  Prompts too short to carry a cacheable prefix skip affinity, and so
  does a fleet without caches (a prompt-hash pin would be pure load
  imbalance).
* **Least-loaded fallback.** When the preferred replica's bounded queue
  is full, or there is no affinity key, the request goes to the replica
  with the fewest queued + live requests (ties to the lowest index);
  paged replicas whose pool can hold it now come first.
* **Fleet backpressure.** When no replica can take a due arrival it
  stays client-side and the refusal is billed to the replica that would
  have taken it: the fleet counter is the sum of the replica counters.
* **Cache directory** (``directory=True``): the per-replica
  ``PagedPrefixCache`` listeners feed one fleet-wide map of which
  replica holds which prefix at which tier, and a directory hit steers
  the request to a replica that does hold it. When no owner can take it,
  the chosen replica imports the owner's host-tier bytes
  (``export_host`` -> ``import_host``) so its admission restores instead
  of prefilling again.
* **Failover.** A ``FaultInjector`` raises ``ReplicaCrash`` or
  ``ReplicaHang`` at a replica's k-th segment finish; a crash or a hang
  past ``max_finish_retries`` kills the replica and requeues everything
  it owed onto the least-loaded healthy survivor, each request resuming
  from its last read token; a dead replica is probed back after
  ``probe_after_s``.
* **Shadow and canary.** ``shadow=Shadow(...)`` mirrors a seeded
  fraction of admitted requests to a variant engine strictly off the
  primary path (its own segments, fetch and registry, its journal
  records marked) and diffs each pair through a ``QualityMonitor``;
  ``canary=CanaryController(...)`` routes a seeded share of traffic to a
  variant replica and holds it on a failing verdict.
* **Elastic autoscaling.** ``autoscaler=Autoscaler(...)`` (or a list,
  one per pool) runs the control loop of ``inference/autoscaler.py`` on
  each turn's clock reading: replicas carry a lifecycle (offline ->
  warming -> serving -> draining -> offline) beside their health; only
  serving replicas take fresh traffic; a scale-up runs the standby's
  ``aot_warmup`` before it serves; a scale-down drains politely (queued
  requests requeue, live slots finish in place, cached prefixes migrate
  to the survivors' host tiers). ``aot_warmup()`` warms every replica's
  program space ahead of a serve.
* **Telemetry.** Replica i records into its own ``metrics.Registry`` as
  if it were rank i; ``merged_telemetry()`` writes one snapshot per
  replica and reduces them with ``merge_log_dir``.

The loop is a staggered pipeline: each turn ingests due arrivals,
dispatches one segment on every busy replica with none in flight, steps
the shadow, then finishes the OLDEST segment in flight (its one counted
fetch). Every clock read that steers it goes through
``observability.journal.now`` / ``sleep``, so a serve recorded with a
journal replays its decisions under ``journal.feed_clock``.

**Replicas on one card.** Without ``build_fleet(devices=...)`` every
replica runs on the engine's device, and all of them issue their work
on the device's current stream: the split-KV decode and paged attention
kernels keep one ticket buffer per (device, size) that serves one stream
at a time, so replicas must not run on streams of their own. Each
engine's segment read waits only for its own segment: ``dispatch_segment``
ends by copying the event log to pinned host memory without blocking and
recording a CUDA event behind the copy, and ``finish_segment`` waits on
that event, so replica 0's fetch does not wait for the segments the
other replicas dispatched after it.

Not ported yet: mp-sharded replicas (the engine takes no mesh).
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..observability import flight as _flight
from ..observability import journal as _journal
from ..observability import metrics as _metrics
from ..observability import quality as _quality
from ..observability.metrics import percentile as _pctl
from .prefix_cache import _common_prefix, make_prefix_cache
from .scheduler import Arrival
from .serving import Request, ServingEngine

__all__ = ["FleetRouter", "FleetReport", "Shadow", "CacheDirectory",
           "build_fleet", "FaultInjector", "ReplicaCrash", "ReplicaHang"]

# ---------------------------------------------------------------------------
# the fleet-wide prefix-cache directory
# ---------------------------------------------------------------------------


class CacheDirectory:
    """prefix -> {replica: tier, pages, last_touch}, kept from the
    per-replica ``PagedPrefixCache`` listener hooks (insert / evict /
    spill / restore): the caches' own transitions are the directory's
    write stream, so it cannot drift from them.

    Lookup follows the caches' matching rule (longest block-aligned
    STRICT common prefix), so a directory hit means the steered
    replica's own ``match()`` hits too. All state is host bytes and
    ints, a deterministic function of the event stream."""

    def __init__(self, block: int):
        if block < 1:
            raise ValueError(f"block must be >= 1, got {block}")
        self.block = int(block)
        self._tokens: Dict[bytes, np.ndarray] = {}
        # key -> replica idx -> {"tier", "pages", "touch"}
        self._owners: Dict[bytes, Dict[int, dict]] = {}
        self._seq = 0
        self.lookups = 0
        self.hits = 0
        self.updates = 0

    def attach(self, idx: int, cache) -> None:
        """Subscribe to one replica's cache transitions."""
        if cache is None or not hasattr(cache, "listeners"):
            return

        def on_event(event, key, tokens, tier, pages, _idx=idx):
            self._note(_idx, event, key, tokens, tier, pages)

        cache.listeners.append(on_event)

    def _note(self, idx: int, event: str, key: bytes, tokens,
              tier: str, pages: int) -> None:
        self.updates += 1
        self._seq += 1
        if event == "evict":
            owners = self._owners.get(key)
            if owners is not None:
                owners.pop(idx, None)
                if not owners:
                    self._owners.pop(key, None)
                    self._tokens.pop(key, None)
            return
        self._tokens[key] = np.asarray(tokens, np.int32)
        self._owners.setdefault(key, {})[idx] = {
            "tier": tier, "pages": int(pages), "touch": self._seq}

    def lookup(self, prompt) -> Optional[dict]:
        """Longest block-aligned strict common prefix across the whole
        fleet's cached entries, or None. Returns ``{"key", "rows",
        "owners": {idx: {tier, pages, touch}}}``."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        b = self.block
        cap = (len(prompt) // b) * b
        if cap == len(prompt):
            cap -= b
        self.lookups += 1
        if cap <= 0 or not self._owners:
            return None
        best_l, best_key = 0, None
        for key, toks in self._tokens.items():
            m = (min(_common_prefix(prompt, toks), cap) // b) * b
            if m > best_l:
                best_l, best_key = m, key
        if best_key is None:
            return None
        self.hits += 1
        return {"key": best_key, "rows": best_l,
                "owners": {i: dict(info)
                           for i, info in self._owners[best_key].items()}}

    def reset(self) -> None:
        self._tokens.clear()
        self._owners.clear()
        self._seq = 0
        self.lookups = self.hits = self.updates = 0

    def stats(self) -> dict:
        return {"entries": len(self._owners),
                "placements": sum(len(o) for o in self._owners.values()),
                "lookups": self.lookups, "hits": self.hits,
                "updates": self.updates}


# ---------------------------------------------------------------------------
# fault injection: a deterministic replica crash / hang schedule
# ---------------------------------------------------------------------------


class ReplicaCrash(Exception):
    """Injected process death: the in-flight segment's results are lost
    and the replica is dead at once."""


class ReplicaHang(Exception):
    """Injected wedge: the segment fetch 'times out'. A retry may get
    through (a transient stall); repeated hangs escalate to dead."""


class FaultInjector:
    """Declarative, deterministic fault schedule. Faults fire at a
    replica's k-th ``finish_segment`` (counted per replica; on a burst
    trace the fleet's dispatch order is deterministic, so a schedule
    keyed on (replica, segment) reproduces exactly). ``seed`` /
    ``crash_p`` add a seeded random crash on top.

    * ``crash={idx: seg_no}``: that finish raises ``ReplicaCrash`` once.
    * ``hang={idx: (seg_no, n)}``: that finish raises ``ReplicaHang``
      ``n`` consecutive times.
    * ``recover_after``: a dead replica's k-th re-admission probe
      succeeds (a restart completing).
    """

    def __init__(self, crash: Optional[Dict[int, int]] = None,
                 hang: Optional[Dict[int, tuple]] = None,
                 recover_after: int = 1, seed: int = 0,
                 crash_p: float = 0.0):
        self.crash = dict(crash or {})
        self.hang = {k: [int(v[0]), int(v[1])]
                     for k, v in (hang or {}).items()}
        self.recover_after = int(recover_after)
        self.seed = int(seed)
        self.crash_p = float(crash_p)
        self._rng = np.random.RandomState(seed)
        self._draws = 0                    # seeded rand() calls consumed
        self.events: List[tuple] = []      # (kind, replica, detail) log

    def describe(self) -> dict:
        """The journal header's snapshot: the current schedule (fired
        crashes popped) and how many seeded draws were consumed."""
        return {"crash": dict(self.crash),
                "hang": {k: list(v) for k, v in self.hang.items()},
                "recover_after": self.recover_after, "seed": self.seed,
                "crash_p": self.crash_p, "draws": self._draws}

    def on_finish(self, idx: int, seg_no: int) -> None:
        """Called right before replica ``idx`` fetches its ``seg_no``-th
        segment; raises to inject the fault."""
        fire = self.crash.get(idx) == seg_no
        if not fire and self.crash_p:
            self._draws += 1
            draw = float(self._rng.rand())
            fire = draw < self.crash_p
            _journal.record("fault", fault="draw", replica=idx,
                            segment=seg_no, draw=draw, fired=fire)
        if fire:
            self.crash.pop(idx, None)
            self.events.append(("crash", idx, seg_no))
            _journal.record("fault", fault="crash", replica=idx,
                            segment=seg_no)
            raise ReplicaCrash(f"replica {idx} crashed at its segment "
                               f"{seg_no}")
        h = self.hang.get(idx)
        if h is not None and h[0] == seg_no and h[1] > 0:
            h[1] -= 1
            self.events.append(("hang", idx, seg_no))
            _journal.record("fault", fault="hang", replica=idx,
                            segment=seg_no, remaining=h[1])
            raise ReplicaHang(f"replica {idx} hung at its segment "
                              f"{seg_no}")

    def on_probe(self, idx: int, probe_no: int) -> bool:
        """Re-admission probe of a dead replica: True = recovered."""
        self.events.append(("probe", idx, probe_no))
        return probe_no >= self.recover_after


# ---------------------------------------------------------------------------
# shadow serving: a sampled fraction of live traffic mirrored to a variant
# engine, off the primary path
# ---------------------------------------------------------------------------


class Shadow:
    """Shadow-serving attachment for :class:`FleetRouter`.

    ``engine`` runs the VARIANT configuration (quantized weights, other
    chunking or K) and receives a seeded, sampled fraction of live
    requests as mirrors:

    * **Off the primary path.** The shadow runs its own segments with its
      own counted fetch, stepped after each loop turn's primary work; its
      telemetry lands in its own registry, and every journal record it
      writes (clock reads included) carries the shadow mark.
    * **Seeded sampling.** ``wants(rid)`` is a pure crc32 draw on (seed,
      fleet rid).
    * **Quality diffing.** When both sides of a pair finish, the
      :class:`~paddle_tpu_torch.observability.quality.QualityMonitor`
      diffs the token streams (exact first divergence) and, when both
      engines carry ``quality_digest``, the logit digests.
    """

    def __init__(self, engine: ServingEngine, sample_p: float = 1.0,
                 seed: int = 0, monitor=None,
                 seg_steps: Optional[int] = None):
        if not 0.0 <= float(sample_p) <= 1.0:
            raise ValueError(f"sample_p must be in [0, 1], got {sample_p}")
        self.engine = engine
        self.sample_p = float(sample_p)
        self.seed = int(seed)
        self.monitor = (monitor if monitor is not None
                        else _quality.QualityMonitor())
        self.seg_steps = seg_steps
        self.registry = _metrics.Registry()
        self.mirrored = 0
        self.dropped = 0           # mirrors skipped (the shadow can't hold)
        self.compared = 0
        self.segments = 0
        self._map: Dict[int, int] = {}       # shadow erid -> fleet rid
        self._awaiting: set = set()          # fleet rids mid-pair
        self._primary: Dict[int, tuple] = {}  # rid -> (toks, digs, cls)
        self._shadow: Dict[int, tuple] = {}   # rid -> (toks, digs)

    def wants(self, rid: int) -> bool:
        """Seeded mirror draw for fleet rid ``rid`` (pure function)."""
        if self.sample_p <= 0.0:
            return False
        if self.sample_p >= 1.0:
            return True
        h = zlib.crc32(f"{self.seed}:{rid}".encode()) % 1_000_000
        return h < int(self.sample_p * 1_000_000)

    @property
    def busy(self) -> bool:
        e = self.engine
        return (bool(e._queue) or e.free_slot_count() < e.slots
                or e._pending_seg is not None)

    def stats(self) -> dict:
        return {"mirrored": self.mirrored, "dropped": self.dropped,
                "compared": self.compared, "segments": self.segments,
                "sample_p": self.sample_p,
                "pending_pairs": len(self._awaiting),
                "ticks": self.engine.last_run_ticks}

    def reset(self) -> None:
        self.engine.reset_slots()
        self.monitor.reset()
        self.registry.reset()
        self.mirrored = self.dropped = self.compared = self.segments = 0
        self._map.clear()
        self._awaiting.clear()
        self._primary.clear()
        self._shadow.clear()


@dataclass
class FleetReport:
    """Measured outcome of one fleet ``serve()`` (times in seconds)."""
    replicas: int
    n_requests: int
    total_tokens: int
    makespan_s: float
    throughput_tok_s: float
    ttft_p50_s: float
    ttft_p99_s: float
    e2e_p50_s: float
    e2e_p99_s: float
    queue_wait_p50_s: float
    segments: int
    ticks: int
    backpressure_events: int       # == sum of per-replica counters
    dispatches_affinity: int
    dispatches_least_loaded: int
    # failover: replicas declared dead this serve, requests requeued to
    # survivors, final health per replica, and the last retry_after_s
    # backpressure hint (None: nothing was refused)
    failovers: int = 0
    requeued: int = 0
    replica_health: Optional[Dict[int, str]] = None
    retry_after_s: Optional[float] = None
    # the worst replica cold start (build to first token) and the
    # attached monitors' reports
    cold_start_s: Optional[float] = None
    slo: Optional[dict] = None
    perf: Optional[dict] = None
    # shadow and canary: the pairs' QualityMonitor report, the shadow's
    # own accounting, canary dispatches and the controller's verdicts
    dispatches_canary: int = 0
    quality: Optional[dict] = None
    shadow: Optional[dict] = None
    canary: Optional[dict] = None
    # directory steering: directory dispatches, cross-replica host-tier
    # imports, and the directory's stats (None without one)
    dispatches_directory: int = 0
    tier_migrations: int = 0
    directory: Optional[dict] = None
    # elastic scaling: scale actions of the serve and the attached
    # policies' reports (None without an autoscaler)
    scale_ups: int = 0
    scale_downs: int = 0
    autoscaler: Optional[dict] = None
    per_replica: List[dict] = field(default_factory=list)
    telemetry: Optional[dict] = None   # merge_log_dir reduction

    def as_dict(self, with_replicas: bool = True) -> dict:
        d = {k: v for k, v in self.__dict__.items()
             if k not in ("per_replica", "telemetry")}
        if with_replicas:
            d["per_replica"] = self.per_replica
        return d


class _Replica:
    """One engine with its own prefix cache, registry and counters."""

    _HEALTH_CODE = {"healthy": 0.0, "suspect": 1.0, "dead": 2.0}

    def __init__(self, idx: int, engine: ServingEngine, prefix_cache):
        self.idx = idx
        self.engine = engine
        self.prefix_cache = prefix_cache
        # pool role: None in a homogeneous fleet; "prefill" / "decode"
        # when a DisaggRouter owns the replica
        self.pool: Optional[str] = None
        self.registry = _metrics.Registry()
        self.backpressure_events = 0
        self.dispatches = {"affinity": 0, "least_loaded": 0,
                           "canary": 0, "directory": 0}
        self.segments = 0
        self.rids: List[int] = []          # fleet rids, assignment order
        # health: healthy -> suspect (a timeout or transient hang) ->
        # dead (repetition or crash) -> healthy again through a probe
        self.health = "healthy"
        self.timeouts = 0                  # consecutive slow segments
        self.dead_since = 0.0
        self.probes = 0
        # the elastic lifecycle, beside health: offline -> warming ->
        # serving -> draining -> offline. Without an autoscaler every
        # replica stays serving
        self.lifecycle = "serving"
        self.drain: Optional[dict] = None   # progress while draining
        self.last_drain: Optional[dict] = None
        self.warmed_s: Optional[float] = None  # its last activation warmup

    def set_health(self, state: str) -> None:
        self.health = state
        with _metrics.scoped_registry(self.registry):
            _metrics.gauge("fleet.replica_health").set(
                self._HEALTH_CODE[state])

    @property
    def queue_depth(self) -> int:
        return len(self.engine._queue)

    @property
    def live(self) -> int:
        return self.engine.slots - self.engine.free_slot_count()

    @property
    def load(self) -> int:
        return self.queue_depth + self.live

    @property
    def busy(self) -> bool:
        return bool(self.engine._queue) or self.live > 0


def build_fleet(cfg, params, n: int, devices: Optional[Sequence] = None,
                **engine_kw) -> List[ServingEngine]:
    """N identical engine replicas. With ``devices`` (torch devices or
    their names), replica i's parameters are moved to ``devices[i %
    len(devices)]`` with ``.to(device)`` and its engine is built there.
    Without, every replica shares ``params`` on the engine's own device
    (``engine_kw["device"]``: CUDA unless the caller asks for the CPU)."""
    engines = []
    for i in range(n):
        p, kw = params, engine_kw
        if devices:
            dev = torch.device(devices[i % len(devices)])
            p = {k: v.to(dev) for k, v in params.items()}
            kw = {**engine_kw, "device": dev}
        engines.append(ServingEngine(cfg, p, **kw))
    return engines


class FleetRouter:
    """Prefix-affinity + least-loaded router over N engine replicas.

    ``engines`` share one serving contract (same model). ``prefix_caches``:
    None (no caching), "auto" (one cache per replica through
    ``make_prefix_cache``: a cache belongs to its engine, never shared),
    or an explicit list. ``max_queue`` bounds each replica's intake
    queue; ``seg_steps`` is the per-segment step budget."""

    def __init__(self, engines: Sequence[ServingEngine],
                 max_queue: int = 64, seg_steps: int = 32,
                 prefix_caches=None, affinity_block: Optional[int] = None,
                 segment_timeout_s: Optional[float] = None,
                 max_finish_retries: int = 1, max_requeues: int = 3,
                 fault_injector: Optional[FaultInjector] = None,
                 probe_after_s: float = 0.05,
                 slo_monitor=None, perf_monitor=None,
                 shadow: Optional[Shadow] = None, canary=None,
                 directory: bool = False, autoscaler=None,
                 capacity_monitor=None):
        if not engines:
            raise ValueError("a fleet needs at least one engine")
        if prefix_caches == "auto":
            prefix_caches = [make_prefix_cache(e) for e in engines]
        elif prefix_caches is None:
            prefix_caches = [None] * len(engines)
        if len(prefix_caches) != len(engines):
            raise ValueError(f"{len(prefix_caches)} prefix caches for "
                             f"{len(engines)} engines")
        for e, pc in zip(engines, prefix_caches):
            if pc is not None and e.paged and getattr(pc, "pager",
                                                      None) is not e.pager:
                raise ValueError(
                    "paged replica's prefix cache must wrap ITS OWN "
                    "pager (fleet isolation: one cache per engine)")
        blocks = {pc.block for pc in prefix_caches if pc is not None}
        if len(blocks) > 1:
            raise ValueError(f"replica caches disagree on block size "
                             f"{sorted(blocks)} — affinity hashing needs "
                             f"one alignment rule")
        self._replicas = [_Replica(i, e, pc)
                          for i, (e, pc) in enumerate(zip(engines,
                                                          prefix_caches))]
        self.max_queue = int(max_queue)
        self.seg_steps = int(seg_steps)
        self.affinity_block = int(affinity_block
                                  or (next(iter(blocks)) if blocks else 32))
        # affinity routes repeat prefixes back to the replica whose CACHE
        # holds them; without caches the router is least-loaded only
        self._use_affinity = any(pc is not None for pc in prefix_caches)
        self.backpressure_events = 0
        self._reqs: Dict[int, tuple] = {}   # fleet rid -> (replica, Request)
        self._next_rid = 0
        # failover knobs. segment_timeout_s: a finish slower than this
        # marks the replica suspect (None: timeouts off, the default, so
        # a loaded machine does not declare its own replicas dead);
        # max_finish_retries: re-attempts of a hung fetch before the
        # replica is dead; max_requeues: per-request failover budget
        self.segment_timeout_s = segment_timeout_s
        self.max_finish_retries = int(max_finish_retries)
        self.max_requeues = int(max_requeues)
        self.fault_injector = fault_injector
        self.probe_after_s = float(probe_after_s)
        # fleet-level monitors, fed from the stamps taken at each
        # segment's fetch; their gauges are the process (fleet) view, so
        # they are fed outside the replicas' scoped registries
        self.slo_monitor = slo_monitor
        self.perf_monitor = perf_monitor
        # the shadow OBSERVES (mirrored traffic, own engine, fetch and
        # registry, journal-marked records, never a routing input); the
        # canary DECIDES (a seeded weight of live traffic routes to its
        # replica, control traffic never does)
        self.shadow = shadow
        if shadow is not None:
            if any(r.engine is shadow.engine for r in self._replicas):
                raise ValueError(
                    "shadow engine must not be a fleet replica — it "
                    "runs the variant config off the primary path")
        self.canary = canary
        if canary is not None:
            if not 0 <= canary.replica < len(self._replicas):
                raise ValueError(
                    f"canary replica {canary.replica} out of range for "
                    f"a {len(self._replicas)}-replica fleet")
            if len(self._replicas) < 2:
                raise ValueError(
                    "a canary needs >= 2 replicas: the canary replica "
                    "is excluded from control traffic, so a 1-replica "
                    "fleet would have no control population")
        # the cache directory (opt-in: blind affinity stays the default)
        self.directory: Optional[CacheDirectory] = None
        if directory:
            paged_pcs = [(i, pc) for i, pc in enumerate(prefix_caches)
                         if pc is not None and hasattr(pc, "pager")]
            if not paged_pcs:
                raise ValueError(
                    "directory steering needs paged prefix caches — it "
                    "routes on the caches' live entry state")
            self.directory = CacheDirectory(paged_pcs[0][1].block)
            for i, pc in paged_pcs:
                self.directory.attach(i, pc)
        self.tier_migrations = 0            # cross-replica imports
        self.failovers = 0                  # replicas declared dead
        self.requeued = 0                   # requests moved to survivors
        self.last_retry_after_s: Optional[float] = None
        self._finished_count = 0
        self._serve_t0 = 0.0
        # fed fleet-wide at every segment finish (host ints): the
        # autoscaler's capacity input
        self.capacity_monitor = capacity_monitor
        # one scaling policy, or a list (a DisaggRouter's one per pool);
        # a policy decides, so its config rides the journal header
        self.autoscalers: list = []
        self.warm_envelope = None           # the last aot_warmup's
        self._attach_autoscalers(autoscaler)

    def _attach_autoscalers(self, autoscaler) -> None:
        """Bind the scaling policies (apart from ``__init__`` so that a
        pool-aware subclass binds them once its replicas carry pool
        tags)."""
        if autoscaler is None:
            return
        ascs = (list(autoscaler)
                if isinstance(autoscaler, (list, tuple))
                else [autoscaler])
        self.autoscalers.extend(ascs)
        for asc in ascs:
            asc.bind(self)

    def aot_warmup(self, envelope=None) -> Dict[int, dict]:
        """Run every replica's program space once ahead of serving
        (``ServingEngine.aot_warmup``, under ``envelope`` or each engine's
        default), each in its replica's registry and rank scope. A
        standby the autoscaler activates later warms the same
        ``envelope``."""
        self.warm_envelope = envelope
        out: Dict[int, dict] = {}
        for r in self._replicas:
            with _metrics.scoped_registry(r.registry), \
                    _journal.rank_scope(r.idx):
                out[r.idx] = r.engine.aot_warmup(
                    envelope, prefix_cache=r.prefix_cache)
        return out

    # --- routing ---------------------------------------------------------
    def _affinity_key(self, prompt: np.ndarray) -> Optional[bytes]:
        """Block-aligned STRICT prefix bytes (the prefix caches' rule: at
        least one token must remain to prefill), or None when the prompt
        is too short to carry a cacheable prefix."""
        b = self.affinity_block
        cap = (len(prompt) // b) * b
        if cap == len(prompt):
            cap -= b
        if cap <= 0:
            return None
        return np.asarray(prompt[:cap], np.int32).tobytes()

    def _page_ready(self, r: _Replica, a: Arrival) -> bool:
        eng = r.engine
        if not eng.paged:
            return True
        need = eng.pager.pages_needed(len(a.prompt) + a.max_new_tokens - 1)
        return eng.pager.pages_free >= need

    def _dispatch_candidates(self) -> List[_Replica]:
        """The replicas fresh arrivals may route to: the serving ones
        (warming replicas are not ready, draining ones are being emptied,
        offline ones are standbys). A pool-aware subclass
        (``DisaggRouter``) narrows this to its prefill pool."""
        return [r for r in self._replicas if r.lifecycle == "serving"]

    def _route(self, a: Arrival, dirinfo: Optional[dict] = None):
        """(replica, reason) for a due arrival, or (bill_target, None)
        when every queue is full (fleet backpressure). Suspect and dead
        replicas are excluded: an affinity pin to an unhealthy replica
        falls through to least-loaded over the healthy set, and only
        when no healthy replica can take it do suspects (never the dead)
        take traffic.

        A directory hit (``dirinfo``) outranks the affinity hash: the
        request goes to a replica that holds its prefix (resident tiers
        before the host tier: a restore costs an upload) if one can take
        it now; otherwise it falls through, and the miss becomes a
        migration (``_migrate``).

        With a canary, a seeded draw on the rid this arrival will take
        routes ``weight`` of traffic to the canary replica (healthy, with
        queue and page room: a degraded canary falls back to control),
        and control traffic never lands on the canary replica."""
        can = self.canary
        ctl = self._dispatch_candidates()
        if can is not None:
            crep = self._replicas[can.replica]
            if (can.assign(self._next_rid) and crep.health == "healthy"
                    and crep.lifecycle == "serving"
                    and crep.queue_depth < self.max_queue
                    and self._page_ready(crep, a)):
                return crep, "canary"
            ctl = [r for r in ctl if r.idx != can.replica]
        if dirinfo is not None:
            owners = dirinfo["owners"]
            dcands = [r for r in ctl
                      if r.idx in owners and r.health == "healthy"
                      and r.queue_depth < self.max_queue
                      and self._page_ready(r, a)]
            if dcands:
                best = min(dcands,
                           key=lambda r: (owners[r.idx]["tier"] == "host",
                                          r.load, r.idx))
                return best, "directory"
        key = (self._affinity_key(a.prompt)
               if self._use_affinity else None)
        pref = (ctl[zlib.crc32(key) % len(ctl)]
                if key is not None else None)
        if (pref is not None and pref.health == "healthy"
                and pref.queue_depth < self.max_queue):
            return pref, "affinity"
        cands = [r for r in ctl
                 if r.queue_depth < self.max_queue
                 and r.health == "healthy"]
        if not cands:
            cands = [r for r in ctl
                     if r.queue_depth < self.max_queue
                     and r.health == "suspect"]
        if not cands:
            # every takeable queue full: bill the replica the request
            # WOULD have gone to, so fleet backpressure is the sum of the
            # replica counters
            bill = pref if pref is not None else \
                min(ctl, key=lambda r: (r.load, r.idx))
            return bill, None
        best = min(cands, key=lambda r: (not self._page_ready(r, a),
                                         r.load, r.idx))
        return best, "least_loaded"

    def _migrate(self, dirinfo: dict, dst: _Replica,
                 rid: int) -> Optional[tuple]:
        """Import ``dirinfo``'s prefix from an owning replica's HOST tier
        into ``dst``'s cache: host-tier pages are replica-portable bytes,
        so a steering miss costs a host-to-host copy instead of a prefill.
        The freshest staged owner wins; an owner whose entry never
        finished staging cannot export and is skipped. Returns (pages,
        bytes) imported, or None."""
        pc = dst.prefix_cache
        if pc is None or getattr(pc, "host_tier", None) is None:
            return None
        owners = sorted(dirinfo["owners"].items(),
                        key=lambda kv: -kv[1]["touch"])
        for idx, _info in owners:
            src = self._replicas[idx].prefix_cache
            if src is None or not hasattr(src, "export_host"):
                continue
            exp = src.export_host(dirinfo["key"])
            if exp is None:
                continue
            planes = {p: exp[p] for p in exp
                      if p not in ("tokens", "pages")}
            if not pc.import_host(exp["tokens"], planes):
                continue
            n = int(exp["pages"])
            nbytes = n * pc.host_tier.page_bytes()
            self.tier_migrations += 1
            _metrics.counter("fleet.tier_migrations").inc()
            _flight.record("tier_migrate", rid=rid, src=idx,
                           dst=dst.idx, pages=n, bytes=nbytes,
                           rows=int(len(exp["tokens"])))
            return n, nbytes
        return None

    # --- intake ----------------------------------------------------------
    def _ingest(self, pending: List[Arrival], now: float, t0: float) -> int:
        refused = 0
        _j = _journal.active()
        while pending and pending[0].t <= now:
            a = pending[0]
            dirinfo = (self.directory.lookup(a.prompt)
                       if self.directory is not None else None)
            rep, reason = self._route(a, dirinfo)
            cands = None
            if _j is not None:
                # the dispatch decision with the per-replica state the
                # router compared (load, health, pool, lifecycle, pages,
                # directory hit), snapshotted before intake changes it
                owners = dirinfo["owners"] if dirinfo is not None else {}
                cands = [{"idx": x.idx, "health": x.health,
                          "pool": x.pool, "lifecycle": x.lifecycle,
                          "queue": x.queue_depth, "live": x.live,
                          "page_ready": self._page_ready(x, a),
                          "pages_free": (x.engine.pager.pages_free
                                         if x.engine.paged else None),
                          "reclaimable": (
                              x.prefix_cache.reclaimable_pages()
                              if x.engine.paged
                              and x.prefix_cache is not None
                              and hasattr(x.prefix_cache,
                                          "reclaimable_pages") else
                              (0 if x.engine.paged else None)),
                          "dir_hit": (dirinfo["rows"]
                                      if x.idx in owners else 0),
                          "dir_tier": (owners[x.idx]["tier"]
                                       if x.idx in owners else None)}
                         for x in self._replicas]
                if reason is None:          # refusal: no rid assigned
                    _j.record("dispatch", rid=None, replica=rep.idx,
                              reason="backpressure", candidates=cands)
            if reason is None:
                refused += 1
                rep.backpressure_events += 1
                self.backpressure_events += 1
                hint = self.retry_after_hint(now)
                self.last_retry_after_s = hint
                with _metrics.scoped_registry(rep.registry):
                    _metrics.counter("serving.backpressure_events").inc()
                _metrics.counter("fleet.backpressure_events").inc()
                _metrics.gauge("fleet.retry_after_s").set(hint)
                _flight.record("backpressure", replica=rep.idx,
                               queue=rep.queue_depth, fleet=True,
                               retry_after_s=round(hint, 4))
                break                       # arrival stays client-side
            pending.pop(0)
            rid = self._next_rid
            self._next_rid += 1
            # migration on a miss: the steered owner could not take this
            # arrival and the chosen replica does not hold the prefix
            imported = None
            if (dirinfo is not None and reason != "directory"
                    and rep.idx not in dirinfo["owners"]):
                imported = self._migrate(dirinfo, rep, rid)
            erid = rep.engine.add_request(a.prompt, a.max_new_tokens)
            req = rep.engine._queue[-1]
            assert req.rid == erid
            req.arrival_time = t0 + a.t
            if imported is not None:
                req.tier_pages += imported[0]
                req.tier_bytes += imported[1]
            self._reqs[rid] = (rep.idx, req)
            rep.rids.append(rid)
            _journal.record("arrival", rid=rid, at=a.t, replica=rep.idx,
                            erid=erid, prompt_len=len(req.prompt),
                            gen=req.max_new_tokens)
            if _j is not None:
                _j.record("dispatch", rid=rid, replica=rep.idx,
                          reason=reason, candidates=cands)
            rep.dispatches[reason] += 1
            _metrics.counter(f"fleet.dispatches.{reason}").inc()
            with _metrics.scoped_registry(rep.registry):
                _metrics.gauge("fleet.replica_queue_depth").set(
                    rep.queue_depth)
            _flight.record("fleet_dispatch", rid=rid, replica=rep.idx,
                           reason=reason, queue=rep.queue_depth)
            if self.shadow is not None and self.shadow.wants(rid):
                self._mirror_to_shadow(rid, req)
        return refused

    # --- shadow serving ----------------------------------------------------
    def _mirror_to_shadow(self, rid: int, req: Request) -> None:
        """Queue a mirror of one admitted request on the shadow engine,
        inside the shadow scope and registry."""
        sh = self.shadow
        eng = sh.engine
        if (len(req.prompt) > max(eng.buckets)
                or len(req.prompt) + req.max_new_tokens - 1 > eng.max_len):
            sh.dropped += 1     # the variant's geometry can't hold it
            return
        with _journal.shadow_scope(), \
                _metrics.scoped_registry(sh.registry):
            serid = eng.add_request(np.asarray(req.prompt, np.int32),
                                    req.max_new_tokens)
            sh._map[serid] = rid
            sh._awaiting.add(rid)
            sh.mirrored += 1
            _journal.record("shadow_mirror", rid=rid, shadow_rid=serid)

    def _shadow_step(self, now_abs: float) -> None:
        """Advance the shadow by at most one finish and one dispatch,
        after this loop turn's primary work. ``now_abs`` is the turn's
        already-read clock: the shadow adds no clock read."""
        sh = self.shadow
        if sh is None:
            return
        eng = sh.engine
        with _journal.shadow_scope():
            finished = False
            with _metrics.scoped_registry(sh.registry):
                if eng._pending_seg is not None:
                    eng.finish_segment()
                    sh.segments += 1
                    finished = True
            if finished:
                # pair collection runs outside the shadow's registry: the
                # quality metrics are the process (fleet) view
                self._collect_shadow()
            with _metrics.scoped_registry(sh.registry):
                if ((eng._queue or eng.free_slot_count() < eng.slots)
                        and eng._pending_seg is None):
                    eng.dispatch_segment(
                        sh.seg_steps if sh.seg_steps else self.seg_steps,
                        now=now_abs)

    def _collect_shadow(self) -> None:
        """Harvest finished shadow requests (tokens and digests) and diff
        any completed pairs."""
        sh = self.shadow
        eng = sh.engine
        if not eng._finished:
            return
        digs = {r.rid: r.digests for r in eng._finished}
        done = eng.collect_finished()
        for serid, toks in done.items():
            rid = sh._map.pop(serid, None)
            if rid is None:
                continue
            d = digs.get(serid)
            sh._shadow[rid] = (toks, d[:len(toks)] if d else None)
            self._compare_pair(rid)

    def _collect_primary(self, rep: _Replica, ev: dict) -> None:
        """The primary side of a pair: at a mirrored request's finish,
        its final token stream (and digests), host mirrors of the fetch
        that just completed."""
        sh = self.shadow
        by_erid = {self._reqs[rid][1].rid: rid for rid in rep.rids}
        for erid in ev["finished"]:
            frid = by_erid[erid]
            if frid not in sh._awaiting:
                continue
            req = self._reqs[frid][1]
            toks = _quality.final_tokens(req.tokens, req.max_new_tokens,
                                         rep.engine.eos)
            digs = (req.digests[:len(toks)] if req.digests else None)
            with _journal.shadow_scope():
                sh._primary[frid] = (toks, digs, req.priority)
                self._compare_pair(frid)

    def _compare_pair(self, rid: int) -> None:
        """Diff a mirrored pair once BOTH sides finished (the caller
        holds the shadow scope)."""
        sh = self.shadow
        if rid not in sh._primary or rid not in sh._shadow:
            return
        p_toks, p_digs, prio = sh._primary.pop(rid)
        s_toks, s_digs = sh._shadow.pop(rid)
        sh._awaiting.discard(rid)
        res = sh.monitor.note_pair(rid, p_toks, s_toks, p_digs, s_digs,
                                   cls=prio)
        sh.compared += 1
        _journal.record("shadow_finish", rid=rid, match=res["match"],
                        first_divergence=res["first_divergence"],
                        compared=res["compared"])

    def _drain_shadow(self) -> None:
        """Finish the shadow's remaining mirrors after the primary trace
        completed (its makespan already stamped), inside the shadow
        scope."""
        sh = self.shadow
        if sh is None:
            return
        with _journal.shadow_scope():
            while sh.busy:
                self._shadow_step(_journal.now())

    # --- the serve loop --------------------------------------------------
    def serve(self, arrivals: Sequence[Arrival], warm: bool = False
              ) -> FleetReport:
        """Serve the trace to completion across the fleet and return the
        measured report. ``warm=True`` serves the trace once first, then
        resets all fleet state, so the measured pass times routing and
        scheduling."""
        if warm:
            self.serve(arrivals, warm=False)
            self.reset()

        _j = _journal.active()
        if _j is not None:
            _j.begin_serve(self._journal_header(arrivals))
        pending = sorted(arrivals, key=lambda a: a.t)
        reps = self._replicas
        for r in reps:
            r.engine.last_run_ticks = 0
            r.engine.last_run_chunks = 0
        segments = 0
        # a staggered pipeline: every busy replica keeps one segment in
        # flight, and each turn finishes only the OLDEST, re-ingests
        # arrivals and tops the fleet back up
        inflight: List[tuple] = []          # (replica, handle, t_disp) FIFO
        t0 = _journal.now()
        self._serve_t0 = t0
        self._finished_count = 0
        self.last_retry_after_s = None
        while (pending or inflight or any(r.busy for r in reps)
               or self._has_deferred_work()):
            now = _journal.now() - t0
            self._probe_dead()
            self._ingest(pending, now, t0)
            # the elastic control loop, on the turn's clock reading (no
            # read of its own)
            self._autoscale(now)
            # dead replicas are out of rotation (abort emptied them);
            # suspects still drain their own backlog
            busy_idle = [r for r in reps
                         if r.health != "dead" and r.busy
                         and r.engine._pending_seg is None]
            for r in busy_idle:
                # deferred cross-replica work (a DisaggRouter's handoffs)
                # lands before any dispatch
                self._pre_dispatch(r)
                with _metrics.scoped_registry(r.registry), \
                        _journal.rank_scope(r.idx):
                    h = r.engine.dispatch_segment(
                        self._seg_steps_for(r),
                        prefix_cache=r.prefix_cache)
                inflight.append((r, h, _journal.now()))
            # the shadow steps after this turn's primary dispatches, on
            # the already-read clock
            self._shadow_step(now + t0)
            if not inflight:
                if self._has_deferred_work():
                    # nothing in flight to coalesce behind: land the
                    # deferred work now
                    self._pre_dispatch(None)
                elif pending:
                    gap = pending[0].t - (_journal.now() - t0)
                    if gap > 0:
                        _journal.sleep(min(gap, 0.05))
                elif any(r.health == "dead" for r in reps):
                    _journal.sleep(0.001)   # wait out the probe window
                continue
            # finish the oldest segment in flight (its one counted fetch)
            # under the failure protocol
            r, h, t_disp = inflight.pop(0)
            if self._finish_one(r, h, t_disp):
                segments += 1
        if self.autoscalers:
            # the last policy step completes the drains of replicas that
            # just emptied (a clock read only when a policy is attached)
            self._autoscale(_journal.now() - t0, final=True)
        makespan = _journal.now() - t0
        # the shadow drains after the makespan stamp, and the canary
        # gives its final verdict
        self._drain_shadow()
        if self.canary is not None:
            self.canary.evaluate(final=True)

        reqs = [req for _, req in self._reqs.values()]
        assert all(
            req.done or (reps[i].engine.eos is not None
                         and reps[i].engine.eos in req.tokens)
            for i, req in self._reqs.values()), \
            "fleet exited with unserved requests"
        total_tokens = sum(len(r.tokens) for r in reqs)
        ttfts = [r.first_token_time - r.arrival_time for r in reqs]
        e2es = [r.finish_time - r.arrival_time for r in reqs]
        qwaits = [r.admit_time - r.arrival_time for r in reqs]
        assert self.backpressure_events == sum(r.backpressure_events
                                               for r in reps)
        return FleetReport(
            replicas=len(reps),
            n_requests=len(reqs),
            total_tokens=total_tokens,
            makespan_s=makespan,
            throughput_tok_s=total_tokens / makespan if makespan else 0.0,
            ttft_p50_s=_pctl(ttfts, 0.50),
            ttft_p99_s=_pctl(ttfts, 0.99),
            e2e_p50_s=_pctl(e2es, 0.50),
            e2e_p99_s=_pctl(e2es, 0.99),
            queue_wait_p50_s=_pctl(qwaits, 0.50),
            segments=segments,
            ticks=sum(r.engine.last_run_ticks for r in reps),
            backpressure_events=self.backpressure_events,
            dispatches_affinity=sum(r.dispatches["affinity"]
                                    for r in reps),
            dispatches_least_loaded=sum(r.dispatches["least_loaded"]
                                        for r in reps),
            dispatches_canary=sum(r.dispatches.get("canary", 0)
                                  for r in reps),
            dispatches_directory=sum(r.dispatches.get("directory", 0)
                                     for r in reps),
            tier_migrations=self.tier_migrations,
            directory=(self.directory.stats()
                       if self.directory is not None else None),
            quality=(self.shadow.monitor.report()
                     if self.shadow is not None else None),
            shadow=(self.shadow.stats()
                    if self.shadow is not None else None),
            canary=(self.canary.report()
                    if self.canary is not None else None),
            failovers=self.failovers,
            requeued=self.requeued,
            replica_health={r.idx: r.health for r in reps},
            scale_ups=sum(a.scale_ups for a in self.autoscalers),
            scale_downs=sum(a.scale_downs for a in self.autoscalers),
            autoscaler=({"policies": [a.report()
                                      for a in self.autoscalers]}
                        if self.autoscalers else None),
            retry_after_s=self.last_retry_after_s,
            cold_start_s=max(
                (round(r.engine.cold_start_s, 4) for r in reps
                 if r.engine.cold_start_s is not None), default=None),
            slo=(self.slo_monitor.report()
                 if self.slo_monitor is not None else None),
            perf=(self.perf_monitor.end_interval()
                  if self.perf_monitor is not None else None),
            per_replica=[{
                "replica": r.idx,
                "requests": len(r.rids),
                "tokens": sum(len(self._reqs[rid][1].tokens)
                              for rid in r.rids),
                "segments": r.segments,
                "ticks": r.engine.last_run_ticks,
                "health": r.health,
                "lifecycle": r.lifecycle,
                "probes": r.probes,
                "cold_start_s": (round(r.engine.cold_start_s, 4)
                                 if r.engine.cold_start_s is not None
                                 else None),
                "backpressure_events": r.backpressure_events,
                "dispatches": dict(r.dispatches),
                "prefix": (r.prefix_cache.stats()
                           if r.prefix_cache is not None else None),
                "pages": (r.engine.pager.stats()
                          if r.engine.paged else None),
            } for r in reps],
        )

    # --- failure protocol --------------------------------------------------
    def retry_after_hint(self, now: float) -> float:
        """Backoff hint for a refused client: elapsed time per finished
        request, clamped to [1 ms, 60 s] (1 s before any finish), fed by
        the fleet-wide finish counter. Draining replicas still finish
        their backlog but admit nothing, so the hint scales by live over
        serving replicas: it quotes the capacity a retry can reach."""
        if self._finished_count and now > 0:
            base = now / self._finished_count
            serving = [r for r in self._replicas
                       if r.lifecycle == "serving" and r.health != "dead"]
            live = [r for r in self._replicas
                    if r.lifecycle in ("serving", "draining")
                    and r.health != "dead"]
            if serving and len(live) > len(serving):
                base *= len(live) / len(serving)
            return min(max(base, 1e-3), 60.0)
        return 1.0

    def _finish_one(self, rep: _Replica, h, t_disp: float) -> bool:
        """Fetch one dispatched segment under the failure protocol.
        Returns True when its results were applied; False when the
        replica died and the segment was discarded (its requests failed
        over inside ``_kill_replica``).

        * ``ReplicaCrash``: dead at once; the event log in flight is
          lost, and its requests resume elsewhere from their last READ
          token.
        * ``ReplicaHang``: suspect; the fetch is retried up to
          ``max_finish_retries`` times, then the replica is dead.
        * a fetch slower than ``segment_timeout_s``: suspect on the
          first, dead on the second consecutive one; a fast segment
          clears suspect. A slow segment's results are real and are
          applied either way."""
        attempts = 0
        while True:
            try:
                if self.fault_injector is not None:
                    self.fault_injector.on_finish(rep.idx, rep.segments)
                with _metrics.scoped_registry(rep.registry), \
                        _journal.rank_scope(rep.idx):
                    ev = rep.engine.finish_segment(h)
                    t_sync = _journal.now()
                    outcomes = self._stamp(rep, ev, t_sync)
                break
            except ReplicaCrash as e:
                self._kill_replica(rep, f"crash: {e}")
                return False
            except ReplicaHang as e:
                attempts += 1
                if rep.health == "healthy":
                    rep.set_health("suspect")
                    _flight.record("replica_suspect", replica=rep.idx,
                                   reason="hang")
                if attempts > self.max_finish_retries:
                    self._kill_replica(
                        rep, f"hang persisted through {attempts - 1} "
                             f"retries: {e}")
                    return False
                _metrics.counter("fleet.finish_retries").inc()
        rep.segments += 1
        self._finished_count += len(ev["finished"])
        # shadow pairs and canary outcomes: host mirrors of the fetch
        # above, outside the replica's registry (the fleet view)
        if self.shadow is not None and ev["finished"]:
            self._collect_primary(rep, ev)
        if self.canary is not None and outcomes:
            grp = ("canary" if rep.idx == self.canary.replica
                   else "control")
            for kind, prio, lat in outcomes:
                self.canary.note_outcome(grp, kind, prio, lat)
        if self.slo_monitor is not None:
            for kind, prio, lat in outcomes:
                (self.slo_monitor.note_ttft if kind == "ttft"
                 else self.slo_monitor.note_e2e)(prio, lat)
            sp = ev.get("spec")
            if sp and sp.get("proposed"):
                self.slo_monitor.note_accept_rate(
                    sp["accepted"] / sp["proposed"])
            self.slo_monitor.end_segment()
        if self.perf_monitor is not None:
            self.perf_monitor.note_segment(ev["steps"],
                                           ev.get("tokens", 0),
                                           elapsed_s=t_sync - t_disp)
        # the fleet-wide capacity feed: the pages the just-admitted
        # requests reserve close the demand bucket, then a new segment
        # opens on the serving replicas' free and reclaimable pages (a
        # draining replica's pages are not capacity to count on)
        if self.capacity_monitor is not None:
            cm = self.capacity_monitor
            if rep.engine.paged and ev["admitted"]:
                by_erid = {self._reqs[rid][1].rid: self._reqs[rid][1]
                           for rid in rep.rids}
                need = sum(
                    rep.engine.pager.pages_needed(
                        len(by_erid[erid].prompt)
                        + by_erid[erid].max_new_tokens - 1)
                    for erid in ev["admitted"])
                cm.note_admission(need, admitted=len(ev["admitted"]))
            cm.close_segment()
            free = sum(x.engine.pager.pages_free
                       for x in self._replicas
                       if x.engine.paged and x.lifecycle == "serving"
                       and x.health != "dead")
            reclaim = sum(
                x.prefix_cache.reclaimable_pages()
                for x in self._replicas
                if x.engine.paged and x.lifecycle == "serving"
                and x.health != "dead" and x.prefix_cache is not None
                and hasattr(x.prefix_cache, "reclaimable_pages"))
            cm.begin_segment(free, reclaim)
        # the DisaggRouter's handoff sweep runs here, with the engine
        # idle and the segment's event log applied
        self._post_segment(rep, ev)
        if attempts and rep.health == "suspect":
            # a retried fetch came back: the hang was transient
            rep.set_health("healthy")
            _flight.record("replica_recovered", replica=rep.idx,
                           via="finish_retry")
        elapsed = t_sync - t_disp
        if (self.segment_timeout_s is not None
                and elapsed > self.segment_timeout_s):
            rep.timeouts += 1
            if rep.timeouts >= 2:
                self._kill_replica(
                    rep, f"two consecutive segment timeouts "
                         f"({elapsed:.3f}s > {self.segment_timeout_s}s)")
                return True                 # this segment's tokens are real
            rep.set_health("suspect")
            _flight.record("replica_suspect", replica=rep.idx,
                           reason="timeout", elapsed_s=round(elapsed, 4))
        elif self.segment_timeout_s is not None:
            rep.timeouts = 0
            if rep.health == "suspect":
                rep.set_health("healthy")
                _flight.record("replica_recovered", replica=rep.idx,
                               via="fast_segment")
        return True

    def _post_segment(self, rep: _Replica, ev: dict) -> None:
        """Hook after a fetched segment's results are applied and the
        monitors fed, with ``rep``'s engine idle. A no-op here; the
        ``DisaggRouter`` runs its prefill -> decode handoff sweep."""

    def _pre_dispatch(self, rep: Optional[_Replica]) -> None:
        """Hook right before each segment dispatch (and from the idle
        branch with ``rep=None``), where work deferred across loop turns
        lands on its target replicas. A no-op here; the ``DisaggRouter``
        drains its parked handoffs under one tier flush."""

    def _has_deferred_work(self) -> bool:
        """True while cross-replica work is parked for the next
        ``_pre_dispatch`` (it keeps the loop alive when every engine is
        idle). The homogeneous fleet defers nothing."""
        return False

    def _seg_steps_for(self, rep: _Replica) -> int:
        """Per-replica segment budget: one knob here, one per pool in
        the ``DisaggRouter``."""
        return self.seg_steps

    def _failover_target(self, survivors: List[_Replica],
                         req: Request) -> _Replica:
        """The survivor a failed-over request requeues onto: the least
        loaded here; the ``DisaggRouter`` keeps pool discipline."""
        return min(survivors, key=lambda x: (x.load, x.idx))

    def _kill_replica(self, rep: _Replica, reason: str) -> None:
        """Declare ``rep`` dead and fail everything it owed over to the
        survivors (zero loss): queued requests, live slots and the picked
        requests of a dispatched-but-lost segment requeue onto the
        least-loaded healthy replica, each resuming from its last READ
        token; greedy decode regenerates the same continuation."""
        rep.set_health("dead")
        rep.timeouts = 0
        rep.probes = 0
        rep.dead_since = _journal.now()
        self.failovers += 1
        _metrics.counter("fleet.replica_deaths").inc()
        _flight.record("replica_dead", replica=rep.idx, reason=reason)
        orphans = rep.engine.abort()
        if rep.prefix_cache is not None:
            # cache page refs pin the dead pool: drop them so the reset
            # pool audits clean for re-admission
            rep.prefix_cache.reset()
        if not orphans:
            return
        survivors = [x for x in self._replicas
                     if x.health == "healthy"
                     and x.lifecycle == "serving"]
        if not survivors:
            raise RuntimeError(
                f"replica {rep.idx} died with {len(orphans)} in-flight "
                f"requests and no healthy survivor to requeue onto")
        orphan_ids = {id(q) for q in orphans}
        moved = sorted(((frid, req) for frid, (ridx, req)
                        in self._reqs.items()
                        if ridx == rep.idx and id(req) in orphan_ids),
                       key=lambda t: t[0])
        for frid, req in moved:
            req.requeues += 1
            if req.requeues > self.max_requeues:
                raise RuntimeError(
                    f"request {frid} exceeded {self.max_requeues} "
                    f"failover requeues — replicas are dying faster "
                    f"than the fleet can serve")
            tgt = self._failover_target(survivors, req)
            if len(req.prompt) + len(req.tokens) > max(tgt.engine.buckets):
                # the grown resume prompt no longer fits an admit window:
                # rewind, and greedy decode regenerates the same stream
                req.tokens = []
            req.rid = tgt.engine._next_rid   # fresh engine-local rid
            tgt.engine._next_rid += 1
            tgt.engine._queue.append(req)
            self._reqs[frid] = (tgt.idx, req)
            tgt.rids.append(frid)
            rep.rids.remove(frid)
            self.requeued += 1
            _metrics.counter("fleet.failover_requeued").inc()
            _flight.record("failover_requeue", rid=frid, src=rep.idx,
                           dst=tgt.idx, tokens_kept=len(req.tokens))

    def _probe_dead(self) -> None:
        """Re-admission probes: after ``probe_after_s`` a dead replica is
        probed (through the injector when one is installed); success
        puts it back in the healthy rotation, failure re-arms the
        wait."""
        for rep in self._replicas:
            if rep.health != "dead":
                continue
            if _journal.now() - rep.dead_since < self.probe_after_s:
                continue
            rep.probes += 1
            ok = (self.fault_injector.on_probe(rep.idx, rep.probes)
                  if self.fault_injector is not None else True)
            _metrics.counter("fleet.probes").inc()
            _journal.record("probe", replica=rep.idx,
                            probe_no=rep.probes, recovered=ok)
            if ok:
                rep.timeouts = 0
                rep.set_health("healthy")
                _flight.record("replica_recovered", replica=rep.idx,
                               via="probe", probes=rep.probes)
            else:
                rep.dead_since = _journal.now()

    # --- the elastic lifecycle -----------------------------------------------
    def _autoscale(self, now: float, final: bool = False) -> None:
        """One control-loop turn of every attached policy, on the loop's
        clock reading."""
        for asc in self.autoscalers:
            asc.step(now, final=final)

    def _warmup_envelope_for(self, rep: _Replica):
        """The envelope a replica activated mid-serve warms: the one the
        fleet's ``aot_warmup`` was given, else None, the engine's default
        (a ``DisaggRouter`` returns its pool's)."""
        return self.warm_envelope

    def _activate_replica(self, rep: _Replica) -> dict:
        """Bring an offline standby into the rotation, its warmup paid
        first: the whole program space runs (``aot_warmup``) before its
        lifecycle turns ``serving``, so a scale-up never meets a key it has
        not run. The two clock reads around the warmup are journaled, so
        a replay is fed the measured cost."""
        if rep.lifecycle != "offline":
            raise RuntimeError(f"activating replica {rep.idx} in "
                               f"lifecycle {rep.lifecycle!r}")
        rep.lifecycle = "warming"
        env = self._warmup_envelope_for(rep)
        t0 = _journal.now()
        with _metrics.scoped_registry(rep.registry), \
                _journal.rank_scope(rep.idx):
            fams = rep.engine.aot_warmup(env,
                                         prefix_cache=rep.prefix_cache)
        warm_s = _journal.now() - t0
        rep.lifecycle = "serving"
        rep.warmed_s = warm_s
        _flight.record("replica_warmed", replica=rep.idx,
                       seconds=round(warm_s, 6),
                       keys=sum(d["keys"] for d in fams.values()))
        return {"seconds": warm_s, "families": fams}

    def _begin_drain(self, rep: _Replica, now: float) -> dict:
        """Start a polite scale-down of ``rep``: it stops admitting (its
        lifecycle leaves the dispatch candidates), its cached prefixes
        move to the survivors' host tiers and its queued requests requeue
        onto them (the failover requeue, run on purpose); its live slots
        finish in place, and ``_finalize_drain`` runs from the policy step
        once it is empty."""
        if rep.lifecycle != "serving":
            raise RuntimeError(f"draining replica {rep.idx} in lifecycle "
                               f"{rep.lifecycle!r}")
        rep.lifecycle = "draining"
        rep.drain = {"since": now, "requeued": 0,
                     "prefixes_migrated": 0, "pages_migrated": 0}
        survivors = [x for x in self._replicas
                     if x is not rep and x.lifecycle == "serving"
                     and x.health == "healthy"]
        self._drain_prefixes(rep, survivors)
        self._drain_requeue(rep, survivors)
        return rep.drain

    def _drain_prefixes(self, rep: _Replica,
                        survivors: List[_Replica]) -> None:
        """Move the draining replica's cached prefixes to survivor host
        tiers (``export_host`` -> ``import_host``), so repeat traffic keeps
        hitting after it leaves: the hottest first with a directory (its
        placements' touch order), else in the cache's insertion order.
        Each move is a journaled ``tier_migrate`` decision."""
        pc = rep.prefix_cache
        if (pc is None or not hasattr(pc, "export_host")
                or getattr(pc, "host_tier", None) is None):
            return
        targets = [x for x in survivors
                   if x.prefix_cache is not None
                   and getattr(x.prefix_cache, "host_tier", None)
                   is not None]
        if not targets:
            return
        if self.directory is not None:
            keys = sorted(
                (k for k, owners in self.directory._owners.items()
                 if rep.idx in owners),
                key=lambda k: -self.directory._owners[k][rep.idx]["touch"])
            seen = set(keys)
            keys += [k for k in pc._entries if k not in seen]
        else:
            keys = list(pc._entries)
        for key in keys:
            exp = pc.export_host(key)
            if exp is None:
                continue        # never finished staging: cannot move
            dst = min(targets, key=lambda x: (x.load, x.idx))
            planes = {p: exp[p] for p in exp
                      if p not in ("tokens", "pages")}
            if not dst.prefix_cache.import_host(exp["tokens"], planes):
                continue        # the survivor holds it already
            n = int(exp["pages"])
            nbytes = n * dst.prefix_cache.host_tier.page_bytes()
            rep.drain["prefixes_migrated"] += 1
            rep.drain["pages_migrated"] += n
            self.tier_migrations += 1
            _metrics.counter("fleet.tier_migrations").inc()
            _flight.record("tier_migrate", rid=None, src=rep.idx,
                           dst=dst.idx, pages=n, bytes=nbytes,
                           rows=int(len(exp["tokens"])))

    def _drain_requeue(self, rep: _Replica,
                       survivors: List[_Replica]) -> None:
        """Requeue the draining replica's queued (never admitted) requests
        onto survivors, as ``_kill_replica`` does (a fresh engine-local
        rid, the same fleet rid). Nothing is dropped; admitted slots keep
        their pages and finish in place."""
        queued = list(rep.engine._queue)
        if not queued:
            return
        if not survivors:
            raise RuntimeError(
                f"draining replica {rep.idx} holds {len(queued)} queued "
                f"requests with no serving survivor to requeue onto")
        ids = {id(q) for q in queued}
        rep.engine._queue.clear()
        moved = sorted(((frid, req) for frid, (ridx, req)
                        in self._reqs.items()
                        if ridx == rep.idx and id(req) in ids),
                       key=lambda t: t[0])
        for frid, req in moved:
            req.requeues += 1
            if req.requeues > self.max_requeues:
                raise RuntimeError(
                    f"request {frid} exceeded {self.max_requeues} "
                    f"requeues during drain")
            tgt = self._failover_target(survivors, req)
            if (len(req.prompt) + len(req.tokens)
                    > max(tgt.engine.buckets)):
                req.tokens = []
            req.rid = tgt.engine._next_rid
            tgt.engine._next_rid += 1
            tgt.engine._queue.append(req)
            self._reqs[frid] = (tgt.idx, req)
            tgt.rids.append(frid)
            rep.rids.remove(frid)
            self.requeued += 1
            rep.drain["requeued"] += 1
            _metrics.counter("fleet.failover_requeued").inc()
            _flight.record("failover_requeue", rid=frid, src=rep.idx,
                           dst=tgt.idx, tokens_kept=len(req.tokens))

    def _finalize_drain(self, rep: _Replica) -> dict:
        """The drain's last act, once the replica is empty: release its
        cache's pages (the evict listeners clear its directory
        placements) and park it offline. Returns the drain's ledger."""
        if rep.busy:
            raise RuntimeError(f"finalizing busy replica {rep.idx}")
        if rep.prefix_cache is not None:
            rep.prefix_cache.reset()
        rep.lifecycle = "offline"
        info = rep.drain or {}
        rep.last_drain = info
        rep.drain = None
        return info

    def _stamp(self, r: _Replica, ev: dict, t_sync: float) -> List[tuple]:
        """Per-request lifecycle stamps at the fetch that surfaced each
        event (``OnlineScheduler.serve``'s rules), recorded into the
        replica's registry (its scope is active). Returns the ``(kind,
        priority, latency_s)`` outcomes for the fleet-level monitors."""
        by_erid = {self._reqs[rid][1].rid: (rid, self._reqs[rid][1])
                   for rid in r.rids}
        m_ttft = _metrics.histogram("serving.ttft_s")
        m_e2e = _metrics.histogram("serving.e2e_s")
        m_qw = _metrics.histogram("serving.queue_wait_s")
        outcomes: List[tuple] = []
        for erid in ev["admitted"]:
            frid, req = by_erid[erid]
            _journal.record("admit", rid=frid, replica=r.idx, erid=erid,
                            prefix_hit_len=req.prefix_hit_len,
                            resumed=bool(req.preemptions or req.requeues),
                            tokens_done=len(req.tokens))
        for erid in ev["first_tokens"]:
            frid, req = by_erid[erid]
            if req.first_token_time:
                # a rewound failover request emits its first token again;
                # the client saw the original, so the TTFT stands
                continue
            req.first_token_time = t_sync
            m_ttft.observe(t_sync - req.arrival_time)
            m_qw.observe(req.admit_time - req.arrival_time)
            outcomes.append(("ttft", req.priority,
                             t_sync - req.arrival_time))
            _journal.record("first_token", rid=frid, replica=r.idx,
                            ttft_s=t_sync - req.arrival_time)
        for erid in ev["finished"]:
            frid, req = by_erid[erid]
            req.finish_time = t_sync
            m_e2e.observe(t_sync - req.arrival_time)
            outcomes.append(("e2e", req.priority,
                             t_sync - req.arrival_time))
            _journal.record("finish", rid=frid, replica=r.idx,
                            tokens=req.tokens, n_tokens=len(req.tokens),
                            e2e_s=t_sync - req.arrival_time,
                            requeues=req.requeues,
                            spec_proposed=req.spec_proposed,
                            spec_accepted=req.spec_accepted)
        _metrics.gauge("fleet.replica_queue_depth").set(r.queue_depth)
        return outcomes

    def _journal_header(self, arrivals) -> dict:
        """The fleet serve's header: router knobs, every replica's
        geometry and prefix cache, the fault injector's live schedule,
        the canary (a decider) and the shadow (an observer, described
        only), and the full trace."""
        return {
            "driver": "fleet",
            "fleet": {"max_queue": self.max_queue,
                      "seg_steps": self.seg_steps,
                      "affinity_block": self.affinity_block,
                      "segment_timeout_s": self.segment_timeout_s,
                      "max_finish_retries": self.max_finish_retries,
                      "max_requeues": self.max_requeues,
                      "probe_after_s": self.probe_after_s,
                      "directory": self.directory is not None,
                      "next_rid": self._next_rid},
            "engines": [_journal.describe_engine(r.engine)
                        for r in self._replicas],
            "prefix_caches": [_journal.describe_prefix_cache(
                r.prefix_cache) for r in self._replicas],
            "fault": (self.fault_injector.describe()
                      if self.fault_injector is not None else None),
            "canary": (self.canary.describe()
                       if self.canary is not None else None),
            "shadow": (None if self.shadow is None else {
                "sample_p": self.shadow.sample_p,
                "seed": self.shadow.seed,
                "engine": _journal.describe_engine(self.shadow.engine)}),
            "llama": _journal.describe_config(
                self._replicas[0].engine.cfg),
            "monitors": {"slo": self.slo_monitor is not None,
                         "perf": self.perf_monitor is not None},
            # the policies decide, so their configs and their input
            # monitors' ride the header for a replay to rebuild
            "autoscaler": ({
                "policies": [a.describe() for a in self.autoscalers],
                "slo": (self.slo_monitor.describe()
                        if self.slo_monitor is not None else None),
                "capacity": (self.capacity_monitor.describe()
                             if self.capacity_monitor is not None
                             else None),
            } if self.autoscalers else None),
            "telemetry_enabled": _metrics.enabled(),
            "trace": _journal.describe_arrivals(arrivals),
        }

    # --- results / lifecycle ---------------------------------------------
    def results(self) -> Dict[int, List[int]]:
        """Fleet rid -> generated tokens (truncated at max_new_tokens and
        after the first EOS, as ``ServingEngine.run``)."""
        for r in self._replicas:
            r.engine.collect_finished()
        return {rid: req.tokens for rid, (_, req) in self._reqs.items()}

    def assignment(self) -> List[List[int]]:
        """Per-replica fleet rids in assignment order."""
        return [list(r.rids) for r in self._replicas]

    def reset(self) -> None:
        """Warm-run isolation: reset every replica's slots, cache and
        registry, and zero the fleet counters."""
        for r in self._replicas:
            r.engine.reset_slots()
            if r.prefix_cache is not None:
                r.prefix_cache.reset()
            r.registry.reset()
            r.backpressure_events = 0
            r.dispatches = {"affinity": 0, "least_loaded": 0,
                            "canary": 0, "directory": 0}
            r.segments = 0
            r.rids = []
            r.health = "healthy"
            r.timeouts = 0
            r.probes = 0
            r.dead_since = 0.0
            r.lifecycle = "serving"
            r.drain = None
            r.last_drain = None
            r.warmed_s = None
        self.backpressure_events = 0
        self.failovers = 0
        self.requeued = 0
        self.tier_migrations = 0
        if self.directory is not None:
            # the cache resets above emptied it through the evict
            # listeners; zero the counters too
            self.directory.reset()
        self.last_retry_after_s = None
        self._finished_count = 0
        self._reqs.clear()
        self._next_rid = 0
        if self.slo_monitor is not None:
            self.slo_monitor.reset()
        if self.perf_monitor is not None:
            # cut (and discard) the warm interval
            self.perf_monitor.end_interval()
        if self.shadow is not None:
            self.shadow.reset()
        if self.canary is not None:
            self.canary.reset()
        if self.capacity_monitor is not None:
            self.capacity_monitor.reset()
        # after the "serving" default above: each policy sets its initial
        # lifecycles again (standbys back offline) and zeroes its ledger
        for asc in self.autoscalers:
            asc.reset()

    def leak_report(self) -> List[str]:
        """Page-leak audit across replicas: with no live requests, each
        paged replica's pool must be whole but for its OWN cache's pages
        (distinct pages: entries sharing a prefix hold its pages once)."""
        bad: List[str] = []
        for r in self._replicas:
            if not r.engine.paged:
                continue
            pc = r.prefix_cache
            if pc is not None and hasattr(pc, "physical_pages_held"):
                held = pc.physical_pages_held()
            elif pc is not None and hasattr(pc, "pages_held"):
                held = pc.pages_held
            else:
                held = 0
            for msg in r.engine.pager.leak_report(expected_held=held):
                bad.append(f"replica {r.idx}: {msg}")
        return bad

    def merged_telemetry(self, log_dir: str) -> dict:
        """Write one rank-tagged snapshot per replica into ``log_dir``
        and reduce them with ``metrics.merge_log_dir``: counters summed
        across replicas, gauges kept per rank."""
        for r in self._replicas:
            _metrics.write_snapshot(log_dir, rank=r.idx,
                                    registry=r.registry)
        return _metrics.merge_log_dir(log_dir)
