"""Online request-lifecycle scheduler over the serving engine.

Port of ``OnlineScheduler`` in ``paddle_tpu/inference/scheduler.py``:
requests arrive over time from a clocked trace, and each turn of the
loop ingests the arrivals that are due, then runs ONE engine segment
(``ServingEngine.run_segment``), which admits queued requests into free
slots and decodes up to ``seg_steps`` steps.

* Clocked arrivals: seeded Poisson (``poisson_arrivals``) or evenly
  spaced (``staggered_arrivals``) traces, plain lists of ``Arrival`` rows
  that replay identically against any engine.
* Admission control: a bounded intake queue. Arrivals past ``max_queue``
  stay client-side, each refusal is counted, and the refused client gets
  a ``retry_after_hint`` from the measured drain rate.
* Measured telemetry: per-request arrival / admit / first-token / finish
  stamps, taken on the host clock right after the segment read that
  surfaced each event, so TTFT and end-to-end latency are measurements.
* Shared-prefix reuse: pass the engine's prefix cache (a ``PrefixCache``
  on the slot-contiguous engine, a ``PagedPrefixCache`` on the paged one,
  with or without a host tier; ``prefix_cache.make_prefix_cache`` builds
  the one that fits).
* Telemetry from the same host stamps: queue-depth and occupancy gauges,
  TTFT / e2e / queue-wait histograms, ``serving.segment`` spans and
  request spans (``profiler._hooks``, ``observability.tracing``), journal
  records (``arrival``, ``admit``, ``first_token``, ``finish``, and a
  header per serve), and the optional SLO, perf and capacity monitors
  (the capacity monitor is evaluated before each paged dispatch). The
  report adds their sections, the per-class meter (``meter``) and the
  host tier's stats (``tiers``).
* The decision clock: every clock read that steers the loop (arrivals due,
  idle waits, segment stamps, deadline shedding) is
  ``observability.journal.now()`` / ``sleep()``, so a serve recorded with
  a journal attached replays its decisions under ``feed_clock``.

``SLOScheduler`` adds the overload control plane: class-ordered intake
with displacement, preempt-and-requeue of lower classes, and deadline
shedding from measured per-token and per-tick EWMAs.

Either engine serves: the loop needs only its segments. The loop reads
the device only through the engine's per-segment fetch.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..observability import capacity as _capacity
from ..observability import flight as _flight
from ..observability import journal as _journal
from ..observability import metrics as _metrics
from ..observability import tracing as _tracing
from ..observability.metrics import percentile
from ..profiler import _hooks
from .serving import Request, ServingEngine

__all__ = ["Arrival", "OnlineReport", "OnlineScheduler", "SLOScheduler",
           "percentile", "poisson_arrivals", "staggered_arrivals",
           "scale_rate"]


@dataclass
class Arrival:
    t: float                  # seconds after serve() start
    prompt: np.ndarray        # [S] int32
    max_new_tokens: int
    # SLO class (smaller outranks larger: 0 interactive, 1+ batch) and an
    # e2e deadline relative to the arrival (None: never shed); only
    # SLOScheduler acts on them
    priority: int = 0
    deadline_s: Optional[float] = None


def poisson_arrivals(seed: int, n: int, rate: float, vocab: int,
                     prompt_lens: Sequence[int] = (32, 64, 128),
                     gen_lens: Sequence[int] = (16, 32, 64),
                     prefix: Optional[np.ndarray] = None) -> List[Arrival]:
    """Seeded Poisson process: exponential gaps at ``rate`` requests/s;
    prompt and generation lengths drawn uniformly from the grids.
    ``prefix`` (optional) is prepended to every prompt."""
    if rate <= 0:
        raise ValueError(f"rate must be > 0, got {rate}")
    rng = np.random.RandomState(seed)
    t = 0.0
    out = []
    for _ in range(n):
        t += float(rng.exponential(1.0 / rate))
        out.append(_draw(rng, t, vocab, prompt_lens, gen_lens, prefix))
    return out


def staggered_arrivals(seed: int, n: int, gap: float, vocab: int,
                       prompt_lens: Sequence[int] = (32, 64, 128),
                       gen_lens: Sequence[int] = (16, 32, 64),
                       prefix: Optional[np.ndarray] = None) -> List[Arrival]:
    """One arrival every ``gap`` seconds: the reproducible trace."""
    rng = np.random.RandomState(seed)
    return [_draw(rng, i * gap, vocab, prompt_lens, gen_lens, prefix)
            for i in range(n)]


def _draw(rng, t, vocab, prompt_lens, gen_lens, prefix) -> Arrival:
    body = rng.randint(0, vocab, (int(rng.choice(prompt_lens)),)
                       ).astype(np.int32)
    if prefix is not None:
        body = np.concatenate([np.asarray(prefix, np.int32), body])
    return Arrival(t, body, int(rng.choice(gen_lens)))


def scale_rate(arrivals: Sequence[Arrival], factor: float) -> List[Arrival]:
    """The same trace at ``factor`` times the arrival rate: identical
    prompts, lengths and order, every gap divided by ``factor``."""
    if factor <= 0:
        raise ValueError(f"factor must be > 0, got {factor}")
    return [Arrival(a.t / factor, a.prompt, a.max_new_tokens)
            for a in arrivals]


@dataclass
class OnlineReport:
    """Measured outcome of one serve() run (times in seconds)."""
    n_requests: int
    total_tokens: int
    makespan_s: float
    throughput_tok_s: float
    ttft_p50_s: float
    ttft_p99_s: float
    e2e_p50_s: float
    e2e_p99_s: float
    queue_wait_p50_s: float
    slot_occupancy: float          # generated tokens / (steps * slots)
    segments: int
    ticks: int                     # segment steps, admits included
    backpressure_events: int       # polls that refused an arrival
    backpressure_pages: int = 0    # segments that deferred for pages
    pages: Optional[dict] = None   # PagedKVCache.stats() (paged engine)
    prefix: Optional[dict] = None  # the prefix cache's stats()
    retry_after_s: Optional[float] = None  # the last hint handed out
    # the SLO scheduler's accounting (zero / None under the plain one)
    preemptions: int = 0
    shed: int = 0
    shed_per_class: Optional[Dict[int, int]] = None
    displaced: int = 0             # queue spots yielded to a higher class
    per_class: Optional[Dict[int, dict]] = None  # class -> latency stats
    # build to first token of the engine served, and the monitors'
    # reports when attached
    cold_start_s: Optional[float] = None
    slo: Optional[dict] = None
    perf: Optional[dict] = None
    capacity: Optional[dict] = None
    # per-class resource meter (paged serves) and the host tier's stats
    # (a prefix cache with a host tier)
    meter: Optional[dict] = None
    tiers: Optional[dict] = None
    per_request: List[dict] = field(default_factory=list)

    def as_dict(self, with_requests: bool = False) -> dict:
        d = {k: v for k, v in self.__dict__.items() if k != "per_request"}
        if with_requests:
            d["per_request"] = self.per_request
        return d


class OnlineScheduler:
    """Drive a ``ServingEngine`` (either layout) under a clocked arrival
    trace.

    ``seg_steps`` is the control-latency knob: the host regains control
    (to ingest arrivals and stamp times) every ``seg_steps`` steps. The
    optional monitors consume only the host stamps the loop takes
    anyway."""

    def __init__(self, engine: ServingEngine, max_queue: int = 64,
                 seg_steps: int = 32, prefix_cache=None,
                 slo_monitor=None, perf_monitor=None,
                 capacity_monitor=None):
        self.engine = engine
        self.max_queue = int(max_queue)
        self.seg_steps = int(seg_steps)
        self.prefix_cache = prefix_cache
        self.slo_monitor = slo_monitor
        self.perf_monitor = perf_monitor
        self.capacity_monitor = capacity_monitor
        self.backpressure_events = 0
        self.last_retry_after_s: Optional[float] = None
        self._reqs: Dict[int, Request] = {}
        self._finished_count = 0
        self._serve_t0 = 0.0
        # measured seconds a segment step (EWMA over segments): with the
        # engine's acceptance EWMA it prices owed tokens in ticks
        self._per_tick_s = 0.0

    # --- intake ----------------------------------------------------------
    def retry_after_hint(self, now: float) -> float:
        """Seconds a refused client should wait: the drain rate's time per
        finished request (elapsed / finished this serve); before any
        finish, one second over the engine's acceptance EWMA (a
        speculative engine drains faster). Clamped to [1 ms, 60 s]."""
        if self._finished_count and now > 0:
            return min(max(now / self._finished_count, 1e-3), 60.0)
        accept = max(float(getattr(self.engine, "spec_accept_ewma", 1.0)),
                     1.0)
        return 1.0 / accept

    def _note_arrival(self, r: Request, a: Arrival) -> None:
        """Per-request intake hook (the SLO scheduler stamps the class and
        deadline and reorders the queue here)."""

    def _journal_arrival(self, r: Request, a: Arrival) -> None:
        _journal.record("arrival", rid=r.rid, at=a.t, priority=r.priority,
                        deadline_s=getattr(a, "deadline_s", None),
                        prompt_len=len(r.prompt), gen=r.max_new_tokens)

    def _note_refused(self, refused: int, now: float) -> None:
        hint = self.retry_after_hint(now)
        self.last_retry_after_s = hint
        self.backpressure_events += 1
        _metrics.counter("serving.backpressure_events").inc()
        _metrics.gauge("serving.retry_after_s").set(hint)
        _flight.record("backpressure", refused=refused,
                       queue=len(self.engine._queue),
                       retry_after_s=round(hint, 4))

    def _ingest(self, pending: List[Arrival], now: float, t0: float) -> int:
        """Move due arrivals into the engine queue, honouring the bound.
        Returns how many were refused (left client-side) this poll."""
        refused = 0
        while pending and pending[0].t <= now:
            if len(self.engine._queue) >= self.max_queue:
                refused += 1
                break
            a = pending.pop(0)
            rid = self.engine.add_request(a.prompt, a.max_new_tokens)
            r = self.engine._queue[-1]
            assert r.rid == rid
            r.arrival_time = t0 + a.t   # client-side timestamp
            self._reqs[rid] = r
            self._note_arrival(r, a)
            self._journal_arrival(r, a)
        if refused:
            self._note_refused(refused, now)
        return refused

    # --- the serve loop --------------------------------------------------
    def reset(self) -> None:
        """Forget the served requests and empty the engine's slots and the
        prefix cache: the state a warm pass leaves behind."""
        self.engine.reset_slots()
        self._reqs.clear()
        self.backpressure_events = 0
        if self.prefix_cache is not None:
            self.prefix_cache.reset()

    def _reset_monitors(self) -> None:
        """Warm-run isolation of the monitors (the perf monitor's
        self-pinned tick budget stays: the warm pass is the baseline)."""
        if self.slo_monitor is not None:
            self.slo_monitor.reset()
        if self.perf_monitor is not None:
            self.perf_monitor.end_interval()
        if self.capacity_monitor is not None:
            self.capacity_monitor.reset()

    def serve(self, arrivals: Sequence[Arrival],
              warm: bool = False) -> OnlineReport:
        """Serve the trace to completion and return measured stats.

        ``warm=True`` first serves the identical trace once, then
        ``reset()``s, so the measured pass starts from built kernels and
        an empty cache."""
        if warm:
            self.serve(arrivals, warm=False)
            self.reset()
            self._reset_monitors()
        _j = _journal.active()
        if _j is not None:
            _j.begin_serve(self._journal_header(arrivals))
        pending = sorted(arrivals, key=lambda a: a.t)
        eng = self.engine
        eng.last_run_ticks = 0
        eng.last_run_chunks = 0
        segments = 0
        self.last_retry_after_s = None
        self._finished_count = 0
        m_queue = _metrics.gauge("serving.queue_depth")
        m_ttft = _metrics.histogram("serving.ttft_s")
        m_e2e = _metrics.histogram("serving.e2e_s")
        m_qwait = _metrics.histogram("serving.queue_wait_s")
        t0 = _journal.now()
        self._serve_t0 = t0
        while pending or eng._queue or eng.free_slot_count() < eng.slots:
            now = _journal.now() - t0
            self._ingest(pending, now, t0)
            m_queue.set(len(eng._queue))
            # the SLO scheduler sheds and preempts here (host only)
            self._pre_segment(now, t0)
            if not eng._queue and eng.free_slot_count() == eng.slots:
                # nothing to admit or decode: sleep to the next arrival
                if pending:
                    gap = pending[0].t - (_journal.now() - t0)
                    if gap > 0:
                        _journal.sleep(min(gap, 0.05))
                continue
            cap = self.capacity_monitor
            if cap is not None and eng.paged:
                # evaluated before the dispatch that could defer for
                # pages, so the alert leads the valve; host-tier pages
                # are the second availability axis
                pc = self.prefix_cache
                has_rec = (pc is not None
                           and hasattr(pc, "reclaimable_pages"))
                cap.begin_segment(
                    eng.pager.pages_free,
                    pc.reclaimable_pages() if has_rec else 0,
                    host_pages=(pc.host_pages if has_rec
                                and getattr(pc, "host_tier", None)
                                is not None else None))
            t_seg = _hooks.now_ns()
            t_seg_pc = _journal.now()
            ev = eng.run_segment(self.seg_steps,
                                 prefix_cache=self.prefix_cache)
            t_sync = _journal.now()
            _hooks.emit("serving.segment", t_seg, _hooks.now_ns(),
                        kind="serving")
            segments += 1
            mon = self.slo_monitor
            for rid in ev["admitted"]:
                r = self._reqs[rid]
                _journal.record("admit", rid=rid,
                                prefix_hit_len=r.prefix_hit_len,
                                priority=r.priority,
                                resumed=bool(r.preemptions or r.requeues),
                                tokens_done=len(r.tokens))
            for rid in ev["first_tokens"]:
                r = self._reqs[rid]
                r.first_token_time = t_sync
                m_ttft.observe(t_sync - r.arrival_time)
                m_qwait.observe(r.admit_time - r.arrival_time)
                if mon is not None:
                    mon.note_ttft(r.priority, t_sync - r.arrival_time)
                self._on_first_token(r, t_sync)
                _journal.record("first_token", rid=rid,
                                ttft_s=t_sync - r.arrival_time)
            for rid in ev["finished"]:
                # the engine stamps finish during its replay; the client
                # sees the tokens now
                r = self._reqs[rid]
                r.finish_time = t_sync
                self._finished_count += 1
                m_e2e.observe(t_sync - r.arrival_time)
                if mon is not None:
                    mon.note_e2e(r.priority, t_sync - r.arrival_time)
                self._on_finish(r, t_sync)
                _tracing.emit_request_trace(
                    rid, r.arrival_time, r.admit_time, r.first_token_time,
                    r.finish_time, prefix_hit_len=r.prefix_hit_len)
                _journal.record("finish", rid=rid, tokens=r.tokens,
                                n_tokens=len(r.tokens),
                                e2e_s=t_sync - r.arrival_time,
                                priority=r.priority,
                                preemptions=r.preemptions,
                                requeues=r.requeues,
                                spec_proposed=r.spec_proposed,
                                spec_accepted=r.spec_accepted)
            if mon is not None:
                sp = ev.get("spec")
                if sp and sp.get("proposed"):
                    mon.note_accept_rate(sp["accepted"] / sp["proposed"])
                mon.end_segment()
            if self.perf_monitor is not None:
                self.perf_monitor.note_segment(
                    ev["steps"], ev.get("tokens", 0),
                    elapsed_s=t_sync - t_seg_pc)
            if cap is not None and eng.paged:
                cap.note_admission(
                    sum(self._reqs[rid].pages_fresh
                        for rid in ev["admitted"]),
                    admitted=len(ev["admitted"]))
                cap.close_segment()
            # seconds a step, averaged over segments: the acceptance-aware
            # service estimate's clock
            dt = (t_sync - t_seg_pc) / max(ev["steps"], 1)
            self._per_tick_s = (dt if not self._per_tick_s
                                else 0.5 * self._per_tick_s + 0.5 * dt)
        makespan = _journal.now() - t0

        reqs = list(self._reqs.values())
        assert all(r.done or (eng.eos is not None and eng.eos in r.tokens)
                   for r in reqs), "scheduler exited with unserved requests"
        total_tokens = sum(len(r.tokens) for r in reqs)
        ttfts = [r.first_token_time - r.arrival_time for r in reqs]
        e2es = [r.finish_time - r.arrival_time for r in reqs]
        qwaits = [r.admit_time - r.arrival_time for r in reqs]
        occupancy = (total_tokens / (eng.last_run_ticks * eng.slots)
                     if eng.last_run_ticks else 0.0)
        _metrics.gauge("serving.slot_occupancy").set(occupancy)
        _metrics.gauge("serving.throughput_tok_s").set(
            total_tokens / makespan if makespan else 0.0)
        tier = getattr(self.prefix_cache, "host_tier", None)
        return OnlineReport(
            n_requests=len(reqs),
            total_tokens=total_tokens,
            makespan_s=makespan,
            throughput_tok_s=total_tokens / makespan if makespan else 0.0,
            ttft_p50_s=percentile(ttfts, 0.50),
            ttft_p99_s=percentile(ttfts, 0.99),
            e2e_p50_s=percentile(e2es, 0.50),
            e2e_p99_s=percentile(e2es, 0.99),
            queue_wait_p50_s=percentile(qwaits, 0.50),
            slot_occupancy=occupancy,
            segments=segments,
            ticks=eng.last_run_ticks,
            backpressure_events=self.backpressure_events,
            backpressure_pages=eng.page_backpressure_events,
            pages=eng.pager.stats() if eng.paged else None,
            prefix=(self.prefix_cache.stats()
                    if self.prefix_cache is not None else None),
            retry_after_s=self.last_retry_after_s,
            cold_start_s=(round(eng.cold_start_s, 4)
                          if eng.cold_start_s is not None else None),
            slo=(self.slo_monitor.report()
                 if self.slo_monitor is not None else None),
            perf=(self.perf_monitor.end_interval()
                  if self.perf_monitor is not None else None),
            capacity=(self.capacity_monitor.report()
                      if self.capacity_monitor is not None else None),
            meter=(_capacity.aggregate_meters(
                reqs,
                ledger=(self.capacity_monitor.ledger
                        if self.capacity_monitor is not None else None),
                page_size=eng.page_size if eng.paged else None)
                if eng.paged else None),
            tiers=tier.stats() if tier is not None else None,
            **self._report_extras(reqs),
            per_request=[{
                "rid": r.rid,
                "prompt_len": int(len(r.prompt)),
                "gen_len": len(r.tokens),
                "prefix_hit_len": r.prefix_hit_len,
                "priority": r.priority,
                "preemptions": r.preemptions,
                "ttft_s": round(r.first_token_time - r.arrival_time, 4),
                "e2e_s": round(r.finish_time - r.arrival_time, 4),
                "pages": r.pages_reserved,
                "page_seconds": round(r.page_seconds, 4),
                "ticks": r.meter_ticks,
                "streams": round(r.meter_streams, 4),
                "tier_pages": r.tier_pages,
                "tier_bytes": r.tier_bytes,
            } for r in reqs],
        )

    # --- SLO hooks (no-ops here; SLOScheduler overrides) -----------------
    def _pre_segment(self, now: float, t0: float) -> None:
        pass

    def _on_first_token(self, r: Request, t_sync: float) -> None:
        pass

    def _on_finish(self, r: Request, t_sync: float) -> None:
        pass

    def _report_extras(self, reqs) -> dict:
        return {}

    def _journal_header(self, arrivals) -> dict:
        """What a replay needs to rebuild this serve: the driver and its
        knobs, the engine, the model config, the prefix cache, the
        monitors attached, and the full trace."""
        return {
            "driver": "online",
            "scheduler": {"max_queue": self.max_queue,
                          "seg_steps": self.seg_steps,
                          "per_tick_s": self._per_tick_s},
            "engines": [_journal.describe_engine(self.engine)],
            "llama": _journal.describe_config(self.engine.cfg),
            "prefix_cache": _journal.describe_prefix_cache(
                self.prefix_cache),
            "monitors": {"slo": self.slo_monitor is not None,
                         "perf": self.perf_monitor is not None,
                         "capacity": self.capacity_monitor is not None},
            "telemetry_enabled": _metrics.enabled(),
            "trace": _journal.describe_arrivals(arrivals),
        }

    def results(self) -> Dict[int, List[int]]:
        """rid -> generated tokens for every served request (truncated at
        max_new_tokens and after the first EOS, like ``ServingEngine.run``)."""
        self.engine.collect_finished()
        return {rid: r.tokens for rid, r in self._reqs.items()}


class SLOScheduler(OnlineScheduler):
    """``OnlineScheduler`` with the overload control plane: priority
    classes, preempt-and-requeue, and deadline shedding.

    * **Priority admission.** The engine queue stays ordered by (priority,
      rid): class 0 ahead of class 1, FCFS within a class, so the
      engine's FCFS pick is priority scheduling. A full queue refuses only
      the arrival itself, or yields to a higher class by displacement: the
      worst queued request (lowest class, latest rid) goes back
      client-side, losing nothing.
    * **Preempt-and-requeue.** Before each segment, while the queue head
      is blocked (no free slot or, paged, too few free pages), running
      requests of a strictly lower class are preempted
      (``ServingEngine.preempt_slot``: worst class first, least progress
      first) and requeue at the head of their class with what they
      generated. Never the same class.
    * **Deadline shedding.** A queued request whose deadline is already
      unmeetable (now plus a measured minimum service time: owed tokens
      times the per-token EWMA, or on a speculative engine owed / the
      acceptance EWMA times the per-tick EWMA) is dropped and counted per
      class. The estimate leaves out queueing, so it only sheds what an
      empty machine could not finish.

    Per-class TTFT / e2e histograms land in ``request.ttft[class<p>]`` /
    ``request.e2e[class<p>]``, counters in ``scheduler.shed[class<p>]`` /
    ``scheduler.preemptions``; every decision is journaled with its
    inputs (``shed_decision``, ``preempt_decision``). All of it is host
    bookkeeping between segments."""

    def __init__(self, engine: ServingEngine, max_queue: int = 64,
                 seg_steps: int = 32, prefix_cache=None,
                 preempt: bool = True, shed_deadlines: bool = True,
                 slo_monitor=None, perf_monitor=None,
                 capacity_monitor=None):
        super().__init__(engine, max_queue=max_queue, seg_steps=seg_steps,
                         prefix_cache=prefix_cache,
                         slo_monitor=slo_monitor,
                         perf_monitor=perf_monitor,
                         capacity_monitor=capacity_monitor)
        self.preempt = bool(preempt)
        self.shed_deadlines = bool(shed_deadlines)
        self.preemptions = 0
        self.shed_count = 0
        self.shed_per_class: Dict[int, int] = {}
        self.shed_log: List[dict] = []
        self.displaced = 0            # queue-level class displacements
        self._arrivals: Dict[int, Arrival] = {}   # rid -> its Arrival
        self._per_token_s = 0.0       # EWMA decode seconds a token

    # --- class-ordered queue ---------------------------------------------
    def _insert_by_class(self, r: Request) -> None:
        """(Re)insert into the engine queue at its (priority, rid)
        position: a preempted request's original rid puts it ahead of
        everything of its class that arrived after it."""
        q = self.engine._queue
        key = (r.priority, r.rid)
        lo = 0
        while lo < len(q) and (q[lo].priority, q[lo].rid) < key:
            lo += 1
        q.insert(lo, r)

    def _note_arrival(self, r: Request, a: Arrival) -> None:
        r.priority = int(getattr(a, "priority", 0))
        dls = getattr(a, "deadline_s", None)
        r.deadline = r.arrival_time + dls if dls else 0.0
        self._arrivals[r.rid] = a
        # the base intake appended at the tail: move to the class position
        assert self.engine._queue[-1] is r
        self.engine._queue.pop()
        self._insert_by_class(r)

    def _ingest(self, pending: List[Arrival], now: float, t0: float) -> int:
        """Class-aware intake: due arrivals are scanned past a refusal,
        and a full queue yields to a higher class by displacing its worst
        request back client-side."""
        refused = 0
        i = 0
        while i < len(pending) and pending[i].t <= now:
            a = pending[i]
            q = self.engine._queue
            displaced_arrival = None
            if len(q) >= self.max_queue:
                victim = max(q, key=lambda r: (r.priority, r.rid))
                if int(getattr(a, "priority", 0)) < victim.priority:
                    q.remove(victim)
                    del self._reqs[victim.rid]
                    displaced_arrival = self._arrivals.pop(victim.rid)
                    self.displaced += 1
                    _metrics.counter("scheduler.displaced").inc()
                    _flight.record("displaced", rid=victim.rid,
                                   cls=victim.priority,
                                   by_cls=int(getattr(a, "priority", 0)))
                else:
                    refused += 1
                    i += 1
                    continue
            # pop first, then put the displaced arrival back in time order
            # (inserting before the pop would shift the index)
            pending.pop(i)
            if displaced_arrival is not None:
                j = 0
                while (j < len(pending)
                       and pending[j].t <= displaced_arrival.t):
                    j += 1
                pending.insert(j, displaced_arrival)
                if j <= i:
                    i += 1     # keep scanning from the same arrival
            rid = self.engine.add_request(a.prompt, a.max_new_tokens)
            r = self.engine._queue[-1]
            assert r.rid == rid
            r.arrival_time = t0 + a.t
            self._reqs[rid] = r
            self._note_arrival(r, a)
            self._journal_arrival(r, a)
        if refused:
            self._note_refused(refused, now)
        return refused

    # --- the control plane (between segments, host only) -----------------
    def _pre_segment(self, now: float, t0: float) -> None:
        if self.shed_deadlines:
            self._shed_pass()
        if self.preempt:
            self._preempt_pass()

    def _min_service_s(self, r: Request) -> float:
        """Lower bound on the time to finish ``r`` from a standing start:
        owed tokens times the per-token EWMA (0.0 before the first finish,
        when only an expired deadline sheds); on a speculative engine owed
        / the acceptance EWMA ticks at the per-tick EWMA."""
        owed = r.max_new_tokens - len(r.tokens)
        if getattr(self.engine, "speculative", 0):
            accept = max(float(self.engine.spec_accept_ewma), 1.0)
            per_tick = self._per_tick_s or self._per_token_s
            return owed / accept * per_tick
        return owed * self._per_token_s

    def _shed_pass(self) -> None:
        t_abs = _journal.now()
        eng = self.engine
        for r in [q for q in eng._queue if q.deadline]:
            min_s = self._min_service_s(r)
            if t_abs + min_s <= r.deadline:
                continue
            eng._queue.remove(r)
            del self._reqs[r.rid]
            self.shed_count += 1
            self.shed_per_class[r.priority] = \
                self.shed_per_class.get(r.priority, 0) + 1
            self.shed_log.append({
                "rid": r.rid, "priority": r.priority,
                "late_by_s": round(t_abs + min_s - r.deadline, 4),
                "tokens_done": len(r.tokens)})
            _metrics.counter("scheduler.shed").inc()
            _metrics.counter(f"scheduler.shed[class{r.priority}]").inc()
            # the decision with its inputs: why this request was shed
            _journal.record("shed_decision", rid=r.rid,
                            priority=r.priority, now_abs=t_abs,
                            deadline_abs=r.deadline,
                            min_service_s=min_s,
                            late_by_s=t_abs + min_s - r.deadline,
                            owed=r.max_new_tokens - len(r.tokens),
                            per_token_s=self._per_token_s,
                            per_tick_s=self._per_tick_s,
                            accept_ewma=float(getattr(
                                self.engine, "spec_accept_ewma", 1.0)),
                            tokens_done=len(r.tokens))
            _flight.record("shed", rid=r.rid, cls=r.priority,
                           queue=len(eng._queue))

    def _head_admissible(self, head: Request) -> bool:
        """Whether the queue head could be admitted now without evicting
        anyone: a free slot, and on a paged engine its whole page span
        free (prefix hits only reduce it)."""
        eng = self.engine
        if eng.free_slot_count() == 0:
            return False
        if not eng.paged:
            return True
        fp, remaining = head.resume_view()
        need = eng.pager.pages_needed(len(fp) + remaining - 1)
        return need <= eng.pager.pages_free

    def _preempt_pass(self) -> None:
        eng = self.engine
        if not eng._queue:
            return
        head = eng._queue[0]          # highest class, earliest rid
        # strictly lower classes than the blocked head, worst class first,
        # least progress first (the least work set back)
        victims = sorted(
            (s for s, r in enumerate(eng._active)
             if r is not None and r.priority > head.priority),
            key=lambda s: (-eng._active[s].priority,
                           len(eng._active[s].tokens)))
        for s in victims:
            if self._head_admissible(head):
                return
            if not eng.can_preempt(s):
                continue
            _journal.record(
                "preempt_decision", rid=eng._active[s].rid,
                victim_slot=s, victim_priority=eng._active[s].priority,
                victim_tokens_done=len(eng._active[s].tokens),
                head_rid=head.rid, head_priority=head.priority,
                considered=[(v, eng._active[v].rid,
                             eng._active[v].priority,
                             len(eng._active[v].tokens))
                            for v in victims
                            if eng._active[v] is not None])
            victim = eng.preempt_slot(s, prefix_cache=self.prefix_cache)
            self._insert_by_class(victim)
            self.preemptions += 1
            _metrics.counter("scheduler.preemptions").inc()

    # --- per-class telemetry and report ----------------------------------
    def _on_first_token(self, r: Request, t_sync: float) -> None:
        _metrics.histogram(f"request.ttft[class{r.priority}]").observe(
            t_sync - r.arrival_time)

    def _on_finish(self, r: Request, t_sync: float) -> None:
        _metrics.histogram(f"request.e2e[class{r.priority}]").observe(
            t_sync - r.arrival_time)
        if r.first_token_time and r.tokens:
            per_tok = ((t_sync - r.admit_time) / len(r.tokens)
                       if r.admit_time else 0.0)
            if per_tok > 0:
                self._per_token_s = (per_tok if not self._per_token_s
                                     else 0.5 * self._per_token_s
                                     + 0.5 * per_tok)

    def _report_extras(self, reqs) -> dict:
        per_class: Dict[int, dict] = {}
        for p in sorted({r.priority for r in reqs}):
            rs = [r for r in reqs if r.priority == p]
            ttfts = [r.first_token_time - r.arrival_time for r in rs]
            e2es = [r.finish_time - r.arrival_time for r in rs]
            per_class[p] = {
                "n": len(rs),
                "ttft_p50_s": round(percentile(ttfts, 0.50), 4),
                "ttft_p99_s": round(percentile(ttfts, 0.99), 4),
                "e2e_p50_s": round(percentile(e2es, 0.50), 4),
                "e2e_p99_s": round(percentile(e2es, 0.99), 4),
                "preemptions": sum(r.preemptions for r in rs),
                "shed": self.shed_per_class.get(p, 0),
            }
        return {"preemptions": self.preemptions,
                "shed": self.shed_count,
                "shed_per_class": dict(self.shed_per_class) or None,
                "displaced": self.displaced,
                "per_class": per_class or None}

    def _journal_header(self, arrivals) -> dict:
        d = super()._journal_header(arrivals)
        d["driver"] = "slo"
        # the shed estimator's state: early decisions depend on what a
        # warm pass taught the EWMAs
        d["scheduler"].update(preempt=self.preempt,
                              shed_deadlines=self.shed_deadlines,
                              per_token_s=self._per_token_s)
        return d

    def reset(self) -> None:
        """The base reset, plus the SLO counters (a warm pass's sheds and
        preemptions must not reach the measured report)."""
        super().reset()
        self.preemptions = 0
        self.shed_count = 0
        self.shed_per_class = {}
        self.shed_log = []
        self.displaced = 0
        self._arrivals.clear()
