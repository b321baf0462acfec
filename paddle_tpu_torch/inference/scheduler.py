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
  on the slot-contiguous engine, a ``PagedPrefixCache`` on the paged one;
  ``prefix_cache.make_prefix_cache`` builds the one that fits).

Either engine serves: the loop needs only its segments. The loop reads
the device only through the engine's per-segment fetch.
Out of this port so far: the journal, tracing spans, the SLO, perf and
capacity monitors, the report's meter and tier sections, and
``SLOScheduler``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from .serving import Request, ServingEngine

__all__ = ["Arrival", "OnlineReport", "OnlineScheduler", "percentile",
           "poisson_arrivals", "staggered_arrivals", "scale_rate"]


def percentile(xs: Sequence[float], q: float) -> float:
    """Nearest-rank percentile over the full sample list: sorted ``xs``,
    index ``min(len - 1, int(len * q))``; 0.0 when empty."""
    if not xs:
        return 0.0
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(len(xs) * q))]


@dataclass
class Arrival:
    t: float                  # seconds after serve() start
    prompt: np.ndarray        # [S] int32
    max_new_tokens: int


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
    per_request: List[dict] = field(default_factory=list)


class OnlineScheduler:
    """Drive a ``ServingEngine`` (either layout) under a clocked arrival
    trace.

    ``seg_steps`` is the control-latency knob: the host regains control
    (to ingest arrivals and stamp times) every ``seg_steps`` steps."""

    def __init__(self, engine: ServingEngine, max_queue: int = 64,
                 seg_steps: int = 32, prefix_cache=None):
        self.engine = engine
        self.max_queue = int(max_queue)
        self.seg_steps = int(seg_steps)
        self.prefix_cache = prefix_cache
        self.backpressure_events = 0
        self.last_retry_after_s: Optional[float] = None
        self._reqs: Dict[int, Request] = {}
        self._finished_count = 0

    # --- intake ----------------------------------------------------------
    def retry_after_hint(self, now: float) -> float:
        """Seconds a refused client should wait: the current drain rate's
        time per finished request (elapsed / finished this serve), 1 s
        before any finish; clamped to [1 ms, 60 s]."""
        if self._finished_count and now > 0:
            return min(max(now / self._finished_count, 1e-3), 60.0)
        return 1.0

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
        if refused:
            self.last_retry_after_s = self.retry_after_hint(now)
            self.backpressure_events += 1
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

    def serve(self, arrivals: Sequence[Arrival],
              warm: bool = False) -> OnlineReport:
        """Serve the trace to completion and return measured stats.

        ``warm=True`` first serves the identical trace once, then
        ``reset()``s, so the measured pass starts from built kernels and
        an empty cache."""
        if warm:
            self.serve(arrivals, warm=False)
            self.reset()
        pending = sorted(arrivals, key=lambda a: a.t)
        eng = self.engine
        eng.last_run_ticks = 0
        eng.last_run_chunks = 0
        segments = 0
        self.last_retry_after_s = None
        self._finished_count = 0
        t0 = time.perf_counter()
        while pending or eng._queue or eng.free_slot_count() < eng.slots:
            self._ingest(pending, time.perf_counter() - t0, t0)
            if not eng._queue and eng.free_slot_count() == eng.slots:
                # nothing to admit or decode: sleep to the next arrival
                if pending:
                    gap = pending[0].t - (time.perf_counter() - t0)
                    if gap > 0:
                        time.sleep(min(gap, 0.05))
                continue
            ev = eng.run_segment(self.seg_steps,
                                 prefix_cache=self.prefix_cache)
            t_sync = time.perf_counter()
            segments += 1
            for rid in ev["first_tokens"]:
                self._reqs[rid].first_token_time = t_sync
            for rid in ev["finished"]:
                # the engine stamps finish during its replay; the client
                # sees the tokens now
                self._reqs[rid].finish_time = t_sync
                self._finished_count += 1
        makespan = time.perf_counter() - t0

        reqs = list(self._reqs.values())
        assert all(r.done or (eng.eos is not None and eng.eos in r.tokens)
                   for r in reqs), "scheduler exited with unserved requests"
        total_tokens = sum(len(r.tokens) for r in reqs)
        ttfts = [r.first_token_time - r.arrival_time for r in reqs]
        e2es = [r.finish_time - r.arrival_time for r in reqs]
        qwaits = [r.admit_time - r.arrival_time for r in reqs]
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
            slot_occupancy=(total_tokens / (eng.last_run_ticks * eng.slots)
                            if eng.last_run_ticks else 0.0),
            segments=segments,
            ticks=eng.last_run_ticks,
            backpressure_events=self.backpressure_events,
            backpressure_pages=eng.page_backpressure_events,
            pages=eng.pager.stats() if eng.paged else None,
            prefix=(self.prefix_cache.stats()
                    if self.prefix_cache is not None else None),
            retry_after_s=self.last_retry_after_s,
            per_request=[{
                "rid": r.rid,
                "prompt_len": int(len(r.prompt)),
                "gen_len": len(r.tokens),
                "prefix_hit_len": r.prefix_hit_len,
                "ttft_s": round(r.first_token_time - r.arrival_time, 4),
                "e2e_s": round(r.finish_time - r.arrival_time, 4),
            } for r in reqs],
        )

    def results(self) -> Dict[int, List[int]]:
        """rid -> generated tokens for every served request (truncated at
        max_new_tokens and after the first EOS, like ``ServingEngine.run``)."""
        self.engine.collect_finished()
        return {rid: r.tokens for rid, r in self._reqs.items()}
