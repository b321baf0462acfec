"""Explained performance: the analytic roofline ledger of a serving
program joined with its runtime counters, and a tick-time regression
sentinel.

Port of ``serving_ledger`` and ``PerfMonitor`` from
``paddle_tpu/observability/perf.py``. Host arithmetic only:

* ``serving_ledger`` computes, from the live parameter tree (shapes, no
  device read): the weight bytes a decode tick streams (every parameter
  but the embedding table, whose row is a gather), the KV bytes a tick
  reads at the average position, the tick floor at the memory rate, the
  tok/s ceiling, and matmul FLOPs a token.
* ``PerfMonitor`` accumulates the counters the scheduler already holds
  (steps, tokens, segment wall time) and reports per interval the
  roofline fraction (measured tok/s over the ceiling) and MFU (measured
  FLOP/s over the peak) in the gauges ``perf.roofline_fraction[<p>]``,
  ``perf.mfu[<p>]`` and ``perf.tok_s[<p>]``.
* The regression sentinel: an EWMA of seconds a tick against a budget
  (given, or pinned from the first ``pin_after`` segments) emits a
  ``perf_regression`` flight event and counts ``perf.regressions`` when
  it crosses ``tolerance`` times the budget.

The default roofline is the card the port runs on: the published figures
of the NVIDIA H100 80GB HBM3 (SXM) at 700 W, 3.35 TB/s of HBM3 and
989 TFLOP/s of dense bf16 tensor-core math (``H100_HBM_BPS``,
``H100_PEAK_FLOPS``). A card capped below 700 W reaches less; pass the
figures of another card explicitly. The JAX package's ledger joins a
static hazard budget per program; the port has no such budgets and its
ledger has no ``hazard_budget`` key.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

from . import flight as _flight
from . import metrics as _metrics

__all__ = ["serving_ledger", "PerfMonitor", "H100_HBM_BPS",
           "H100_PEAK_FLOPS", "install", "uninstall"]

# NVIDIA H100 80GB HBM3 (SXM, 700 W), published: HBM3 bandwidth and dense
# bf16 tensor-core throughput
H100_HBM_BPS = 3.35e12
H100_PEAK_FLOPS = 989e12


def serving_ledger(cfg, params, batch: int, avg_pos: float,
                   program: str = "serving_segment",
                   hbm_bytes_s: float = H100_HBM_BPS,
                   peak_flops_s: float = H100_PEAK_FLOPS) -> dict:
    """Analytic byte/op ledger for a decode-bound serving program,
    computed from the LIVE param tree (host shape metadata only — no
    device sync). ``batch`` is the concurrent slot count, ``avg_pos``
    the average KV position a tick attends over.

    Every decode tick streams the non-embedding weights once plus the
    KV rows written so far; the ceiling is ``batch / tick_floor``.
    FLOPs/token = 2 x non-embedding params (matmul MACs x 2) plus the
    attention score/value contractions at ``avg_pos``."""
    n_params = sum(int(np.prod(tuple(p.shape)))
                   for p in params.values())
    embed_rows = cfg.vocab_size * cfg.hidden_size
    itemsize = cfg.dtype.itemsize
    weight_bytes = (n_params - embed_rows) * itemsize
    kv_bytes = (cfg.num_layers * 2 * float(avg_pos) * cfg.num_kv_heads
                * cfg.head_dim * batch * itemsize)
    tick_floor_s = (weight_bytes + kv_bytes) / hbm_bytes_s
    ceiling_tok_s = batch / tick_floor_s
    flops_per_token = (2.0 * (n_params - embed_rows)
                       + 4.0 * float(avg_pos) * cfg.num_heads
                       * cfg.head_dim * cfg.num_layers)
    ledger = {
        "program": program,
        "batch": int(batch),
        "avg_pos": float(avg_pos),
        "n_params": n_params,
        "weight_bytes_per_tick": int(weight_bytes),
        "kv_bytes_per_tick": int(kv_bytes),
        "hbm_bytes_s": hbm_bytes_s,
        "peak_flops_s": peak_flops_s,
        "tick_floor_s": tick_floor_s,
        "ceiling_tok_s": ceiling_tok_s,
        "flops_per_token": flops_per_token,
    }
    return ledger


class PerfMonitor:
    """Join one serving program's analytic ledger with its runtime
    counters; report roofline fraction + MFU per interval and watch the
    per-tick EWMA for regressions.

    Feed it per-segment host numbers via :meth:`note_segment` (the
    schedulers pass exact steps/tokens/elapsed from the audited fetch's
    host mirrors) and call :meth:`end_interval` whenever a report
    should be cut (the benchmarks cut one per rated serve; the ops
    endpoint serves the running interval live).

    ``tick_budget_s``: pinned seconds/tick the sentinel guards. When
    ``None`` it self-pins to the EWMA after ``pin_after`` segments —
    the 'no regression vs my own warm baseline' mode the serving lanes
    use. ``tolerance``: multiplier over budget that trips the sentinel.
    """

    def __init__(self, cfg, params, batch: int, avg_pos: float = 64.0,
                 program: str = "serving_segment",
                 hbm_bytes_s: float = H100_HBM_BPS,
                 peak_flops_s: float = H100_PEAK_FLOPS,
                 tick_budget_s: Optional[float] = None,
                 pin_after: int = 4, tolerance: float = 1.5,
                 ewma_alpha: float = 0.5):
        self.program = program
        self.ledger = serving_ledger(cfg, params, batch, avg_pos,
                                     program=program,
                                     hbm_bytes_s=hbm_bytes_s,
                                     peak_flops_s=peak_flops_s)
        self.tick_budget_s = tick_budget_s
        self._explicit_budget = tick_budget_s is not None
        self.pin_after = int(pin_after)
        self.tolerance = float(tolerance)
        self.ewma_alpha = float(ewma_alpha)
        self.tick_ewma_s: Optional[float] = None
        self.regressions = 0
        self.segments = 0             # lifetime (the self-pin clock)
        # interval accumulators (host ints/floats only)
        self._iv_segments = 0
        self._iv_steps = 0
        self._iv_tokens = 0
        self._iv_busy_s = 0.0
        self._iv_t0: Optional[float] = None
        self.last_report: Optional[dict] = None

    # --- per-segment intake ----------------------------------------------
    def note_segment(self, steps: int, new_tokens: int,
                     elapsed_s: Optional[float] = None) -> None:
        """One segment's host mirrors: device ticks run, tokens
        surfaced, and (when the caller timed the dispatch→fetch span)
        its wall time. ``elapsed_s=None`` skips the sentinel (ambient
        attachments that cannot time the segment still feed the
        throughput interval)."""
        if self._iv_t0 is None:
            self._iv_t0 = time.perf_counter()
        self.segments += 1
        self._iv_segments += 1
        self._iv_steps += int(steps)
        self._iv_tokens += int(new_tokens)
        if elapsed_s is None or steps <= 0:
            return
        self._iv_busy_s += float(elapsed_s)
        per_tick = float(elapsed_s) / int(steps)
        self.tick_ewma_s = (per_tick if self.tick_ewma_s is None
                            else (1 - self.ewma_alpha) * self.tick_ewma_s
                            + self.ewma_alpha * per_tick)
        _metrics.gauge(
            f"perf.tick_time_ewma_s[{self.program}]").set(self.tick_ewma_s)
        if not self._explicit_budget:
            if self.segments == self.pin_after:
                # self-pin: the warm baseline becomes the budget
                self.tick_budget_s = self.tick_ewma_s
            elif self.segments < self.pin_after:
                return
        if (self.tick_budget_s is not None
                and self.tick_ewma_s > self.tolerance * self.tick_budget_s):
            self.regressions += 1
            _metrics.counter("perf.regressions").inc()
            _flight.record(
                "perf_regression", program=self.program,
                tick_ewma_s=round(self.tick_ewma_s, 6),
                budget_s=round(self.tick_budget_s, 6),
                tolerance=self.tolerance, segment=self.segments)

    # --- interval reporting ----------------------------------------------
    def interval_report(self, now: Optional[float] = None) -> dict:
        """The running interval's explained numbers (without closing
        it): measured tok/s, roofline fraction, MFU, busy fraction."""
        now = time.perf_counter() if now is None else now
        elapsed = (now - self._iv_t0) if self._iv_t0 is not None else 0.0
        tok_s = self._iv_tokens / elapsed if elapsed > 0 else 0.0
        led = self.ledger
        return {
            "program": self.program,
            "interval_s": round(elapsed, 4),
            "segments": self._iv_segments,
            "steps": self._iv_steps,
            "tokens": self._iv_tokens,
            "tok_s": round(tok_s, 2),
            "ceiling_tok_s": round(led["ceiling_tok_s"], 2),
            # NOT rounded: on the CPU the fraction of the card
            # ceiling is ~1e-6 and rounding would zero the signal
            "roofline_fraction": (tok_s / led["ceiling_tok_s"]
                                  if led["ceiling_tok_s"] else 0.0),
            "mfu": (tok_s * led["flops_per_token"] / led["peak_flops_s"]
                    if led["peak_flops_s"] else 0.0),
            "busy_fraction": (round(self._iv_busy_s / elapsed, 4)
                              if elapsed > 0 else 0.0),
            "tick_ewma_s": self.tick_ewma_s,
            "tick_budget_s": self.tick_budget_s,
            "regressions": self.regressions,
        }

    def end_interval(self) -> dict:
        """Close the interval: publish the gauges, reset accumulators,
        return (and retain) the report."""
        rep = self.interval_report()
        p = self.program
        _metrics.gauge(f"perf.tok_s[{p}]").set(rep["tok_s"])
        _metrics.gauge(f"perf.roofline_fraction[{p}]").set(
            rep["roofline_fraction"])
        _metrics.gauge(f"perf.mfu[{p}]").set(rep["mfu"])
        self._iv_segments = 0
        self._iv_steps = 0
        self._iv_tokens = 0
        self._iv_busy_s = 0.0
        self._iv_t0 = None
        self.last_report = rep
        return rep

    def report(self) -> dict:
        """The ``/perf`` endpoint payload: the analytic ledger plus the
        running interval and the last closed one."""
        return {"ledger": dict(self.ledger),
                "interval": self.interval_report(),
                "last_interval": self.last_report}


# ---------------------------------------------------------------------------
# Ambient attachment: every engine segment feeds
# the interval accumulators through serving.SEGMENT_HOOKS. No elapsed
# time is available at that hook (the engine doesn't time its own
# dispatch→fetch span), so the sentinel stays quiet — the attachment
# proves hazard-neutrality, the schedulers provide the timed feed.
# ---------------------------------------------------------------------------

_INSTALLED: list = []


def install(monitor: PerfMonitor) -> None:
    from ..inference import serving as _serving

    for m, _ in _INSTALLED:
        if m is monitor:
            return

    def hook(steps: int, new_tokens: int, finished: int) -> None:
        monitor.note_segment(steps, new_tokens, elapsed_s=None)

    _serving.SEGMENT_HOOKS.append(hook)
    _INSTALLED.append((monitor, hook))


def uninstall(monitor: Optional[PerfMonitor] = None) -> None:
    from ..inference import serving as _serving

    keep = []
    for m, hook in _INSTALLED:
        if monitor is None or m is monitor:
            if hook in _serving.SEGMENT_HOOKS:
                _serving.SEGMENT_HOOKS.remove(hook)
        else:
            keep.append((m, hook))
    _INSTALLED[:] = keep
