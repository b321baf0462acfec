"""The port's observability base against the JAX package's, on the CPU.

The same calls go to ``paddle_tpu_torch.observability`` and
``paddle_tpu.observability``: the metrics registry (snapshots, Prometheus
text, rank merges and the log-dir merge), the flight ring, the journal
(records, rotation, readers, journeys) and its decision clock (record,
feed, and a ``JournalError`` when the feed runs out), request tracing, and
the SLO, perf (with the v5e figures passed explicitly) and capacity
monitors fed the same synthetic stamps. The zero-extra-sync contract is
held as a refusal: a ``torch.Tensor`` can reach neither a metric nor the
journal. ``aggregate_meters`` is held to the identity that its fair-share
streams tile the segment steps of a plain paged serve.
"""

import json
import os

import numpy as np
import pytest
import torch

from paddle_tpu.inference.scheduler import OnlineScheduler as JaxOnline
from paddle_tpu.inference.scheduler import staggered_arrivals as jax_trace
from paddle_tpu.inference.serving import ServingEngine as JaxEngine
from paddle_tpu.observability import capacity as jcap
from paddle_tpu.observability import flight as jflight
from paddle_tpu.observability import journal as jjournal
from paddle_tpu.observability import metrics as jmetrics
from paddle_tpu.observability import perf as jperf
from paddle_tpu.observability import slo as jslo
from paddle_tpu.observability import tracing as jtracing
from paddle_tpu.parallel import set_mesh
from paddle_tpu.profiler import _hooks as jhooks
from paddle_tpu_torch.inference import scheduler as tsched
from paddle_tpu_torch.inference.serving import ServingEngine
from paddle_tpu_torch.models import llama as tl
from paddle_tpu_torch.models.convert import params_from_numpy
from paddle_tpu_torch.observability import capacity as tcap
from paddle_tpu_torch.observability import flight as tflight
from paddle_tpu_torch.observability import journal as tjournal
from paddle_tpu_torch.observability import metrics as tmetrics
from paddle_tpu_torch.observability import perf as tperf
from paddle_tpu_torch.observability import slo as tslo
from paddle_tpu_torch.observability import tracing as ttracing
from paddle_tpu_torch.profiler import _hooks as thooks

SKIP_KEYS = ("v", "gseq", "rank", "seq", "t")


@pytest.fixture(scope="module")
def both(tiny_llama):
    set_mesh(None)
    cfg, params = tiny_llama
    tcfg = tl.LlamaConfig.tiny(max_seq_len=cfg.max_seq_len)
    tparams = params_from_numpy({k: np.asarray(v) for k, v in params.items()},
                                tcfg, "cpu")
    return cfg, params, tcfg, tparams


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------


def _script(mod, reg, variant):
    """One sequence of metric calls into ``reg``."""
    rng = np.random.RandomState(variant)
    reg.counter("serving.admissions", "admitted").inc(3)
    reg.counter("serving.admissions").inc(np.int64(2))
    reg.gauge("serving.queue_depth").set(np.float32(4.5))
    h = reg.histogram("serving.ttft_s", "first token")
    for v in rng.exponential(0.05, 40):
        h.observe(float(v))
    reg.histogram("request.ttft[class0]").observe(0.01 * variant)
    reg.histogram("request.ttft[class1]", buckets=(0.1, 1.0)).observe(2.0)
    reg.counter("scheduler.shed[class1]").inc()
    reg.gauge('perf.mfu[decode "tick"]').set(0.25)
    if variant:
        reg.counter("odd name-with/bad:chars").inc(variant)
    return reg


class TestMetrics:
    @pytest.mark.parametrize("variant", [0, 1, 2])
    def test_snapshot_and_prometheus_match_jax(self, variant):
        got = _script(tmetrics, tmetrics.Registry(), variant)
        want = _script(jmetrics, jmetrics.Registry(), variant)
        assert got.snapshot(rank=3) == want.snapshot(rank=3)
        assert got.render_prometheus() == want.render_prometheus()
        hg = got._metrics["serving.ttft_s"]
        hw = want._metrics["serving.ttft_s"]
        for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0):
            assert hg.quantile(q) == hw.quantile(q)

    def test_merge_snapshots_matches_jax(self):
        snaps_t = [_script(tmetrics, tmetrics.Registry(), v).snapshot(rank=v)
                   for v in range(3)]
        snaps_j = [_script(jmetrics, jmetrics.Registry(), v).snapshot(rank=v)
                   for v in range(3)]
        assert snaps_t == snaps_j
        assert tmetrics.merge_snapshots(snaps_t) == \
            jmetrics.merge_snapshots(snaps_j)
        bad = [dict(snaps_t[0]), dict(snaps_t[1])]
        bad[1]["histograms"] = {"serving.ttft_s": {
            **snaps_t[1]["histograms"]["serving.ttft_s"], "buckets": [1.0]}}
        with pytest.raises(ValueError, match="ladders differ"):
            tmetrics.merge_snapshots(bad)

    def test_log_dir_merge_skips_corrupt_file(self, tmp_path):
        d_t, d_j = tmp_path / "t", tmp_path / "j"
        for mod, d in ((tmetrics, d_t), (jmetrics, d_j)):
            for v in range(2):
                mod.write_snapshot(str(d), rank=v,
                                   registry=_script(mod, mod.Registry(), v))
            (d / "telemetry_rank9.json").write_text('{"trunc')
        got = tmetrics.merge_log_dir(str(d_t))
        want = jmetrics.merge_log_dir(str(d_j))
        assert got == want and got["skipped_files"] == [
            "telemetry_rank9.json"]
        with pytest.raises(FileNotFoundError):
            tmetrics.merge_log_dir(str(tmp_path / "empty"))

    def test_percentile_matches_jax_and_is_the_schedulers(self):
        rng = np.random.RandomState(11)
        for n in (0, 1, 2, 7, 100):
            xs = list(rng.standard_normal(n))
            for q in (0.0, 0.25, 0.5, 0.9, 0.99, 1.0):
                assert tmetrics.percentile(xs, q) == \
                    jmetrics.percentile(xs, q)
        assert tsched.percentile is tmetrics.percentile

    @pytest.mark.parametrize("call", ["inc", "set", "observe"])
    def test_refuses_a_tensor(self, call):
        """The zero-extra-sync contract: a tensor (on any device) is a
        caller bug, refused before it could be read."""
        reg = tmetrics.Registry()
        m = {"inc": reg.counter("c"), "set": reg.gauge("g"),
             "observe": reg.histogram("h")}[call]
        with pytest.raises(TypeError, match="host scalars only"):
            getattr(m, call)(torch.tensor(1.0))
        getattr(m, call)(np.float64(1.0))       # numpy scalars are host

    def test_set_enabled_and_scoped_registry(self):
        reg = tmetrics.Registry()
        with tmetrics.scoped_registry(reg):
            tmetrics.counter("x").inc()
            prev = tmetrics.set_enabled(False)
            try:
                tmetrics.counter("x").inc(5)
                tmetrics.gauge("y").set(3)
            finally:
                tmetrics.set_enabled(prev)
        assert reg.snapshot(rank=0)["counters"]["x"] == {"value": 1.0}
        assert reg.snapshot(rank=0)["gauges"]["y"] == {"value": 0.0}
        assert "x" not in tmetrics.registry()._metrics or \
            tmetrics.registry() is not reg
        with pytest.raises(TypeError, match="already registered"):
            reg.gauge("x")


# ---------------------------------------------------------------------------
# flight recorder
# ---------------------------------------------------------------------------


def _flight_ops(mod):
    fr = mod.FlightRecorder(capacity=4)
    seen = []
    mod.LISTENERS.append(lambda k, d: seen.append(k))
    try:
        for i in range(6):
            fr.record("admit" if i % 2 else "segment", rid=i, steps=i * 2)
    finally:
        mod.LISTENERS.pop()
    fr.set_capacity(3)
    strip = lambda evs: [{k: v for k, v in e.items() if k != "t"}
                         for e in evs]
    return (strip(fr.events()), strip(fr.events(kind="admit")),
            strip(fr.events(rid=5)), fr.dropped_events, len(fr),
            fr.capacity, seen)


class TestFlight:
    def test_ring_matches_jax(self):
        assert _flight_ops(tflight) == _flight_ops(jflight)

    def test_dump_and_dump_on_exception(self, tmp_path):
        fr = tflight.FlightRecorder(capacity=8)
        fr.record("probe", rid=1)
        path = tmp_path / "ring.json"
        evs = fr.dump(str(path), reason="test")
        on_disk = json.loads(path.read_text())
        assert on_disk["reason"] == "test" and on_disk["events"] == evs
        assert on_disk["capacity"] == 8
        tflight.clear()
        crash = tmp_path / "crash.json"
        with pytest.raises(RuntimeError):
            with tflight.dump_on_exception(str(crash)):
                raise RuntimeError("boom")
        dumped = json.loads(crash.read_text())
        assert dumped["reason"] == "exception: RuntimeError"
        assert dumped["events"][-1]["kind"] == "exception"

    def test_capacity_validation(self):
        with pytest.raises(ValueError):
            tflight.FlightRecorder(capacity=0)


# ---------------------------------------------------------------------------
# journal and the decision clock
# ---------------------------------------------------------------------------


def _journal_ops(mod, log_dir=None):
    j = mod.Journal(log_dir=log_dir, max_bytes=400)
    j.begin_serve({"driver": "online", "trace": [1, 2]})
    j.record("arrival", rid=1, at=0.0, prompt=np.arange(3))
    with j.rank_scope(2):
        j.record("admit", rid=1, tokens_done=np.int64(0))
    j.record("first_token", rid=1, ttft_s=np.float32(0.5))
    j.record("preempt", rid=1, slot=0)
    j.record("admit", rid=1, tokens_done=2)
    j.record("finish", rid=1, tokens=[4, 5, 6], n_tokens=3)
    j.record("arrival", rid=2, at=0.1)
    j.begin_serve({"driver": "slo"})
    j.record("shed_decision", rid=7, late_by_s=0.2)
    recs = [{k: v for k, v in r.items() if k not in SKIP_KEYS}
            for r in j.records()]
    secs = mod.sections(j.records())
    return (recs, [len(s["records"]) for s in secs],
            [s["header"]["driver"] for s in secs],
            {k: v for k, v in mod.request_journey(j.records(), 1).items()
             if k != "events"},
            j.serves, j.total_records, j.tail(n=2, kind="admit")[-1]["rid"])


class TestJournal:
    def test_records_and_readers_match_jax(self):
        assert _journal_ops(tjournal) == _journal_ops(jjournal)

    def test_file_journal_rotates_and_reads_back(self, tmp_path):
        got = _journal_ops(tjournal, str(tmp_path / "t"))
        want = _journal_ops(jjournal, str(tmp_path / "j"))
        assert got == want
        parts = sorted(os.listdir(tmp_path / "t"))
        assert any(".jsonl." in p for p in parts)
        (tmp_path / "t" / "journal_rank5.jsonl").write_text("{oops\n")
        out = tjournal.read_journal(str(tmp_path / "t"))
        assert out["skipped_files"] == ["journal_rank5.jsonl"]
        assert out["ranks"] == [0, 2]

    def test_refuses_a_tensor(self):
        j = tjournal.Journal()
        with pytest.raises(TypeError, match="device value"):
            j.record("admit", rid=torch.tensor(1))
        with pytest.raises(TypeError, match="device value"):
            j.record("finish", tokens=[1, torch.tensor([2])])

    def test_clock_records_when_attached(self):
        j = tjournal.Journal()
        with tjournal.attach(j):
            a = tjournal.now()
            b = tjournal.now()
            tflight.record("segment", steps=1)     # forwarded
        assert a <= b
        recs = j.records()
        assert [r["kind"] for r in recs] == ["clock", "clock", "segment"]
        assert [r["c"] for r in recs[:2]] == [a, b]
        assert tjournal.active() is None
        tflight.record("segment", steps=2)         # not forwarded now
        assert len(j.records()) == 3

    def test_feed_replays_values_and_skips_sleep(self):
        j = tjournal.Journal()
        with tjournal.attach(j), tjournal.feed_clock([5.0, 6.5]) as feed:
            assert tjournal.now() == 5.0
            tjournal.sleep(30.0)                     # skipped under a feed
            assert tjournal.now() == 6.5
            assert feed.remaining == 0
        assert [r["c"] for r in j.records()] == [5.0, 6.5]

    def test_exhausted_feed_raises(self):
        with tjournal.feed_clock([1.0]):
            tjournal.now()
            with pytest.raises(tjournal.JournalError, match="exhausted"):
                tjournal.now()

    def test_misuse_raises(self):
        j = tjournal.Journal()
        with tjournal.attach(j):
            with pytest.raises(tjournal.JournalError, match="already"):
                tjournal.install(tjournal.Journal())
        with pytest.raises(tjournal.JournalError, match="not installed"):
            tjournal.uninstall(j)
        with tjournal.feed_clock([1.0]):
            with pytest.raises(tjournal.JournalError, match="feed"):
                with tjournal.feed_clock([2.0]):
                    pass

    def test_shadow_scope_marks_records(self):
        j = tjournal.Journal()
        with tjournal.attach(j):
            with tjournal.shadow_scope():
                tjournal.record("admit", rid=1)
            tjournal.record("admit", rid=2)
        recs = j.records()
        assert recs[0].get("shadow") is True and "shadow" not in recs[1]

    def test_serve_header_matches_jax(self, both):
        """A serve's journal header: the engine and cache descriptions and
        the trace equal the JAX serve's (the model config aside: the
        packages' config classes differ in fields)."""
        cfg, params, tcfg, tparams = both
        geom = dict(slots=2, max_len=96, prompt_buckets=(16, 32),
                    paged=True, page_size=16)
        heads = []
        for port in (True, False):
            mod = tjournal if port else jjournal
            eng = (ServingEngine(tcfg, tparams, device="cpu", **geom)
                   if port else JaxEngine(cfg, params, **geom))
            trace = (tsched.staggered_arrivals if port else jax_trace)(
                3, 3, 0.0, cfg.vocab_size, prompt_lens=(5,),
                gen_lens=(3,))
            sch = (tsched.OnlineScheduler if port else JaxOnline)(
                eng, seg_steps=8)
            j = mod.Journal()
            with mod.attach(j):
                sch.serve(trace)
            h = dict(j.header)
            h.pop("llama")
            heads.append(h)
        assert heads[0] == heads[1]


# ---------------------------------------------------------------------------
# tracing
# ---------------------------------------------------------------------------


class _Collector:
    def __init__(self):
        self.spans = []

    def _host_event(self, name, start, end, kind):
        self.spans.append((name, start, end, kind))


@pytest.mark.parametrize("stamps", [(1.0, 1.5, 2.0, 3.0, 0),
                                    (1.0, 1.0, 2.0, 2.0, 32),
                                    (0.0, 1.0, 2.0, 3.0, 16)])
def test_request_trace_matches_jax(stamps):
    out = []
    for hooks, tracing in ((thooks, ttracing), (jhooks, jtracing)):
        c = _Collector()
        hooks.COLLECTORS.append(c)
        try:
            tracing.emit_request_trace(7, *stamps[:4],
                                       prefix_hit_len=stamps[4])
            with tracing.span("serving.segment", kind="serving"):
                pass
        finally:
            hooks.COLLECTORS.remove(c)
        out.append([s[0] if s[0] == "serving.segment" else s
                    for s in c.spans])
    assert out[0] == out[1]
    assert not thooks.active()


# ---------------------------------------------------------------------------
# monitors fed synthetic stamps
# ---------------------------------------------------------------------------


def _slo_run(mod):
    objs = {0: mod.Objective(ttft_target_s=0.1, compliance=0.9),
            1: mod.Objective(e2e_target_s=1.0, tbt_target_s=0.05)}
    mon = mod.SLOMonitor(objs, fast_window=2, slow_window=4,
                         clear_after=2, accept_drift={"min_segments": 2,
                                                      "sustain": 1},
                         pool_objectives={"decode": mod.Objective(
                             tbt_target_s=0.02)})
    rng = np.random.RandomState(3)
    for seg in range(14):
        bad = 4 <= seg < 9
        for _ in range(3):
            mon.note_ttft(0, 0.5 if bad else 0.05)
            mon.note_e2e(1, float(rng.uniform(0.5, 2.0)))
            mon.note_pool_tbt("decode", 0.03 if bad else 0.01)
        mon.note_accept_rate(0.2 if bad else 0.8)
        mon.end_segment()
    rep = mon.report()
    desc = mon.describe()
    again = mod.SLOMonitor.from_description(desc).describe()
    return rep, desc == again, mon.worst_level()


def _perf_run(mod, cfg, params, **kw):
    mon = mod.PerfMonitor(cfg, params, batch=4, avg_pos=48.0,
                          pin_after=3, tolerance=1.2, **kw)
    for i, dt in enumerate([0.01, 0.011, 0.0105, 0.03, 0.04, 0.01]):
        mon.note_segment(8, 20, elapsed_s=dt * 8)
    mon.note_segment(4, 6, elapsed_s=None)
    rep = mon.interval_report()
    for k in ("interval_s", "tok_s", "roofline_fraction", "mfu",
              "busy_fraction"):
        rep.pop(k)
    return rep, mon.ledger, mon.regressions


def _cap_run(mod):
    cap = mod.CapacityMonitor(fast_window=2, slow_window=4, warn_horizon=8,
                              page_horizon=3, clear_after=2)
    for seg, (free, rec, host, pages) in enumerate(
            [(40, 4, None, 2), (36, 4, 10, 6), (28, 2, 12, 9),
             (18, 2, 12, 9), (9, 0, 20, 8), (30, 6, 20, 0),
             (40, 6, 20, 0), (44, 6, 20, 0), (44, 6, None, 0)]):
        cap.begin_segment(free, rec, host_pages=host)
        cap.note_admission(pages, admitted=1)
        cap.close_segment()
    return cap.report(), cap.describe()


class TestMonitors:
    def test_slo_monitor_matches_jax(self):
        got, want = _slo_run(tslo), _slo_run(jslo)
        assert got == want
        assert got[0]["alerts"] and got[1]

    def test_perf_monitor_with_v5e_figures_matches_jax(self, both):
        """With the JAX defaults passed explicitly, the ledger (the JAX
        side's hazard-budget join aside) and the sentinel equal JAX's."""
        cfg, params, tcfg, tparams = both
        got = _perf_run(tperf, tcfg, tparams, hbm_bytes_s=819e9,
                        peak_flops_s=197e12)
        want = _perf_run(jperf, cfg, params)
        ledger = dict(want[1])
        ledger.pop("hazard_budget", None)
        assert got[0] == want[0] and got[1] == ledger and got[2] == want[2]
        assert got[2] >= 1

    def test_perf_defaults_are_the_h100s(self, both):
        tcfg, tparams = both[2:]
        led = tperf.serving_ledger(tcfg, tparams, batch=8, avg_pos=64.0)
        assert tperf.H100_HBM_BPS == 3.35e12
        assert tperf.H100_PEAK_FLOPS == 989e12
        assert led["hbm_bytes_s"] == 3.35e12
        assert led["peak_flops_s"] == 989e12
        n = sum(t.numel() for t in tparams.values())
        assert led["n_params"] == n
        assert "hazard_budget" not in led

    def test_capacity_monitor_matches_jax(self):
        got, want = _cap_run(tcap), _cap_run(jcap)
        assert got == want
        levels = [a["level"] for a in got[0]["alerts"]]
        assert "page" in levels or "warning" in levels
        assert got[0]["avail_by_tier"]["host"] == 20

    @pytest.mark.parametrize("stats", [
        {"mean_prompt_tokens": 40, "mean_new_tokens": 24,
         "rate_req_s": 2.0},
        {"mean_prompt_tokens": 100, "mean_new_tokens": 8,
         "concurrency": 3},
        {"mean_prompt_tokens": 16, "mean_new_tokens": 64,
         "rate_req_s": None, "mean_service_s": 1.5}])
    def test_capacity_plan_matches_jax(self, stats):
        kw = dict(page_size=16, slots=8, headroom=0.1,
                  measured={"per_tick_s": 0.008, "slot_occupancy": 0.7})
        assert tcap.capacity_plan(stats, **kw) == \
            jcap.capacity_plan(stats, **kw)
        with pytest.raises(NotImplementedError, match="chip-fit"):
            tcap.capacity_plan(stats, hbm_bytes=80 << 30, **kw)


class TestPoolAndMeters:
    def _pool_ops(self, both, port):
        cfg, params, tcfg, tparams = both
        geom = dict(slots=3, max_len=96, prompt_buckets=(16, 32),
                    paged=True, page_size=16, num_pages=24)
        eng = (ServingEngine(tcfg, tparams, device="cpu", **geom) if port
               else JaxEngine(cfg, params, **geom))
        mod = tcap if port else jcap
        pgr = eng.pager
        mon = mod.PoolMonitor(pgr, high_water_frac=0.5, timeline_cap=4)
        with mon:
            spans = [pgr.reserve(rows)[0] for rows in (40, 70, 90, 33)]
            pgr.install(0, spans[0])
            pgr.allocator.retain(spans[1][:2])
            pgr.release_pages(spans[2])
            pgr.release_pages(spans[1][:2])
        snap = mon.snapshot()
        snap.pop("page_seconds_integral")
        return snap

    def test_pool_monitor_matches_jax(self, both):
        got = self._pool_ops(both, True)
        assert got == self._pool_ops(both, False)
        assert got["high_water_events"] == 1 and got["timeline"]

    def test_meters_tile_the_segment_steps(self, both):
        """On a plain paged serve the requests' fair-share weight streams
        sum to the segment steps, and the per-class meter (page-seconds
        aside) equals JAX's."""
        cfg, params, tcfg, tparams = both
        geom = dict(slots=3, max_len=96, chunk=8, prompt_buckets=(16, 32),
                    paged=True, page_size=16)
        outs = []
        for port in (True, False):
            eng = (ServingEngine(tcfg, tparams, device="cpu", **geom)
                   if port else JaxEngine(cfg, params, **geom))
            mk = tsched.staggered_arrivals if port else jax_trace
            sch = (tsched.OnlineScheduler if port else JaxOnline)(
                eng, seg_steps=16)
            rep = sch.serve(mk(5, 7, 0.0, cfg.vocab_size,
                               prompt_lens=(5, 9, 14), gen_lens=(4, 7)))
            reqs = list(sch._reqs.values())
            ledger = (tperf if port else jperf).serving_ledger(
                tcfg if port else cfg, tparams if port else params,
                batch=3, avg_pos=16.0, hbm_bytes_s=819e9,
                peak_flops_s=197e12)
            agg = (tcap if port else jcap).aggregate_meters(
                reqs, ledger=ledger, page_size=16)
            assert abs(agg["total"]["streams"] - rep.ticks) < 1e-3
            assert rep.meter["total"]["streams"] == agg["total"]["streams"]
            for a in [agg["total"]] + list(agg["per_class"].values()):
                a.pop("page_seconds")
            outs.append((agg, [(r.pages_reserved, r.pages_fresh,
                                r.meter_ticks, round(r.meter_streams, 6))
                               for r in reqs]))
            assert all(r.page_seconds > 0 for r in reqs)
        assert outs[0] == outs[1]

    def test_install_attaches_to_segment_hooks(self, both):
        from paddle_tpu_torch.inference import paged_kv, serving

        tcfg, tparams = both[2:]
        eng = ServingEngine(tcfg, tparams, slots=2, max_len=96,
                            prompt_buckets=(16,), paged=True, page_size=16,
                            device="cpu")
        slo = tslo.SLOMonitor({0: tslo.Objective(ttft_target_s=1.0)})
        perf = tperf.PerfMonitor(tcfg, tparams, batch=2)
        cap = tcap.CapacityMonitor()
        for mod, mon in ((tslo, slo), (tperf, perf), (tcap, cap)):
            mod.install(mon)
            mod.install(mon)                      # idempotent
        try:
            eng.add_request(np.arange(10, dtype=np.int32), 4)
            while eng._queue or eng.free_slot_count() < eng.slots:
                eng.run_segment(8)
        finally:
            for mod, mon in ((tslo, slo), (tperf, perf), (tcap, cap)):
                mod.uninstall(mon)
        assert slo.segment_no == perf.segments == cap.segment_no >= 1
        assert cap.pages_admitted_total >= 1
        assert not serving.SEGMENT_HOOKS and not paged_kv.POOL_HOOKS
