"""The port's elastic fleet (``inference/autoscaler.py`` and the fleet's
lifecycle) against the JAX package's, on the CPU.

The reference's 1x -> 4x -> 1x episode (``tests/test_autoscaler.py``: four
paged replicas with tiered prefix caches and the cache directory, one
policy, the SLO and capacity monitors, a burst, a spread wave over four
prefix groups, a sparse repeat wave and a single-request tail) is served
once by the JAX router under a recording journal and once by the port's
under that clock fed back. Held equal: assignment, tokens, every decision
record (``scale_decision`` with its input snapshot, the ``dispatch``
rankings with their lifecycles, ``tier_migrate`` and ``failover_requeue``
of the drains, ...), the ``replica_warmed`` records (their seconds are fed
clock differences) and ``FleetReport.as_dict()`` with its ``autoscaler``
section (``cold_start_s`` and the port's tier ``flushes`` aside). Then
the reference's contracts on the port's serve: no request stranded, each
scale-up warmed before its replica admits, the lifecycles back at 1x, the
port's own journal replaying bit-exactly and a mutated ``scale_decision``
named as the first divergence, and the warmed re-serve within the
zero budget of ``analysis.recompile``.

Also: the chip-fit refusal and the drain requeue (both packages, fed
clock), ``describe`` round trip and validation, ``install`` counting
segments, ``emit_scaling_trace`` against the JAX spans, the drain-aware
retry hint, and a ``DisaggRouter`` with one policy per pool (both
packages, fed clock, then replayed). Not run here: the ops endpoints
(``exporter.py``, ROADMAP Queue A item 7) and the sync audit of the JAX
package's gate (the port's fetch audit is held in
``test_torch_fleet.py``).
"""

import copy

import numpy as np
import pytest
import torch

from paddle_tpu.inference import disagg as jdisagg
from paddle_tpu.inference import fleet as jfleet
from paddle_tpu.inference import scheduler as jsched
from paddle_tpu.inference.autoscaler import Autoscaler as JAutoscaler
from paddle_tpu.inference.kv_tiers import HostTier as JHostTier
from paddle_tpu.inference.prefix_cache import PagedPrefixCache as JPaged
from paddle_tpu.observability.capacity import CapacityMonitor as JCapacity
from paddle_tpu.observability.slo import Objective as JObjective
from paddle_tpu.observability.slo import SLOMonitor as JSLO
from paddle_tpu_torch.analysis import recompile
from paddle_tpu_torch.inference import autoscaler as tasc_mod
from paddle_tpu_torch.inference import disagg as tdisagg
from paddle_tpu_torch.inference import fleet as tfleet
from paddle_tpu_torch.inference import scheduler as tsched
from paddle_tpu_torch.inference.autoscaler import Autoscaler as TAutoscaler
from paddle_tpu_torch.inference.kv_tiers import HostTier as THostTier
from paddle_tpu_torch.inference.prefix_cache import PagedPrefixCache as TPaged
from paddle_tpu_torch.inference.serving import ServingEngine
from paddle_tpu_torch.observability import replay
from paddle_tpu_torch.observability import tracing as ttracing
from paddle_tpu_torch.observability.capacity import CapacityMonitor as TCapacity
from paddle_tpu_torch.observability.slo import Objective as TObjective
from paddle_tpu_torch.observability.slo import SLOMonitor as TSLO

from torch_fleet_common import (assert_same_serve, both_models, fed_serve,
                                records, two_threads)

N_REPLICAS = 4
N_PREFIX_GROUPS = 4
GEOM = dict(slots=2, max_len=96, prompt_buckets=(8, 16, 32), paged=True,
            page_size=16)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = two_threads()
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def both(tiny_llama):
    return both_models(tiny_llama)


def _pkg(port):
    """(fleet module, Autoscaler, PagedPrefixCache, HostTier, SLOMonitor,
    Objective, CapacityMonitor) of one package."""
    if port:
        return (tfleet, TAutoscaler, TPaged, THostTier, TSLO, TObjective,
                TCapacity)
    return (jfleet, JAutoscaler, JPaged, JHostTier, JSLO, JObjective,
            JCapacity)


def _build(both, port, n, **kw):
    cfg, params, tcfg, tparams = both
    fleet = _pkg(port)[0]
    if port:
        return fleet.build_fleet(tcfg, tparams, n, device="cpu", **kw)
    return fleet.build_fleet(cfg, params, n, **kw)


def _elastic_fleet(both, port, **asc_kw):
    """The reference episode's fleet on one package."""
    fleet, Asc, Paged, Tier, SLO, Obj, Cap = _pkg(port)
    engines = _build(both, port, N_REPLICAS, **GEOM)
    pcs = [Paged(e.pager, capacity_pages=16,
                 host_tier=Tier(e.pager, capacity_pages=64))
           for e in engines]
    kw = dict(min_replicas=1, max_replicas=N_REPLICAS, initial_replicas=1,
              queue_high=2, queue_low=0, scale_down_after=2)
    kw.update(asc_kw)
    asc = Asc(**kw)
    slo = SLO({0: Obj(ttft_target_s=0.5, e2e_target_s=2.0)},
              fast_window=2, slow_window=3, warn_burn=2.0, page_burn=8.0,
              clear_after=1)
    router = fleet.FleetRouter(engines, seg_steps=4, prefix_caches=pcs,
                               directory=True, autoscaler=asc,
                               slo_monitor=slo,
                               capacity_monitor=Cap(warn_horizon=0.5,
                                                    page_horizon=0.1))
    return router, asc


def _episode_trace(vocab):
    """The reference episode's four phases (a burst, a spread wave, a
    sparse repeat wave over the same prefixes, a single-request tail)."""
    def make(sched):
        rng = np.random.RandomState(7)
        prefs = [rng.randint(0, vocab, (16,)).astype(np.int32)
                 for _ in range(N_PREFIX_GROUPS)]

        def req(pref, gen=5):
            return (np.concatenate([pref, rng.randint(
                0, vocab, (6,)).astype(np.int32)]), gen)

        burst = [sched.Arrival(0.0, *req(rng.randint(0, vocab, (12,)
                                                     ).astype(np.int32)))
                 for _ in range(12)]
        spread = [sched.Arrival(2.0 + 0.08 * i,
                                *req(prefs[i % N_PREFIX_GROUPS]))
                  for i in range(8)]
        repeat = [sched.Arrival(4.5 + 0.4 * i,
                                *req(prefs[i % N_PREFIX_GROUPS], gen=4))
                  for i in range(8)]
        tail = [sched.Arrival(8.2 + 0.6 * i,
                              *req(prefs[i % N_PREFIX_GROUPS], gen=3))
                for i in range(3)]
        return burst + spread + repeat + tail
    return make


def _warmed(j):
    return [{k: v for k, v in r.items()
             if k not in ("v", "gseq", "rank", "seq", "t")}
            for r in j.records() if r["kind"] == "replica_warmed"]


@pytest.fixture(scope="module")
def episode(both):
    """The episode on both packages under one clock (JAX recorded)."""
    jr, jasc = _elastic_fleet(both, False)
    tr, tasc = _elastic_fleet(both, True)
    make = _episode_trace(both[0].vocab_size)
    run = fed_serve(jr, tr, make, jsched, tsched)
    return {"jr": jr, "tr": tr, "jasc": jasc, "tasc": tasc, "run": run,
            "make": make, "logs": {"jax": list(jasc.decision_log),
                                   "port": list(tasc.decision_log)}}


class TestElasticEpisode:
    def test_same_serve_decisions_and_report(self, episode):
        jr, tr, run = episode["jr"], episode["tr"], episode["run"]
        assert_same_serve(jr, tr, run)
        got = records(run["tj"], {"scale_decision"})
        assert got == records(run["jj"], {"scale_decision"}) and got
        assert _warmed(run["tj"]) == _warmed(run["jj"])
        assert run["trep"].autoscaler == run["jrep"].autoscaler
        assert [r.lifecycle for r in tr._replicas] == \
            [r.lifecycle for r in jr._replicas]
        assert [r.last_drain for r in tr._replicas] == \
            [r.last_drain for r in jr._replicas]
        assert tr.requeued == jr.requeued
        assert tr.tier_migrations == jr.tier_migrations

    def test_zero_stranded_and_back_to_initial(self, episode):
        tr, tasc, rep = episode["tr"], episode["tasc"], episode["run"]["trep"]
        out = tr.results()
        assert len(out) == rep.n_requests == 31
        assert all(out[rid] for rid in out)
        assert tr.leak_report() == []
        assert rep.scale_ups >= 1
        assert tasc.drains_completed == rep.scale_downs
        assert tasc.actual == tasc.desired
        drains = [d for d in tasc.decision_log
                  if d["action"] == "drain_complete"]
        assert all("0 stranded" in d["reason"] for d in drains)
        for d in tasc.decision_log:
            assert d["action"] in ("scale_up", "scale_down",
                                   "drain_complete", "refuse")
            assert set(d["inputs"]["lifecycle"]) == {"0", "1", "2", "3"}

    def test_warmup_before_traffic(self, episode):
        """Every scale-up warms its replica before it admits, and the
        decision's key estimate is what the warmup ran."""
        recs = episode["run"]["tj"].records()
        ups = [r for r in recs if r["kind"] == "scale_decision"
               and r["action"] == "scale_up"]
        warmed = [r for r in recs if r["kind"] == "replica_warmed"]
        assert len(warmed) == len(ups)
        for up, w in zip(ups, warmed):
            assert w["replica"] == up["replica"]
            assert w["keys"] == up["warmup"]["keys"]
            assert not [r for r in recs if r["kind"] == "admit"
                        and r["replica"] == up["replica"]
                        and up["gseq"] < r["gseq"] < w["gseq"]]

    def test_port_journal_replays_bit_exactly(self, episode, both):
        recs = episode["run"]["tj"].records()
        res = replay.replay_serve(recs, params=both[3])
        assert res.identical, (res.divergence, res.error)
        assert res.n_decisions == len([r for r in recs
                                       if r["kind"] in
                                       replay.DECISION_KINDS])

    def test_mutated_scale_decision_is_first_divergence(self, episode,
                                                        both):
        recs = copy.deepcopy(episode["run"]["tj"].records())
        victim = next(r for r in recs if r["kind"] == "scale_decision")
        victim["action"] = "scale_down"
        victim["desired"] = 99
        res = replay.replay_serve(recs, params=both[3])
        assert not res.identical
        assert res.divergence["kind"] == "scale_decision"
        assert res.divergence["field"] == "action"

    def test_scaling_trace_spans_equal_jax(self, episode):
        from paddle_tpu.observability import tracing as jtracing
        from paddle_tpu.profiler import _hooks as jhooks
        from paddle_tpu_torch.profiler import _hooks as thooks

        spans = {}
        for name, hooks, tracing in (("jax", jhooks, jtracing),
                                     ("port", thooks, ttracing)):
            got = []

            class _Coll:
                def _host_event(self, n, t0, t1, kind):
                    got.append((n, t1 - t0, kind))

            hooks.COLLECTORS.append(_Coll())
            try:
                tracing.emit_scaling_trace(episode["logs"][name])
            finally:
                hooks.COLLECTORS.pop()
            spans[name] = got
        assert spans["port"] == spans["jax"] and spans["port"]
        assert all(k == "serving.scaling" for _, _, k in spans["port"])

    def test_warmed_reserve_meets_zero_budget(self, episode):
        """With every replica warmed under the fleet's envelope (segments
        of 4 behind the caches' 16-token blocks; scale-ups warm it too), a
        reset re-serve (its scale-ups, warmups and drains included) loads
        no library, makes no ticket buffer and dispatches no key a
        replica had not run."""
        tr = episode["tr"]
        env = tr._replicas[0].engine.default_envelope(seg_steps=(4,),
                                                      prefix_block=16)
        tr.aot_warmup(env)
        assert tr.warm_envelope is env
        tr.reset()
        with recompile.enforce_zero_compiles("elastic re-serve") as cw:
            rep = tr.serve(episode["make"](tsched))
        assert cw.compiles == 0
        assert rep.n_requests == 31 and tr.leak_report() == []


def test_chip_fit_refusal(both):
    """An unfit candidate is refused once, with its verdict journaled, on
    both packages under one clock."""
    routers = []
    for port in (False, True):
        fleet, Asc = _pkg(port)[:2]
        engines = _build(both, port, 2, **GEOM)
        asc = Asc(min_replicas=1, max_replicas=2, initial_replicas=1,
                  queue_high=1, hbm_bytes=1024)
        routers.append(fleet.FleetRouter(engines, seg_steps=8,
                                         autoscaler=asc))

    def make(sched):
        rng = np.random.RandomState(13)
        return [sched.Arrival(0.0, rng.randint(0, both[0].vocab_size,
                                               (12,)).astype(np.int32), 5)
                for _ in range(4)]

    run = fed_serve(*routers, make, jsched, tsched)
    assert_same_serve(*routers, run)
    tr = routers[1]
    asc = tr.autoscalers[0]
    assert asc.refusals == 1 and run["trep"].scale_ups == 0
    assert tr._replicas[1].lifecycle == "offline"
    refusals = [r for r in records(run["tj"], {"scale_decision"})
                if r["action"] == "refuse"]
    assert len(refusals) == 1
    d = refusals[0]
    assert "chip_fit refused replica 1" in d["reason"]
    assert d["fit"]["fits"] is False
    assert d["fit"]["envelope_bytes"] > d["fit"]["hbm_bytes"] == 1024
    assert len(tr.results()) == 4


def test_drain_requeues_queued_requests(both):
    """A drain victim's queued requests requeue onto the survivor
    (``failover_requeue`` records) and every request finishes."""
    dense = dict(slots=2, max_len=96, prompt_buckets=(8, 16, 32))
    routers = []
    for port in (False, True):
        fleet, Asc = _pkg(port)[:2]
        asc = Asc(min_replicas=1, max_replicas=2, initial_replicas=2,
                  queue_high=50, queue_low=8, scale_down_after=1)
        routers.append(fleet.FleetRouter(_build(both, port, 2, **dense),
                                         seg_steps=4, autoscaler=asc))

    def make(sched):
        rng = np.random.RandomState(23)
        return [sched.Arrival(0.0, rng.randint(0, both[0].vocab_size,
                                               (10,)).astype(np.int32), 5)
                for _ in range(10)]

    run = fed_serve(*routers, make, jsched, tsched)
    assert_same_serve(*routers, run)
    tr = routers[1]
    assert run["trep"].scale_downs == 1
    victim = next(r for r in tr._replicas if r.lifecycle == "offline")
    assert victim.last_drain["requeued"] > 0
    assert tr.requeued == victim.last_drain["requeued"]
    assert records(run["tj"], {"failover_requeue"})
    out = tr.results()
    assert len(out) == 10 and all(out[rid] for rid in out)
    assert tr._replicas[1 - victim.idx].lifecycle == "serving"


def test_disagg_one_policy_per_pool(both):
    """A ``DisaggRouter`` with a policy for each pool: both packages under
    one clock, the header's pool envelopes, then the port's journal
    replayed."""
    geom = dict(slots=2, max_len=96, prompt_buckets=(8, 16, 32, 64),
                paged=True, page_size=16, num_pages=24)
    routers = []
    for port in (False, True):
        mod = tdisagg if port else jdisagg
        Asc = _pkg(port)[1]
        es = _build(both, port, 4, **geom)
        ascs = [Asc(pool="prefill", min_replicas=1, initial_replicas=1,
                    queue_high=2, scale_down_after=2),
                Asc(pool="decode", min_replicas=1, initial_replicas=1,
                    queue_high=1, scale_down_after=2)]
        routers.append(mod.DisaggRouter(es[:2], es[2:], prefill_seg_steps=4,
                                        decode_seg_steps=8,
                                        max_queue=10 ** 6, autoscaler=ascs))

    def make(sched):
        rng = np.random.RandomState(5)
        lens = (24, 40, 56, 12)
        out = [sched.Arrival(0.0, rng.randint(0, both[0].vocab_size, (
            lens[i % 4],)).astype(np.int32), 8) for i in range(8)]
        return out + [sched.Arrival(0.6 + 0.3 * i, rng.randint(
            0, both[0].vocab_size, (20,)).astype(np.int32), 4)
            for i in range(3)]

    run = fed_serve(*routers, make, jsched, tsched)
    assert_same_serve(*routers, run)
    tr = routers[1]
    assert tr.handoff_log == routers[0].handoff_log
    decs = records(run["tj"], {"scale_decision"})
    assert decs == records(run["jj"], {"scale_decision"})
    assert {d["pool"] for d in decs if d["action"] == "scale_up"} <= \
        {"prefill", "decode"}
    assert [a.report() for a in tr.autoscalers] == \
        [a.report() for a in routers[0].autoscalers]
    header = next(r for r in run["tj"].records()
                  if r["kind"] == "header")["header"]
    jheader = next(r for r in run["jj"].records()
                   if r["kind"] == "header")["header"]
    assert header["disagg"]["envelopes"] == jheader["disagg"]["envelopes"]
    assert header["autoscaler"]["policies"] == \
        jheader["autoscaler"]["policies"]
    res = replay.replay_serve(run["tj"].records(), params=both[3])
    assert res.identical, (res.divergence, res.error)


def test_retry_after_hint_excludes_draining_capacity(both):
    engines = _build(both, True, 2, slots=2, max_len=96,
                     prompt_buckets=(8, 16, 32))
    router = tfleet.FleetRouter(engines, seg_steps=8)
    router._finished_count = 10
    base = router.retry_after_hint(5.0)
    assert base == pytest.approx(0.5)
    router._replicas[1].lifecycle = "draining"
    assert router.retry_after_hint(5.0) == pytest.approx(2 * base)
    router._replicas[1].lifecycle = "offline"
    assert router.retry_after_hint(5.0) == pytest.approx(base)


class TestPolicyConfig:
    def test_describe_round_trip_equals_jax(self):
        kw = dict(min_replicas=2, max_replicas=6, initial_replicas=3,
                  pool="prefill", queue_high=4, scale_down_after=5,
                  hbm_bytes=1 << 30)
        asc = TAutoscaler(**kw)
        d = asc.describe()
        assert TAutoscaler.from_description(d).describe() == d
        assert d == JAutoscaler(**kw).describe()

    @pytest.mark.parametrize("kw", [dict(min_replicas=0),
                                    dict(min_replicas=3, max_replicas=2),
                                    dict(queue_high=2, queue_low=5)])
    def test_validation(self, kw):
        with pytest.raises(ValueError):
            TAutoscaler(**kw)

    def test_bind_validation(self, both):
        engines = _build(both, True, 2, slots=2, max_len=96,
                         prompt_buckets=(8, 16, 32))
        with pytest.raises(ValueError, match="exceeds the 2 built"):
            tfleet.FleetRouter(engines, autoscaler=TAutoscaler(
                max_replicas=3))
        with pytest.raises(ValueError, match="manages no replicas"):
            tfleet.FleetRouter(engines, autoscaler=TAutoscaler(
                pool="decode"))

    def test_install_counts_segments(self, both):
        """An unbound policy on ``SEGMENT_HOOKS`` counts segments and
        decides nothing."""
        _, _, tcfg, tparams = both
        asc = TAutoscaler()
        tasc_mod.install(asc)
        try:
            eng = ServingEngine(tcfg, tparams, slots=2, max_len=96,
                                prompt_buckets=(8, 16, 32), device="cpu")
            rng = np.random.RandomState(3)
            eng.add_request(rng.randint(0, tcfg.vocab_size, (8,)
                                        ).astype(np.int32), 4)
            for _ in range(8):
                if eng.run_segment(4)["finished"]:
                    break
        finally:
            tasc_mod.uninstall(asc)
        assert asc.segments_observed > 0
        assert asc.decision_log == [] and asc.scale_ups == 0
        assert asc.report()["decisions"] == 0


def test_replay_refuses_without_weights(tmp_path):
    """The command line refuses, naming why: the port does not rebuild
    the JAX package's jax.random weights."""
    from paddle_tpu_torch.observability import journal as tjournal

    j = tjournal.Journal(str(tmp_path))
    j.params_info = {"prng_seed": 0}
    j.begin_serve({"driver": "online", "trace": []})
    j.close()
    assert replay.main([str(tmp_path)]) == 2
    with pytest.raises(tjournal.JournalError, match="jax.random"):
        replay.replay_serve(str(tmp_path))


@pytest.mark.parametrize("kind", ["online", "slo", "int8"])
def test_scheduler_journals_replay(both, kind):
    """A serve the port records through ``OnlineScheduler`` (with a prefix
    cache), ``SLOScheduler`` (classes and deadlines) or an int8 engine
    with digests replays bit-exactly from its journal."""
    from paddle_tpu_torch.observability import journal as tjournal

    _, _, tcfg, tparams = both
    kw = dict(GEOM)
    if kind == "int8":
        kw.update(quant="int8", quality_digest=True)
    eng = ServingEngine(tcfg, tparams, device="cpu", **kw)
    cls = tsched.SLOScheduler if kind == "slo" else tsched.OnlineScheduler
    sch = cls(eng, seg_steps=8, prefix_cache=TPaged(eng.pager,
                                                    capacity_pages=8))
    rng = np.random.RandomState(11)
    pref = rng.randint(0, tcfg.vocab_size, (16,)).astype(np.int32)
    arrivals = [tsched.Arrival(
        0.01 * i, np.concatenate([pref, rng.randint(
            0, tcfg.vocab_size, (4 + i,)).astype(np.int32)]), 6,
        priority=i % 2, deadline_s=(5.0 if i % 3 == 0 else None))
        for i in range(10)]
    j = tjournal.Journal()
    with tjournal.attach(j):
        sch.serve(arrivals)
    res = replay.replay_serve(j.records(), params=tparams)
    assert res.identical, (res.divergence, res.error)
    assert res.kind == ("slo" if kind == "slo" else "online")
    assert res.n_decisions > 20
