"""The port's ``FleetRouter`` against the JAX package's, on the CPU.

Each case builds the same fleet on both packages (``build_fleet`` over
the session's ``tiny_llama``, the port's in fp32 from the same numpy
weights), serves the same trace through both, the JAX router under a
recording journal and the port's under that clock fed back, and holds the
port to the JAX serve: per-replica assignment, tokens, every decision
record of the journal (``dispatch`` with its candidate ranking,
``fleet_dispatch``, ``arrival`` / ``admit`` / ``first_token`` /
``finish``, ``fault``, ``probe``, ``replica_dead``, ``failover_requeue``,
``tier_migrate`` and the engines' own records; the journal forwards
every flight event), and ``FleetReport.as_dict()`` (``cold_start_s``
dropped: a ``perf_counter`` reading). Then each case's own contract, as
the reference suite states it, on the port's serve.

The cases are those of ``tests/test_fleet_serving.py::TestFleetRouter``
(all eight), ``tests/test_slo_serving.py::TestFleetFailover`` (all five)
and ``tests/test_kv_tiers.py::TestCacheDirectory`` (steering, migration on
a miss, the loop's fetch audit: on the port, one counted fetch a segment
and no other device read). Not run here, with what each waits for:

* ``TestTensorParallelServing`` (mp-sharded replicas): meshes, ROADMAP
  Queue A item 6;
* ``TestCacheDirectory::test_healthz_and_capacity_tiers_breakdown``: the
  ops endpoints (``exporter.py``), item 7;
* the journal-replay cases and the elastic fleet (``autoscaler=``,
  ``aot_warmup``) run in ``test_torch_autoscaler.py``; below, that both
  are wired.
"""

import numpy as np
import pytest
import torch

from paddle_tpu.inference import fleet as jfleet
from paddle_tpu.inference import scheduler as jsched
from paddle_tpu.inference.kv_tiers import HostTier as JHostTier
from paddle_tpu.inference.prefix_cache import \
    PagedPrefixCache as JPagedPrefixCache
from paddle_tpu_torch.inference import fleet as tfleet
from paddle_tpu_torch.inference import scheduler as tsched
from paddle_tpu_torch.inference import serving as tserving
from paddle_tpu_torch.inference.kv_tiers import HostTier as THostTier
from paddle_tpu_torch.inference.prefix_cache import (
    PagedPrefixCache as TPagedPrefixCache, make_prefix_cache)

from torch_fleet_common import (assert_same_serve, both_models,
                                dense_reference, fed_serve, records,
                                two_threads)

DENSE = dict(slots=2, max_len=96, prompt_buckets=(8, 16, 32))
PAGED = dict(DENSE, paged=True, page_size=16)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = two_threads()
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def both(tiny_llama):
    return both_models(tiny_llama)


def _fleets(both, n=2, engine=DENSE, caches=None, **router):
    """(JAX router, port router) over ``n`` replicas of ``engine``.
    ``caches``: None, "auto", or a function (package, engines) -> list."""
    cfg, params, tcfg, tparams = both
    out = []
    for port, mod in ((False, jfleet), (True, tfleet)):
        kw = dict(engine, device="cpu") if port else dict(engine)
        engines = mod.build_fleet(tcfg if port else cfg,
                                  tparams if port else params, n, **kw)
        pcs = caches(port, engines) if callable(caches) else caches
        out.append(mod.FleetRouter(engines, prefix_caches=pcs, **router))
    return out


def _burst(reqs):
    return lambda mod: [mod.Arrival(0.0, p, n) for p, n in reqs]


def _mixed_reqs(seed, n, cfg, lens=(5, 12, 8, 20, 3, 15, 7, 9),
                gens=(9, 6, 12, 4, 8, 5, 10, 7)):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, cfg.vocab_size, (lens[i % len(lens)],)
                         ).astype(np.int32), gens[i % len(gens)])
            for i in range(n)]


def _serve(jr, tr, make, **kw):
    run = fed_serve(jr, tr, make, jsched, tsched, **kw)
    assert_same_serve(jr, tr, run)
    return run


# ---------------------------------------------------------------------------
# tests/test_fleet_serving.py::TestFleetRouter
# ---------------------------------------------------------------------------


class TestFleetRouter:
    def test_determinism_and_token_identity(self, both):
        cfg = both[0]
        reqs = _mixed_reqs(21, 6, cfg)
        jr, tr = _fleets(both, max_queue=8, seg_steps=8)
        run1 = _serve(jr, tr, _burst(reqs))
        out1, asg1 = tr.results(), tr.assignment()
        jr.reset()
        tr.reset()
        run2 = _serve(jr, tr, _burst(reqs))
        assert tr.assignment() == asg1 and tr.results() == out1
        assert sorted(len(a) for a in asg1) != [0, 6]
        for rid, (p, n) in zip(sorted(out1), reqs):
            assert out1[rid] == dense_reference(cfg, both[1], p, n)
        assert run1["trep"].n_requests == run2["trep"].n_requests == 6
        assert run1["trep"].segments > 0 and run1["trep"].ticks > 0

    def test_least_loaded_fallback_under_skew(self, both):
        cfg = both[0]
        rng = np.random.RandomState(31)
        shared = rng.randint(0, cfg.vocab_size, (16,)).astype(np.int32)
        reqs = [(np.concatenate([shared, rng.randint(
            0, cfg.vocab_size, (4,)).astype(np.int32)]), 5)
            for _ in range(6)]
        jr, tr = _fleets(both, max_queue=2, seg_steps=8, caches="auto",
                         affinity_block=16)
        rep = _serve(jr, tr, _burst(reqs))["trep"]
        assert rep.dispatches_affinity > 0
        assert rep.dispatches_least_loaded > 0
        assert all(len(a) > 0 for a in tr.assignment())

    def test_fleet_backpressure_counter_is_sum_of_replicas(self, both):
        reqs = _mixed_reqs(33, 6, both[0], lens=(6,), gens=(6,))
        jr, tr = _fleets(both, engine=dict(slots=1, max_len=96,
                                           prompt_buckets=(8,)),
                         max_queue=1, seg_steps=8)
        rep = _serve(jr, tr, _burst(reqs))["trep"]
        assert rep.backpressure_events > 0
        assert rep.backpressure_events == sum(
            r["backpressure_events"] for r in rep.per_replica)
        assert rep.retry_after_s is not None
        assert rep.n_requests == 6 and len(tr.results()) == 6

    def test_affinity_prefix_never_misses_across_replicas(self, both):
        cfg = both[0]
        rng = np.random.RandomState(41)
        groups = [rng.randint(0, cfg.vocab_size, (32,)).astype(np.int32)
                  for _ in range(2)]

        def wave(seed, per_group):
            r = np.random.RandomState(seed)
            return [(np.concatenate([g, r.randint(
                0, cfg.vocab_size, (6,)).astype(np.int32)]), 5)
                for g in groups for _ in range(per_group)]

        jr, tr = _fleets(both, engine=dict(DENSE,
                                           prompt_buckets=(8, 16, 64)),
                         max_queue=8, seg_steps=16, caches="auto")
        wave1, wave2 = wave(43, 1), wave(44, 3)
        _serve(jr, tr, _burst(wave1))
        _serve(jr, tr, _burst(wave2))
        wave2_reqs = [tr._reqs[rid][1]
                      for rid in sorted(tr._reqs)[len(wave1):]]
        assert all(r.prefix_hit_len >= 32 for r in wave2_reqs)
        assert sum(r.prefix_cache.hits for r in tr._replicas) >= len(wave2)
        assert sum(r.dispatches["affinity"] for r in tr._replicas) == \
            len(wave1) + len(wave2)

    def test_one_fetch_per_segment_over_fleet_loop(self, both, monkeypatch):
        """The reference's one-sync-per-segment audit, on the port: the
        whole two-replica loop reads the device only through each
        segment's one counted fetch (the blocking ``_fetch`` of an EOS
        or speculative step never runs)."""
        reqs = _mixed_reqs(51, 6, both[0])
        jr, tr = _fleets(both, max_queue=8, seg_steps=8)
        _serve(jr, tr, _burst(reqs))
        jr.reset()
        tr.reset()
        before = [r.engine.fetches for r in tr._replicas]
        blocking = []
        real = tserving.ServingEngine._fetch

        def spy(self, t):
            blocking.append(t.shape)
            return real(self, t)

        monkeypatch.setattr(tserving.ServingEngine, "_fetch", spy)
        rep = _serve(jr, tr, _burst(reqs))["trep"]
        assert blocking == []
        assert sum(r.engine.fetches - b for r, b in
                   zip(tr._replicas, before)) == rep.segments

    def test_paged_fleet_leak_report_aggregates(self, both):
        cfg = both[0]
        reqs = _mixed_reqs(61, 4, cfg)
        jr, tr = _fleets(both, engine=PAGED, max_queue=8, seg_steps=8,
                         caches="auto")
        _serve(jr, tr, _burst(reqs))
        out = tr.results()
        for rid, (p, n) in zip(sorted(out), reqs):
            assert out[rid] == dense_reference(cfg, both[1], p, n)
        assert tr.leak_report() == [] == jr.leak_report()
        pgr = tr._replicas[1].engine.pager
        page = pgr.allocator.alloc(1)
        bad = tr.leak_report()
        assert bad and all(b.startswith("replica 1:") for b in bad), bad
        pgr.allocator.release(page)
        assert tr.leak_report() == []

    def test_merged_telemetry_ranks(self, both, tmp_path):
        reqs = _mixed_reqs(71, 4, both[0])
        jr, tr = _fleets(both, max_queue=8, seg_steps=8)
        run = _serve(jr, tr, _burst(reqs))
        want = jr.merged_telemetry(str(tmp_path / "jax"))
        got = tr.merged_telemetry(str(tmp_path / "port"))
        assert got["ranks"] == want["ranks"] == [0, 1]
        for name in ("serving.segments", "serving.tokens_generated"):
            assert got["counters"][name]["value"] == \
                want["counters"][name]["value"]
        assert got["counters"]["serving.segments"]["value"] == \
            run["trep"].segments
        assert got["counters"]["serving.tokens_generated"]["value"] == \
            run["trep"].total_tokens
        by_rank = got["gauges"]["fleet.replica_queue_depth"]["by_rank"]
        assert by_rank == \
            want["gauges"]["fleet.replica_queue_depth"]["by_rank"]
        assert set(by_rank) == {"0", "1"}

    def test_prefix_cache_engine_keying_enforced(self, both):
        cfg, _, tcfg, tparams = both
        engines = tfleet.build_fleet(tcfg, tparams, 2, device="cpu",
                                     **PAGED)
        wrong = [make_prefix_cache(engines[1]),
                 make_prefix_cache(engines[0])]
        with pytest.raises(ValueError, match="ITS OWN"):
            tfleet.FleetRouter(engines, prefix_caches=wrong)


# ---------------------------------------------------------------------------
# tests/test_slo_serving.py::TestFleetFailover
# ---------------------------------------------------------------------------


def _fleet_arr(vocab, rng, n=10):
    rows = [(rng.randint(0, vocab, (8 + i % 8,)).astype(np.int32),
             6 + i % 4) for i in range(n)]
    return rows


def _failover(both, rows, inj_kw, late=(), n=2, **kw):
    """The failover fleet of the reference suite on both packages, each
    with its own ``FaultInjector(**inj_kw)``; ``late``: (t, prompt, gen)
    arrivals after the burst."""
    jr, tr = _fleets(both, n=n, engine=PAGED, max_queue=16, seg_steps=8,
                     **kw)
    jr.fault_injector = jfleet.FaultInjector(**inj_kw)
    tr.fault_injector = tfleet.FaultInjector(**inj_kw)

    def make(mod):
        return ([mod.Arrival(0.0, p, g) for p, g in rows]
                + [mod.Arrival(t, p, g) for t, p, g in late])

    run = _serve(jr, tr, make)
    assert tr.fault_injector.events == jr.fault_injector.events
    out = tr.results()
    return tr, run["trep"], [out[r] for r in sorted(out)]


@pytest.fixture(scope="module")
def fleet_baseline(both):
    rows = _fleet_arr(both[0].vocab_size, np.random.RandomState(43))
    _, rep0, out0 = _failover(both, rows, {})
    return rows, rep0, out0


class TestFleetFailover:
    def test_crash_zero_loss_token_identity(self, both, fleet_baseline):
        rows, rep0, out0 = fleet_baseline
        tr, rep1, out1 = _failover(both, rows, dict(crash={1: 1}),
                                   probe_after_s=60.0)
        assert rep1.n_requests == len(rows) == rep0.n_requests
        assert out1 == out0
        assert rep1.failovers == 1 and rep1.requeued > 0
        assert rep1.replica_health[1] == "dead"
        assert tr.leak_report() == []
        assert ("crash", 1, 1) in tr.fault_injector.events

    def test_transient_hang_retries_through(self, both, fleet_baseline):
        rows, _, out0 = fleet_baseline
        _, rep1, out1 = _failover(both, rows, dict(hang={0: (1, 1)}),
                                  max_finish_retries=1)
        assert rep1.failovers == 0
        assert out1 == out0
        assert rep1.replica_health == {0: "healthy", 1: "healthy"}

    def test_persistent_hang_escalates_to_dead(self, both, fleet_baseline):
        rows, _, out0 = fleet_baseline
        tr, rep1, out1 = _failover(both, rows, dict(hang={1: (1, 5)}),
                                   max_finish_retries=1,
                                   probe_after_s=60.0)
        assert rep1.failovers == 1
        assert rep1.n_requests == len(rows)
        assert out1 == out0
        assert tr.leak_report() == []

    def test_recovered_replica_rejoins_rotation(self, both):
        vocab = both[0].vocab_size
        rng = np.random.RandomState(47)
        rows = _fleet_arr(vocab, rng, n=6)
        late = [(0.3, rng.randint(0, vocab, (8,)).astype(np.int32), 6)
                for _ in range(6)]
        tr, rep, _ = _failover(both, rows, dict(crash={1: 0},
                                                recover_after=1),
                               late=late, probe_after_s=0.0)
        assert rep.failovers == 1
        assert rep.replica_health == {0: "healthy", 1: "healthy"}
        assert rep.n_requests == len(rows) + len(late)
        assert [e for e in tr.fault_injector.events if e[0] == "probe"]
        assert any(p["replica"] == 1 and p["requests"] > 0
                   for p in rep.per_replica)
        assert tr.leak_report() == []

    def test_determinism_across_runs(self, both):
        rows = _fleet_arr(both[0].vocab_size, np.random.RandomState(53))
        outs = []
        for _ in range(2):
            _, rep, out = _failover(both, rows, dict(crash={0: 1}),
                                    probe_after_s=60.0)
            assert rep.n_requests == len(rows)
            outs.append(out)
        assert outs[0] == outs[1]


# ---------------------------------------------------------------------------
# tests/test_kv_tiers.py::TestCacheDirectory
# ---------------------------------------------------------------------------


def _tiered(port, engines):
    Cache, Tier = ((TPagedPrefixCache, THostTier) if port
                   else (JPagedPrefixCache, JHostTier))
    return [Cache(e.pager, capacity_pages=16,
                  host_tier=Tier(e.pager, capacity_pages=64))
            for e in engines]


def _directory_fleets(both):
    return _fleets(both, engine=PAGED, seg_steps=16, caches=_tiered,
                   directory=True)


def _hot_trace(vocab, pref, n, seed=3, gen=6):
    rng = np.random.RandomState(seed)
    rows = [(np.concatenate([pref, rng.randint(0, vocab, (8,)).astype(
        np.int32)]), gen) for _ in range(n)]
    return _burst(rows)


class TestCacheDirectory:
    def test_steering_routes_to_owner(self, both):
        vocab = both[0].vocab_size
        jr, tr = _directory_fleets(both)
        rng = np.random.RandomState(11)
        pref = rng.randint(0, vocab, (16,)).astype(np.int32)
        _serve(jr, tr, _hot_trace(vocab, pref, 4))
        owner = next(r for r in tr._replicas
                     if r.prefix_cache.stats()["entries"] > 0)
        run = _serve(jr, tr, _hot_trace(vocab, pref, 4, seed=5))
        rep = run["trep"]
        assert tr.directory.stats() == jr.directory.stats()
        assert rep.dispatches_directory > 0
        assert rep.directory["hits"] > 0
        for r in tr._replicas:
            if r.idx != owner.idx:
                assert r.dispatches["directory"] == 0
        cands = [r["candidates"] for r in run["tj"].records()
                 if r["kind"] == "dispatch" and r.get("candidates")]
        steered = [c for cl in cands for c in cl if c["dir_hit"] > 0]
        assert steered and all(c["dir_tier"] in ("hbm", "clean", "host")
                               for c in steered)
        assert tr.leak_report() == []

    def test_migration_on_miss_imports(self, both):
        vocab = both[0].vocab_size
        jr, tr = _directory_fleets(both)
        rng = np.random.RandomState(17)
        pref = rng.randint(0, vocab, (16,)).astype(np.int32)
        _serve(jr, tr, _hot_trace(vocab, pref, 4, seed=19))
        owner = next(r for r in tr._replicas
                     if r.prefix_cache.stats()["entries"] > 0)
        assert owner.prefix_cache.host_tier.stages > 0
        for router in (jr, tr):
            router._replicas[owner.idx].set_health("suspect")
        run = _serve(jr, tr, _hot_trace(vocab, pref, 3, seed=29))
        migrations = records(run["tj"], {"tier_migrate"})
        assert migrations == records(run["jj"], {"tier_migrate"}) != []
        other = tr._replicas[1 - owner.idx]
        assert run["trep"].tier_migrations > 0
        assert other.prefix_cache.host_tier.imports > 0
        assert other.prefix_cache.restores > 0
        assert other.prefix_cache.hits > 0
        assert tr.directory.stats() == jr.directory.stats()
        owner.set_health("healthy")
        assert tr.leak_report() == []

    def test_fleet_loop_fetch_audit_with_tiers(self, both):
        """The tiered fleet loop reads the device once a segment (the
        stages land at those fetches) and nowhere else."""
        vocab = both[0].vocab_size
        jr, tr = _directory_fleets(both)
        rng = np.random.RandomState(31)
        pref = rng.randint(0, vocab, (16,)).astype(np.int32)
        arr = _hot_trace(vocab, pref, 6, seed=37)
        _serve(jr, tr, arr)
        jr.reset()
        tr.reset()
        before = [r.engine.fetches for r in tr._replicas]
        flushes = [r.prefix_cache.host_tier.flushes for r in tr._replicas]
        rep = _serve(jr, tr, arr)["trep"]
        assert sum(r.engine.fetches - b for r, b in
                   zip(tr._replicas, before)) == rep.segments
        assert [r.prefix_cache.host_tier.flushes
                for r in tr._replicas] == flushes


# ---------------------------------------------------------------------------
# what waits for later ports
# ---------------------------------------------------------------------------


def test_autoscaler_and_aot_warmup_not_ported(both):
    """Once not ported, now wired: ``autoscaler=`` binds the policy (one
    replica serving, the other an offline standby) and ``aot_warmup``
    runs each replica's program space, the JAX router's key counts."""
    from paddle_tpu_torch.inference.autoscaler import Autoscaler

    cfg, params, tcfg, tparams = both
    engines = tfleet.build_fleet(tcfg, tparams, 2, device="cpu", **DENSE)
    asc = Autoscaler(min_replicas=1, initial_replicas=1)
    router = tfleet.FleetRouter(engines, autoscaler=asc)
    assert router.autoscalers == [asc] and asc.max_replicas == 2
    assert [r.lifecycle for r in router._replicas] == ["serving",
                                                       "offline"]
    assert router._dispatch_candidates() == router._replicas[:1]
    got = tfleet.FleetRouter(engines).aot_warmup()
    jengines = jfleet.build_fleet(cfg, params, 2, **DENSE)
    want = {i: e.program_space() for i, e in enumerate(jengines)}
    assert {i: {f: v["keys"] for f, v in fams.items()}
            for i, fams in got.items()} == \
        {i: {f: len(k) for f, k in fams.items()}
         for i, fams in want.items()}
    assert all(e.prog_key_hits == {} and e.aot_warmup_s > 0
               for e in engines)


def test_build_fleet_devices_moves_params(both):
    """``devices=`` builds replica i on ``devices[i % n]``, its
    parameters moved there."""
    _, _, tcfg, tparams = both
    engines = tfleet.build_fleet(tcfg, tparams, 3, devices=["cpu"],
                                 **DENSE)
    assert all(e.device == torch.device("cpu") for e in engines)
    torch.testing.assert_close(engines[2].params["lm_head"],
                               tparams["lm_head"], rtol=0, atol=0)
