"""The port's ``DisaggRouter`` against the JAX package's, on the CPU.

One prefill and one decode replica (paged, pages of 16, a 24-page pool)
on both packages from the same numpy weights; the JAX router serves under
a recording journal, the port's under that clock fed back. Held equal:
assignment, tokens, every decision record (``handoff`` among them, with
the flight events the journal forwards), ``FleetReport.as_dict()``
(``cold_start_s`` and the port's tier ``flushes`` aside), the
``handoff_log`` and ``handoff_report()``, and the per-pool SLO report.
Then the reference suite's contracts on the port's serve.

The cases are those of ``tests/test_disagg.py``: ``TestDisaggIdentity``
(all three), ``TestDisaggAudits``' one-sync case (on the port: one
counted fetch a segment, and one counted wait for stages per handoff
batch, ``kv_tiers.wait_for_stages``, and nothing else) and per-pool SLO
case, ``test_constructor_validation``, ``test_dispatch_candidates_carry_pool_tag``
and ``test_zero_post_warmup_compiles_per_pool`` (the pool envelopes equal
the JAX router's, each pool warms its own keys, and the serve after it
meets no key, library load or ticket buffer it had not: the port's
``analysis.recompile`` budget). Not run here, with what each waits for:
``test_gate_auditor_observes_without_perturbing`` (the analysis gate's
``HandoffAuditor``; the port has no gate, ROADMAP Queue A item 8) and
``TestDisaggOpsSurface::test_healthz_and_capacity_report_pools`` (the ops
endpoints, item 7). The cross-pool replay runs in
``test_torch_autoscaler.py``.

The port parks one page fewer than the JAX engine when a preempted
request's prompt and tokens fill whole pages (``DisaggRouter``'s
docstring); these traces never hand off at such a boundary, which the
ledger comparison would show.
"""

import numpy as np
import pytest
import torch

from paddle_tpu.analysis.tiers import disagg_serve_audit, handoff_audit
from paddle_tpu.inference import disagg as jdisagg
from paddle_tpu.inference import fleet as jfleet
from paddle_tpu.inference import scheduler as jsched
from paddle_tpu.observability.slo import Objective as JObjective
from paddle_tpu.observability.slo import SLOMonitor as JSLOMonitor
from paddle_tpu_torch.inference import disagg as tdisagg
from paddle_tpu_torch.inference import fleet as tfleet
from paddle_tpu_torch.inference import kv_tiers as tkv
from paddle_tpu_torch.inference import scheduler as tsched
from paddle_tpu_torch.inference import serving as tserving
from paddle_tpu_torch.observability.slo import Objective as TObjective
from paddle_tpu_torch.observability.slo import SLOMonitor as TSLOMonitor

from torch_fleet_common import (assert_same_serve, both_models, fed_serve,
                                records, two_threads)

PSZ = 16
ENGINE = dict(slots=2, max_len=96, prompt_buckets=(8, 16, 32, 64),
              paged=True, page_size=PSZ, num_pages=24)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = two_threads()
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def both(tiny_llama):
    return both_models(tiny_llama)


def _engines(both, port, n=2, **kw):
    cfg, params, tcfg, tparams = both
    geom = {**ENGINE, **kw}
    if port:
        return tfleet.build_fleet(tcfg, tparams, n, device="cpu", **geom)
    return jfleet.build_fleet(cfg, params, n, **geom)


def _disagg(both, port, **kw):
    es = _engines(both, port)
    kw.setdefault("prefill_seg_steps", 4)
    kw.setdefault("decode_seg_steps", 8)
    kw.setdefault("max_queue", 10 ** 6)
    mod = tdisagg if port else jdisagg
    return mod.DisaggRouter(es[:1], es[1:], **kw)


def _co(both, port):
    mod = tfleet if port else jfleet
    return mod.FleetRouter(_engines(both, port), max_queue=10 ** 6,
                           seg_steps=8, prefix_caches="auto")


def _reqs(vocab, seed=0, n=8, lens=(24, 40, 56, 12), gen=8):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, vocab, (lens[i % len(lens)],)).astype(np.int32),
             gen) for i in range(n)]


def _burst(reqs):
    return lambda mod: [mod.Arrival(0.0, p, g) for p, g in reqs]


def _pair(both, make_router, reqs, **router_kw):
    """Both packages' routers, served on ``reqs`` under one clock and held
    equal. Returns (JAX router, port router, the serve's run)."""
    jr = make_router(both, False, **router_kw.get("jax", {}))
    tr = make_router(both, True, **router_kw.get("port", {}))
    run = fed_serve(jr, tr, _burst(reqs), jsched, tsched)
    assert_same_serve(jr, tr, run)
    if hasattr(tr, "handoff_log"):
        assert tr.handoff_log == jr.handoff_log
        assert tr.handoff_report() == jr.handoff_report()
        assert tr.pool_stats() == jr.pool_stats()
    return jr, tr, run


def _interference(router, decode_only=False):
    """Prefill rows of OTHER requests admitted into a request's decode
    window on its own engine, per generated token (the reference suite's
    measure of the co-residency decode tax)."""
    by_eng = {}
    for idx, r in router._reqs.values():
        by_eng.setdefault(idx, []).append(r)
    vals = []
    for idx, group in by_eng.items():
        if decode_only and router._replicas[idx].pool != "decode":
            continue
        for r in group:
            if (not r.finish_time or not r.first_token_time
                    or len(r.tokens) < 2):
                continue
            rows = sum(max(0, len(q.prompt) - q.prefix_hit_len)
                       for q in group
                       if q is not r and q.first_token_time
                       and r.first_token_time < q.first_token_time
                       <= r.finish_time)
            vals.append(rows / (len(r.tokens) - 1))
    return float(np.mean(vals)) if vals else 0.0


@pytest.fixture(scope="module")
def served(both):
    """The disaggregated serve of the mixed trace on both packages, and
    the co-resident fleet's on the port."""
    reqs = _reqs(both[0].vocab_size)
    jr, tr, run = _pair(both, _disagg, reqs)
    _, co, _ = _pair(both, lambda b, port: _co(b, port), reqs)
    return {"jax": jr, "port": tr, "run": run, "co": co}


class TestDisaggIdentity:
    def test_tokens_identical_to_co_resident(self, served):
        dis = served["port"]
        assert dis.handoffs > 0
        assert dis.results() == served["co"].results()

    def test_decode_pool_carries_no_full_prompt_prefills(self, both):
        reqs = _reqs(both[0].vocab_size, lens=(32, 48, 64, 16))
        _, dis, _ = _pair(both, _disagg, reqs)
        decode_reqs = [q for idx, q in dis._reqs.values()
                       if dis._replicas[idx].pool == "decode"]
        assert decode_reqs
        for q in decode_reqs:
            assert q.prefix_hit_len >= len(q.prompt) - PSZ, \
                (q.rid, q.prefix_hit_len, len(q.prompt))
        _, co, _ = _pair(both, lambda b, port: _co(b, port), reqs)
        assert _interference(co) > 0.0
        assert _interference(dis, decode_only=True) == 0.0

    def test_handoff_budget_ledger_and_report(self, served):
        dis = served["port"]
        assert dis.handoffs > 0
        assert disagg_serve_audit(dis) == []
        pb = dis._replicas[0].prefix_cache.host_tier.page_bytes()
        assert handoff_audit(dis.handoff_log, pb) == []
        rep = dis.handoff_report()
        assert rep["handoffs"] == dis.handoffs == len(dis.handoff_log)
        assert rep["pages"] == sum(h["pages"] for h in dis.handoff_log)
        assert rep["bytes"] == sum(h["bytes"] for h in dis.handoff_log)
        assert any(h["pages"] > 0 for h in dis.handoff_log)
        stats = dis.pool_stats()
        assert set(stats) == {"prefill", "decode"}
        assert stats["prefill"]["replicas"] == [0]
        assert stats["decode"]["replicas"] == [1]


class TestDisaggAudits:
    def test_one_fetch_per_segment_and_one_wait_per_batch(self, both,
                                                          monkeypatch):
        """The reference's one-sync contract on the port, warmed: one
        counted fetch a segment (no blocking step read), and one counted
        wait for stages per handoff batch, nothing else."""
        reqs = _reqs(both[0].vocab_size)
        jr = _disagg(both, False)
        tr = _disagg(both, True)
        run = fed_serve(jr, tr, _burst(reqs), jsched, tsched, warm=True)
        assert_same_serve(jr, tr, run)
        jr.reset()
        tr.reset()
        waits, blocking = [], []
        real_wait = tkv.wait_for_stages
        real_fetch = tserving.ServingEngine._fetch

        def wait_spy(tiers):
            waits.append(len(tiers))
            return real_wait(tiers)

        def fetch_spy(self, t):
            blocking.append(t.shape)
            return real_fetch(self, t)

        monkeypatch.setattr(tkv, "wait_for_stages", wait_spy)
        monkeypatch.setattr(tserving.ServingEngine, "_fetch", fetch_spy)
        before = [r.engine.fetches for r in tr._replicas]
        run = fed_serve(jr, tr, _burst(reqs), jsched, tsched)
        assert_same_serve(jr, tr, run)
        assert blocking == []
        assert sum(r.engine.fetches - b for r, b in
                   zip(tr._replicas, before)) == run["trep"].segments
        assert len(waits) == tr.handoff_flushes == jr.handoff_flushes > 0

    def test_per_pool_slo_objectives(self, both):
        mons = {}

        def make(b, port):
            S, O = (TSLOMonitor, TObjective) if port else (JSLOMonitor,
                                                           JObjective)
            mons[port] = S({}, pool_objectives={
                "prefill": O(ttft_target_s=30.0),
                "decode": O(tbt_target_s=30.0)})
            return _disagg(b, port, slo_monitor=mons[port])

        _, dis, _ = _pair(both, make, _reqs(both[0].vocab_size))
        assert dis.handoffs > 0
        assert mons[True].report() == mons[False].report()
        rep = mons[True].report()["pools"]
        assert rep["prefill"]["outcomes"] > 0
        assert rep["decode"]["outcomes"] > 0
        assert rep["prefill"]["violations"] == 0
        assert rep["decode"]["violations"] == 0
        assert mons[True].pool_state("prefill") == "ok"
        assert mons[True].pool_state("decode") == "ok"


def test_constructor_validation(both):
    _, _, tcfg, tparams = both
    es = _engines(both, True)
    with pytest.raises(ValueError, match="pool"):
        tdisagg.DisaggRouter(es[:1], [])
    with pytest.raises(ValueError, match="canary"):
        tdisagg.DisaggRouter(es[:1], es[1:], canary=object())
    flat = tfleet.build_fleet(tcfg, tparams, 2, device="cpu", slots=2,
                              max_len=96, prompt_buckets=(8, 16, 32, 64))
    with pytest.raises(ValueError, match="paged"):
        tdisagg.DisaggRouter(flat[:1], flat[1:])


def test_dispatch_candidates_carry_pool_tag(both):
    _, dis, run = _pair(both, _disagg, _reqs(both[0].vocab_size, n=4))
    dispatches = records(run["tj"], {"dispatch"})
    assert dispatches
    for d in dispatches:
        assert {c["pool"] for c in d["candidates"]} == {"prefill",
                                                        "decode"}
        assert dis._replicas[d["replica"]].pool == "prefill"


def test_handoff_journal_records_match(served):
    """Every crossing is a ``handoff`` decision record, equal to the JAX
    router's, and one per ledger entry."""
    run = served["run"]
    got = records(run["tj"], {"handoff"})
    assert got == records(run["jj"], {"handoff"})
    assert len(got) == len(served["port"].handoff_log)


def test_program_envelopes_not_ported(both):
    """Once not ported, now held: each pool's envelope equals the JAX
    router's, ``aot_warmup`` runs each replica's pool keys (the JAX key
    counts), and a serve after it stays inside them."""
    from paddle_tpu.observability import journal as jjournal
    from paddle_tpu_torch.analysis import recompile
    from paddle_tpu_torch.observability import journal as tjournal

    jdis, dis = _disagg(both, False), _disagg(both, True)
    for pool in ("prefill", "decode"):
        assert tjournal.describe_envelope(dis.pool_envelope(pool)) == \
            jjournal.describe_envelope(jdis.pool_envelope(pool))
    got = dis.aot_warmup()
    want = {i: r.engine.program_space(jdis.pool_envelope(r.pool))
            for i, r in enumerate(jdis._replicas)}
    assert {i: {f: v["keys"] for f, v in fams.items()}
            for i, fams in got.items()} == \
        {i: {f: len(k) for f, k in fams.items()}
         for i, fams in want.items()}
    reqs = _reqs(both[0].vocab_size)
    with recompile.enforce_zero_compiles("disaggregated serve"):
        dis.serve(_burst(reqs)(tsched))
    assert dis.handoffs and len(dis.results()) == len(reqs)
