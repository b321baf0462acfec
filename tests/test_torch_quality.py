"""The port's ``observability/quality.py`` and shadow and canary serving
against the JAX package's, on the CPU.

Units first: ``final_tokens``, ``QualityMonitor`` (the same ``note_pair``
calls on both packages: every result, level, transition and ``report()``
equal) and ``CanaryController`` (verdicts, hold, ``report()``), and
``install`` / ``uninstall`` on the port's ``serving.SEGMENT_HOOKS``.

Then the fleet cases of ``tests/test_quality.py``: ``TestShadowDiff`` (a
control shadow on the same weights, and a shadow whose lm_head carries
seeded noise, with logit budgets and an SLO monitor attached),
``TestShadowAudit``'s loop case (on the port: one counted fetch per
primary and per shadow segment, nothing else) and ``TestCanary`` (all
three). Each fleet runs on both packages from the same numpy weights
(fp32), the JAX serve under a recording journal and the port's under its
clock fed back; assignment, tokens, decision records and the report
(``cold_start_s`` aside) are held equal, the shadow's ``QualityMonitor``
report and the canary's ``report()`` with them. The two packages' quality
digests are the logits of two fp32 implementations, so where a report
carries a logit statistic of the perturbed shadow it is compared to rtol
1e-4 (the control's are 0 on both); tokens, positions, counts and levels
are compared exactly.

Not run here, with what each waits for:
``TestShadowAudit::test_quality_program_budget_and_gate_bit_identity``
(the analysis gate, ROADMAP Queue A item 8),
``test_shadowed_serve_replays_identical`` and
``test_journey_gains_the_shadow_pair`` (journal replay and its journeys,
item 6), ``test_quality_endpoint_round_trip`` (the ops endpoints, item
7); ``TestDigests`` is ``test_torch_quant.py``'s, and
``TestDriftAndOverhead`` holds the SLO monitor (``test_torch_slo.py``) and
a wall-clock overhead gate.
"""

import math

import jax
import numpy as np
import pytest
import torch

from paddle_tpu.inference import fleet as jfleet
from paddle_tpu.inference import scheduler as jsched
from paddle_tpu.inference.serving import ServingEngine as JEngine
from paddle_tpu.observability import quality as jq
from paddle_tpu.observability.slo import Objective as JObjective
from paddle_tpu.observability.slo import SLOMonitor as JSLOMonitor
from paddle_tpu_torch.inference import fleet as tfleet
from paddle_tpu_torch.inference import scheduler as tsched
from paddle_tpu_torch.inference import serving as tserving
from paddle_tpu_torch.inference.serving import ServingEngine as TEngine
from paddle_tpu_torch.observability import quality as tq
from paddle_tpu_torch.observability.slo import Objective as TObjective
from paddle_tpu_torch.observability.slo import SLOMonitor as TSLOMonitor

from torch_fleet_common import (assert_same_serve, both_models, fed_serve,
                                port_params, records, report, two_threads)

ENGINE = dict(slots=2, max_len=96, prompt_buckets=(8, 16, 32), paged=True,
              page_size=16)
RTOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = two_threads()
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def both(tiny_llama):
    return both_models(tiny_llama)


def _close(a, b, path="report"):
    """Equal, but floats within RTOL."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (path, a, b)
        for k in a:
            _close(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    elif isinstance(a, float) and isinstance(b, float):
        assert math.isclose(a, b, rel_tol=RTOL, abs_tol=1e-7), (path, a, b)
    else:
        assert a == b, (path, a, b)


# ---------------------------------------------------------------------------
# units
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("toks,n,eos", [
    ([5, 6, 7, 8], 3, None), ([5, 6, 7, 8], 8, 7), ([7, 6], 4, 7),
    ([], 4, 1), ([1, 2, 3], 2, 3)])
def test_final_tokens_matches_reference(toks, n, eos):
    assert tq.final_tokens(toks, n, eos) == jq.final_tokens(toks, n, eos)


def _pairs(seed=5, n=14):
    """Synthetic pairs: matches, divergences at spread positions, length
    artifacts, and digests whose logit errors grow then shrink."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        p = [int(t) for t in rng.randint(0, 50, (8,))]
        s = list(p)
        if i % 3 == 1:
            s[int(rng.randint(0, 8))] += 1
        elif i % 5 == 4:
            s = s[:5]
        err = [0.0, 0.01, 0.2, 0.5, 0.02, 0.0][i % 6]
        ids = [int(x) for x in rng.permutation(10)[:4]]
        vals = [float(v) for v in sorted(rng.randn(4), reverse=True)]

        def dig(tokens, e):
            return [(vals[0] + e, ids, [v + e * k for k, v
                                        in enumerate(vals)])
                    for _ in tokens]

        out.append((i, p, s, dig(p, 0.0), dig(s, err), i % 2))
    return out


@pytest.mark.parametrize("kw", [
    {}, dict(logit_abs_warn=0.05, logit_abs_page=0.4),
    dict(kl_warn=1e-4, kl_page=1e-2, fast_window=3, slow_window=5,
         clear_after=2),
    dict(match_rate_warn=0.9, match_rate_page=0.5, pair_log_cap=3)])
def test_quality_monitor_matches_reference(kw):
    jm, tm = jq.QualityMonitor(**kw), tq.QualityMonitor(**kw)
    for rid, p, s, pd, sd, cls in _pairs():
        assert tm.note_pair(rid, p, s, pd, sd, cls=cls) == \
            jm.note_pair(rid, p, s, pd, sd, cls=cls)
        assert tm.level == jm.level
    for m in (jm, tm):
        m.note_segment()
    assert tm.report() == jm.report()
    assert tm.alert_log and tm.alert_log == jm.alert_log
    tm.reset()
    jm.reset()
    assert tm.report() == jm.report()


@pytest.mark.parametrize("bad", [
    dict(match_rate_warn=0.9, match_rate_page=0.95),
    dict(fast_window=4, slow_window=2), dict(logit_abs_warn=0.1),
    dict(kl_warn=0.5, kl_page=0.1)])
def test_quality_monitor_refusals(bad):
    with pytest.raises(ValueError):
        jq.QualityMonitor(**bad)
    with pytest.raises(ValueError):
        tq.QualityMonitor(**bad)


def _canary_feed(mod, can_lat, n_can, verdict_every=6):
    can = mod.CanaryController(replica=1, weight=0.5, seed=0,
                               latency_ratio_max=1.5, min_outcomes=3,
                               verdict_every=verdict_every)
    for _ in range(6):
        can.note_outcome("control", "e2e", 0, 0.1)
        can.note_outcome("control", "ttft", 1, 0.05)
    for _ in range(n_can):
        can.note_outcome("canary", "e2e", 0, can_lat)
        can.note_outcome("canary", "ttft", 1, 0.06)
    return can


class TestCanaryUnits:
    def test_verdict_auto_hold_on_latency(self):
        jc = _canary_feed(jq, 1.0, 5)
        tc = _canary_feed(tq, 1.0, 5)
        assert not tc.held
        for c in (jc, tc):
            c.note_outcome("canary", "e2e", 0, 1.0)
        assert tc.held and tc.weight == 0.0
        assert tc.verdicts[-1]["verdict"] == "hold"
        assert tc.hold_reason == "latency_ratio"
        assert not tc.assign(123)
        assert tc.report() == jc.report()
        assert tc.describe() == jc.describe()

    def test_verdict_pass_and_insufficient(self):
        for mod in (jq, tq):
            can = mod.CanaryController(replica=1, weight=0.5,
                                       min_outcomes=3, verdict_every=100)
            assert can.evaluate()["verdict"] == "insufficient"
        jc = _canary_feed(jq, 0.11, 4, verdict_every=100)
        tc = _canary_feed(tq, 0.11, 4, verdict_every=100)
        assert tc.evaluate(final=True) == jc.evaluate(final=True)
        assert tc.verdicts[-1]["verdict"] == "pass" and not tc.held

    def test_assign_and_linked_quality_page(self):
        jm, tm = jq.QualityMonitor(), tq.QualityMonitor()
        for rid in range(3):
            jm.note_pair(rid, [1, 2, 3], [1, 9, 3])
            tm.note_pair(rid, [1, 2, 3], [1, 9, 3])
        jc = jq.CanaryController(replica=0, weight=0.3, seed=7,
                                 quality_monitor=jm)
        tc = tq.CanaryController(replica=0, weight=0.3, seed=7,
                                 quality_monitor=tm)
        assert [tc.assign(r) for r in range(64)] == \
            [jc.assign(r) for r in range(64)]
        assert tc.evaluate() == jc.evaluate()
        assert tc.held and tc.hold_reason == "quality_page"
        assert tc.report() == jc.report()


def test_install_counts_segments(both):
    """``install`` hooks the monitor on every engine segment (once per
    monitor), ``uninstall`` takes it off again."""
    _, _, tcfg, tparams = both
    hooks = list(tserving.SEGMENT_HOOKS)
    mon = tq.QualityMonitor()
    tq.install(mon)
    tq.install(mon)
    try:
        eng = TEngine(tcfg, tparams, device="cpu", **ENGINE)
        rng = np.random.RandomState(3)
        for _ in range(3):
            eng.add_request(rng.randint(0, tcfg.vocab_size, (8,)), 4)
        segments = 0
        while eng._queue or eng.free_slot_count() < eng.slots:
            eng.run_segment(4)
            segments += 1
        assert mon.segments == segments > 0
    finally:
        tq.uninstall(mon)
    assert tserving.SEGMENT_HOOKS == hooks
    assert mon.report()["segments"] == segments


# ---------------------------------------------------------------------------
# shadow and canary fleets (tests/test_quality.py)
# ---------------------------------------------------------------------------


def _engine(both, port, params=None, digest=True):
    cfg, jparams, tcfg, tparams = both
    kw = dict(ENGINE, quality_digest=digest)
    if port:
        return TEngine(tcfg, params if params is not None else tparams,
                       device="cpu", **kw)
    return JEngine(cfg, params if params is not None else jparams, **kw)


def _trace(vocab, n=6, seed=11, gen=6):
    rng = np.random.RandomState(seed)
    rows = [rng.randint(0, vocab, (8,)).astype(np.int32) for _ in range(n)]
    return lambda mod: [mod.Arrival(0.0, p, gen) for p in rows]


def _perturbed(both, scale=0.05, seed=99):
    """Seeded noise on lm_head (every logit moves a little, some argmaxes
    flip), made by the JAX package and carried to the port as numpy."""
    cfg, params, tcfg, _ = both
    p = dict(params)
    noise = jax.random.normal(jax.random.PRNGKey(seed),
                              params["lm_head"].shape,
                              params["lm_head"].dtype)
    p["lm_head"] = params["lm_head"] + scale * noise
    return p, port_params(p, tcfg)


def _shadow_pair(both, shadow_params=None, monitor_kw=None, slo=False):
    """(JAX router, port router, run) of a one-replica fleet with a
    shadow at sample_p 1."""
    routers, extras = [], {}
    for port, fmod, qmod in ((False, jfleet, jq), (True, tfleet, tq)):
        sp = None if shadow_params is None else shadow_params[port]
        mon = qmod.QualityMonitor(**(monitor_kw or {}))
        kw = {}
        if slo:
            S, O = (TSLOMonitor, TObjective) if port else (JSLOMonitor,
                                                           JObjective)
            kw["slo_monitor"] = S({0: O(ttft_target_s=30.0,
                                        e2e_target_s=60.0,
                                        compliance=0.99)})
        routers.append(fmod.FleetRouter(
            [_engine(both, port)],
            shadow=fmod.Shadow(_engine(both, port, sp), sample_p=1.0,
                               monitor=mon),
            seg_steps=16, **kw))
        extras[port] = (mon, kw.get("slo_monitor"))
    jr, tr = routers
    run = fed_serve(jr, tr, _trace(both[0].vocab_size), jsched, tsched)
    return jr, tr, run, extras


@pytest.fixture(scope="module")
def control(both):
    return _shadow_pair(both)


@pytest.fixture(scope="module")
def perturbed(both):
    jp, tp = _perturbed(both)
    return _shadow_pair(both, {False: jp, True: tp},
                        dict(logit_abs_warn=0.05, logit_abs_page=5.0),
                        slo=True) + ((jp, tp),)


class TestShadowDiff:
    def test_control_certifies_identity(self, control):
        jr, tr, run, _ = control
        assert_same_serve(jr, tr, run)
        rep = run["trep"]
        q = rep.quality
        assert rep.shadow["mirrored"] == rep.n_requests
        assert rep.shadow["compared"] == rep.n_requests
        assert q["token_match_rate"] == 1.0
        assert q["pairs_mismatched"] == 0
        assert q["logit_max_abs_err"] <= 1e-6
        assert q["level"] == "ok" and q["alerts"] == []

    def test_perturbation_detected_with_exact_positions(self, both,
                                                        perturbed):
        """The noisy shadow is caught, its report equals the JAX
        router's (logit statistics to rtol 1e-4), and every first
        divergence equals the diff of the primary stream against a dense
        greedy generation under the perturbed weights."""
        jr, tr, run, extras, (jp, _) = perturbed
        assert tr.assignment() == jr.assignment()
        assert tr.results() == jr.results()
        assert records(run["tj"], shadow=False) == \
            records(run["jj"], shadow=False)
        _close(report(run["trep"]), report(run["jrep"]))
        kinds = {"shadow_finish", "quality_divergence", "quality_alert"}
        _close(records(run["tj"], kinds), records(run["jj"], kinds))
        q = run["trep"].quality
        assert q["pairs_mismatched"] >= 1
        cfg = both[0]
        results = {rid: req.tokens for rid, (_, req) in tr._reqs.items()}
        arr = _trace(cfg.vocab_size)(jsched)
        from torch_fleet_common import dense_reference
        checked = 0
        for pair in extras[True][0].pair_log:
            rid = pair["rid"]
            ref = dense_reference(cfg, jp, arr[rid].prompt,
                                  arr[rid].max_new_tokens)
            expect = next((i for i, (a, b) in
                           enumerate(zip(results[rid], ref)) if a != b),
                          None)
            assert pair["first_divergence"] == expect
            checked += 1
        assert checked >= 1

    def test_quality_page_before_any_slo_violation(self, perturbed):
        _, _, _, extras, _ = perturbed
        mon, slo = extras[True]
        assert mon.worst_level() == "page"
        assert any(a["level"] == "page" for a in mon.alert_log)
        rep = slo.report()
        assert rep["alerts"] == []
        assert all(c["violations"] == 0 for c in rep["classes"].values())
        _close(rep, extras[False][1].report())

    def test_divergence_metrics_recorded(self, perturbed):
        q = perturbed[2]["trep"].quality
        assert q["logit_max_abs_err"] > 0.0
        assert q["kl_sampled_max"] is not None
        assert len(q["first_divergence_positions"]) == \
            q["pairs_mismatched"]


def test_shadowed_fleet_loop_fetches(both):
    """The shadowed loop reads the device only through each primary and
    each shadow segment's one counted fetch."""
    routers = []
    for port, fmod in ((False, jfleet), (True, tfleet)):
        routers.append(fmod.FleetRouter(
            [_engine(both, port)],
            shadow=fmod.Shadow(_engine(both, port), sample_p=1.0),
            seg_steps=16))
    jr, tr = routers
    make = _trace(both[0].vocab_size, n=4, seed=23)
    fed_serve(jr, tr, make, jsched, tsched)
    jr.reset()
    tr.reset()
    prim, shad = tr._replicas[0].engine, tr.shadow.engine
    f0 = (prim.fetches, shad.fetches)
    run = fed_serve(jr, tr, make, jsched, tsched)
    assert_same_serve(jr, tr, run)
    rep = run["trep"]
    assert prim.fetches - f0[0] == rep.segments
    assert shad.fetches - f0[1] == rep.shadow["segments"] > 0


class TestCanaryFleet:
    def test_router_canary_split_and_isolation(self, both):
        make = _trace(both[0].vocab_size, n=10, seed=31)

        def pair(**ckw):
            routers = []
            for port, fmod, qmod in ((False, jfleet, jq),
                                     (True, tfleet, tq)):
                cfg, params, tcfg, tparams = both
                engines = fmod.build_fleet(
                    tcfg if port else cfg, tparams if port else params, 2,
                    **(dict(ENGINE, device="cpu") if port else ENGINE))
                can = qmod.CanaryController(replica=1, weight=0.5, seed=3,
                                            **ckw)
                if ckw.get("min_outcomes") is None:
                    can.hold("operator")
                routers.append(fmod.FleetRouter(engines, seg_steps=16,
                                                canary=can))
            run = fed_serve(*routers, make, jsched, tsched)
            assert_same_serve(*routers, run)
            assert routers[1].canary.report() == routers[0].canary.report()
            return routers[1], run["trep"]

        router, rep = pair(min_outcomes=4, verdict_every=4)
        assert rep.dispatches_canary > 0
        crep = router._replicas[1]
        assert crep.dispatches["affinity"] == 0
        assert crep.dispatches["least_loaded"] == 0
        assert crep.dispatches["canary"] == rep.dispatches_canary
        assert rep.canary is not None and rep.canary["verdicts"]
        _, rep2 = pair()
        assert rep2.dispatches_canary == 0
