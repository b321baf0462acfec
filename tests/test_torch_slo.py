"""The port's ``SLOScheduler`` against the JAX package's, on the CPU.

Its decisions read the clock (arrivals due, deadline shedding, the
per-token and per-tick EWMAs), so the two are held to each other under one
clock: the JAX serve runs with a ``journal.Journal`` attached, which keeps
every decision-clock read as a ``clock`` record, and the port serves the
same trace from the same numpy weights (float32) under the port's
``journal.feed_clock`` of those values, with its own journal attached. The
decision records (``arrival``, ``admit``, ``first_token``, ``finish``,
``shed_decision``, ``preempt_decision``, the flight events the journal
forwards: ``preempt``, ``displaced``, ``shed``, ``segment``, ...) and the
tokens must then be identical, on the paged and on the contiguous engine.
A feed that runs out means the port read the clock where JAX did not: a
failure. The port's own contracts follow the JAX suite
(tests/test_slo_serving.py): preempt-resume token identity, no priority
inversion, never a same-class preemption, shed accounting, the retry
hint, and monitors that change nothing the engine does.
"""

import numpy as np
import pytest
import torch

from paddle_tpu.inference import scheduler as jsched
from paddle_tpu.inference.serving import ServingEngine as JaxEngine
from paddle_tpu.observability import journal as jjournal
from paddle_tpu.parallel import set_mesh
from paddle_tpu_torch.inference import scheduler as tsched
from paddle_tpu_torch.inference.prefix_cache import PagedPrefixCache
from paddle_tpu_torch.inference.serving import ServingEngine
from paddle_tpu_torch.models import llama as tl
from paddle_tpu_torch.models.convert import params_from_numpy
from paddle_tpu_torch.observability import journal as tjournal
from paddle_tpu_torch.observability.capacity import CapacityMonitor
from paddle_tpu_torch.observability.perf import PerfMonitor
from paddle_tpu_torch.observability.slo import Objective, SLOMonitor

PAGED = dict(slots=2, max_len=96, prompt_buckets=(8, 16, 64), paged=True,
             page_size=16)
DENSE = dict(slots=2, max_len=96, prompt_buckets=(8, 16, 64))
# the record kinds compared (the journal's own bookkeeping, header and
# wall-time fields aside)
SKIP_KEYS = ("v", "gseq", "rank", "seq", "t")


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """The models here are tiny: more intra-op threads than two only spin
    against the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def both(tiny_llama):
    set_mesh(None)
    cfg, params = tiny_llama
    tcfg = tl.LlamaConfig.tiny(max_seq_len=cfg.max_seq_len)
    tparams = params_from_numpy({k: np.asarray(v) for k, v in params.items()},
                                tcfg, "cpu")
    return cfg, params, tcfg, tparams


def _engine(both, port, paged=True, **kw):
    cfg, params, tcfg, tparams = both
    geom = {**(PAGED if paged else DENSE), **kw}
    if port:
        return ServingEngine(tcfg, tparams, device="cpu", **geom)
    return JaxEngine(cfg, params, **geom)


def _rows(rng, vocab, spec):
    """(t, prompt_len, gen, priority, deadline_s) rows as plain data."""
    return [(t, rng.randint(0, vocab, (n,)).astype(np.int32), g, p, d)
            for t, n, g, p, d in spec]


def _preempt_trace(vocab, seed=23):
    """Three class-1 requests pin both slots; a class-0 one arrives 1 ms
    in (during the first segment) and preempts the least advanced."""
    rng = np.random.RandomState(seed)
    return _rows(rng, vocab, [(0.0, 8, 24, 1, None)] * 3
                 + [(0.001, 8, 4, 0, None)])


def _shed_trace(vocab, seed=37):
    """Two requests whose deadline passed before they arrived (shed at the
    first pass), one with a generous deadline and one with none."""
    rng = np.random.RandomState(seed)
    return _rows(rng, vocab, [(0.0, 10, 6, 0, None), (0.0, 10, 6, 0, 30.0),
                              (0.0, 10, 6, 1, -0.001),
                              (0.0, 10, 6, 1, -0.001)])


def _displace_trace(vocab, seed=53):
    """A bounded queue of 2 filled by class 1, then class-0 arrivals that
    displace them back client-side, and a later class-1 trickle."""
    rng = np.random.RandomState(seed)
    return _rows(rng, vocab, [(0.0, 8, 10, 1, None)] * 4
                 + [(0.002, 8, 4, 0, None)] * 2
                 + [(0.004, 16, 6, 1, 50.0)])


def _burst_trace(vocab, seed=29):
    """Both classes at once, more than two slots hold."""
    rng = np.random.RandomState(seed)
    spec = [(0.0, int(rng.choice((8, 16))), int(rng.choice((6, 10))),
             0 if i % 3 == 0 else 1, None) for i in range(12)]
    return _rows(rng, vocab, spec)


TRACES = {"preempt": (_preempt_trace, 8), "shed": (_shed_trace, 8),
          "displace": (_displace_trace, 2), "burst": (_burst_trace, 16)}


def _arrivals(mod, rows):
    return [mod.Arrival(t, p, g, priority=pr, deadline_s=d)
            for t, p, g, pr, d in rows]


def _records(j):
    out = []
    for r in j.records():
        if r["kind"] == "header" or r["kind"] not in jjournal.DECISION_KINDS:
            continue
        out.append({k: v for k, v in r.items() if k not in SKIP_KEYS})
    return out


def _report(rep):
    d = rep.as_dict(with_requests=True)
    d.pop("cold_start_s")            # build time: perf_counter, not fed
    if d["meter"] is not None:
        for agg in [d["meter"]["total"]] + list(
                d["meter"]["per_class"].values()):
            agg.pop("page_seconds")
    for row in d["per_request"]:
        row.pop("page_seconds")
    return d


def _jax_serve(both, rows, max_queue, paged=True, seg_steps=16, **sched):
    eng = _engine(both, False, paged)
    sch = jsched.SLOScheduler(eng, max_queue=max_queue, seg_steps=seg_steps,
                              **sched)
    j = jjournal.Journal()
    with jjournal.attach(j):
        rep = sch.serve(_arrivals(jsched, rows))
    clock = [r["c"] for r in j.records() if r["kind"] == "clock"]
    return {"records": _records(j), "report": _report(rep),
            "results": sch.results()}, clock


def _port_serve(both, rows, max_queue, clock, paged=True, seg_steps=16,
                **sched):
    eng = _engine(both, True, paged)
    sch = tsched.SLOScheduler(eng, max_queue=max_queue, seg_steps=seg_steps,
                              **sched)
    j = tjournal.Journal()
    with tjournal.attach(j), tjournal.feed_clock(clock) as feed:
        rep = sch.serve(_arrivals(tsched, rows))
    assert feed.remaining == 0, "the port read the clock fewer times"
    return {"records": _records(j), "report": _report(rep),
            "results": sch.results()}, sch, rep


@pytest.fixture(scope="module")
def fed(both):
    """Every scenario on both engines: the JAX serve recorded, the port's
    under its clock."""
    out = {}
    vocab = both[0].vocab_size
    for name, (mk, max_queue) in TRACES.items():
        rows = mk(vocab)
        for paged in (True, False):
            want, clock = _jax_serve(both, rows, max_queue, paged)
            got, sch, rep = _port_serve(both, rows, max_queue, clock, paged)
            out[name, paged] = (want, got, sch, rep)
    return out


SCENARIOS = [(n, p) for n in TRACES for p in (True, False)]
IDS = [f"{n}-{'paged' if p else 'contiguous'}" for n, p in SCENARIOS]


class TestFedClockParity:
    @pytest.mark.parametrize("name,paged", SCENARIOS, ids=IDS)
    def test_decision_records_match_jax(self, fed, name, paged):
        want, got = fed[name, paged][:2]
        assert len(got["records"]) == len(want["records"])
        for i, (g, w) in enumerate(zip(got["records"], want["records"])):
            assert g == w, (i, g, w)

    @pytest.mark.parametrize("name,paged", SCENARIOS, ids=IDS)
    def test_tokens_and_report_match_jax(self, fed, name, paged):
        want, got = fed[name, paged][:2]
        assert got["results"] == want["results"]
        assert got["report"] == want["report"]

    def test_scenarios_exercise_the_control_plane(self, fed):
        """Each trace really takes its path: preemptions, sheds and
        displacements happen where they are meant to."""
        for paged in (True, False):
            assert fed["preempt", paged][3].preemptions >= 1
            assert fed["shed", paged][3].shed == 2
            assert fed["displace", paged][3].displaced >= 1
            kinds = {r["kind"] for r in fed["preempt", paged][1]["records"]}
            assert {"preempt_decision", "preempt", "arrival", "admit",
                    "first_token", "finish", "clock"} <= kinds

    def test_feed_that_runs_out_is_a_divergence(self, both):
        rows = _preempt_trace(both[0].vocab_size)
        _, clock = _jax_serve(both, rows, 8)
        with pytest.raises(tjournal.JournalError, match="exhausted"):
            _port_serve(both, rows, 8, clock[:len(clock) // 2])


# ---------------------------------------------------------------------------
# the port's own contracts (tests/test_slo_serving.py)
# ---------------------------------------------------------------------------


def _serve(both, rows, paged=True, slo=True, cache=False, max_queue=8,
           **sched):
    eng = _engine(both, True, paged)
    pc = (PagedPrefixCache(eng.pager, capacity_pages=32)
          if cache and paged else None)
    cls = tsched.SLOScheduler if slo else tsched.OnlineScheduler
    sch = cls(eng, max_queue=max_queue, seg_steps=16, prefix_cache=pc,
              **sched)
    rep = sch.serve(_arrivals(tsched, rows))
    return sch, rep, sch.results(), eng, pc


@pytest.mark.parametrize("paged,cache", [(True, False), (True, True),
                                         (False, False)])
def test_preempt_resume_token_identity(both, paged, cache):
    """A class-0 arrival preempts the least advanced class-1 request; the
    victim resumes (on a paged engine with a cache, over its parked
    pages) and every stream equals the plain scheduler's."""
    rows = _preempt_trace(both[0].vocab_size)
    sch, rep, out, eng, pc = _serve(both, rows, paged, cache=cache)
    _, _, ref, _, _ = _serve(both, rows, paged, slo=False)
    assert rep.preemptions >= 1 and out == ref
    victims = [r for r in sch._reqs.values() if r.preemptions]
    assert victims and all(r.priority == 1 for r in victims)
    if cache:
        assert victims[0].prefix_hit_len > 0
        pc.clear()
    if paged:
        assert eng.pager.leak_report() == []


@pytest.mark.parametrize("paged", [True, False])
def test_no_priority_inversion_under_overload(both, paged):
    """With both classes bursting at once, class 0's TTFT p99 stays below
    class 1's."""
    rows = _burst_trace(both[0].vocab_size)
    _, rep, _, _, _ = _serve(both, rows, paged, max_queue=16)
    assert set(rep.per_class) == {0, 1}
    assert rep.per_class[0]["ttft_p99_s"] < rep.per_class[1]["ttft_p99_s"]


@pytest.mark.parametrize("paged", [True, False])
def test_never_preempts_same_or_higher_class(both, paged):
    rng = np.random.RandomState(31)
    rows = _rows(rng, both[0].vocab_size,
                 [(0.0, 16, 12, 0, None)] * 3 + [(0.05, 8, 4, 1, None)])
    j = tjournal.Journal()
    with tjournal.attach(j):
        _, rep, _, _, _ = _serve(both, rows, paged)
    assert rep.preemptions == 0 and rep.n_requests == 4
    assert not [r for r in j.records() if r["kind"] == "preempt"]


@pytest.mark.parametrize("paged", [True, False])
def test_preempt_decisions_only_lower_classes(both, paged):
    j = tjournal.Journal()
    with tjournal.attach(j):
        _, rep, _, _, _ = _serve(both, _burst_trace(both[0].vocab_size),
                                 paged, max_queue=16)
    decisions = [r for r in j.records() if r["kind"] == "preempt_decision"]
    assert len(decisions) == rep.preemptions
    for d in decisions:
        assert d["victim_priority"] > d["head_priority"]


@pytest.mark.parametrize("paged", [True, False])
def test_shed_accounting_matches_report(both, paged):
    from paddle_tpu_torch.observability import metrics

    before = metrics.counter("scheduler.shed").value
    j = tjournal.Journal()
    with tjournal.attach(j):
        sch, rep, out, _, _ = _serve(both,
                                     _shed_trace(both[0].vocab_size), paged)
    sheds = [r for r in j.records() if r["kind"] == "shed_decision"]
    assert rep.shed == 2 == sch.shed_count == len(sheds) == len(
        sch.shed_log)
    assert rep.shed_per_class == {1: 2}
    assert metrics.counter("scheduler.shed").value == before + 2
    assert rep.n_requests == 2 and len(out) == 2
    assert {r["rid"] for r in sheds}.isdisjoint(out)
    for r in sheds:
        assert r["now_abs"] + r["min_service_s"] > r["deadline_abs"]


def test_retry_after_hint_matches_jax(both):
    """The hint before any finish (one second over the acceptance EWMA)
    and after finishes (elapsed / finished, clamped), and on a refused
    serve: in the report and the gauge."""
    from paddle_tpu_torch.observability import metrics

    got = tsched.SLOScheduler(_engine(both, True))
    want = jsched.SLOScheduler(_engine(both, False))
    for sch in (got, want):
        sch.engine.spec_accept_ewma = 2.5
    assert got.retry_after_hint(3.0) == want.retry_after_hint(3.0) == 0.4
    for finished, now in ((4, 2.0), (1, 1e-5), (1, 500.0)):
        got._finished_count = want._finished_count = finished
        assert got.retry_after_hint(now) == want.retry_after_hint(now)
    arr = tsched.staggered_arrivals(41, 8, 0.0, both[0].vocab_size,
                                    prompt_lens=(8,), gen_lens=(8,))
    sch = tsched.SLOScheduler(_engine(both, True), max_queue=2,
                              seg_steps=16)
    rep = sch.serve(arr)
    assert rep.backpressure_events > 0 and rep.retry_after_s > 0
    assert metrics.gauge("serving.retry_after_s").value > 0
    assert rep.n_requests == 8


def test_min_service_estimate_matches_jax(both):
    """The shed estimate: owed x per-token EWMA, or on a speculative
    engine owed / acceptance x per-tick EWMA."""
    for kw in ({}, {"speculative": 2}):
        got = tsched.SLOScheduler(_engine(both, True, **kw))
        want = jsched.SLOScheduler(_engine(both, False, **kw))
        for sch, mod in ((got, tsched), (want, jsched)):
            sch._per_token_s, sch._per_tick_s = 0.003, 0.011
            sch.engine.spec_accept_ewma = 2.0
        for p, g, done in ((8, 10, 0), (8, 10, 4), (16, 3, 2)):
            rg = got.engine._queue  # unused: requests built directly
            del rg
            r_t = tsched.Request(0, np.zeros(p, np.int32), g,
                                 tokens=[1] * done)
            r_j = jsched.Request(0, np.zeros(p, np.int32), g,
                                 tokens=[1] * done)
            assert got._min_service_s(r_t) == want._min_service_s(r_j)


def test_queue_is_class_ordered(both):
    sch = tsched.SLOScheduler(_engine(both, True))
    eng = sch.engine
    for prio in (1, 0, 1, 0, 2):
        rid = eng.add_request(np.arange(8, dtype=np.int32), 2)
        r = eng._queue.pop()
        assert r.rid == rid
        r.priority = prio
        sch._insert_by_class(r)
    assert [(r.priority, r.rid) for r in eng._queue] == \
        [(0, 1), (0, 3), (1, 0), (1, 2), (2, 4)]


@pytest.mark.parametrize("paged", [True, False])
def test_monitors_change_nothing_on_the_engine(both, paged):
    """With the SLO, perf and capacity monitors attached the tokens, the
    segments and the engine's reads are the same as without: the monitors
    only read host stamps."""
    cfg, tcfg = both[0], both[2]
    rows = _preempt_trace(cfg.vocab_size)

    def run(monitors):
        kw = {}
        eng = _engine(both, True, paged)
        if monitors:
            kw = dict(slo_monitor=SLOMonitor({0: Objective(
                ttft_target_s=1.0), 1: Objective(e2e_target_s=5.0)}),
                perf_monitor=PerfMonitor(tcfg, eng.params, batch=2),
                capacity_monitor=CapacityMonitor())
        sch = tsched.SLOScheduler(eng, max_queue=8, seg_steps=16,
                                  shed_deadlines=False, **kw)
        rep = sch.serve(_arrivals(tsched, rows))
        return sch.results(), rep.segments, rep.ticks, eng.fetches, rep

    on, off = run(True), run(False)
    assert on[:4] == off[:4]
    rep = on[4]
    assert rep.slo["segments"] == rep.segments
    assert rep.perf["segments"] == rep.segments
    if paged:
        assert rep.capacity["segments"] == rep.segments
    else:
        assert rep.capacity["segments"] == 0


def test_warm_serve_resets_slo_counters(both):
    rows = _shed_trace(both[0].vocab_size)
    sch = tsched.SLOScheduler(_engine(both, True), max_queue=8,
                              seg_steps=16)
    rep = sch.serve(_arrivals(tsched, rows), warm=True)
    assert rep.shed == 2 == sch.shed_count
    assert rep.shed_per_class == {1: 2}
