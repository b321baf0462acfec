"""The port's speculative and sampled segments (``sseg``) against the JAX
engine's, on the CPU.

Greedy speculation (K drafted tokens verified in one tick) against
``paddle_tpu``'s engine on the same numpy weights, in float32: tokens equal
to the non-speculative engine's on both sides, every segment's event dict
(with its ``spec`` counts), the emitted-count log ``acc``, each request's
drafts proposed and accepted and ``spec_accept_ewma`` equal to JAX's, also
with chunked prefill, EOS and preemption. Sampling cannot be compared draw
for draw (the port's streams are its own), so its contracts are held
directly: seeds replay, a request's stream does not depend on its
neighbours, ``top_k=1`` and temperature 0 equal greedy, a preempted request
resumes deterministically, and the verify rule's emitted tokens follow the
filtered softmax (a chi-square test on a six-token vocabulary). The device
reads follow the rule of ``ServingEngine._run_steps``. The cases mirror
tests/test_spec_sampling.py.
"""

import jax
import numpy as np
import pytest
import torch
from scipy import stats

from paddle_tpu.inference.prefix_cache import PagedPrefixCache as JaxPaged
from paddle_tpu.inference.serving import ServingEngine as JaxEngine
from paddle_tpu.parallel import set_mesh
from paddle_tpu_torch.inference import speculative as sp
from paddle_tpu_torch.inference.prefix_cache import PagedPrefixCache
from paddle_tpu_torch.inference.scheduler import (OnlineScheduler,
                                                  staggered_arrivals)
from paddle_tpu_torch.inference.serving import ServingEngine
from paddle_tpu_torch.models import llama as tl
from paddle_tpu_torch.models.convert import params_from_numpy

# the chi-square tests' significance: each fails by chance once in 10^4
# runs (their draws are fixed by the stream's keys, so a run is repeatable)
ALPHA = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
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


KW = dict(slots=4, max_len=64, chunk=4, prompt_buckets=(16,), paged=True,
          page_size=16)
SAMP = {"temperature": 0.8, "top_k": 32}


def _engine(both, port: bool, **kw):
    cfg, params, tcfg, tparams = both
    kw = {**KW, **kw}
    if port:
        return ServingEngine(tcfg, tparams, device="cpu", **kw)
    return JaxEngine(cfg, params, **kw)


def _repeats(seed, n, vocab=256):
    """Prompts of a 3-token pattern four times over: the tiny model's
    greedy continuations repeat too, so drafts get accepted."""
    rng = np.random.RandomState(seed)
    return [np.tile(rng.randint(0, vocab, (3,)), 4).astype(np.int32)
            for _ in range(n)]


def _randoms(seed, n, vocab=256, length=12):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, (length,)).astype(np.int32)
            for _ in range(n)]


def _segment(eng, port: bool, steps, pc=None):
    """One segment: (event dict, the emitted-count log of its steps)."""
    h = eng.dispatch_segment(steps, prefix_cache=pc)
    if port:
        ev = eng.finish_segment(h)
        acc = (None if h.log.acc is None
               else h.log.acc[:ev["steps"]].tolist())
        return ev, acc
    dev = jax.device_get(h.dev)
    ev = eng.finish_segment(h)
    return ev, (dev[3][:ev["steps"]].tolist() if h.spec else None)


def _serve(both, port, prompts, gen, steps=16, waves=1, **kw):
    """Serve ``prompts`` in ``waves`` (each queued after the previous
    wave's first segment) through segments; returns everything the two
    engines must agree on."""
    eng = _engine(both, port, **kw)
    parts = np.array_split(np.arange(len(prompts)), waves)
    rids, events, reqs = [], [], []
    for w, part in enumerate(parts):
        for i in part:
            rids.append(eng.add_request(prompts[i], gen))
            reqs.append(eng._queue[-1])
        events.append(_segment(eng, port, steps))
        if w == len(parts) - 1:
            while eng._queue or eng.free_slot_count() < eng.slots:
                events.append(_segment(eng, port, steps))
    out = eng.collect_finished()
    assert eng.pager.leak_report() == []
    return {"tokens": [out[r] for r in rids], "events": events,
            "ledger": [(r.spec_proposed, r.spec_accepted) for r in reqs],
            "ewma": eng.spec_accept_ewma, "ticks": eng.last_run_ticks,
            "fetches": eng.fetches if port else None}


def _strip(rec):
    return {k: v for k, v in rec.items() if k != "fetches"}


class TestGreedy:
    @pytest.mark.parametrize("K", [0, 2, 4])
    def test_matches_jax_and_the_plain_engine(self, both, K):
        """Seven requests over four slots in two waves: tokens equal the
        non-speculative engine's, and events, emitted counts, ledgers and
        the acceptance average equal JAX's."""
        prompts = _repeats(5, 4) + _randoms(6, 3)
        want = _serve(both, False, prompts, 20, waves=2, speculative=K)
        got = _serve(both, True, prompts, 20, waves=2, speculative=K)
        assert _strip(got) == _strip(want)
        plain = _serve(both, True, prompts, 20, waves=2)
        assert got["tokens"] == plain["tokens"]
        if K:
            accepted = sum(a for _, a in got["ledger"])
            assert accepted > 0 and got["ewma"] > 1.0
            assert all(p > 0 and 0 <= a <= p for p, a in got["ledger"])
            spec = [ev["spec"] for ev, _ in got["events"]]
            assert sum(s["accepted"] for s in spec) == accepted
            assert sum(s["emitted"] for s in spec) == \
                sum(len(t) for t in got["tokens"]) - len(prompts)

    @pytest.mark.parametrize("K", [2, 4])
    def test_chunked_and_eos_compose(self, both, K):
        """Speculation over chunked admits, then with an EOS that the
        plain stream emits early: equal to JAX's and truncated where the
        plain engine truncates."""
        prompts = _repeats(7, 3) + _randoms(8, 3)
        base = _serve(both, True, prompts, 16)["tokens"]
        kw = dict(speculative=K, chunked_prefill=True, prefill_chunks=(8,))
        want = _serve(both, False, prompts, 16, waves=2, **kw)
        got = _serve(both, True, prompts, 16, waves=2, **kw)
        assert _strip(got) == _strip(want)
        assert got["tokens"] == base
        eos = base[0][2]
        b_eos = _serve(both, True, prompts, 16, eos_token_id=eos)["tokens"]
        want = _serve(both, False, prompts, 16, waves=2, speculative=K,
                      eos_token_id=eos)
        got = _serve(both, True, prompts, 16, waves=2, speculative=K,
                     eos_token_id=eos)
        assert _strip(got) == _strip(want)
        assert got["tokens"] == b_eos
        for toks, full in zip(got["tokens"], base):
            assert toks == (full[:full.index(eos) + 1] if eos in full
                            else full)

    def test_preempt_resume_token_identity(self, both):
        """A verifying slot preempted after the first segment (its rows
        parked in the prefix cache) resumes token-identical, as on the JAX
        engine; no page leaks."""
        prompts = _repeats(9, 4)
        outs = []
        for port in (False, True):
            eng = _engine(both, port, speculative=3)
            pc = (PagedPrefixCache if port else JaxPaged)(
                eng.pager, capacity_pages=16)
            rids = [eng.add_request(p, 20) for p in prompts]
            events = [eng.run_segment(8, prefix_cache=pc)]
            slot = next(s for s in range(eng.slots) if eng.can_preempt(s))
            victim = eng.preempt_slot(slot, prefix_cache=pc)
            eng._queue.insert(0, victim)
            while eng._queue or eng.free_slot_count() < eng.slots:
                events.append(eng.run_segment(8, prefix_cache=pc))
            out = eng.collect_finished()
            pc.clear()
            assert eng.pager.leak_report() == []
            outs.append(([out[r] for r in rids], events, victim.rid))
        assert outs[1] == outs[0]
        plain = _serve(both, True, prompts, 20)["tokens"]
        assert outs[1][0] == plain

    def test_online_scheduler_serves_speculation(self, both):
        """``OnlineScheduler`` over the speculative engine: every request
        gets the non-speculative engine's tokens."""
        tcfg, tparams = both[2], both[3]
        arrivals = staggered_arrivals(5, 6, 0.002, tcfg.vocab_size,
                                      prompt_lens=(8, 12), gen_lens=(4, 6))
        res = []
        for kw in (dict(speculative=3), {}):
            eng = ServingEngine(tcfg, tparams, device="cpu", **KW, **kw)
            sch = OnlineScheduler(eng, seg_steps=16)
            rep = sch.serve(arrivals)
            assert rep.n_requests == 6
            res.append(sch.results())
        assert res[0] == res[1]


class TestSampled:
    @pytest.mark.parametrize("K", [0, 3])
    def test_seed_replay_and_isolation(self, both, K):
        """The same seeds replay exactly; two seeds on one prompt diverge;
        and a request's stream is the same whoever its neighbours are
        (other prompts, other seeds, other slots)."""
        p = _randoms(11, 1)[0]
        others = _randoms(12, 3)

        def serve(reqs):
            eng = _engine(both, True, speculative=K, sampling=SAMP)
            rids = [eng.add_request(q, 12, seed=s) for q, s in reqs]
            out = eng.run()
            assert eng.pager.leak_report() == []
            return [out[r] for r in rids]

        first = serve([(p, 1), (p, 2)])
        assert serve([(p, 1), (p, 2)]) == first
        assert first[0] != first[1], "different seeds must diverge"
        alone = serve([(p, 1)])[0]
        assert alone == first[0]
        crowd = serve([(others[0], 9), (others[1], 4), (p, 1),
                       (others[2], 7), (p, 5)])
        assert crowd[2] == first[0]

    @pytest.mark.parametrize("K", [0, 3])
    def test_top_k_1_and_temperature_0_equal_greedy(self, both, K):
        prompts = _repeats(13, 2) + _randoms(14, 3)
        greedy = _serve(both, True, prompts, 12)["tokens"]
        k1 = _serve(both, True, prompts, 12, speculative=K,
                    sampling={"temperature": 0.8, "top_k": 1})["tokens"]
        assert k1 == greedy
        t0 = _serve(both, True, prompts, 12, speculative=K,
                    sampling={"temperature": 0.0, "top_k": 16})
        assert t0["tokens"] == greedy
        assert _engine(both, True, sampling={"temperature": 0.0}
                       ).sampling is None

    @pytest.mark.parametrize("K", [0, 2])
    def test_preempt_and_resume_continue_deterministically(self, both, K):
        """A sampled request preempted mid-stream resumes from a stream
        keyed by its seed and its tokens so far: the whole serve replays,
        and the resumed request keeps the tokens it had."""
        prompts = _randoms(15, 4)

        def serve():
            eng = _engine(both, True, speculative=K, sampling=SAMP)
            pc = PagedPrefixCache(eng.pager, capacity_pages=16)
            rids = [eng.add_request(p, 16) for p in prompts]
            eng.run_segment(6, prefix_cache=pc)
            slot = next(s for s in range(eng.slots) if eng.can_preempt(s))
            victim = eng.preempt_slot(slot, prefix_cache=pc)
            kept = list(victim.tokens)
            eng._queue.insert(0, victim)
            while eng._queue or eng.free_slot_count() < eng.slots:
                eng.run_segment(6, prefix_cache=pc)
            out = eng.collect_finished()
            pc.clear()
            assert eng.pager.leak_report() == []
            assert out[victim.rid][:len(kept)] == kept
            return [out[r] for r in rids], victim.rid

        first = serve()
        assert serve() == first
        assert all(len(t) == 16 for t in first[0])


class TestRejectionRule:
    @pytest.mark.parametrize("K", [0, 1, 3])
    def test_emitted_tokens_follow_the_filtered_softmax(self, K):
        """The verify rule on fixed logits over a six-token vocabulary
        (temperature 0.9, top-k 5: one token is filtered out), 60000 rows
        each with its own stream key and fixed drafts: the token emitted
        at position i, among rows that accepted the drafts before it, is
        distributed as the filtered softmax of position i (chi-square at
        ALPHA over the kept support; the filtered token never appears), and
        draft i is accepted at the rate p_i(d_i) (a binomial test at
        ALPHA)."""
        V, N = 6, 60000
        gen = torch.Generator().manual_seed(K)
        base = torch.randn(K + 1, V, generator=gen) * 1.5
        sampling = (0.9, 5, 1.0)
        p = torch.softmax(tl.sample_filter_logits(base, *sampling), -1)
        # the drafts: each position's likeliest token, then its second
        drafts = torch.tensor([int(torch.argsort(p[i])[-1 - i % 2])
                               for i in range(K)], dtype=torch.int64)
        rng = torch.stack([torch.arange(N, dtype=torch.int64),
                           torch.zeros(N, dtype=torch.int64)], 1)
        e, a = sp.verify(base[None].expand(N, K + 1, V).contiguous(),
                         drafts[None].expand(N, K).contiguous(),
                         torch.zeros(N, dtype=torch.int64), sampling, rng)
        assert (rng[:, 1] == sp.draws_a_tick(K)).all()
        for i in range(K + 1):
            rows = a >= i
            got = torch.bincount(e[rows, i], minlength=V).numpy()
            support = p[i].numpy() > 0
            assert got[~support].sum() == 0
            n = int(rows.sum())
            assert n > 1000
            want = p[i].double().numpy()[support]
            chi = stats.chisquare(got[support], n * want / want.sum())
            assert chi.pvalue > ALPHA, (i, got, n * want)
            if i < K:
                acc = int((a[rows] > i).sum())
                assert stats.binomtest(acc, n, float(p[i, drafts[i]])
                                       ).pvalue > ALPHA

    def test_greedy_rule_and_draft(self):
        """Greedy: the argmax chain, drafts accepted up to the first
        mismatch. The draft: the tokens after the latest earlier bigram
        match within [hstart + 1, pos), else the next token repeated."""
        logits = torch.zeros(2, 4, 5)
        chain = torch.tensor([[1, 2, 3, 4], [0, 0, 1, 2]])
        logits.scatter_(2, chain[..., None], 1.0)
        e, a = sp.verify(logits, torch.tensor([[1, 2, 0], [0, 1, 1]]),
                         torch.zeros(2, dtype=torch.int64))
        assert e.tolist() == chain.tolist()
        assert a.tolist() == [2, 1]
        hist = torch.tensor([[5, 7, 8, 5, 7, 9, 5, 0, 0],
                             [5, 7, 8, 5, 7, 9, 5, 0, 0]])
        d = sp.ngram_draft(hist, torch.tensor([0, 2], dtype=torch.int32),
                           torch.tensor([7, 7], dtype=torch.int32),
                           torch.tensor([7, 7]), 3)
        # slot 0: bigram (5, 7) last at columns 3-4 -> 9, 5, then clamped
        # to column pos - 1 = 6; slot 1 scans from column 3: the same
        assert d.tolist() == [[9, 5, 5], [9, 5, 5]]
        d = sp.ngram_draft(hist, torch.tensor([4, 0], dtype=torch.int32),
                           torch.tensor([7, 3], dtype=torch.int32),
                           torch.tensor([7, 1]), 2)
        assert d.tolist() == [[7, 7], [1, 1]]   # no match: repeat nxt


class TestFetches:
    def _count(self, both, prompts, steps=16, **kw):
        eng = _engine(both, True, **kw)
        for p in prompts:
            eng.add_request(p, 20)
        segments = 0
        while eng._queue or eng.free_slot_count() < eng.slots:
            eng.run_segment(steps)
            segments += 1
        eng.collect_finished()
        return eng.fetches, segments

    def test_one_fetch_a_segment_where_nothing_depends_on_the_data(
            self, both):
        """Sampled K = 0 and chunked greedy: one fetch a segment (the
        bounds on every slot's remaining count are exact); K > 0 with no
        request waiting for a slot reads more: whether a slot is still
        live after a tick depends on what it accepted."""
        many, few = _randoms(16, 7), _repeats(17, 4)
        for kw, prompts in ((dict(sampling=SAMP), many),
                            (dict(chunked_prefill=True, prefill_chunks=(8,)),
                             many)):
            fetches, segments = self._count(both, prompts, **kw)
            assert fetches == segments, kw
        fetches, segments = self._count(both, few, speculative=3)
        assert fetches > segments

    def test_reads_only_where_the_schedule_depends_on_them(self, both):
        """K > 0 with requests waiting for slots: each read is a choice
        the bounds could not make, so a serve reads more than once a
        segment but less than once a step; the tokens are unchanged. No
        verify tick is issued with every slot frozen: the ticks run equal
        the verify steps the event logs count (each with a live slot),
        also in a segment's tail, where drafts are accepted."""
        prompts = _repeats(18, 4) + _randoms(19, 4)
        eng = _engine(both, True, speculative=3)
        verify, ticks = eng._verify_paged, [0]

        def counted():
            ticks[0] += 1
            return verify()
        eng._verify_paged = counted
        rids = [eng.add_request(p, 20) for p in prompts]
        steps = segments = verify_steps = accepted = 0
        while eng._queue or eng.free_slot_count() < eng.slots:
            ev = eng.run_segment(16)
            steps += ev["steps"]
            verify_steps += ev["spec"]["verify_steps"]
            accepted += ev["spec"]["accepted"]
            segments += 1
        out = eng.collect_finished()
        assert segments < eng.fetches < steps
        assert accepted > 0
        assert ticks[0] == verify_steps
        plain = _serve(both, True, prompts, 20)["tokens"]
        assert [out[r] for r in rids] == plain


class TestState:
    def test_reset_and_abort_rebuild_the_spec_state(self, both):
        eng = _engine(both, True, speculative=2, sampling=SAMP)
        for p in _randoms(20, 3):
            eng.add_request(p, 12)
        eng.run_segment(6)
        assert int(eng._hist.abs().sum()) > 0
        assert int(eng._rng[:, 1].sum()) > 0
        orphans = eng.abort()
        assert len(orphans) == 3
        assert int(eng._hist.abs().sum()) == 0
        assert int(eng._rng.abs().sum()) == 0
        assert eng.pager.leak_report() == []
        eng._queue.extend(orphans)
        eng.run()
        eng.spec_accept_ewma = 3.0
        eng.reset_slots()
        assert eng.spec_accept_ewma == 1.0
        assert int(eng._hist.abs().sum()) == 0
        plain = _engine(both, True)
        assert plain._hist is None and plain._rng is None
