"""The port's contiguous engine against the JAX package's, on the CPU.

``paddle_tpu_torch``'s ``ServingEngine(device="cpu")`` against
``paddle_tpu``'s on the same requests and the same numpy weights, in
float32: the fused drain (``run()``), the contiguous engine's re-entrant
segments with and without the row-copy ``PrefixCache``, the online
scheduler over them, and preemption and abort on both engines. Tokens,
segment event dicts, step and chunk counts, prefix-cache statistics and
the order of returned requests must be identical; harvested rows equal
``prompt_kv``'s within 1e-5. Every stream also equals the port's dense
``generate`` (itself held to JAX's in tests/test_torch_sampling.py). The
cases mirror tests/test_serving.py and tests/test_slo_serving.py.
"""

import numpy as np
import pytest
import torch

from paddle_tpu.inference import scheduler as jsched
from paddle_tpu.inference.prefix_cache import PagedPrefixCache as JaxPaged
from paddle_tpu.inference.prefix_cache import PrefixCache as JaxCache
from paddle_tpu.inference.serving import ServingEngine as JaxEngine
from paddle_tpu.models import llama as jl
from paddle_tpu.parallel import set_mesh
from paddle_tpu_torch.inference import scheduler as tsched
from paddle_tpu_torch.inference.prefix_cache import (PagedPrefixCache,
                                                     PrefixCache,
                                                     make_prefix_cache)
from paddle_tpu_torch.inference.serving import ServingEngine
from paddle_tpu_torch.models import llama as tl
from paddle_tpu_torch.models.convert import params_from_numpy

# harvested rows against a standalone prefill: fp32 in another summation
# order (the JAX package's own bar for the same comparison)
KV_TOL = dict(rtol=1e-5, atol=1e-5)


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


def _engines(both, **kw):
    """(JAX engine, port engine), built alike."""
    cfg, params, tcfg, tparams = both
    return (JaxEngine(cfg, params, **kw),
            ServingEngine(tcfg, tparams, device="cpu", **kw))


def _dense(both, prompt, n, eos=None):
    """The port's dense greedy stream, truncated after the first EOS."""
    tcfg, tparams = both[2:]
    out = tl.generate(tparams, np.asarray(prompt, np.int32)[None], tcfg,
                      max_new_tokens=n, max_len=96, device="cpu")
    toks = [int(t) for t in out[0]]
    return toks[:toks.index(eos) + 1] if eos in toks else toks


def _prompts(seed, vocab, shapes, prefix=None):
    rng = np.random.RandomState(seed)
    out = []
    for l, n in shapes:
        p = rng.randint(0, vocab, (l,)).astype(np.int32)
        if prefix is not None:
            p = np.concatenate([prefix, p])
        out.append((p, n))
    return out


def _add(engines, reqs):
    """Add ``reqs`` to every engine; returns the rids (equal across)."""
    ids = [[e.add_request(p, n) for p, n in reqs] for e in engines]
    assert all(i == ids[0] for i in ids)
    return ids[0]


def _segments_both(ref, eng, max_steps, pc_ref=None, pc=None):
    """One segment on each engine: the event dicts must be equal."""
    want = ref.run_segment(max_steps, prefix_cache=pc_ref)
    got = eng.run_segment(max_steps, prefix_cache=pc)
    assert got == want
    return got


def _drain_both(ref, eng, max_steps, pc_ref=None, pc=None):
    while ref._queue or ref.free_slot_count() < ref.slots:
        _segments_both(ref, eng, max_steps, pc_ref, pc)
    assert not eng._queue and eng.free_slot_count() == eng.slots
    want, got = ref.collect_finished(), eng.collect_finished()
    assert got == want
    return got


class TestWindowedPath:
    SHAPES = [(5, 7), (12, 3), (30, 9), (3, 12), (17, 5)]

    def test_windowed_matches_fused(self, both):
        """run() (the fused drain) against JAX's run(): the same tokens,
        decode ticks, chunks and latency keys, one fetch; and the port's
        windowed loop gives the same tokens."""
        reqs = _prompts(3, both[0].vocab_size, self.SHAPES)
        kw = dict(slots=3, max_len=96, chunk=4, prompt_buckets=(8, 16, 32))
        ref, eng = _engines(both, **kw)
        ids = _add((ref, eng), reqs)
        want, got = ref.run(), eng.run()
        assert got == want
        assert eng.last_run_ticks == ref.last_run_ticks > 0
        assert eng.last_run_chunks == ref.last_run_chunks
        assert set(eng.last_latencies) == set(ref.last_latencies) == set(ids)
        assert eng.fetches == 1
        win = ServingEngine(both[2], both[3], device="cpu", **kw)
        _add((win,), reqs)
        assert win.run(fused=False) == got
        assert [len(got[r]) for r in ids] == [n for _, n in reqs]

    def test_windowed_eos_deferred_freeze(self, both):
        """EOS mid-generation and at the prefill token: the fused drain
        truncates after the first EOS as JAX's does, reading each step
        (one fetch a step), and the windowed loop agrees."""
        reqs = _prompts(5, both[0].vocab_size, [(6 + i, 8) for i in range(5)])
        refs = [_dense(both, p, n) for p, n in reqs]
        kw = dict(slots=2, max_len=96, chunk=4, prompt_buckets=(16,))
        for eos in (refs[0][2], refs[1][0]):
            ref, eng = _engines(both, eos_token_id=eos, **kw)
            ids = _add((ref, eng), reqs)
            want, got = ref.run(), eng.run()
            assert got == want
            assert eng.last_run_ticks == ref.last_run_ticks
            assert eng.last_run_chunks == ref.last_run_chunks
            assert eng.fetches == eng.last_run_ticks + len(reqs)
            for rid, full in zip(ids, refs):
                assert got[rid] == (full[:full.index(eos) + 1]
                                    if eos in full else full)
            win = ServingEngine(both[2], both[3], device="cpu",
                                eos_token_id=eos, **kw)
            _add((win,), reqs)
            assert win.run(fused=False) == got


class TestSegmentReentry:
    @pytest.mark.parametrize("cache", [False, True])
    def test_segments_match_jax_with_midflight_arrivals(self, both, cache):
        """Requests added between segments, while earlier ones still hold
        slots, with EOS set: every segment's event dict equals the JAX
        engine's, as do the streams (also the dense ones) and, with a
        PrefixCache, its statistics. The prompts share a 32-token prefix,
        so the cache serves hits."""
        vocab = both[0].vocab_size
        prefix = np.random.RandomState(20).randint(0, vocab, (32,)).astype(
            np.int32)
        wave1 = _prompts(21, vocab, [(5, 9), (12, 6), (8, 12)], prefix)
        wave2 = _prompts(22, vocab, [(20, 4), (3, 8), (15, 5), (7, 10)],
                         prefix)
        eos = _dense(both, *wave1[0])[3]
        ref, eng = _engines(both, slots=2, max_len=96, eos_token_id=eos,
                            prompt_buckets=(8, 16, 64))
        pc_ref = JaxCache(block=16, capacity_tokens=2048) if cache else None
        pc = PrefixCache(block=16, capacity_tokens=2048) if cache else None
        ids = _add((ref, eng), wave1)
        assert _segments_both(ref, eng, 5, pc_ref, pc)["steps"] == 5
        ids += _add((ref, eng), wave2)
        out = _drain_both(ref, eng, 7, pc_ref, pc)
        for rid, (p, n) in zip(ids, wave1 + wave2):
            assert out[rid] == _dense(both, p, n, eos)
        if cache:
            assert pc.stats() == pc_ref.stats()
            assert pc.hits > 0

    def test_segment_eos_freeze_and_reuse(self, both):
        """EOS inside a segment frees the slot and a queued request takes
        it within the same segment."""
        reqs = _prompts(23, both[0].vocab_size,
                        [(6 + i, 8) for i in range(4)])
        eos = _dense(both, *reqs[0])[1]
        ref, eng = _engines(both, slots=1, max_len=96, eos_token_id=eos,
                            prompt_buckets=(16,))
        ids = _add((ref, eng), reqs)
        out = _drain_both(ref, eng, 24)
        for rid, (p, n) in zip(ids, reqs):
            assert out[rid] == _dense(both, p, n, eos)

    def test_requeues_what_the_budget_did_not_admit(self, both):
        """Four picked, two admitted in a 3-step segment: the other two go
        back to the queue head with no admit time, as in JAX's engine."""
        reqs = _prompts(24, both[0].vocab_size, [(6, 6)] * 4)
        ref, eng = _engines(both, slots=2, max_len=96, prompt_buckets=(8,))
        _add((ref, eng), reqs)
        ev = _segments_both(ref, eng, 3)
        assert len(ev["admitted"]) == 2
        assert [r.rid for r in eng._queue] == [r.rid for r in ref._queue]
        assert all(r.admit_time == 0.0 for r in eng._queue)
        _drain_both(ref, eng, 16)


class TestOnlineScheduler:
    def test_serve_matches_dense_per_request(self, both):
        """A seeded staggered trace through the scheduler on a contiguous
        engine: every request equals its dense stream, and the measured
        telemetry is ordered."""
        cfg = both[0]
        arr = tsched.staggered_arrivals(31, 9, 0.02, cfg.vocab_size,
                                        prompt_lens=(5, 11, 23),
                                        gen_lens=(3, 7, 11))
        eng = ServingEngine(both[2], both[3], slots=3, max_len=96,
                            prompt_buckets=(8, 16, 32), device="cpu")
        sch = tsched.OnlineScheduler(eng, seg_steps=6)
        rep = sch.serve(arr)
        out = sch.results()
        assert rep.n_requests == len(arr) == len(out)
        for a, rid in zip(sorted(arr, key=lambda x: x.t), sorted(out)):
            assert out[rid] == _dense(both, a.prompt, a.max_new_tokens)
        for r in rep.per_request:
            assert r["ttft_s"] >= 0 and r["e2e_s"] >= r["ttft_s"]
        assert rep.ticks > 0 and rep.segments > 0 and rep.pages is None

    @pytest.mark.parametrize("cache", [False, True])
    def test_burst_matches_jax_scheduler(self, both, cache):
        """Every arrival at t = 0 (the schedule does not depend on the
        clock), through a warm pass: the same streams, segments, steps and
        prefix-cache section as JAX's scheduler on its contiguous
        engine."""
        cfg = both[0]
        prefix = np.random.RandomState(30).randint(0, cfg.vocab_size, (32,))
        arr = tsched.staggered_arrivals(32, 7, 0.0, cfg.vocab_size,
                                        prompt_lens=(5, 9, 14),
                                        gen_lens=(4, 7, 11), prefix=prefix)
        kw = dict(slots=3, max_len=96, prompt_buckets=(16, 64))
        ref, eng = _engines(both, **kw)
        reports = []
        for mod, e, pc in ((jsched, ref, JaxCache(block=16)),
                           (tsched, eng, PrefixCache(block=16))):
            sch = mod.OnlineScheduler(e, seg_steps=8,
                                      prefix_cache=pc if cache else None)
            rep = sch.serve([mod.Arrival(a.t, a.prompt, a.max_new_tokens)
                             for a in arr], warm=True)
            reports.append((sch.results(), rep.segments, rep.ticks,
                            rep.prefix,
                            [r["prefix_hit_len"] for r in rep.per_request]))
        assert reports[1] == reports[0]
        if cache:
            assert reports[1][3]["hits"] > 0


class TestPrefixCache:
    def test_hit_path_token_identical_and_cheaper(self, both):
        """Admission through a hit gives the cold path's tokens, and the
        hits shorten the prefills; the cache's statistics equal JAX's
        after the same serve."""
        vocab = both[0].vocab_size
        rng = np.random.RandomState(41)
        prefix = rng.randint(0, vocab, (32,)).astype(np.int32)
        tails = [rng.randint(0, vocab, (6,)).astype(np.int32)
                 for _ in range(4)]
        reqs = [(np.concatenate([prefix, t]), 6) for t in tails]
        kw = dict(slots=2, max_len=96, prompt_buckets=(8, 16, 64))

        def serve(pc_ref, pc):
            ref, eng = _engines(both, **kw)
            ids = _add((ref, eng), reqs)
            out = _drain_both(ref, eng, 16, pc_ref, pc)
            return [out[r] for r in ids]

        cold = serve(None, None)
        pc_ref = JaxCache(block=16, capacity_tokens=2048)
        pc = PrefixCache(block=16, capacity_tokens=2048)
        hot = serve(pc_ref, pc)
        assert cold == hot == [_dense(both, p, n) for p, n in reqs]
        assert pc.hits >= 2 and pc.hit_tokens >= 2 * 32
        assert pc.stats() == pc_ref.stats()

    def test_partial_overlap_and_eviction(self, both):
        """A block-aligned partial overlap hits; LRU eviction keeps the
        rows held under capacity; the statistics follow JAX's."""
        cfg, params, tcfg, tparams = both
        rng = np.random.RandomState(43)
        base = rng.randint(0, cfg.vocab_size, (48,)).astype(np.int32)
        probe = np.concatenate(
            [base[:16], rng.randint(0, cfg.vocab_size, (20,))]).astype(
                np.int32)
        other = rng.randint(0, cfg.vocab_size, (48,)).astype(np.int32)
        caches = (JaxCache(block=16, capacity_tokens=64),
                  PrefixCache(block=16, capacity_tokens=64))
        for pc, p, c in zip(caches, (params, tparams), (cfg, tcfg)):
            pc.put_prompt(p, base, c)
            m = pc.match(probe)
            assert m is not None and m.length == 16
            pc.put_prompt(p, other, c)
            assert pc.tokens_held <= 64 and pc.evictions >= 1
        assert caches[1].stats() == caches[0].stats()
        np.testing.assert_allclose(
            caches[1].match(other).k[:, :32].numpy(),
            np.asarray(caches[0].match(other).k[:, :32]), **KV_TOL)

    def test_harvested_rows_match_standalone_prefill(self, both):
        """Rows harvested from a slot after admission equal
        ``prompt_kv``'s standalone prefill, the port's and JAX's."""
        cfg, params, tcfg, tparams = both
        prompt = np.random.RandomState(45).randint(
            0, cfg.vocab_size, (16,)).astype(np.int32)
        pc = PrefixCache(block=16, capacity_tokens=1024)
        eng = ServingEngine(tcfg, tparams, slots=1, max_len=96,
                            prompt_buckets=(16,), device="cpu")
        eng.add_request(prompt, 2)
        while eng._queue or eng.free_slot_count() < eng.slots:
            eng.run_segment(8, prefix_cache=pc)
        m = pc.match(np.concatenate([prompt, prompt[:4]]))
        assert m is not None and m.length == 16
        own, _ = tl.prompt_kv(tparams, prompt, tcfg, device="cpu")
        ref, _ = jl.prompt_kv(params, prompt, cfg)
        for k, rows in (("k", m.k), ("v", m.v)):
            np.testing.assert_allclose(rows[:, :16].numpy(),
                                       own[k][:, 0].numpy(), rtol=1e-5,
                                       atol=1e-6)
            np.testing.assert_allclose(rows[:, :16].numpy(),
                                       np.asarray(ref[k][:, 0]), **KV_TOL)

    def test_hit_after_its_source_slot_was_reused(self, both):
        """A one-slot engine: A's prompt is harvested, B (no shared
        prefix) then overwrites the slot's rows, and C hits A's prefix. C
        must still get its dense stream: the entry owns a copy of A's
        rows, not a view of the slot."""
        vocab = both[0].vocab_size
        rng = np.random.RandomState(47)
        prefix = rng.randint(0, vocab, (32,)).astype(np.int32)
        a = np.concatenate([prefix, rng.randint(0, vocab, (5,))])
        b = rng.randint(0, vocab, (60,))
        c = np.concatenate([prefix, rng.randint(0, vocab, (9,))])
        eng = ServingEngine(both[2], both[3], slots=1, max_len=96,
                            prompt_buckets=(16, 64), device="cpu")
        pc = PrefixCache(block=16)
        out = {}
        for p in (a, b, c):
            rid = eng.add_request(p.astype(np.int32), 6)
            while eng._queue or eng.free_slot_count() < eng.slots:
                eng.run_segment(8, prefix_cache=pc)
            out.update(eng.collect_finished())
            assert out[rid] == _dense(both, p, 6)
        assert eng._finished == [] and pc.hits == 1
        assert pc.hit_tokens == 32

    def test_make_prefix_cache(self, both):
        tcfg, tparams = both[2:]
        eng = ServingEngine(tcfg, tparams, slots=2, max_len=96,
                            prompt_buckets=(16,), device="cpu")
        pc = make_prefix_cache(eng, block=8, capacity_tokens=256)
        assert isinstance(pc, PrefixCache)
        assert (pc.block, pc.capacity_tokens) == (8, 256)
        paged = ServingEngine(tcfg, tparams, slots=2, max_len=96,
                              prompt_buckets=(16,), paged=True,
                              page_size=16, device="cpu")
        ppc = make_prefix_cache(paged, capacity_tokens=256)
        assert isinstance(ppc, PagedPrefixCache) and ppc.pager is paged.pager
        assert ppc.capacity_pages == 16
        tiered = make_prefix_cache(paged, capacity_tokens=256,
                                   host_tier_pages=4)
        assert tiered.host_tier is not None
        assert tiered.host_tier.pager is paged.pager
        assert tiered.host_tier.capacity_pages == 4
        assert make_prefix_cache(eng, host_tier_pages=4).block == 32


def _caches(paged, ref, eng):
    if paged:
        return (JaxPaged(ref.pager, capacity_pages=32),
                PagedPrefixCache(eng.pager, capacity_pages=32))
    return (JaxCache(block=16, capacity_tokens=1024),
            PrefixCache(block=16, capacity_tokens=1024))


@pytest.mark.parametrize("paged", [False, True])
class TestPreemption:
    KW = dict(slots=2, max_len=96, prompt_buckets=(8, 16, 64))

    def _engines(self, both, paged):
        kw = dict(self.KW, paged=True, page_size=16) if paged else self.KW
        return _engines(both, **kw)

    def test_preempt_resume_token_identity(self, both, paged):
        """Three long requests hold both slots; after one segment the
        first slot is preempted with its prefix parked in the cache, a
        short request and then the victim go to the queue head, and the
        drain resumes: the same victim, event dicts and streams as JAX's
        engine, each stream its dense one, the resume rides the parked
        prefix, and no page leaks."""
        rng = np.random.RandomState(23)
        vocab = both[0].vocab_size
        lows = [(rng.randint(0, vocab, (8,)).astype(np.int32), 24)
                for _ in range(3)]
        high = (rng.randint(0, vocab, (8,)).astype(np.int32), 4)
        ref, eng = self._engines(both, paged)
        pc_ref, pc = _caches(paged, ref, eng)
        ids = _add((ref, eng), lows)
        _segments_both(ref, eng, 16, pc_ref, pc)
        assert eng.can_preempt(0) and ref.can_preempt(0)
        victims = [e.preempt_slot(0, prefix_cache=c)
                   for e, c in ((ref, pc_ref), (eng, pc))]
        assert victims[1].rid == victims[0].rid
        assert victims[1].tokens == victims[0].tokens
        assert victims[1].preemptions == 1
        ids += _add((ref, eng), [high])
        for e, v in zip((ref, eng), victims):
            h = e._queue.pop()
            e._queue[:0] = [h, v]
        out = _drain_both(ref, eng, 16, pc_ref, pc)
        assert victims[1].prefix_hit_len == victims[0].prefix_hit_len > 0
        for rid, (p, n) in zip(ids, lows + [high]):
            assert out[rid] == _dense(both, p, n)
        assert pc.stats() == pc_ref.stats()
        if paged:
            pc.clear()
            assert eng.pager.leak_report() == []

    def test_second_preemption_within_a_parked_block(self, both, paged):
        """Preempted at 8 + 8 tokens (a whole block, whose last row was
        never written, since the last token is not fed yet), resumed, then
        preempted again 4 tokens later and resumed on the parked prefix:
        the stream is still its dense one. The engine parks only written
        rows (the JAX engine parks the whole block here and its second
        resume reads the stale row)."""
        prompt = np.random.RandomState(1).randint(
            0, both[0].vocab_size, (8,)).astype(np.int32)
        _, eng = self._engines(both, paged)
        pc = (PagedPrefixCache(eng.pager, capacity_pages=32) if paged
              else PrefixCache(block=16))
        rid = eng.add_request(prompt, 40)
        for steps in (8, 4):
            eng.run_segment(steps, prefix_cache=pc)
            v = eng.preempt_slot(0, prefix_cache=pc)
            eng._queue.insert(0, v)
        assert len(v.tokens) == 12
        while eng._queue or eng.free_slot_count() < eng.slots:
            eng.run_segment(16, prefix_cache=pc)
        assert v.prefix_hit_len > 0
        assert eng.collect_finished()[rid] == _dense(both, prompt, 40)
        if paged:
            pc.clear()
            assert eng.pager.leak_report() == []

    def test_preempt_without_cache_and_refusals(self, both, paged):
        """Without a cache the resume prefills again (still its dense
        stream); a slot whose resume view outgrew the largest bucket
        cannot be preempted; an empty slot or a segment in flight is
        refused."""
        rng = np.random.RandomState(25)
        vocab = both[0].vocab_size
        reqs = [(rng.randint(0, vocab, (8,)).astype(np.int32), 30),
                (rng.randint(0, vocab, (60,)).astype(np.int32), 20)]
        _, eng = self._engines(both, paged)
        ids = _add((eng,), reqs)
        eng.run_segment(12)
        assert eng.can_preempt(0) and not eng.can_preempt(1)
        v = eng.preempt_slot(0)
        with pytest.raises(ValueError, match="empty slot"):
            eng.preempt_slot(0)
        eng._queue.insert(0, v)
        pending = eng.dispatch_segment(4)
        with pytest.raises(RuntimeError, match="in flight"):
            eng.preempt_slot(1)
        eng.finish_segment(pending)
        while eng._queue or eng.free_slot_count() < eng.slots:
            eng.run_segment(16)
        out = eng.collect_finished()
        for rid, (p, n) in zip(ids, reqs):
            assert out[rid] == _dense(both, p, n)
        if paged:
            assert eng.pager.leak_report() == []

    def test_abort_returns_every_owed_request(self, both, paged):
        """After a segment, with the next one dispatched and never read,
        ``abort`` returns the in-flight segment's picked requests, then
        the live slots, then the queue, in JAX's order; the requests
        resume on fresh engines to JAX's streams and their dense ones,
        and no page leaks."""
        reqs = _prompts(27, both[0].vocab_size,
                        [(5, 9), (12, 6), (8, 12), (20, 4), (3, 8)])
        ref, eng = self._engines(both, paged)
        ids = _add((ref, eng), reqs)
        _segments_both(ref, eng, 6)
        for e in (ref, eng):
            e.dispatch_segment(6, n_pad=1)
        orphans = [ref.abort(), eng.abort()]
        assert [r.rid for r in orphans[1]] == [r.rid for r in orphans[0]]
        assert sorted(r.rid for r in orphans[1]) == ids
        assert [r.tokens for r in orphans[1]] == \
            [r.tokens for r in orphans[0]]
        assert eng._queue == [] and eng.free_slot_count() == eng.slots
        if paged:
            assert eng.pager.leak_report() == []
        fresh = self._engines(both, paged)
        for e, rs in zip(fresh, orphans):
            e._queue.extend(rs)
        out = _drain_both(*fresh, 16)
        for rid, (p, n) in zip(ids, reqs):
            assert out[rid] == _dense(both, p, n)
        if paged:
            assert fresh[1].pager.leak_report() == []
