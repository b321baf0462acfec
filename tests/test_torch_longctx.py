"""The port's sequence-parallel long-context prefill (``spseg``) against the
JAX engine's, on the CPU.

``ServingEngine(seq_parallel=sp, long_buckets=(64,))`` on both packages,
the same numpy weights, float32: a 56-token prompt past the largest
regular bucket (32) prefills in slabs of sp chunks of 8 tokens, one
batched call whose rows share the request's page-table row. For sp in {1,
2, 4} every segment's event dict equals JAX's and the tokens equal the
unsharded engines' (plain and chunked, buckets up to 64), also under
``OnlineScheduler``; a prefill that spans segments holds its reservation
(``_sp_inflight``) and matches; on regular traffic an sp = 1 engine gives
the plain chunked engine's event log; the pool's pages after an sp = 2
prefill are within 1e-5 of the unsharded chunked prefill's (the slab's
batched matmuls may sum in another order); and ``abort`` and
``preempt_slot`` around a long request leave no page held. The cases
mirror tests/test_longctx_serving.py.
"""

import numpy as np
import pytest
import torch

from paddle_tpu.inference.prefix_cache import PagedPrefixCache as JaxPaged
from paddle_tpu.inference.serving import ServingEngine as JaxEngine
from paddle_tpu.parallel import set_mesh
from paddle_tpu_torch.inference.prefix_cache import PagedPrefixCache
from paddle_tpu_torch.inference.scheduler import Arrival, OnlineScheduler
from paddle_tpu_torch.inference.serving import ServingEngine
from paddle_tpu_torch.models import llama as tl
from paddle_tpu_torch.models.convert import params_from_numpy

# pool rows against the unsharded prefill: fp32 in another summation order
KV_TOL = dict(rtol=1e-5, atol=1e-5)


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


def _mk(both, port: bool, sp, **over):
    """sp=0: the unsharded reference, whose buckets reach 64; sp >= 1:
    regular buckets to 32 and the long bucket 64."""
    cfg, params, tcfg, tparams = both
    kw = dict(slots=4, max_len=96, paged=True, page_size=8, num_pages=48,
              prefill_chunks=(8,))
    if sp:
        kw.update(prompt_buckets=(8, 16, 32), seq_parallel=sp,
                  long_buckets=(64,))
    else:
        kw.update(prompt_buckets=(8, 16, 32, 64))
    kw.update(over)
    if port:
        return ServingEngine(tcfg, tparams, device="cpu", **kw)
    return JaxEngine(cfg, params, **kw)


def _prompts(vocab, lens=(56, 12, 40, 9), seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, (n,)).astype(np.int32) for n in lens]


def _drain(eng, seg_steps):
    """Segments until idle: (event dicts, whether a prefill was carried
    over between two of them)."""
    events, spanned = [], False
    while eng._queue or any(r is not None for r in eng._active):
        events.append(eng.run_segment(seg_steps))
        spanned = spanned or bool(getattr(eng, "_sp_inflight", None))
    return events, spanned


def _serve(eng, prompts, seg_steps, gen=6):
    rids = [eng.add_request(p, gen) for p in prompts]
    events, spanned = _drain(eng, seg_steps)
    out = eng.collect_finished()
    assert eng.pager.leak_report() == []
    assert not eng._sp_inflight
    return [out[r] for r in rids], events, spanned


@pytest.fixture(scope="module")
def reference(both):
    """The unsharded serve of the mixed trace, on the JAX engine and on
    the port's plain and chunked engines (all equal)."""
    prompts = _prompts(both[0].vocab_size)
    want = _serve(_mk(both, False, 0), prompts, 4)[0]
    for kw in ({}, dict(chunked_prefill=True)):
        assert _serve(_mk(both, True, 0, **kw), prompts, 16)[0] == want
    return prompts, want


class TestTokenIdentity:
    @pytest.mark.parametrize("sp", [1, 2, 4])
    def test_slabs_match_jax_and_the_unsharded_engine(self, both, reference,
                                                      sp):
        prompts, want = reference
        ref = _serve(_mk(both, False, sp), prompts, 4)
        got = _serve(_mk(both, True, sp), prompts, 4)
        assert got == ref
        assert got[0] == want

    def test_online_scheduler_over_sp2(self, both, reference):
        prompts, want = reference
        eng = _mk(both, True, 2)
        sch = OnlineScheduler(eng, seg_steps=4, max_queue=100)
        rep = sch.serve([Arrival(0.002 * i, p, 6)
                         for i, p in enumerate(prompts)])
        assert rep.n_requests == len(prompts)
        res = sch.results()
        assert [res[i] for i in range(len(prompts))] == want
        assert eng.pager.leak_report() == []

    @pytest.mark.parametrize("sp", [2, 4])
    def test_prefill_spans_segments_and_holds_its_pages(self, both,
                                                        reference, sp):
        """One-step segments: the long prefill is carried over (its
        reservation held, ``_sp_inflight`` set between segments, empty at
        the end), the event logs equal JAX's and the tokens the unsharded
        serve's."""
        prompts, want = reference
        logs = []
        for port in (False, True):
            eng = _mk(both, port, sp)
            eng.add_request(prompts[0], 6)
            held = []
            events = []
            while eng._queue or any(r is not None for r in eng._active):
                events.append(eng.run_segment(1))
                held.append({rid: (len(i["pages"]), i["resident"])
                             for rid, i in eng._sp_inflight.items()})
            out = eng.collect_finished()
            assert eng.pager.leak_report() == []
            logs.append((events, held, out))
        assert logs[1] == logs[0]
        assert any(logs[1][1]), "the prefill never spanned segments"
        assert list(logs[1][2].values()) == [want[0]]


class TestDegeneracy:
    def test_sp1_regular_traffic_is_the_chunked_log(self, both):
        """Regular-bucket traffic never engages the slab family: an sp = 1
        chunked engine's event log is the chunked engine's, and both equal
        JAX's."""
        prompts = _prompts(both[0].vocab_size, lens=(12, 9, 20, 30), seed=1)
        kw = dict(chunked_prefill=True, prompt_buckets=(8, 16, 32))
        plain = _serve(_mk(both, True, 0, **kw), prompts, 8)
        got = _serve(_mk(both, True, 1, **kw), prompts, 8)
        assert got == plain
        assert _serve(_mk(both, False, 1, **kw), prompts, 8) == got
        assert not got[2]


class TestPoolParity:
    def test_sp2_pages_match_the_unsharded_chunked_prefill(self, both):
        """The sp = 2 prefill of the 56-token prompt lands its K/V in the
        same pages as the unsharded chunked prefill, within 1e-5 (page 0,
        the trash page the slab's overrun rows write, is left out)."""
        long_p = _prompts(both[0].vocab_size, lens=(56,))[0]

        def pool_after(sp, **kw):
            e = _mk(both, True, sp, **kw)
            e.add_request(long_p, max_new_tokens=1)
            _drain(e, 16)
            return e.pager.pool["k"].clone(), e.pager.pool["v"].clone()

        k0, v0 = pool_after(0, chunked_prefill=True)
        k2, v2 = pool_after(2)
        n_pages = -(-len(long_p) // 8)
        assert n_pages == 7
        torch.testing.assert_close(k2[:, 1:1 + n_pages],
                                   k0[:, 1:1 + n_pages], **KV_TOL)
        torch.testing.assert_close(v2[:, 1:1 + n_pages],
                                   v0[:, 1:1 + n_pages], **KV_TOL)
        assert k2[:, 1:1 + n_pages].abs().sum() > 0


class TestAbortAndPreempt:
    def test_abort_of_a_carried_over_prefill(self, both, reference):
        """``abort`` between segments, while the long prefill holds its
        reservation, and again with a slab segment dispatched and never
        read: every owed request comes back in JAX's order, no page is
        held, and resumed on the same engine the tokens are the unsharded
        serve's."""
        prompts, want = reference
        logs = []
        for port in (False, True):
            eng = _mk(both, port, 2)
            for p in prompts:
                eng.add_request(p, 6)
            eng.run_segment(2)
            assert eng._sp_inflight
            first = eng.abort()
            assert eng.pager.leak_report() == []
            assert not eng._sp_inflight
            eng._queue.extend(first)        # resumed on the same engine
            eng.dispatch_segment(2)
            second = eng.abort()
            assert eng.pager.leak_report() == []
            eng._queue.extend(second)
            _drain(eng, 4)
            res = eng.collect_finished()
            assert eng.pager.leak_report() == []
            logs.append(([r.rid for r in first], [r.rid for r in second],
                         res))
        assert logs[1] == logs[0]
        assert sorted(logs[1][0]) == [0, 1, 2, 3]
        assert [logs[1][2][i] for i in range(len(prompts))] == want

    def test_preempt_of_a_long_request(self, both, reference):
        """The long request, once decoding, preempted with a prefix cache
        and requeued at the head: its resume rides the slab family again
        (a suffix past the regular buckets) and reuses its parked pages;
        tokens equal JAX's and the unsharded serve's, no page held."""
        prompts, want = reference
        logs = []
        for port in (False, True):
            eng = _mk(both, port, 2)
            pc = (PagedPrefixCache if port else JaxPaged)(
                eng.pager, capacity_pages=16)
            rids = [eng.add_request(p, 6) for p in prompts]
            events = []
            while not any(r is not None and r.rid == 0
                          for r in eng._active):
                events.append(eng.run_segment(4, prefix_cache=pc))
            slot = next(s for s, r in enumerate(eng._active)
                        if r is not None and r.rid == 0)
            victim = eng.preempt_slot(slot, prefix_cache=pc)
            eng._queue.insert(0, victim)
            while eng._queue or any(r is not None for r in eng._active):
                events.append(eng.run_segment(4, prefix_cache=pc))
            out = eng.collect_finished()
            hit = victim.prefix_hit_len
            pc.clear()
            assert eng.pager.leak_report() == []
            logs.append(([out[r] for r in rids], events, hit))
        assert logs[1] == logs[0]
        assert logs[1][0] == want
        assert logs[1][2] > 0


class TestIntake:
    def test_long_intake_and_rungs(self, both):
        eng = _mk(both, True, 2)
        ref = _mk(both, False, 2)
        with pytest.raises(ValueError) as got:
            eng.add_request(np.zeros((65,), np.int32), 2)
        with pytest.raises(ValueError) as want:
            ref.add_request(np.zeros((65,), np.int32), 2)
        assert str(got.value) == str(want.value)
        assert eng.add_request(np.zeros((64,), np.int32), 2) == 0
        assert eng._long_rung(40) == 64
        with pytest.raises(ValueError, match="no long bucket"):
            eng._long_rung(65)
        with pytest.raises(ValueError, match="largest bucket 32"):
            _mk(both, True, 0, prompt_buckets=(8, 16, 32)).add_request(
                np.zeros((40,), np.int32), 2)
