"""The port's chunked-prefill segments (``cseg``) against the JAX engine's,
on the CPU.

``paddle_tpu_torch``'s paged ``ServingEngine(chunked_prefill=True,
device="cpu")`` against ``paddle_tpu``'s on the same requests and the same
numpy weights, in float32: every segment's event dict and its admit log
(``aq``/``aslot``: admits, decode ticks and non-final chunk steps, each in
its slot), with and without a ``PagedPrefixCache`` and with EOS; tokens
against the unchunked engine on both sides; the interleave of decode ticks
between chunk steps; the step-budget and option refusals with the JAX
engine's messages; ``program_space.chunk_for`` against the JAX package's;
and one device read a segment. The cases mirror tests/test_slo_serving.py.
"""

import jax
import numpy as np
import pytest
import torch

from paddle_tpu.inference import program_space as jps
from paddle_tpu.inference.prefix_cache import PagedPrefixCache as JaxPaged
from paddle_tpu.inference.serving import ServingEngine as JaxEngine
from paddle_tpu.parallel import set_mesh
from paddle_tpu_torch.inference import program_space as tps
from paddle_tpu_torch.inference.prefix_cache import PagedPrefixCache
from paddle_tpu_torch.inference.serving import ServingEngine
from paddle_tpu_torch.models import llama as tl
from paddle_tpu_torch.models.convert import params_from_numpy


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


KW = dict(slots=2, max_len=96, prompt_buckets=(8, 16, 32), paged=True,
          page_size=16, chunked_prefill=True, prefill_chunks=(8,))


def _engine(both, port: bool, **kw):
    cfg, params, tcfg, tparams = both
    kw = {**KW, **kw}
    if port:
        return ServingEngine(tcfg, tparams, device="cpu", **kw)
    return JaxEngine(cfg, params, **kw)


def _prompts(seed, vocab, shapes):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, vocab, (l,)).astype(np.int32), n)
            for l, n in shapes]


def _segment(eng, port: bool, steps, pc=None):
    """One segment, dispatched and finished apart: (event dict, the admit
    log of the steps run)."""
    h = eng.dispatch_segment(steps, prefix_cache=pc)
    if port:
        ev = eng.finish_segment(h)
        st = ev["steps"]
        return ev, (h.log.aq[:st].tolist(), h.log.aslot[:st].tolist())
    _, aq, aslot, st, _ = jax.device_get(h.dev)
    ev = eng.finish_segment(h)
    return ev, (aq[:int(st)].tolist(), aslot[:int(st)].tolist())


def _serve(both, port: bool, waves, steps, cache_pages=None, first=None,
           **kw):
    """Serve ``waves`` on one engine (the first wave's first segment of
    ``first`` steps runs before the next wave arrives); returns what the
    two engines must agree on."""
    eng = _engine(both, port, **kw)
    pc = None
    if cache_pages:
        pc = (PagedPrefixCache if port else JaxPaged)(
            eng.pager, capacity_pages=cache_pages)
    rids, events = [], []
    for w, wave in enumerate(waves):
        rids += [eng.add_request(p, n) for p, n in wave]
        if w == 0 and first:
            events.append(_segment(eng, port, first, pc))
            continue
        while eng._queue or eng.free_slot_count() < eng.slots:
            events.append(_segment(eng, port, steps, pc))
    out = eng.collect_finished()
    rec = {"tokens": [out[r] for r in rids], "events": events,
           "ticks": eng.last_run_ticks, "chunks": eng.last_run_chunks,
           "pages": eng.pager.stats(),
           "prefix": pc.stats() if pc is not None else None}
    if pc is not None:
        pc.clear()
    assert eng.pager.leak_report() == []
    return rec


def _parity(both, waves, steps, **kw):
    want = _serve(both, False, waves, steps, **kw)
    got = _serve(both, True, waves, steps, **kw)
    assert got == want
    return got


class TestEventLogs:
    @pytest.mark.parametrize("cache_pages", [None, 64])
    def test_mid_flight_arrivals_match_jax(self, both, cache_pages):
        """Two waves, the second arriving after a short first segment:
        every event dict and admit log equals JAX's, and some steps are
        non-final chunk steps (aq = n_pad + 1)."""
        vocab = both[0].vocab_size
        waves = [_prompts(21, vocab, [(5, 9), (30, 6), (8, 12)]),
                 _prompts(22, vocab, [(20, 4), (3, 8), (27, 5), (7, 10)])]
        rec = _parity(both, waves, 12, first=8, cache_pages=cache_pages)
        assert [len(t) for t in rec["tokens"]] == [
            n for w in waves for _, n in w]
        n_pad = 2
        assert any(a == n_pad + 1 for _, (aq, _) in rec["events"]
                   for a in aq)

    def test_prefix_hits_shorten_chunked_suffixes(self, both):
        """Requests over a shared 32-token prefix: later admits hit the
        cache and prefill only their suffix, in chunks, at offset 32."""
        rng = np.random.RandomState(41)
        vocab = both[0].vocab_size
        prefix = rng.randint(0, vocab, (32,)).astype(np.int32)
        reqs = [(np.concatenate([prefix, rng.randint(0, vocab, (n,))])
                 .astype(np.int32), 5) for n in (6, 20, 9, 14)]
        rec = _parity(both, [reqs], 16, cache_pages=64,
                      prompt_buckets=(8, 16, 64))
        assert rec["prefix"]["hits"] >= 2

    def test_eos_freeze_and_slot_reuse(self, both):
        """EOS at a request's second token freezes its slot (read step by
        step); the chunked serve equals JAX's and the truncated unchunked
        stream."""
        reqs = _prompts(23, both[0].vocab_size,
                        [(6 + 7 * i, 8) for i in range(4)])
        plain = _serve(both, True, [reqs], 24, chunked_prefill=False)
        eos = plain["tokens"][0][1]
        rec = _parity(both, [reqs], 24, eos_token_id=eos)
        for got, full in zip(rec["tokens"], plain["tokens"]):
            assert got == (full[:full.index(eos) + 1] if eos in full
                           else full)

    def test_ladder_of_chunks(self, both):
        """A ladder (8, 16): a 32-wide window takes chunks of 8 (four
        chunks), a 64-wide one chunks of 16."""
        reqs = _prompts(29, both[0].vocab_size, [(60, 4), (17, 6), (40, 3)])
        _parity(both, [reqs], 16, prefill_chunks=(8, 16),
                prompt_buckets=(16, 64))


class TestTokens:
    def test_chunked_equals_unchunked_on_both_sides(self, both):
        reqs = _prompts(17, both[0].vocab_size,
                        [(12, 5), (30, 4), (7, 6), (25, 3), (14, 4)])
        outs = {}
        for port in (False, True):
            for chunked in (False, True):
                outs[port, chunked] = _serve(
                    both, port, [reqs], 16,
                    chunked_prefill=chunked)["tokens"]
        assert len({repr(v) for v in outs.values()}) == 1
        assert [len(t) for t in outs[True, True]] == [n for _, n in reqs]

    def test_run_drains_through_chunked_segments(self, both):
        reqs = _prompts(9, both[0].vocab_size,
                        [(5, 7), (12, 3), (30, 9), (3, 12), (17, 5)])
        got, want = [], []
        for port, out in ((True, got), (False, want)):
            eng = _engine(both, port, chunk=8)
            for p, n in reqs:
                eng.add_request(p, n)
            out += [eng.run(), eng.last_run_ticks, eng.last_run_chunks,
                    eng.pager.stats()]
        assert got == want


class TestSchedule:
    def test_decode_interleaves_with_long_prefill(self, both):
        """While a 30-token prompt prefills in chunks of 8, the resident
        request decodes between them: a decode step falls inside the
        chunk-step span, on both engines alike."""
        rng = np.random.RandomState(19)
        vocab = both[0].vocab_size
        short = rng.randint(0, vocab, (6,)).astype(np.int32)
        long_p = rng.randint(0, vocab, (30,)).astype(np.int32)
        logs = []
        for port in (False, True):
            eng = _engine(both, port)
            eng.add_request(short, 12)
            _segment(eng, port, 8)
            eng.add_request(long_p, 4)
            ev, (aq, _) = _segment(eng, port, 16)
            logs.append((ev, aq))
            n_pad = 2
            chunk_steps = [i for i, a in enumerate(aq) if a == n_pad + 1]
            decode_steps = [i for i, a in enumerate(aq) if a == n_pad]
            assert len(chunk_steps) >= 3
            assert any(chunk_steps[0] < d < chunk_steps[-1]
                       for d in decode_steps)
            while eng._queue or eng.free_slot_count() < eng.slots:
                eng.run_segment(16)
            eng.collect_finished()
            assert eng.pager.leak_report() == []
        assert logs[0] == logs[1]

    def test_seg_steps_too_small_raises(self, both):
        msgs = []
        for port in (False, True):
            eng = _engine(both, port)
            eng.add_request(np.arange(30, dtype=np.int32), 4)
            with pytest.raises(ValueError, match="chunked") as e:
                eng.run_segment(4)        # 4 < 2 * (32 / 8)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]

    def test_one_fetch_per_segment(self, both):
        """Without EOS the chunk schedule follows from the lengths alone:
        each segment reads the device once."""
        eng = _engine(both, True)
        for p, n in _prompts(2, both[0].vocab_size,
                             [(5, 6), (29, 3), (12, 8), (20, 5)]):
            eng.add_request(p, n)
        segments = 0
        while eng._queue or eng.free_slot_count() < eng.slots:
            before = eng.fetches
            eng.run_segment(10)
            segments += 1
            assert eng.fetches == before + 1
        assert segments > 1


class TestOptions:
    def test_chunk_for_matches_jax(self):
        assert tps.MAX_PREFILL_CHUNKS == jps.MAX_PREFILL_CHUNKS
        for ladder in [(8,), (8, 16), (8, 16, 32, 64), (16, 32, 64),
                       (4, 64), (32,), (16, 128)]:
            for s_max in range(1, 600, 7):
                assert tps.chunk_for(ladder, s_max) == \
                    jps.chunk_for(ladder, s_max)

    @pytest.mark.parametrize("kw", [
        dict(chunked_prefill=True),
        dict(chunked_prefill=True, paged=True, prefill_chunks=()),
        dict(speculative=2),
        dict(speculative=-1, paged=True),
        dict(sampling={"temperature": 1.0}),
        dict(sampling={"temperature": -0.5}, paged=True),
        dict(quality_digest=True, paged=True, chunked_prefill=True),
        dict(quality_digest=True, paged=True, speculative=2),
        dict(quality_digest=True, paged=True,
             sampling={"temperature": 0.7}),
        dict(quant="int8", paged=True, chunked_prefill=True),
        dict(quant="int8", paged=True, speculative=3),
        dict(quant="int8", paged=True, sampling={"temperature": 1.0}),
        dict(quant="int8"),
        dict(seq_parallel=2),
        dict(seq_parallel=-1, paged=True),
        dict(seq_parallel=2, paged=True),
        dict(seq_parallel=2, paged=True, long_buckets=(64,), speculative=1),
        dict(seq_parallel=2, paged=True, long_buckets=(64,),
             sampling={"temperature": 1.0}),
        dict(seq_parallel=2, paged=True, long_buckets=(64,),
             quality_digest=True),
        dict(seq_parallel=2, paged=True, long_buckets=(64,), quant="int8"),
        dict(seq_parallel=2, paged=True, long_buckets=(16, 64)),
        dict(seq_parallel=2, paged=True, long_buckets=(128,)),
    ])
    def test_refusals_match_jax(self, both, kw):
        """Each combination the JAX engine refuses, the port refuses with
        the same message."""
        cfg, params, tcfg, tparams = both
        base = dict(slots=2, max_len=96, prompt_buckets=(8, 16, 32),
                    page_size=16)
        with pytest.raises(ValueError) as want:
            JaxEngine(cfg, params, **base, **kw)
        with pytest.raises(ValueError) as got:
            ServingEngine(tcfg, tparams, device="cpu", **base, **kw)
        assert str(got.value) == str(want.value)

    def test_temperature_zero_is_greedy_and_options_kept(self, both):
        cfg, params, tcfg, tparams = both
        kw = dict(slots=2, max_len=96, prompt_buckets=(8, 16, 32),
                  paged=True, chunked_prefill=True,
                  prefill_chunks=(16, 8), sampling={"temperature": 0.0},
                  sample_seed=5)
        ref = JaxEngine(cfg, params, **kw)
        eng = ServingEngine(tcfg, tparams, device="cpu", **kw)
        for name in ("chunked", "prefill_chunks", "speculative",
                     "sampling", "sample_seed", "seq_parallel",
                     "long_buckets"):
            assert getattr(eng, name) == getattr(ref, name), name
        assert eng.sampling is None
        assert eng._prefill_chunk_for(32) == ref._prefill_chunk_for(32)
