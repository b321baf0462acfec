"""The port's paged serving path against the JAX package's, on the CPU.

The same numpy inputs go through ``paddle_tpu`` and ``paddle_tpu_torch``
in float32:

* ``ragged_paged_attention_plain`` (what a CPU tensor takes) against the
  Pallas kernel in interpret mode, on the cases of tests/test_paged_kv.py;
* ``forward_with_pages``: one ragged decode tick and one prefill chunk at
  a context offset, with dead slots writing to the trash page;
* the allocator, copy-on-write and the paged prefix cache, case for case
  as tests/test_paged_kv.py holds the JAX classes;
* ``ServingEngine(paged=True)``: the same requests through both engines
  give identical tokens, segment results, step and segment counts,
  backpressure counts and pool statistics, and every page comes back.

Logits agree to rtol 2e-4 (XLA's float32 transcendentals are fast
approximations), attention outputs and pool rows to 2e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.ops.pallas.paged_attention as jpa
from paddle_tpu.inference.prefix_cache import PagedPrefixCache as JaxCache
from paddle_tpu.inference.serving import ServingEngine as JaxEngine
from paddle_tpu.models import llama as jl
from paddle_tpu.parallel import set_mesh
from paddle_tpu_torch.inference.paged_kv import PageAllocator, PagedKVCache
from paddle_tpu_torch.inference.prefix_cache import PagedPrefixCache
from paddle_tpu_torch.inference.serving import ServingEngine
from paddle_tpu_torch.models import llama as tl
from paddle_tpu_torch.models.convert import params_from_numpy
from paddle_tpu_torch.ops.kernels import paged_attention as pa


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """The models here are tiny: more intra-op threads than two only spin
    against the suite's other workers (timing-sensitive tests among
    them)."""
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


def _close(a, b, rtol=2e-4, atol=1e-5):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


# ---------------------------------------------------------------------------
# the kernel's plain version against the Pallas kernel
# ---------------------------------------------------------------------------


class TestRaggedPagedAttention:
    @pytest.mark.parametrize("nH,Hkv,D", [(4, 2, 64), (2, 2, 128),
                                          (8, 8, 64)])
    def test_plain_matches_pallas_interpret(self, nH, Hkv, D):
        """Co-resident prefill chunks (q_len > 1) and decode ticks over a
        shuffled page table: rows below q_len agree."""
        rng = np.random.RandomState(0)
        B, Tq, psz, P, max_pages = 4, 8, 16, 33, 8
        q = rng.randn(B, Tq, nH, D).astype(np.float32)
        kp = rng.randn(P, psz, Hkv, D).astype(np.float32)
        vp = rng.randn(P, psz, Hkv, D).astype(np.float32)
        pt = rng.permutation(np.arange(1, P))[:B * max_pages].reshape(
            B, max_pages).astype(np.int32)
        ctx = np.asarray([0, 5, 37, 100], np.int32)
        qlen = np.asarray([1, 8, 3, 1], np.int32)
        ref = np.asarray(jpa.ragged_paged_attention(
            jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
            jnp.asarray(pt), jnp.asarray(ctx), jnp.asarray(qlen),
            interpret=True))
        t = [torch.from_numpy(a) for a in (q, kp, vp, pt, ctx, qlen)]
        out = pa.ragged_paged_attention(*t).numpy()
        for b in range(B):  # rows past q_len are padding
            _close(out[b, :qlen[b]], ref[b, :qlen[b]], rtol=2e-5, atol=2e-5)

    @staticmethod
    def _against_pallas(rng, B, Tq, nH, Hkv, D, psz, max_pages, ctx, qlen):
        P = B * max_pages + 1
        q = rng.randn(B, Tq, nH, D).astype(np.float32)
        kp = rng.randn(P, psz, Hkv, D).astype(np.float32)
        vp = rng.randn(P, psz, Hkv, D).astype(np.float32)
        pt = rng.permutation(np.arange(1, P)).reshape(
            B, max_pages).astype(np.int32)
        ctx = np.asarray(ctx, np.int32)
        qlen = np.asarray(qlen, np.int32)
        ref = np.asarray(jpa.ragged_paged_attention(
            jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
            jnp.asarray(pt), jnp.asarray(ctx), jnp.asarray(qlen),
            interpret=True))
        t = [torch.from_numpy(a) for a in (q, kp, vp, pt, ctx, qlen)]
        out = pa.ragged_paged_attention(*t).numpy()
        for b in range(B):  # rows past q_len are padding
            _close(out[b, :qlen[b]], ref[b, :qlen[b]], rtol=2e-5, atol=2e-5)

    @pytest.mark.parametrize("psz,nH,Hkv,D", [(8, 4, 2, 64), (32, 4, 2, 64),
                                              (16, 8, 1, 128)])
    def test_plain_matches_pallas_on_chunk_edges(self, psz, nH, Hkv, D):
        """Decode ticks with contexts on the edges of the card kernel's
        64-key chunks (one key, the last key of a chunk, the first of the
        next and the one after, two chunks, the window's last row), on
        pages of 8 and 32 and with GQA rep 8 at D 128."""
        C, W = pa._CHUNK, 192
        ctx = [0, C - 1, C, C + 1, 2 * C - 1, 2 * C, W - 1]
        self._against_pallas(np.random.RandomState(psz + D), len(ctx), 1,
                             nH, Hkv, D, psz, W // psz, ctx, [1] * len(ctx))

    @pytest.mark.parametrize("psz,nH,Hkv,D", [(8, 4, 2, 64), (32, 4, 2, 64),
                                              (16, 8, 1, 128)])
    def test_plain_matches_pallas_prefill_at_page_boundaries(self, psz, nH,
                                                             Hkv, D):
        """Prefill chunks (more query rows a kv head than the card's decode
        family takes) at context 0, at a page boundary, and ending on the
        window's last row, one with a ragged q_len."""
        W, Tq = 128, 16
        self._against_pallas(np.random.RandomState(psz + D + 1), 3, Tq, nH,
                             Hkv, D, psz, W // psz, [0, 2 * psz, W - Tq],
                             [Tq, 9, Tq])
        assert pa.family(Tq, nH // Hkv) == "prefill"

    def test_plain_matches_pallas_long_prefill(self):
        """A 512-row prefill chunk (past the 256 rows the card kernel
        once took; an engine at max_len 2048 admits up to its largest
        bucket) at context 0 and past a page boundary, ragged q_len."""
        self._against_pallas(np.random.RandomState(5), 2, 512, 4, 2, 64,
                             16, 40, [0, 100], [512, 400])
        assert pa.max_rows(torch.float32) >= 2048 * 8

    @pytest.mark.parametrize("nH,Hkv,D", [(8, 8, 16), (8, 4, 32)])
    @pytest.mark.parametrize("Tq", [1, 16])
    def test_plain_matches_pallas_small_head_dims(self, nH, Hkv, D, Tq):
        """cpu_small's 8 heads of D 16, and D 32 in GQA (Hkv * D the
        reference's 128 lanes): decode ticks on the chunk edges and
        prefill chunks past a page boundary."""
        C, W = pa._CHUNK, 192
        if Tq == 1:
            ctx = [0, C - 1, C, C + 1, 2 * C, W - 1]
            qlen = [1] * len(ctx)
        else:
            ctx, qlen = [0, 20, W - Tq], [Tq, 9, Tq]
        self._against_pallas(np.random.RandomState(D + Tq), len(ctx), Tq,
                             nH, Hkv, D, 16, W // 16, ctx, qlen)

    def test_family_by_rows_a_kv_head(self):
        """At most 8 query rows a kv head take the split-KV decode family,
        more the prefill family."""
        assert pa.family(1, 1) == pa.family(1, 8) == "decode"
        assert pa.family(2, 4) == pa.family(8, 1) == "decode"
        assert pa.family(3, 4) == pa.family(9, 1) == "prefill"
        assert pa.family(256, 1) == pa.family(64, 8) == "prefill"

    def test_cpu_tensor_takes_plain_version(self, monkeypatch):
        def no_kernel():
            raise AssertionError("the CUDA kernel was reached on the CPU")

        monkeypatch.setattr(pa, "_kernel", no_kernel)
        rng = np.random.RandomState(1)
        q = torch.from_numpy(rng.randn(2, 3, 4, 64).astype(np.float32))
        kp = torch.from_numpy(rng.randn(9, 16, 2, 64).astype(np.float32))
        pt = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
        ctx = torch.tensor([0, 17], dtype=torch.int32)
        before = pa.ragged_paged_attention.launches
        out = pa.ragged_paged_attention(q, kp, kp, pt, ctx)
        torch.testing.assert_close(
            out, pa.ragged_paged_attention_plain(q, kp, kp, pt, ctx))
        assert out.shape == q.shape and out.dtype == q.dtype
        assert pa.ragged_paged_attention.launches == before

    def test_rejects_bad_inputs(self):
        q = torch.zeros(2, 1, 4, 64)
        kp = torch.zeros(9, 16, 2, 64)
        pt = torch.zeros(2, 4, dtype=torch.int32)
        ctx = torch.zeros(2, dtype=torch.int32)
        with pytest.raises(ValueError, match="multiple"):
            pa.ragged_paged_attention(torch.zeros(2, 1, 3, 64), kp, kp, pt,
                                      ctx)
        with pytest.raises(ValueError, match="page_table"):
            pa.ragged_paged_attention(q, kp, kp, pt.long(), ctx)
        with pytest.raises(ValueError, match="ctx_len"):
            pa.ragged_paged_attention(q, kp, kp, pt, ctx[:1])
        with pytest.raises(ValueError, match="q_len"):
            pa.ragged_paged_attention(q, kp, kp, pt, ctx, ctx.long())
        with pytest.raises(TypeError, match="dtype"):
            pa.ragged_paged_attention(q.double(), kp.double(), kp.double(),
                                      pt, ctx)
        with pytest.raises(ValueError, match="expected"):
            pa.ragged_paged_attention(q[0], kp, kp, pt, ctx)
        with pytest.raises(ValueError, match="devices"):
            pa.ragged_paged_attention(q, kp, kp, pt, ctx.to("meta"))

    def test_pages_read_scale_with_position(self):
        assert pa.pages_read(0, 1, 16) == jpa.pages_read(0, 1, 16) == 1
        assert pa.pages_read(15, 1, 16) == 1
        assert pa.pages_read(16, 1, 16) == 2
        assert pa.pages_read(100, 1, 16) == 7
        assert pa.pages_read(32, 8, 16) == 3   # a prefill chunk spans more


# ---------------------------------------------------------------------------
# forward_with_pages
# ---------------------------------------------------------------------------


class TestForwardWithPages:
    def _pool(self, cfg, tcfg, rng, num_pages=17, psz=16):
        shape = (cfg.num_layers, num_pages, psz, cfg.num_kv_heads,
                 cfg.head_dim)
        k, v = (rng.randn(*shape).astype(np.float32) * 0.1 for _ in "kv")
        return ({"k": jnp.asarray(k), "v": jnp.asarray(v)},
                {"k": torch.from_numpy(k.copy()),
                 "v": torch.from_numpy(v.copy())})

    def _check(self, cfg, params, tparams, tcfg, tokens, pt, pos, live,
               logit_pos=None, seed=0):
        jpool, tpool = self._pool(cfg, tcfg, np.random.RandomState(seed))
        jlog, jpool = jl.forward_with_pages(
            params, jnp.asarray(tokens), cfg, jpool, jnp.asarray(pt),
            jnp.asarray(pos), live=jnp.asarray(live),
            logit_pos=None if logit_pos is None else jnp.asarray(logit_pos))
        tlog, tpool = tl.forward_with_pages(
            tparams, torch.from_numpy(tokens), tcfg, tpool,
            torch.from_numpy(pt), torch.from_numpy(pos),
            live=torch.from_numpy(live),
            logit_pos=None if logit_pos is None
            else torch.from_numpy(logit_pos))
        _close(tlog.numpy(), jlog)
        for kk in ("k", "v"):       # page 0, the trash page, included
            _close(tpool[kk].numpy(), jpool[kk], rtol=2e-5, atol=2e-5)

    def test_ragged_decode_tick(self, both):
        """Mixed positions on a shuffled table; one dead slot writes to
        the trash page, one slot sits at max_len (past the table)."""
        cfg, params, tcfg, tparams = both
        rng = np.random.RandomState(3)
        pt = rng.permutation(np.arange(1, 17))[:12].reshape(4, 3).astype(
            np.int32)
        tokens = rng.randint(0, cfg.vocab_size, (4, 1)).astype(np.int32)
        pos = np.asarray([9, 37, 20, 48], np.int32)   # 48 = 3 pages * 16
        live = np.asarray([True, True, False, True])
        self._check(cfg, params, tparams, tcfg, tokens, pt, pos, live)

    def test_prefill_at_context_offset(self, both):
        """Two 8-row chunks, one live at ctx 20 with logits read at its
        true last row, one dead (its rows land in the trash page)."""
        cfg, params, tcfg, tparams = both
        rng = np.random.RandomState(4)
        pt = rng.permutation(np.arange(1, 17))[:8].reshape(2, 4).astype(
            np.int32)
        tokens = rng.randint(0, cfg.vocab_size, (2, 8)).astype(np.int32)
        pos = np.asarray([20, 5], np.int32)
        live = np.asarray([True, False])
        self._check(cfg, params, tparams, tcfg, tokens, pt, pos, live,
                    logit_pos=np.asarray([5, 7], np.int32), seed=1)


# ---------------------------------------------------------------------------
# allocator, copy-on-write, prefix cache (tests/test_paged_kv.py's cases)
# ---------------------------------------------------------------------------


class TestPageAllocator:
    def test_alloc_free_refcount_roundtrip(self):
        a = PageAllocator(9)                      # 8 usable + trash
        assert a.pages_free == 8
        pages = a.alloc(3)
        assert a.pages_free == 5 and all(a.ref(p) == 1 for p in pages)
        a.retain(pages[:2])                       # COW share
        assert [a.ref(p) for p in pages] == [2, 2, 1]
        assert a.release(pages) == 1              # only the unshared frees
        assert a.pages_free == 6
        assert a.release(pages[:2]) == 2
        assert a.pages_free == 8
        assert a.check() == []

    def test_misuse_raises(self):
        a = PageAllocator(5)
        pages = a.alloc(2)
        a.release(pages)
        with pytest.raises(RuntimeError, match="double free"):
            a.release(pages[:1])
        with pytest.raises(RuntimeError, match="unallocated"):
            a.retain([pages[0]])
        with pytest.raises(RuntimeError, match="exhausted"):
            a.alloc(5)
        assert a.check() == []

    def test_randomized_schedule_no_leak_no_double_free(self):
        """Randomized admit / share / finish / preempt schedule: the
        invariant holds at every step and every page comes back."""
        rng = np.random.RandomState(0)
        a = PageAllocator(33)                     # 32 usable
        live = []
        for step in range(300):
            op = rng.randint(4)
            if op == 0 and a.pages_free >= 4:     # admit
                live.append(a.alloc(int(rng.randint(1, 5))))
            elif op == 1 and live:                # COW prefix share
                src = live[rng.randint(len(live))]
                k = int(rng.randint(1, len(src) + 1))
                shared = src[:k]
                a.retain(shared)
                extra = (a.alloc(int(rng.randint(0, min(3, a.pages_free)
                                                 + 1)))
                         if a.pages_free else [])
                live.append(shared + extra)
            elif op == 2 and live:                # finish
                a.release(live.pop(rng.randint(len(live))))
            elif op == 3 and live:                # preempt: free + resume
                pages = live.pop(rng.randint(len(live)))
                a.release(pages)
                if a.pages_free >= len(pages):
                    live.append(a.alloc(len(pages)))
            assert a.check() == [], f"invariant broke at step {step}"
        for pages in live:
            a.release(pages)
        assert a.check() == []
        assert a.pages_free == 32


class TestCopyOnWrite:
    def test_break_on_write_gives_private_page(self, both):
        """fork -> shared pages (ref 2, no copy); ensure_writable on the
        sharer -> one private copy whose mutation leaves the original as
        it was; a private page breaks for free."""
        tcfg = both[2]
        pgr = PagedKVCache(tcfg, slots=2, page_size=8, num_pages=9,
                           max_pages=4, device="cpu")
        pages, row = pgr.reserve(16)              # 2 pages for slot 0
        pgr.install(0, pages)
        pgr.page_table[0] = torch.from_numpy(row)
        marker = torch.ones_like(pgr.pool["k"][:, pages[0]]) * 7.0
        pgr.pool["k"][:, pages[0]] = marker

        pgr.fork_slot(0, 1)                       # ref bump only
        assert pgr.slot_pages[1] == pages
        assert pgr.page_table[1].tolist() == row.tolist()
        assert pgr.allocator.ref(pages[0]) == 2
        assert pgr.cow_breaks == 0

        new = pgr.ensure_writable(1, 0)           # break on write
        assert new != pages[0] and pgr.cow_breaks == 1
        assert pgr.allocator.ref(pages[0]) == 1
        assert int(pgr.page_table[1, 0]) == new
        torch.testing.assert_close(pgr.pool["k"][:, new], marker)
        pgr.pool["k"][:, new] = marker * 2
        torch.testing.assert_close(pgr.pool["k"][:, pages[0]], marker)
        assert pgr.ensure_writable(1, 0) == new   # already private
        assert pgr.cow_breaks == 1
        pgr.free_slot(0)
        pgr.free_slot(1)
        assert pgr.leak_report() == []

    def test_mesh_and_quant_raise(self, both):
        """A mesh still raises; a quantized pool now builds, with int8
        pages and fp32 per-row scale planes ``ks``/``vs``."""
        with pytest.raises(NotImplementedError):
            PagedKVCache(both[2], slots=1, page_size=8, num_pages=3,
                         max_pages=2, device="cpu", mesh=object())
        pgr = PagedKVCache(both[2], slots=1, page_size=8, num_pages=3,
                           max_pages=2, device="cpu", quant="int8")
        assert set(pgr.pool) == {"k", "v", "ks", "vs"}
        assert pgr.pool["k"].dtype == torch.int8
        assert pgr.pool["ks"].dtype == torch.float32
        assert pgr.pool["ks"].shape == pgr.pool["k"].shape[:3]


class TestPagedPrefixCacheUnit:
    def test_match_insert_evict_mechanics(self, both):
        tcfg = both[2]
        pgr = PagedKVCache(tcfg, slots=1, page_size=8, num_pages=17,
                           max_pages=8, device="cpu")
        pc = PagedPrefixCache(pgr, capacity_pages=4)
        rng = np.random.RandomState(43)
        base = rng.randint(0, tcfg.vocab_size, (32,)).astype(np.int32)
        pages, _ = pgr.reserve(32)               # a "slot" holding base
        pc.insert(base, pages)
        assert pc.pages_held == 4
        assert all(pgr.allocator.ref(p) == 2 for p in pages)
        # partial overlap: the same first 8 tokens -> a one-page hit
        probe = np.concatenate(
            [base[:8], rng.randint(0, tcfg.vocab_size, (12,))]
        ).astype(np.int32)
        m = pc.match(probe)
        assert m is not None and m.length == 8 and m.pages == [pages[0]]
        assert pc.match(base[:8]) is None        # one token must prefill
        other_pages, _ = pgr.reserve(32)         # capacity eviction
        pc.insert(rng.randint(0, tcfg.vocab_size, (32,)).astype(np.int32),
                  other_pages)
        assert pc.pages_held <= 4 and pc.evictions >= 1
        pgr.release_pages(pages)
        pgr.release_pages(other_pages)
        pc.clear()
        assert pgr.leak_report() == []


# ---------------------------------------------------------------------------
# the paged engine against the JAX engine
# ---------------------------------------------------------------------------


def _prompts(rng, vocab, shapes):
    return [(rng.randint(0, vocab, (l,)).astype(np.int32), n)
            for l, n in shapes]


def _serve(both, port: bool, waves, steps, cache_pages=None, first=None,
           **kw):
    """Serve ``waves`` of requests on one engine: each wave is queued,
    then segments of ``steps`` run (the first wave's first segment of
    ``first`` steps, before the next wave arrives) until the engine is
    idle. Returns everything the two engines must agree on."""
    cfg, params, tcfg, tparams = both
    if port:
        eng = ServingEngine(tcfg, tparams, paged=True, device="cpu", **kw)
        pc = (PagedPrefixCache(eng.pager, capacity_pages=cache_pages)
              if cache_pages else None)
    else:
        eng = JaxEngine(cfg, params, paged=True, **kw)
        pc = (JaxCache(eng.pager, capacity_pages=cache_pages)
              if cache_pages else None)
    rids, events = [], []
    for w, wave in enumerate(waves):
        rids += [eng.add_request(p, n) for p, n in wave]
        if w == 0 and first:
            events.append(eng.run_segment(first, prefix_cache=pc))
            continue
        while eng._queue or eng.free_slot_count() < eng.slots:
            events.append(eng.run_segment(steps, prefix_cache=pc))
    out = eng.collect_finished()
    rec = {"tokens": [out[r] for r in rids], "events": events,
           "ticks": eng.last_run_ticks, "chunks": eng.last_run_chunks,
           "backpressure": eng.page_backpressure_events,
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


class TestEngineParity:
    @pytest.mark.parametrize("cache_pages", [None, 64])
    def test_r7_workload_mid_flight_arrivals(self, both, cache_pages):
        rng = np.random.RandomState(21)
        vocab = both[0].vocab_size
        waves = [_prompts(rng, vocab, [(5, 9), (12, 6), (8, 12)]),
                 _prompts(rng, vocab, [(20, 4), (3, 8), (15, 5), (7, 10)])]
        rec = _parity(both, waves, 7, first=5, cache_pages=cache_pages,
                      slots=3, max_len=96, prompt_buckets=(8, 16, 32),
                      page_size=16)
        assert [len(t) for t in rec["tokens"]] == [
            n for w in waves for _, n in w]

    def test_eos_freeze_and_slot_reuse(self, both):
        """EOS at a request's second token freezes its slot; the pages free
        at the replay and the next request takes the slot."""
        cfg, params, tcfg, tparams = both
        rng = np.random.RandomState(23)
        reqs = _prompts(rng, cfg.vocab_size, [(6 + i, 8) for i in range(4)])
        kw = dict(slots=1, max_len=96, prompt_buckets=(16,), page_size=16)
        plain = _serve(both, True, [reqs], 24, **kw)["tokens"]
        eos = plain[0][1]
        rec = _parity(both, [reqs], 24, eos_token_id=eos, **kw)
        for got, full in zip(rec["tokens"], plain):
            assert got == (full[:full.index(eos) + 1] if eos in full
                           else full)

    def test_prefix_hit_is_ref_bump_only(self, both):
        """Four prompts over one 32-token prefix: later admits hit the
        cache (a page-ref bump, no copy, no COW break) and prefill only
        their suffix at context offset 32."""
        rng = np.random.RandomState(41)
        vocab = both[0].vocab_size
        prefix = rng.randint(0, vocab, (32,)).astype(np.int32)
        reqs = [(np.concatenate([prefix, rng.randint(0, vocab, (6,))])
                 .astype(np.int32), 6) for _ in range(4)]
        kw = dict(slots=2, max_len=96, prompt_buckets=(8, 16, 64),
                  page_size=16)
        cold = _serve(both, True, [reqs], 16, **kw)
        rec = _parity(both, [reqs], 16, cache_pages=64, **kw)
        assert rec["tokens"] == cold["tokens"]
        assert rec["prefix"]["hits"] >= 2
        assert rec["prefix"]["hit_tokens"] >= 2 * 32
        assert rec["pages"]["cow_breaks"] == 0

    @pytest.mark.parametrize("case", ["max_len_wall", "backpressure",
                                      "pressure_valve"])
    def test_tight_pool(self, both, case):
        """A pool below slots x max_len serves at full concurrency; a pool
        that fits one request at a time defers on pages; a prefix cache
        yields its pages before live traffic defers."""
        vocab = both[0].vocab_size
        if case == "max_len_wall":
            reqs = _prompts(np.random.RandomState(7), vocab,
                            [(30, 9), (5, 7), (12, 3), (3, 12), (17, 5),
                             (25, 4), (8, 8), (6, 6)])
            rec = _parity(both, [reqs], 8, slots=4, max_len=96,
                          prompt_buckets=(8, 16, 32), page_size=16,
                          num_pages=14)
        elif case == "backpressure":
            reqs = _prompts(np.random.RandomState(5), vocab, [(30, 9)] * 3)
            rec = _parity(both, [reqs], 16, slots=2, max_len=96,
                          prompt_buckets=(32,), page_size=16, num_pages=6)
            assert rec["backpressure"] > 0
        else:
            reqs = _prompts(np.random.RandomState(11), vocab, [(50, 6)] * 3)
            rec = _parity(both, [reqs], 16, cache_pages=8, slots=2,
                          max_len=96, prompt_buckets=(64,), page_size=16,
                          num_pages=6)
            assert rec["prefix"]["evictions"] > 0
        assert [len(t) for t in rec["tokens"]] == [n for _, n in reqs]

    def test_unadmitted_tail_requeued(self, both):
        """A segment picks more requests than its step budget admits: the
        tail goes back to the queue head in order, its reservations
        released, and is served by the next segments."""
        cfg, params, tcfg, tparams = both
        reqs = _prompts(np.random.RandomState(13), cfg.vocab_size,
                        [(6, 5), (9, 4), (3, 6), (12, 3)])
        kw = dict(slots=1, max_len=96, prompt_buckets=(16,), paged=True,
                  page_size=16)
        ref = JaxEngine(cfg, params, **kw)
        eng = ServingEngine(tcfg, tparams, device="cpu", **kw)
        logs = []
        for e in (ref, eng):
            for p, n in reqs:
                e.add_request(p, n)
            ev = [e.run_segment(3, n_pad=4)]
            queued = [r.rid for r in e._queue]
            held = e.pager.allocator.pages_used
            while e._queue or e.free_slot_count() < e.slots:
                ev.append(e.run_segment(3, n_pad=4))
            logs.append((ev, queued, held, e.collect_finished(),
                         e.pager.stats()))
        assert logs[1] == logs[0]
        assert logs[1][1] == [1, 2, 3]      # FCFS order kept
        assert logs[1][2] == 1              # only the admitted one's page
        assert eng.pager.leak_report() == []

    def test_starved_pool_raises(self, both):
        """Pages pinned outside the engine, with no live slot to free
        any: admission fails loudly instead of spinning."""
        eng = ServingEngine(both[2], both[3], slots=2, max_len=96,
                            prompt_buckets=(16,), paged=True, page_size=16,
                            num_pages=4, device="cpu")
        pinned, _ = eng.pager.reserve(48)        # all 3 usable pages
        eng.add_request(np.arange(10, dtype=np.int32), 4)
        with pytest.raises(RuntimeError, match="starved"):
            eng.run_segment(4)
        eng.pager.release_pages(pinned)
        assert eng.run_segment(8)["finished"] == [0]

    def test_run_drains_through_segments(self, both):
        cfg, params, tcfg, tparams = both
        reqs = _prompts(np.random.RandomState(9), cfg.vocab_size,
                        [(5, 7), (12, 3), (30, 9), (3, 12), (17, 5)])
        kw = dict(slots=2, max_len=96, chunk=4, prompt_buckets=(8, 16, 32),
                  paged=True, page_size=16)
        ref = JaxEngine(cfg, params, **kw)
        eng = ServingEngine(tcfg, tparams, device="cpu", **kw)
        for e in (ref, eng):
            for p, n in reqs:
                e.add_request(p, n)
        want, got = ref.run(), eng.run()
        assert got == want
        assert (eng.last_run_ticks, eng.last_run_chunks) == \
            (ref.last_run_ticks, ref.last_run_chunks)
        assert eng.pager.stats() == ref.pager.stats()
        assert set(eng.last_latencies) == set(got)
        assert eng.pager.leak_report() == []


class TestSegmentContract:
    def _engine(self, both, **kw):
        kw = {"slots": 2, "max_len": 96, "prompt_buckets": (8, 16),
              "page_size": 16, **kw}
        return ServingEngine(both[2], both[3], paged=True, device="cpu",
                             **kw)

    def _reqs(self, both):
        return _prompts(np.random.RandomState(2), both[0].vocab_size,
                        [(5, 6), (9, 3), (12, 8), (4, 5)])

    def test_one_fetch_per_segment_without_eos(self, both):
        eng = self._engine(both)
        for p, n in self._reqs(both):
            eng.add_request(p, n)
        segments = 0
        while eng._queue or eng.free_slot_count() < eng.slots:
            before = eng.fetches
            ev = eng.run_segment(6)
            segments += 1
            assert ev["steps"] > 0 and eng.fetches == before + 1
        assert segments > 1 and eng.fetches == segments

    def test_one_fetch_per_step_with_eos(self, both):
        """With EOS the next step depends on the tokens: each step's
        tokens are read once, and nothing else is."""
        eng = self._engine(both, eos_token_id=3)
        for p, n in self._reqs(both):
            eng.add_request(p, n)
        while eng._queue or eng.free_slot_count() < eng.slots:
            before = eng.fetches
            ev = eng.run_segment(6)
            assert eng.fetches == before + ev["steps"]

    def test_dispatch_finish_pairing(self, both):
        eng = self._engine(both)
        eng.add_request(np.arange(4, dtype=np.int32), 3)
        p = eng.dispatch_segment(4)
        with pytest.raises(RuntimeError, match="in flight"):
            eng.dispatch_segment(4)
        with pytest.raises(RuntimeError, match="matching"):
            eng.finish_segment(object())
        ev = eng.finish_segment(p)
        assert ev["admitted"] == [0]
        with pytest.raises(RuntimeError, match="matching"):
            eng.finish_segment()

    def test_contiguous_engine_and_foreign_cache_raise(self, both):
        """Each engine refuses a prefix cache of the other layout (the
        contiguous engine runs segments too, over a row-copy cache)."""
        cont = ServingEngine(both[2], both[3], slots=1, max_len=96,
                             prompt_buckets=(16,), device="cpu")
        eng = self._engine(both)
        cont.add_request(np.arange(8, dtype=np.int32), 2)
        with pytest.raises(TypeError, match="takes a PrefixCache"):
            cont.run_segment(4, prefix_cache=PagedPrefixCache(eng.pager))
        eng.add_request(np.arange(8, dtype=np.int32), 2)
        with pytest.raises(TypeError, match="PagedPrefixCache"):
            eng.run_segment(4, prefix_cache=object())

    def test_intake_checks(self, both):
        eng = self._engine(both, num_pages=3)
        with pytest.raises(ValueError, match="pages"):
            eng.add_request(np.zeros((16,), np.int32), 20)   # 3 pages > 2
        with pytest.raises(ValueError, match="page_size"):
            self._engine(both, max_len=90)

    def test_paged_engine_defaults_to_cuda(self, both, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            ServingEngine(both[2], both[3], paged=True)
