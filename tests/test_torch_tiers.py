"""The port's host KV tier and the paged prefix cache behind it, against
the JAX package's, on the CPU.

``paddle_tpu_torch.inference.kv_tiers.HostTier`` behind a
``PagedPrefixCache`` and ``paddle_tpu.inference.kv_tiers.HostTier`` behind
the JAX one serve the same spill-heavy multi-tenant trace (the geometry of
tests/test_kv_tiers.py: a pool of 10 usable pages, a cache of 8, tenants
with 2-page prefixes) from the same numpy weights in float32. Every
segment's event dict, the tokens, ``HostTier.stats()``, the cache's
``stats()``, the eviction reasons and the ``tier_transfer`` flight events
must be identical (stages land at the same segment boundary on both
sides: the port's at its counted fetch), and the tokens must equal a
serve with no cache at all. The tier's mechanics are held to JAX's
operation by operation: stage / complete / spill / restore, host-capacity
LRU, and the staged bytes of the same pool contents, bit for bit, on fp32,
int8 and fp8 pools (scale planes included). Migration between two port
caches, ``TierMeter`` and ``flush_tiers`` close it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.inference import kv_tiers as jtiers
from paddle_tpu.inference.prefix_cache import PagedPrefixCache as JaxPaged
from paddle_tpu.inference.scheduler import Arrival as JaxArrival
from paddle_tpu.inference.scheduler import OnlineScheduler as JaxOnline
from paddle_tpu.inference.serving import ServingEngine as JaxEngine
from paddle_tpu.observability import flight as jflight
from paddle_tpu.observability.capacity import CapacityMonitor as JaxCap
from paddle_tpu.parallel import set_mesh
from paddle_tpu_torch.inference import kv_tiers
from paddle_tpu_torch.inference import paged_kv, serving
from paddle_tpu_torch.inference.prefix_cache import (PagedPrefixCache,
                                                     make_prefix_cache)
from paddle_tpu_torch.inference.scheduler import Arrival, OnlineScheduler
from paddle_tpu_torch.inference.serving import ServingEngine
from paddle_tpu_torch.models import llama as tl
from paddle_tpu_torch.models.convert import params_from_numpy
from paddle_tpu_torch.observability import flight
from paddle_tpu_torch.observability.capacity import CapacityMonitor

GEOM = dict(slots=2, max_len=96, prompt_buckets=(8, 16, 32, 64), paged=True,
            page_size=16)
STEPS = 12


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


def _mk(both, port: bool, tiered=True, num_pages=11, host_pages=64,
        cache_pages=8, quant=None):
    cfg, params, tcfg, tparams = both
    if port:
        eng = ServingEngine(tcfg, tparams, num_pages=num_pages, quant=quant,
                            device="cpu", **GEOM)
        tier = (kv_tiers.HostTier(eng.pager, capacity_pages=host_pages)
                if tiered else None)
        return eng, PagedPrefixCache(eng.pager, capacity_pages=cache_pages,
                                     host_tier=tier)
    eng = JaxEngine(cfg, params, num_pages=num_pages, quant=quant, **GEOM)
    tier = (jtiers.HostTier(eng.pager, capacity_pages=host_pages)
            if tiered else None)
    return eng, JaxPaged(eng.pager, capacity_pages=cache_pages,
                         host_tier=tier)


def _tenant_trace(vocab, seed=7, tenants=4, rounds=2, gen=24):
    """tests/test_kv_tiers.py's round-robin trace: ``tenants`` 2-page
    prefixes, 8-token tails, all at t = 0; the prefixes' working set
    overflows the tight pool, so the tier carries them between rounds."""
    rng = np.random.RandomState(seed)
    prefs = [rng.randint(0, vocab, (32,)).astype(np.int32)
             for _ in range(tenants)]
    out = []
    for _ in range(rounds):
        for t in range(tenants):
            tail = rng.randint(0, vocab, (8,)).astype(np.int32)
            out.append((np.concatenate([prefs[t], tail]), gen))
    return out


def _no_tier(d):
    """A stats dict without the port's ``flushes`` count (the JAX tier has
    none: its flushes are syncs the auditor counts)."""
    if d is None:
        return None
    d = {k: v for k, v in d.items() if k != "flushes"}
    if isinstance(d.get("tier"), dict):
        d["tier"] = _no_tier(d["tier"])
    return d


def _tier_events(recorder):
    keep = ("tier_transfer", "prefix_evict")
    return [{k: v for k, v in e.items() if k not in ("seq", "t")}
            for e in recorder.events() if e["kind"] in keep]


def _serve(both, port: bool, trace, tiered=True, cached=True, quant=None,
           **mk):
    """The trace through ``run_segment`` one segment at a time (what
    ``OnlineScheduler`` does with every arrival due at t = 0); returns
    what the two packages must agree on."""
    eng, pc = _mk(both, port, tiered=tiered, quant=quant, **mk)
    if not cached:
        pc = None
    rec = flight if port else jflight
    rec.clear()
    listened = []
    if pc is not None:
        pc.listeners.append(lambda ev, key, toks, tier, n: listened.append(
            (ev, len(toks), tier, n)))
    rids = [eng.add_request(p, n) for p, n in trace]
    events = []
    while eng._queue or eng.free_slot_count() < eng.slots:
        events.append(eng.run_segment(STEPS, prefix_cache=pc))
    out = eng.collect_finished()
    res = {"tokens": [out[r] for r in rids], "events": events,
           "pages": eng.pager.stats(),
           "prefix": _no_tier(pc.stats()) if pc is not None else None,
           "tier": (_no_tier(pc.host_tier.stats())
                    if pc is not None and pc.host_tier is not None
                    else None),
           "flight": _tier_events(rec), "listened": listened,
           "reclaim": ([pc.reclaimable_pages(t) for t in ("hbm", "host",
                                                          "all")]
                       + [pc.spillable_pages(), pc.physical_pages_held()]
                       if pc is not None else None)}
    return res, eng, pc


@pytest.fixture(scope="module")
def spill(both):
    """The spill-heavy serve on both packages, and the port's no-cache
    serve of the same trace (the token oracle)."""
    trace = _tenant_trace(both[0].vocab_size)
    want, _, _ = _serve(both, False, trace)
    got, eng, pc = _serve(both, True, trace)
    ref, _, _ = _serve(both, True, trace, cached=False)
    return {"trace": trace, "want": want, "got": got, "ref": ref,
            "eng": eng, "pc": pc}


class TestSpillHeavyServe:
    @pytest.mark.parametrize("key", ["events", "tokens", "pages", "prefix",
                                     "tier", "flight", "listened",
                                     "reclaim"])
    def test_matches_jax(self, spill, key):
        """Each segment's event dict, the tokens, the pager's, cache's and
        tier's stats, every ``tier_transfer`` / ``prefix_evict`` flight
        event in order (direction, pages, bytes, reason), the listeners'
        transitions and the reclaimable-page views equal JAX's."""
        assert spill["got"][key] == spill["want"][key]

    def test_tier_really_carried_the_prefixes(self, spill):
        t = spill["got"]["tier"]
        assert t["stages"] > 0 and t["spills"] > 0 and t["restores"] > 0
        assert spill["got"]["prefix"]["hits"] > 0
        dirs = {e["direction"] for e in spill["got"]["flight"]
                if e["kind"] == "tier_transfer"}
        assert {"stage", "spill", "restore"} <= dirs
        reasons = {e["reason"] for e in spill["got"]["flight"]
                   if e["kind"] == "prefix_evict"}
        assert "spill" in reasons
        assert reasons <= {"capacity", "pressure", "spill", "subsumed",
                           "reset"}

    def test_tokens_equal_no_cache_serve(self, spill):
        assert spill["got"]["tokens"] == spill["ref"]["tokens"]

    def test_one_fetch_a_segment_and_no_flush(self, spill):
        """The stages land at the segment's own fetch: the tiered serve
        reads the device once a segment and never waits in the tier."""
        eng, pc = spill["eng"], spill["pc"]
        assert eng.fetches == len(spill["got"]["events"])
        assert pc.host_tier.flushes == 0

    def test_bytes_priced_per_page(self, spill):
        pb = spill["pc"].host_tier.page_bytes()
        cfg = spill["eng"].cfg
        assert pb == 2 * cfg.num_layers * 16 * cfg.num_kv_heads \
            * cfg.head_dim * 4
        for e in spill["got"]["flight"]:
            if e["kind"] == "tier_transfer" and e["direction"] != "spill":
                assert e["bytes"] == e["pages"] * pb

    def test_pool_clean_after_reset(self, spill):
        eng, pc = spill["eng"], spill["pc"]
        pc.reset()
        assert eng.pager.leak_report() == []
        assert pc.host_pages == 0 and pc.pages_held == 0


class TestSchedulerReport:
    def _run(self, both, port, trace, cap=False, tiered=True):
        eng, pc = _mk(both, port, tiered=tiered)
        mod_arr = Arrival if port else JaxArrival
        mon = (CapacityMonitor() if port else JaxCap()) if cap else None
        sch = (OnlineScheduler if port else JaxOnline)(
            eng, seg_steps=STEPS, prefix_cache=pc, capacity_monitor=mon)
        rep = sch.serve([mod_arr(0.0, p, n) for p, n in trace])
        rows = [{k: v for k, v in r.items()
                 if k not in ("ttft_s", "e2e_s", "page_seconds")}
                for r in rep.per_request]
        meter = rep.meter
        for agg in [meter["total"]] + list(meter["per_class"].values()):
            agg.pop("page_seconds")
        out = {"results": sch.results(), "rows": rows, "meter": meter,
               "tiers": _no_tier(rep.tiers), "prefix": _no_tier(rep.prefix),
               "segments": rep.segments, "ticks": rep.ticks,
               "backpressure_pages": rep.backpressure_pages}
        if cap:
            c = rep.capacity
            out["capacity"] = {k: c[k] for k in (
                "segments", "avail_by_tier", "pages_admitted_total",
                "admitted_total", "level", "demand_fast")}
        return out, rep

    def test_report_matches_jax(self, both):
        trace = _tenant_trace(both[0].vocab_size, seed=13)
        want, _ = self._run(both, False, trace, cap=True)
        got, rep = self._run(both, True, trace, cap=True)
        assert got == want
        assert rep.tiers["restores"] > 0
        assert any(r["tier_bytes"] > 0 for r in rep.per_request)
        assert rep.capacity["avail_by_tier"]["host"] is not None
        for r in rep.per_request:
            assert r["tier_bytes"] <= r["pages"] * rep.tiers["page_bytes"]

    def test_tiered_beats_untiered_hit_tokens(self, both):
        """On the same trace a cache without a tier loses the prefixes to
        pressure; the tier serves the repeat round from them. Tokens are
        the same either way."""
        trace = _tenant_trace(both[0].vocab_size, seed=13)
        tiered, _ = self._run(both, True, trace)
        flat, _ = self._run(both, True, trace, tiered=False)
        assert tiered["results"] == flat["results"]
        assert tiered["prefix"]["hit_tokens"] > flat["prefix"]["hit_tokens"]


class TestGeometries:
    @pytest.mark.parametrize("tenants,rounds,gen,cache_pages", [
        (3, 3, 16, 8), (5, 2, 12, 8), (4, 2, 24, 4), (2, 4, 20, 6)])
    def test_other_traces_match_jax(self, both, tenants, rounds, gen,
                                    cache_pages):
        trace = _tenant_trace(both[0].vocab_size, seed=tenants * 7 + rounds,
                              tenants=tenants, rounds=rounds, gen=gen)
        want, _, _ = _serve(both, False, trace, cache_pages=cache_pages)
        got, eng, pc = _serve(both, True, trace, cache_pages=cache_pages)
        assert got == want
        ref, _, _ = _serve(both, True, trace, cached=False)
        assert got["tokens"] == ref["tokens"]
        pc.clear()
        assert eng.pager.leak_report() == []


# ---------------------------------------------------------------------------
# HostTier mechanics, operation by operation
# ---------------------------------------------------------------------------


def _stage_one(both, port, num_pages=21, seed=47):
    eng, pc = _mk(both, port, num_pages=num_pages)
    toks = np.random.RandomState(seed).randint(
        0, both[0].vocab_size, (32,)).astype(np.int32)
    pages, _ = eng.pager.reserve(32)          # a live span of 2 pages
    pc.insert(toks, pages)                    # queues the stage
    return eng, pc, toks, pages


class TestHostTierUnit:
    def _mechanics(self, both, port):
        eng, pc, toks, pages = _stage_one(both, port)
        tier, pgr = pc.host_tier, eng.pager
        trail = [tier.stats()["pending_stages"], tier.has(toks.tobytes())]
        tier.flush()                          # out-of-loop landing
        trail += [tier.has(toks.tobytes()), tier.pages_host,
                  tier.bytes_to_host]
        pgr.release_pages(pages)              # the span retires
        pc.evict_until(pgr.num_pages)         # clean: spills
        trail += [pc.spills, pc.pages_held]
        tail = np.random.RandomState(3).randint(
            0, both[0].vocab_size, (8,)).astype(np.int32)
        m = pc.match(np.concatenate([toks, tail]))
        trail += [m.tier, list(m.pages), m.length]
        restored = pc.restore(m.key, m.length)
        trail += [len(restored), pc.restores, tier.bytes_to_hbm]
        st = _no_tier(tier.stats())
        pc.clear()
        trail += [pgr.leak_report(), st]
        return trail

    def test_stage_flush_spill_restore_matches_jax(self, both):
        assert self._mechanics(both, True) == self._mechanics(both, False)

    def test_stage_lands_only_at_the_counted_fetch(self, both):
        """``has`` turns true at the segment finish after the stage was
        queued, and no earlier."""
        eng, pc, toks, pages = _stage_one(both, True)
        assert not pc.host_tier.has(toks.tobytes())
        eng.pager.release_pages(pages)
        eng.add_request(toks[:8], 2)
        ev = eng.dispatch_segment(8, prefix_cache=pc)
        assert not pc.host_tier.has(toks.tobytes())
        eng.finish_segment(ev)
        assert pc.host_tier.has(toks.tobytes())
        assert pc.host_tier.stats()["pending_stages"] == 0

    def test_pending_stage_dropped_with_its_entry(self, both):
        """An entry evicted before its stage landed is dropped, never
        spilled, and its stage is cancelled (JAX's rule)."""
        def run(port):
            eng, pc, toks, pages = _stage_one(both, port)
            eng.pager.release_pages(pages)
            pc.evict_until(eng.pager.num_pages)
            return [pc.spills, pc.evictions, pc.host_tier.stats()[
                "pending_stages"], pc.host_tier.has(toks.tobytes()),
                eng.pager.leak_report()]
        got = run(True)
        assert got == run(False)
        assert got[:4] == [0, 1, 0, False]

    def test_partial_restore_truncates_entry(self, both):
        """A hit covering one of an entry's two pages restores one page
        and re-keys the entry (and its host copy) to that page."""
        def run(port):
            eng, pc, toks, pages = _stage_one(both, port)
            pc.host_tier.flush()
            eng.pager.release_pages(pages)
            pc.evict_until(eng.pager.num_pages)
            m = pc.match(np.concatenate([toks[:16], toks[:5]]))
            got = pc.restore(m.key, m.length)
            keys = [len(np.frombuffer(k, np.int32)) for k in pc._entries]
            out = [len(got), keys, pc.host_tier.pages_host,
                   pc.host_tier.has(toks[:16].tobytes()),
                   _no_tier(pc.stats())]
            pc.clear()
            return out + [eng.pager.leak_report()]
        assert run(True) == run(False)

    def test_restore_past_capacity_keeps_its_pages(self, both):
        """A restored span larger than ``capacity_pages``, with another
        spilled entry in the cache, keeps its fresh pages until the
        admission shares them, and they hold the host bytes. The
        reference's restore spills that very entry again in its
        capacity shrink and returns pages it has freed (ROADMAP Queue
        C's reference caveats)."""
        def run(port):
            eng, pc = _mk(both, port, num_pages=21, cache_pages=1)
            pgr, rng = eng.pager, np.random.RandomState(5)
            vocab = both[0].vocab_size
            toks = [rng.randint(0, vocab, (32,)).astype(np.int32)
                    for _ in range(2)]
            pool = {p: np.asarray(a) for p, a in pgr.pool.items()}
            host = {p: rng.standard_normal(
                (a.shape[0], 2) + a.shape[2:]).astype(a.dtype)
                for p, a in pool.items()}
            for t in toks:
                assert pc.import_host(t, host)
            pages = pc.restore(toks[0].tobytes(), 32)
            return eng, pc, pages, host
        eng, pc, pages, host = run(True)
        pgr = eng.pager
        assert len(pages) == 2 > pc.capacity_pages
        assert [pgr.allocator.ref(p) for p in pages] == [1, 1]
        assert pc._entries[next(reversed(pc._entries))].pages == pages
        for p, a in host.items():
            assert np.array_equal(pgr.pool[p][:, pages].numpy(), a)
        slot_pages, _ = pgr.reserve(40, shared=pages)
        assert slot_pages[:2] == pages
        pgr.release_pages(slot_pages)
        pc.clear()
        assert pgr.leak_report() == []
        jeng, jpc, jpages, _ = run(False)
        assert [jeng.pager.allocator.ref(p) for p in jpages] == [0, 0]

    def test_host_capacity_lru_matches_jax(self, both):
        def run(port):
            eng, _ = _mk(both, port, tiered=False, num_pages=21)
            tier = (kv_tiers if port else jtiers).HostTier(
                eng.pager, capacity_pages=3)
            cfg = both[2] if port else both[0]
            for i in range(4):
                k = np.full((cfg.num_layers, 2, 16, cfg.num_kv_heads,
                             cfg.head_dim), i, np.float32)
                tier.note_import(f"k{i}".encode(), {"k": k, "v": k}, 2)
            return [list(tier._host), tier.pages_host, tier.host_evictions,
                    tier.imports, tier.bytes_imported]
        got = run(True)
        assert got == run(False)
        assert got[2] >= 1

    def test_capacity_validation(self, both):
        eng, _ = _mk(both, True, tiered=False)
        with pytest.raises(ValueError, match="capacity_pages"):
            kv_tiers.HostTier(eng.pager, capacity_pages=0)

    def test_prewarm_transfers_leaves_pool(self, both):
        eng, pc, _, _ = _stage_one(both, True)
        before = {k: v.clone() for k, v in eng.pager.pool.items()}
        pc.host_tier.prewarm_transfers(4)
        assert all(torch.equal(before[k], eng.pager.pool[k])
                   for k in before)
        assert pc.host_tier.stats()["pending_stages"] == 1

    @pytest.mark.parametrize("quant", [None, "int8", "fp8"])
    def test_page_bytes_matches_jax(self, both, quant):
        e_t, _ = _mk(both, True, tiered=False, quant=quant)
        e_j, _ = _mk(both, False, tiered=False, quant=quant)
        assert kv_tiers.page_bytes(e_t.pager) == \
            jtiers.page_bytes(e_j.pager)


# ---------------------------------------------------------------------------
# staged bytes, bit for bit
# ---------------------------------------------------------------------------


def _bits(a) -> np.ndarray:
    """The bytes of a host value: a torch tensor through a uint8 view, a
    numpy array (ml_dtypes included) the same way."""
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.uint8).numpy()
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.uint8)


def _random_pool(jeng, seed):
    """Random contents for every plane of the JAX engine's pool, in its
    dtypes, as numpy."""
    rng = np.random.RandomState(seed)
    out = {}
    for name, a in jeng.pager.pool.items():
        a = np.asarray(a)
        if a.dtype == np.float32:
            out[name] = rng.standard_normal(a.shape).astype(np.float32)
        else:    # int8, or fp8 through its bytes (finite values only)
            raw = rng.randint(-120, 120, a.shape).astype(np.int8)
            out[name] = raw.view(a.dtype) if a.dtype.itemsize == 1 \
                and a.dtype != np.int8 else raw
    return out


def _load(both, quant, seed):
    """The same random pool in a port and a JAX pager."""
    e_t, pc_t = _mk(both, True, quant=quant, num_pages=21)
    e_j, pc_j = _mk(both, False, quant=quant, num_pages=21)
    pool = _random_pool(e_j, seed)
    e_j.pager.pool = {k: jnp.asarray(v) for k, v in pool.items()}
    for k, v in pool.items():
        dst = e_t.pager.pool[k]
        src = torch.from_numpy(np.ascontiguousarray(v).view(np.uint8)) \
            if v.dtype.itemsize == 1 else torch.from_numpy(v)
        kv_tiers._raw(dst).copy_(src.view(kv_tiers._raw(dst).dtype)
                                 if src.dtype != kv_tiers._raw(dst).dtype
                                 else src)
    for k, v in pool.items():
        assert np.array_equal(_bits(e_t.pager.pool[k]), _bits(v))
    return e_t, pc_t, e_j, pc_j


class TestStagedBits:
    @pytest.mark.parametrize("quant", [None, "int8", "fp8"])
    def test_staged_bytes_equal_jax(self, both, quant):
        """The same pool contents staged from the same pages give the same
        host bytes in every plane (``ks``/``vs`` of a narrow pool
        included)."""
        e_t, pc_t, e_j, pc_j = _load(both, quant, seed=5)
        toks = np.arange(48, dtype=np.int32)
        pages = [7, 3, 12]
        pc_t.host_tier.stage(toks.tobytes(), pages)
        pc_j.host_tier.stage(toks.tobytes(), pages)
        pc_t.host_tier.flush()
        pc_j.host_tier.flush()
        h_t = pc_t.host_tier.get(toks.tobytes())
        h_j = pc_j.host_tier.get(toks.tobytes())
        planes = pc_t.host_tier.planes()
        assert planes == pc_j.host_tier.planes()
        assert set(planes) == ({"k", "v"} if quant is None
                               else {"k", "v", "ks", "vs"})
        for p in planes:
            assert h_t[p].dtype == e_t.pager.pool[p].dtype
            assert np.array_equal(_bits(h_t[p]), _bits(h_j[p])), p

    @pytest.mark.parametrize("quant", [None, "int8", "fp8"])
    def test_restore_round_trip_bits(self, both, quant):
        """Stage, spill, restore into other pages: every plane of the
        restored pages equals the staged bytes, and JAX's restore of the
        same entry writes the same bytes."""
        e_t, pc_t, e_j, pc_j = _load(both, quant, seed=9)
        toks = np.arange(32, dtype=np.int32)
        outs = []
        for eng, pc in ((e_t, pc_t), (e_j, pc_j)):
            pages, _ = eng.pager.reserve(32)
            pc.insert(toks, pages)
            pc.host_tier.flush()
            eng.pager.release_pages(pages)
            pc.evict_until(eng.pager.num_pages)
            assert pc.spills == 1
            hold, _ = eng.pager.reserve(64)   # the old pages go elsewhere
            m = pc.match(np.concatenate([toks, toks[:3]]))
            got = pc.restore(m.key, m.length)
            assert set(got).isdisjoint(pages)
            host = pc.host_tier.get(toks.tobytes())
            restored = {p: np.asarray(_bits(eng.pager.pool[p]))[:, got]
                        for p in pc.host_tier.planes()}
            for p, rows in restored.items():
                assert np.array_equal(rows, _bits(host[p])), p
            outs.append(restored)
            eng.pager.release_pages(hold)
        for p in outs[0]:
            assert np.array_equal(outs[0][p], outs[1][p]), p

    def test_upload_writes_staged_bits_during_serve(self, both,
                                                    monkeypatch):
        """Every restore of the spill-heavy serve leaves, in the pages it
        wrote, exactly the bytes that were staged."""
        seen = []
        orig = kv_tiers.HostTier.upload

        def spy(self, pages, planes):
            orig(self, pages, planes)
            for p, src in planes.items():
                rows = self.pager.pool[p][:, pages]
                seen.append(np.array_equal(_bits(rows), _bits(src)))

        monkeypatch.setattr(kv_tiers.HostTier, "upload", spy)
        _serve(both, True, _tenant_trace(both[0].vocab_size))
        assert seen and all(seen)


class TestQuantizedTier:
    def test_int8_spill_serve(self, both):
        """The spill-heavy trace on an int8 pool: the events, tier and
        cache stats and tier transfers equal JAX's, the tokens equal the
        port's int8 serve with no cache, and page bytes count the scale
        planes."""
        trace = _tenant_trace(both[0].vocab_size)
        want, _, _ = _serve(both, False, trace, quant="int8")
        got, eng, pc = _serve(both, True, trace, quant="int8")
        for key in ("events", "prefix", "tier", "flight", "pages"):
            assert got[key] == want[key], key
        ref, _, _ = _serve(both, True, trace, cached=False, quant="int8")
        assert got["tokens"] == ref["tokens"]
        assert got["tier"]["restores"] > 0
        cfg = eng.cfg
        assert pc.host_tier.page_bytes() == 2 * cfg.num_layers * 16 * (
            cfg.num_kv_heads * cfg.head_dim + 4)


# ---------------------------------------------------------------------------
# migration, the ambient meter, and the multi-tier flush
# ---------------------------------------------------------------------------


class TestMigration:
    def test_export_import_between_two_port_caches(self, both):
        """A prefix staged by one cache lands in another's tier, restores
        there on a hit, and the request's tokens equal a serve with no
        cache."""
        vocab = both[0].vocab_size
        rng = np.random.RandomState(31)
        pref = rng.randint(0, vocab, (32,)).astype(np.int32)
        prompt = np.concatenate([pref, rng.randint(0, vocab, (8,))
                                 ]).astype(np.int32)
        src, pc_src = _mk(both, True, num_pages=21)
        src.add_request(prompt, 6)
        while src._queue or src.free_slot_count() < src.slots:
            src.run_segment(STEPS, prefix_cache=pc_src)
        pc_src.host_tier.flush()
        key = next(iter(pc_src._entries))
        exp = pc_src.export_host(key)
        assert exp["pages"] == 2 and len(exp["tokens"]) == 32
        dst, pc_dst = _mk(both, True, num_pages=21)
        assert pc_dst.import_host(exp["tokens"], {
            p: exp[p] for p in pc_dst.host_tier.planes()})
        assert not pc_dst.import_host(exp["tokens"], {
            p: exp[p] for p in pc_dst.host_tier.planes()})
        assert pc_dst.host_tier.imports == 1
        imported = pc_dst.host_tier.get(exp["tokens"].tobytes())
        for p in pc_dst.host_tier.planes():
            assert np.array_equal(_bits(imported[p]), _bits(exp[p]))
            assert imported[p].data_ptr() != exp[p].data_ptr()
        rid = dst.add_request(prompt, 6)
        while dst._queue or dst.free_slot_count() < dst.slots:
            dst.run_segment(STEPS, prefix_cache=pc_dst)
        toks = dst.collect_finished()[rid]
        assert pc_dst.restores == 1
        ref, _, _ = _serve(both, True, [(prompt, 6)], cached=False,
                           num_pages=21)
        assert toks == ref["tokens"][0]

    def test_import_refusals(self, both):
        eng, flat = _mk(both, True, tiered=False)
        assert not flat.import_host(np.arange(32, dtype=np.int32), {})
        eng, pc = _mk(both, True)
        assert not pc.import_host(np.arange(8, dtype=np.int32), {})
        assert pc.export_host(b"missing") is None


class TestMeterAndFlush:
    def test_tier_meter_install_uninstall(self, both):
        """The ambient meter counts the tier's pool events and segments
        as JAX's does, and detaches clean."""
        def run(port):
            mod = kv_tiers if port else jtiers
            meter = mod.TierMeter()
            mod.install(meter)
            mod.install(meter)                # idempotent
            try:
                _serve(both, port, _tenant_trace(both[0].vocab_size,
                                                 seed=59, tenants=2))
            finally:
                mod.uninstall(meter)
            return meter
        got, want = run(True), run(False)
        assert (got.segments, got.events, got.pages) == \
            (want.segments, want.events, want.pages)
        assert got.events.get("tier_stage", 0) >= 1
        assert got.on_pool not in paged_kv.POOL_HOOKS
        assert got.on_segment not in serving.SEGMENT_HOOKS

    def test_flush_tiers_over_two_tiers(self, both):
        """One call lands two tiers' pending stages, each in its own
        store; with nothing pending it waits on nothing."""
        a = _stage_one(both, True, seed=1)
        b = _stage_one(both, True, seed=2)
        tiers = [a[1].host_tier, b[1].host_tier]
        assert kv_tiers.flush_tiers(tiers) == 2
        for (eng, pc, toks, _), t in zip((a, b), tiers):
            assert t.has(toks.tobytes()) and t.stages == 1
            assert t.flushes == 1 and t.stats()["pending_stages"] == 0
        assert kv_tiers.flush_tiers(tiers) == 0
        assert [t.flushes for t in tiers] == [1, 1]
        ja = _stage_one(both, False, seed=1)
        jb = _stage_one(both, False, seed=2)
        assert jtiers.flush_tiers([ja[1].host_tier, jb[1].host_tier]) == 2
        for (_, pc, toks, _), (_, jpc, _, _) in zip((a, b), (ja, jb)):
            assert _no_tier(pc.host_tier.stats()) == \
                jpc.host_tier.stats()

    def test_make_prefix_cache_host_tier(self, both):
        eng, _ = _mk(both, True, tiered=False)
        pc = make_prefix_cache(eng, capacity_tokens=128,
                               host_tier_pages=32)
        assert pc.capacity_pages == 8
        assert pc.host_tier.capacity_pages == 32
        assert pc.stats()["tier"]["capacity_pages"] == 32
