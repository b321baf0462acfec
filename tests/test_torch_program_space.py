"""The port's program space, key accounting, coverage passes and
ahead-of-time warmup against the JAX package's, on the CPU.

For nine engine configurations (contiguous, paged, int8, fp8, quality
digests, chunked, speculative, sampled and ``seq_parallel=2``) built on
both packages from the same numpy weights: ``default_envelope``,
``program_space(envelope)`` under several envelopes and
``journal.describe_envelope`` equal, tuple for tuple. Then the same 32
mixed requests served on both (the contiguous windowed loop and fused
drain, the paged engine's segments with a prefix cache): ``prog_key_hits``
and ``cache_info()["keys"]`` equal. The coverage passes on the port's
sources and engines: the registry-only lint clean, the envelope replay
equal to the enumeration, and, after ``aot_warmup`` and a serve, no
unenumerated key and the JAX engine's unreached set. Last the warmup's
contract on the port: the engine idle and unchanged after it (page table,
slot state, pool statistics, queue, prefix cache; ``prog_key_hits``
zeroed), a following serve equal to a cold engine's in tokens and event
log, and ``analysis.recompile``'s budget: zero inside the envelope, a key
outside it counted and refused.
"""

import numpy as np
import pytest
import torch

from paddle_tpu.analysis import coverage as jcov
from paddle_tpu.inference.prefix_cache import PagedPrefixCache as JPaged
from paddle_tpu.inference.serving import ServingEngine as JaxEngine
from paddle_tpu.observability import journal as jjournal
from paddle_tpu.parallel import set_mesh
from paddle_tpu_torch.analysis import coverage as tcov
from paddle_tpu_torch.analysis import recompile
from paddle_tpu_torch.inference import program_space as tps
from paddle_tpu_torch.inference.prefix_cache import PagedPrefixCache
from paddle_tpu_torch.inference.serving import ServingEngine
from paddle_tpu_torch.models import llama as tl
from paddle_tpu_torch.models.convert import params_from_numpy
from paddle_tpu_torch.observability import journal as tjournal


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


BASE = dict(slots=4, max_len=96, prompt_buckets=(8, 16, 32))
PAGED = dict(BASE, paged=True, page_size=8)
CONFIGS = {
    "dense": BASE,
    "paged": PAGED,
    "int8": dict(PAGED, quant="int8"),
    "fp8": dict(PAGED, quant="fp8"),
    "digest": dict(PAGED, quality_digest=True),
    "chunked": dict(PAGED, chunked_prefill=True, prefill_chunks=(8, 16)),
    "speculative": dict(PAGED, speculative=2),
    "sampled": dict(PAGED, sampling={"temperature": 0.8, "top_k": 8}),
    "seq_parallel": dict(PAGED, seq_parallel=2, long_buckets=(64,),
                         prefill_chunks=(8,)),
}


def _engine(both, port, **kw):
    cfg, params, tcfg, tparams = both
    if port:
        return ServingEngine(tcfg, tparams, device="cpu", **kw)
    return JaxEngine(cfg, params, **kw)


def _envelopes(eng):
    """The default envelope and narrower ones: a declared scheduler budget
    and prefix block, no resume, an offline batch, explicit n_pads."""
    return [eng.default_envelope(),
            eng.default_envelope(seg_steps=(4, 16), prefix_block=8),
            eng.default_envelope(seg_steps=(8,), prefix_block=16,
                                 resume=False),
            eng.default_envelope(seg_steps=(2, 32), offline_batch=3),
            tps.WorkloadEnvelope(max_prompt=20, max_new_tokens=9,
                                 seg_steps=(12,), n_pads=(2, 4),
                                 prefix_block=8)]


def _jenv(env):
    from paddle_tpu.inference.program_space import WorkloadEnvelope

    return WorkloadEnvelope(**tjournal.describe_envelope(env))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_program_space_equals_jax(both, name):
    kw = CONFIGS[name]
    jeng, teng = _engine(both, False, **kw), _engine(both, True, **kw)
    assert tjournal.describe_envelope(teng.default_envelope()) == \
        jjournal.describe_envelope(jeng.default_envelope())
    for env in _envelopes(teng):
        jenv = _jenv(env)
        assert tjournal.describe_envelope(env) == \
            jjournal.describe_envelope(jenv)
        got, want = teng.program_space(env), jeng.program_space(jenv)
        assert got == want, name
        assert tps.PROGRAM_SPACE.enumerate(teng, env) == \
            frozenset().union(*want.values())
        # the replay of the admission arithmetic reaches exactly the
        # enumeration, through the port engine's own helpers
        assert tcov.check_envelope(teng, env) == []
        assert tcov.reachable_keys_replay(teng, env) == \
            jcov.reachable_keys_replay(jeng, jenv)


def test_registry_keys_and_families(both):
    from paddle_tpu.inference import program_space as jps

    assert tps.PROGRAM_SPACE.families() == jps.PROGRAM_SPACE.families()
    assert tps.FAMILY_TAGS == jps.FAMILY_TAGS
    for fam in tps.PROGRAM_SPACE.families():
        t, j = tps.PROGRAM_SPACE.family(fam), jps.PROGRAM_SPACE.family(fam)
        assert (t.tag, t.axes, t.budget_program) == \
            (j.tag, j.axes, j.budget_program)
        key = t.key(**{a: i + 3 for i, a in enumerate(t.axes)})
        assert key == j.key(**{a: i + 3 for i, a in enumerate(j.axes)})
        assert tps.PROGRAM_SPACE.family_of(key) == fam
    assert tps.PROGRAM_SPACE.family_of(("nope", 1)) is None
    with pytest.raises(TypeError, match="takes axes"):
        tps.PROGRAM_SPACE.key("pseg", n_pad=4)
    with pytest.raises(ValueError, match="max_prompt"):
        tps.WorkloadEnvelope(max_prompt=0, max_new_tokens=1, seg_steps=(4,))
    with pytest.raises(ValueError, match="seg_steps"):
        tps.WorkloadEnvelope(max_prompt=4, max_new_tokens=1, seg_steps=())
    env = tps.WorkloadEnvelope(max_prompt=30, max_new_tokens=9,
                               seg_steps=(8, 4, 8))
    assert env.seg_steps == (4, 8)
    assert env.admit_lengths((8, 16, 32)) == (1, 32)


def test_registry_only_lint_clean_and_catches():
    assert tcov.lint_registry_only() == []
    bad = tcov.lint_source("k = ('pseg', 4, 32, 8)\n'pseg' in s\n", "m")
    assert len(bad) == 1 and "m:1" in bad[0]


# ---------------------------------------------------------------------------
# key accounting over the 32 mixed requests
# ---------------------------------------------------------------------------

def _mixed(vocab, n=32, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, vocab, (int(rng.randint(3, 33)),)).astype(
        np.int32), int(rng.randint(1, 21))) for _ in range(n)]


def _segments(eng, reqs, cache, steps=8):
    for p, g in reqs:
        eng.add_request(p, g)
    evs = []
    while eng._queue or eng.free_slot_count() < eng.slots:
        evs.append(eng.run_segment(steps, prefix_cache=cache, now=0.0))
    return evs, eng.collect_finished()


@pytest.fixture(scope="module")
def served(both):
    """The 32 mixed requests on both packages: the contiguous engine's
    windowed loop and fused drain, and the paged engine's segments over a
    prefix cache (a shared 16-token prefix on half the requests, so hits
    bucket the suffix). The JAX serves run once for the module."""
    cfg = both[0]
    reqs = _mixed(cfg.vocab_size)
    pref = np.arange(16, dtype=np.int32) + 5
    preqs = [(np.concatenate([pref, p[:16]]) if i % 2 else p, g)
             for i, (p, g) in enumerate(reqs)]
    out = {"reqs": reqs, "preqs": preqs}
    for port in (False, True):
        side = {}
        for fused in (False, True):
            eng = _engine(both, port, **BASE)
            for p, g in reqs:
                eng.add_request(p, g)
            side["dense_fused" if fused else "dense"] = (
                eng, eng.run(fused=fused))
        eng = _engine(both, port, **PAGED)
        pc = (PagedPrefixCache if port else JPaged)(eng.pager,
                                                    capacity_pages=24)
        side["paged"] = (eng, _segments(eng, preqs, pc), pc)
        out["port" if port else "jax"] = side
    return out


@pytest.mark.parametrize("path", ["dense", "dense_fused", "paged"])
def test_prog_key_hits_and_cache_info_equal(served, path):
    j, t = served["jax"][path], served["port"][path]
    assert t[1] == j[1]
    assert t[0].prog_key_hits == j[0].prog_key_hits
    assert t[0].cache_info() == j[0].cache_info()
    # the fused drain is one key; the other paths dispatch many
    assert sum(t[0].prog_key_hits.values()) >= (1 if path == "dense_fused"
                                                 else 10)


def test_paged_serve_reaches_suffix_buckets(served):
    eng = served["port"]["paged"][0]
    widths = {k[2] for k in eng.prog_key_hits}
    assert len(widths) > 1, eng.prog_key_hits


# ---------------------------------------------------------------------------
# coverage after a warmed serve
# ---------------------------------------------------------------------------

def test_coverage_after_warmed_serve_equals_jax(both, served):
    """Both engines warmed under the same tight envelope, then the same
    segments: no unenumerated key on either, the same unreached keys and
    the same usage."""
    preqs = served["preqs"][:12]
    reps = {}
    for port in (False, True):
        eng = _engine(both, port, **PAGED)
        env = eng.default_envelope(seg_steps=(8,), prefix_block=8)
        pc = (PagedPrefixCache if port else JPaged)(eng.pager,
                                                    capacity_pages=24)
        fams = eng.aot_warmup(env, prefix_cache=pc)
        assert eng.prog_key_hits == {}
        assert {f: r["keys"] for f, r in fams.items()} == \
            {f: len(v) for f, v in eng.program_space(env).items()}
        _segments(eng, preqs, pc)
        cov = (tcov if port else jcov).coverage_report(eng, env, lint=False)
        reps[port] = (eng, cov)
    (jeng, jc), (teng, tc) = reps[False], reps[True]
    assert tc.ok and tc.unenumerated == [] and jc.unenumerated == []
    assert [k for k, _ in tc.unreached] == [k for k, _ in jc.unreached]
    assert tc.program_space_size == jc.program_space_size
    assert tc.families == jc.families
    assert teng.prog_key_hits == jeng.prog_key_hits
    assert teng.aot_warmup_s > 0 and "UNENUMERATED" not in tc.format()


def test_coverage_names_an_unenumerated_key(both):
    eng = _engine(both, True, **PAGED)
    env = eng.default_envelope(seg_steps=(8,))
    eng.aot_warmup(env)
    eng.add_request(np.arange(5, dtype=np.int32), 3)
    eng.run_segment(12, now=0.0)              # a budget outside the envelope
    cov = tcov.coverage_report(eng, env, lint=False)
    assert not cov.ok
    assert cov.unenumerated == [("pseg", 4, 32, 12)]
    assert "UNENUMERATED KEY" in cov.format()


def test_aot_audit(both):
    eng = _engine(both, True, **CONFIGS["chunked"])
    env = eng.default_envelope(seg_steps=(16,), prefix_block=8)
    rep = tcov.aot_audit(eng, env)
    assert rep["program_space_keys"] == sum(
        len(v) for v in eng.program_space(env).values())
    assert set(rep["families"]) == {"cseg"}


# ---------------------------------------------------------------------------
# the warmup's contract
# ---------------------------------------------------------------------------

def _state(eng):
    """Everything a warmup must leave as it found it."""
    st = {k: (None if getattr(eng, k) is None
              else getattr(eng, k).clone())
          for k in ("_pos", "_nxt", "_rem", "_hist", "_hstart", "_rng")}
    st["rem_host"] = list(eng._rem_host)
    st["active"] = list(eng._active)
    st["queue"] = list(eng._queue)
    st["fetches"] = eng.fetches
    if eng.paged:
        st["table"] = eng.pager.page_table.clone()
        st["pages"] = eng.pager.stats()
        st["free"] = eng.pager.pages_free
    return st


def _same_state(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], torch.Tensor):
            assert torch.equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


def _small_env(eng):
    kw = dict(seg_steps=(8,), prefix_block=8)
    if not eng.paged:
        kw["offline_batch"] = 2
    env = eng.default_envelope(**kw)
    return tps.WorkloadEnvelope(
        max_prompt=env.max_prompt, max_new_tokens=min(env.max_new_tokens,
                                                      16),
        seg_steps=env.seg_steps, prefix_block=env.prefix_block,
        offline_batch=env.offline_batch)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_warmup_leaves_engine_idle_and_serves_as_cold(both, name):
    """Every family's warmup runs on the port, leaves the engine as it
    was, and the next serve inside the envelope equals a cold engine's
    (events, tokens) and meets no key it has not run."""
    kw = CONFIGS[name]
    cold, warm = _engine(both, True, **kw), _engine(both, True, **kw)
    env = _small_env(warm)
    pcs = [PagedPrefixCache(e.pager, capacity_pages=16) if e.paged
           else None for e in (cold, warm)]
    before = _state(warm)
    stats = pcs[1].stats() if pcs[1] is not None else None
    fams = warm.aot_warmup(env, prefix_cache=pcs[1])
    _same_state(before, _state(warm))
    assert warm.prog_key_hits == {}
    assert (pcs[1].stats() if pcs[1] is not None else None) == stats
    assert set(fams) == set(warm.program_space(env))
    assert set(warm._progs) == set().union(*warm.program_space(env).values())
    reqs = _mixed(both[0].vocab_size, n=8, seed=3)
    if kw.get("seq_parallel"):
        reqs[0] = (np.arange(50, dtype=np.int32) % 200, 4)
    want = _segments(cold, reqs, pcs[0])
    with recompile.enforce_zero_compiles(name) as cw:
        got = _segments(warm, reqs, pcs[1])
    assert got == want
    assert cw.as_dict() == {"loads": 0, "tickets": 0, "unenumerated": 0}
    if warm.paged:
        assert warm.pager.leak_report(
            expected_held=pcs[1].physical_pages_held()) == []


def test_budget_refuses_a_key_outside_the_envelope(both):
    eng = _engine(both, True, **PAGED)
    eng.aot_warmup(eng.default_envelope(seg_steps=(8,)))
    eng.add_request(np.arange(6, dtype=np.int32), 4)
    with pytest.raises(recompile.CompileBudgetError, match="unenumerated"):
        with recompile.enforce_zero_compiles("off-envelope"):
            eng.run_segment(6, now=0.0)
    with recompile.CompileWatch() as cw:
        while eng._queue or eng.free_slot_count() < eng.slots:
            eng.run_segment(6, now=0.0)    # run once: no longer cold
    assert cw.compiles == 0


def test_windowed_warmup_and_refusals(both):
    """``warmup()`` runs the windowed keys on a contiguous engine (and is
    a no-op on a paged one); ``aot_warmup`` refuses a busy engine."""
    eng = _engine(both, True, **BASE)
    jeng = _engine(both, False, **BASE)
    eng.warmup()
    jeng.warmup()
    assert eng.cache_info() == jeng.cache_info()
    assert eng.prog_key_hits == jeng.prog_key_hits
    assert not eng.decode_kernel_active()
    paged = _engine(both, True, **PAGED)
    paged.warmup()
    assert paged.cache_info()["keys"] == []
    paged.add_request(np.arange(4, dtype=np.int32), 2)
    with pytest.raises(RuntimeError, match="non-idle"):
        paged.aot_warmup()
