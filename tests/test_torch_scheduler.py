"""The port's online scheduler against the JAX package's, on the CPU.

``paddle_tpu_torch.inference.scheduler.OnlineScheduler`` over the port's
paged engine and ``paddle_tpu.inference.scheduler.OnlineScheduler`` over
the JAX one serve the same trace from the same numpy weights, in float32.
With every arrival at t = 0 (``staggered_arrivals(..., gap=0.0)``) the
schedule does not depend on the clock, so the generated tokens, the
segment and step counts and the paging statistics must be identical,
with and without a paged prefix cache and through a warm pass. The trace
generators and the nearest-rank percentile are held against the JAX
package's too.
"""

import numpy as np
import pytest
import torch

from paddle_tpu.inference import scheduler as jsched
from paddle_tpu.inference.prefix_cache import PagedPrefixCache as JaxCache
from paddle_tpu.inference.serving import ServingEngine as JaxEngine
from paddle_tpu.observability.metrics import percentile as jax_percentile
from paddle_tpu.parallel import set_mesh
from paddle_tpu_torch.inference import scheduler as tsched
from paddle_tpu_torch.inference.prefix_cache import PagedPrefixCache
from paddle_tpu_torch.inference.serving import ServingEngine
from paddle_tpu_torch.models import llama as tl
from paddle_tpu_torch.models.convert import params_from_numpy

ENGINE = dict(slots=3, max_len=96, chunk=8, prompt_buckets=(16, 32),
              paged=True, page_size=16)


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


def _trace(vocab, prefix_len=0, n=7, seed=0):
    prefix = (np.random.RandomState(seed + 100).randint(
        0, vocab, (prefix_len,)).astype(np.int32) if prefix_len else None)
    return tsched.staggered_arrivals(seed, n, 0.0, vocab,
                                     prompt_lens=(5, 9, 14),
                                     gen_lens=(4, 7, 11), prefix=prefix)


def _serve(both, port: bool, arrivals, cache_pages=None, warm=False,
           **sched_kw):
    cfg, params, tcfg, tparams = both
    if port:
        eng = ServingEngine(tcfg, tparams, device="cpu", **ENGINE)
        pc = (PagedPrefixCache(eng.pager, capacity_pages=cache_pages)
              if cache_pages else None)
        mod = tsched
    else:
        eng = JaxEngine(cfg, params, **ENGINE)
        pc = (JaxCache(eng.pager, capacity_pages=cache_pages)
              if cache_pages else None)
        mod = jsched
    arr = [mod.Arrival(a.t, a.prompt, a.max_new_tokens) for a in arrivals]
    sched = mod.OnlineScheduler(eng, seg_steps=16, prefix_cache=pc,
                                **sched_kw)
    rep = sched.serve(arr, warm=warm)
    out = {"results": sched.results(), "segments": rep.segments,
           "ticks": rep.ticks, "n_requests": rep.n_requests,
           "total_tokens": rep.total_tokens,
           "backpressure_events": rep.backpressure_events,
           "backpressure_pages": rep.backpressure_pages,
           "pages": rep.pages, "prefix": rep.prefix,
           "slot_occupancy": rep.slot_occupancy,
           "prefix_hits": [r["prefix_hit_len"] for r in rep.per_request]}
    held = pc.pages_held if pc is not None else 0
    assert eng.pager.leak_report(expected_held=held) == []
    return out, rep


class TestAgainstReference:
    @pytest.mark.parametrize("cache_pages,warm", [(None, False),
                                                  (None, True),
                                                  (32, False), (32, True)])
    def test_serve_matches(self, both, cache_pages, warm):
        vocab = both[0].vocab_size
        arrivals = _trace(vocab, prefix_len=16 if cache_pages else 0)
        want, _ = _serve(both, False, arrivals, cache_pages, warm)
        got, rep = _serve(both, True, arrivals, cache_pages, warm)
        assert got == want
        assert rep.n_requests == len(arrivals)
        assert [len(got["results"][rid]) for rid in sorted(got["results"])
                ] == [a.max_new_tokens for a in arrivals]
        if cache_pages:
            assert rep.prefix["hits"] >= 1
        for r in rep.per_request:
            assert 0.0 <= r["ttft_s"] <= r["e2e_s"]
        assert rep.throughput_tok_s > 0
        assert rep.ttft_p50_s <= rep.ttft_p99_s
        assert rep.e2e_p50_s <= rep.e2e_p99_s

    def test_bounded_queue_refuses_and_hints(self, both):
        arrivals = _trace(both[0].vocab_size, n=8, seed=3)
        want, _ = _serve(both, False, arrivals, max_queue=2)
        got, rep = _serve(both, True, arrivals, max_queue=2)
        assert got == want
        assert rep.backpressure_events > 0
        assert 1e-3 <= rep.retry_after_s <= 60.0


class TestTraces:
    def test_generators_match(self):
        prefix = np.arange(7, dtype=np.int32)
        pairs = [(tsched.poisson_arrivals(5, 6, 3.0, 100, prefix=prefix),
                  jsched.poisson_arrivals(5, 6, 3.0, 100, prefix=prefix)),
                 (tsched.staggered_arrivals(2, 6, 0.25, 100),
                  jsched.staggered_arrivals(2, 6, 0.25, 100))]
        pairs.append((tsched.scale_rate(pairs[0][0], 4.0),
                      jsched.scale_rate(pairs[0][1], 4.0)))
        for got, want in pairs:
            assert len(got) == len(want)
            for a, b in zip(got, want):
                assert (a.t, a.max_new_tokens) == (b.t, b.max_new_tokens)
                np.testing.assert_array_equal(a.prompt, b.prompt)
        with pytest.raises(ValueError, match="rate"):
            tsched.poisson_arrivals(0, 1, 0.0, 10)
        with pytest.raises(ValueError, match="factor"):
            tsched.scale_rate(pairs[1][0], 0.0)

    @pytest.mark.parametrize("q", [0.0, 0.5, 0.9, 0.99, 1.0])
    def test_percentile_matches(self, q):
        rng = np.random.RandomState(int(q * 100))
        for n in (0, 1, 2, 7, 100):
            xs = list(rng.exponential(1.0, n))
            assert tsched.percentile(xs, q) == jax_percentile(xs, q)
