"""The port's generation functions against the JAX package's, on the CPU.

``paddle_tpu_torch.models.llama``'s ``sample_filter_logits``, ``generate``
(greedy, and sampled with top-k / top-p), ``beam_search_generate`` and
``prompt_kv`` against ``paddle_tpu.models.llama``'s on the same numpy
logits and weights, in float32. The filter's -inf mask must equal JAX's
and its finite values agree within 1e-6; greedy generation, sampling that
keeps one token (``top_k=1``, ``top_p=1e-6``) and beam search must be
token-identical. The sampler cannot replay ``jax.random``'s stream, so a
sampled stream is held to its support, to its seed and to the softmax of
its filtered logits instead. The filter cases mirror
tests/test_spec_sampling.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.models import llama as jl
from paddle_tpu.parallel import set_mesh
from paddle_tpu_torch.models import llama as tl
from paddle_tpu_torch.models.convert import params_from_numpy

# the filter's finite values: the same fp32 division by the temperature
FILTER_ATOL = 1e-6
# the prefix rows: fp32 prefill in another summation order
KV_TOL = dict(rtol=1e-5, atol=1e-5)
# logits: XLA's fp32 exp and rsqrt are approximations (test_torch_llama's)
LOGIT_TOL = dict(rtol=2e-4, atol=1e-5)


@pytest.fixture(scope="module")
def both(tiny_llama):
    set_mesh(None)
    cfg, params = tiny_llama
    tcfg = tl.LlamaConfig.tiny(max_seq_len=cfg.max_seq_len)
    tparams = params_from_numpy({k: np.asarray(v) for k, v in params.items()},
                                tcfg, "cpu")
    return cfg, params, tcfg, tparams


@pytest.fixture(scope="module")
def prompt(both):
    return np.random.RandomState(0).randint(
        0, both[0].vocab_size, (2, 8)).astype(np.int32)


def _filter_both(logits, temperature, **kw):
    want = np.asarray(jl.sample_filter_logits(jnp.asarray(logits),
                                              temperature, **kw))
    got = tl.sample_filter_logits(torch.from_numpy(logits), temperature,
                                  **kw).numpy()
    return want, got


class TestSampleFilterLogits:
    @pytest.mark.parametrize("temperature,kw", [
        (1.0, dict(top_k=1)), (0.7, dict(top_k=4)), (1.3, dict(top_k=64)),
        (1.0, dict(top_p=0.5)), (0.7, dict(top_p=0.9)),
        (1.3, dict(top_p=0.2)), (0.8, dict(top_k=50, top_p=0.9)),
        (0.5, dict()), (1.0, dict(top_p=1e-6))])
    def test_matches_jax(self, temperature, kw):
        """Random rows with repeated values (rounded to 0.1), so top-k's
        ties at the k-th value and the nucleus cut at a tied logit are
        exercised: the same -inf mask as JAX's, finite values within
        FILTER_ATOL."""
        rng = np.random.RandomState(7)
        logits = np.round(rng.randn(6, 97) * 2, 1).astype(np.float32)
        want, got = _filter_both(logits, temperature, **kw)
        assert ((want == -np.inf) == (got == -np.inf)).all()
        fin = np.isfinite(want)
        np.testing.assert_allclose(got[fin], want[fin], rtol=0,
                                   atol=FILTER_ATOL)

    def test_topk_truncates_exactly(self):
        rng = np.random.RandomState(3)
        logits = rng.randn(5, 33).astype(np.float32)
        for k in (1, 4, 16):
            filt = tl.sample_filter_logits(torch.from_numpy(logits), 1.0,
                                           top_k=k).numpy()
            for b in range(5):
                order = np.argsort(-logits[b], kind="stable")
                ref = logits[b] >= logits[b][order[k - 1]]
                assert ((filt[b] > -np.inf) == ref).all()
                assert np.allclose(filt[b][ref], logits[b][ref])

    def test_topp_mass_truncation(self):
        """The kept mass reaches p, and dropping the weakest survivor would
        fall below it (the nucleus is minimal)."""
        rng = np.random.RandomState(4)
        logits = rng.randn(6, 47).astype(np.float32) * 2.0
        for temp, p in ((1.0, 0.5), (0.7, 0.9), (1.3, 0.2)):
            filt = tl.sample_filter_logits(torch.from_numpy(logits), temp,
                                           top_p=p).numpy()
            for b in range(6):
                z = logits[b] / temp
                probs = np.exp(z - z.max())
                probs /= probs.sum()
                order = np.argsort(-z, kind="stable")
                keep = np.concatenate([[True],
                                       np.cumsum(probs[order])[:-1] < p])
                ref = z >= z[order[np.nonzero(keep)[0].max()]]
                sup = filt[b] > -np.inf
                assert (sup == ref).all()
                assert probs[sup].sum() >= p - 1e-6
                if sup.sum() > 1:
                    weakest = np.argmin(np.where(sup, z, np.inf))
                    assert probs[sup].sum() - probs[weakest] < p + 1e-6

    def test_temperature_scales_before_filter(self):
        logits = torch.tensor([[2.0, 1.0, 0.0, -1.0]])
        assert torch.allclose(tl.sample_filter_logits(logits, 2.0),
                              logits / 2.0)


class TestSample:
    def test_draws_follow_the_filtered_softmax(self):
        """20000 rows of one distribution in one call: each token's share
        of the draws within 0.015 of its probability (four standard
        deviations at p = 0.5), and no draw outside the support."""
        row = torch.tensor([2.0, 1.0, 0.5, 0.0, -0.5, -3.0])
        logits = row.repeat(20000, 1)
        gen = torch.Generator().manual_seed(0)
        toks = tl._sample(logits, 0.8, 4, gen, top_p=0.95)
        filt = tl.sample_filter_logits(row[None], 0.8, 4, 0.95)[0]
        p = torch.softmax(filt, dim=-1)
        freq = torch.bincount(toks, minlength=6).double() / len(toks)
        assert (freq[p == 0] == 0).all()
        assert (freq - p.double()).abs().max() <= 0.015

    def test_greedy_at_temperature_zero(self):
        logits = torch.randn(4, 31, generator=torch.Generator().manual_seed(1))
        toks = tl._sample(logits, 0.0, 5, torch.Generator().manual_seed(0))
        assert torch.equal(toks, logits.argmax(-1))


class TestGenerate:
    def test_greedy_matches_jax(self, both, prompt):
        cfg, params, tcfg, tparams = both
        want = np.asarray(jl.generate(params, prompt, cfg, max_new_tokens=8))
        got = tl.generate(tparams, prompt, tcfg, max_new_tokens=8,
                          device="cpu")
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)

    @pytest.mark.parametrize("kw", [dict(top_k=1), dict(top_p=1e-6)])
    def test_one_token_support_matches_jax(self, both, prompt, kw):
        """Sampling that keeps only the top token is greedy, whatever the
        random stream: token-identical to JAX's sampled generate and to
        greedy."""
        cfg, params, tcfg, tparams = both
        want = np.asarray(jl.generate(params, prompt, cfg, max_new_tokens=8,
                                      temperature=0.8, seed=3, **kw))
        got = tl.generate(tparams, prompt, tcfg, max_new_tokens=8,
                          temperature=0.8, seed=3, device="cpu", **kw)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            want, np.asarray(jl.generate(params, prompt, cfg,
                                         max_new_tokens=8)))

    def test_seed_replays_and_draws_stay_in_support(self, both, prompt,
                                                    monkeypatch):
        """The same seed gives the same tokens, another seed other tokens,
        and every draw lies in its step's top-k / top-p support."""
        cfg, params, tcfg, tparams = both
        kw = dict(max_new_tokens=12, temperature=1.0, top_k=20, top_p=0.9,
                  device="cpu")
        a = tl.generate(tparams, prompt, tcfg, seed=5, **kw)
        b = tl.generate(tparams, prompt, tcfg, seed=5, **kw)
        c = tl.generate(tparams, prompt, tcfg, seed=6, **kw)
        assert torch.equal(a, b) and not torch.equal(a, c)
        seen = []
        sample = tl._sample

        def spy(logits, *args, **kwargs):
            tok = sample(logits, *args, **kwargs)
            seen.append((logits, tok))
            return tok

        monkeypatch.setattr(tl, "_sample", spy)
        d = tl.generate(tparams, prompt, tcfg, seed=5, **kw)
        assert torch.equal(a, d) and len(seen) == 12
        for logits, tok in seen:
            filt = tl.sample_filter_logits(logits, 1.0, 20, 0.9)
            assert torch.isfinite(filt.gather(1, tok[:, None])).all()

    def test_validation(self, both, prompt):
        cfg, params, tcfg, tparams = both
        with pytest.raises(ValueError, match="max_new_tokens"):
            tl.generate(tparams, prompt, tcfg, max_new_tokens=0,
                        device="cpu")
        with pytest.raises(ValueError, match="cache slots"):
            tl.generate(tparams, prompt, tcfg, max_new_tokens=8, max_len=10,
                        device="cpu")
        with pytest.raises(ValueError, match="num_beams"):
            tl.beam_search_generate(tparams, prompt, tcfg, num_beams=0,
                                    device="cpu")


class TestBeamSearch:
    @pytest.fixture(scope="class")
    def eos(self, both, prompt):
        """An EOS the best beam of row 0 emits at its third token, so the
        EOS cases freeze beams."""
        cfg, params = both[:2]
        out = np.asarray(jl.beam_search_generate(params, prompt, cfg,
                                                 max_new_tokens=8,
                                                 num_beams=4))
        return int(out[0, 2])

    @pytest.mark.parametrize("use_eos", [False, True])
    @pytest.mark.parametrize("length_penalty", [0.0, 1.0, 2.0])
    def test_matches_jax(self, both, prompt, eos, use_eos, length_penalty):
        cfg, params, tcfg, tparams = both
        kw = dict(max_new_tokens=8, num_beams=4,
                  eos_token_id=eos if use_eos else None,
                  length_penalty=length_penalty)
        want = np.asarray(jl.beam_search_generate(params, prompt, cfg, **kw))
        got = tl.beam_search_generate(tparams, prompt, tcfg, device="cpu",
                                      **kw)
        assert got.shape == (2, 8) and got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)

    def test_one_beam_is_greedy(self, both, prompt):
        cfg, params, tcfg, tparams = both
        got = tl.beam_search_generate(tparams, prompt, tcfg,
                                      max_new_tokens=8, num_beams=1,
                                      device="cpu")
        want = tl.generate(tparams, prompt, tcfg, max_new_tokens=8,
                           device="cpu")
        assert torch.equal(got, want)

    def test_single_token(self, both, prompt):
        cfg, params, tcfg, tparams = both
        want = np.asarray(jl.beam_search_generate(params, prompt, cfg,
                                                  max_new_tokens=1,
                                                  num_beams=3))
        got = tl.beam_search_generate(tparams, prompt, tcfg,
                                      max_new_tokens=1, num_beams=3,
                                      device="cpu")
        np.testing.assert_array_equal(got.numpy(), want)


def test_prompt_kv_matches_jax(both):
    cfg, params, tcfg, tparams = both
    toks = np.random.RandomState(2).randint(0, cfg.vocab_size, (20,))
    want, wl = jl.prompt_kv(params, toks, cfg, max_len=24)
    got, gl = tl.prompt_kv(tparams, toks, tcfg, max_len=24, device="cpu")
    for k in ("k", "v"):
        assert tuple(got[k].shape) == want[k].shape
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   **KV_TOL)
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), **LOGIT_TOL)
