"""The port's continuous-batching engine against the JAX package's.

``paddle_tpu_torch``'s ``ServingEngine(device="cpu")`` against
``paddle_tpu``'s ``ServingEngine(paged=False)`` on the same requests and
the same numpy weights, in float32, through both drains: the windowed
loop (``run(fused=False)`` on both sides) and the fused drain (``run()``,
the default, on both sides). Tokens are identical per request, and so
are the decode ticks and chunks (the scheduling decisions are the same).
The cases mirror tests/test_serving.py.
"""

import numpy as np
import pytest
import torch

from paddle_tpu.inference.serving import ServingEngine as JaxEngine
from paddle_tpu.parallel import set_mesh
from paddle_tpu_torch.inference.serving import ServingEngine
from paddle_tpu_torch.models import llama as tl
from paddle_tpu_torch.models.convert import params_from_numpy


@pytest.fixture(scope="module")
def both(tiny_llama):
    set_mesh(None)
    cfg, params = tiny_llama
    tcfg = tl.LlamaConfig.tiny(max_seq_len=cfg.max_seq_len)
    tparams = params_from_numpy({k: np.asarray(v) for k, v in params.items()},
                                tcfg, "cpu")
    return cfg, params, tcfg, tparams


def _serve_both(both, reqs, fused=False, **kw):
    """Serve ``reqs`` on both engines through the windowed loop (or, with
    ``fused``, the fused drain); returns the port's results and asserts
    they equal the reference's, request by request."""
    cfg, params, tcfg, tparams = both
    ref = JaxEngine(cfg, params, paged=False, **kw)
    eng = ServingEngine(tcfg, tparams, device="cpu", **kw)
    ref_ids = [ref.add_request(p, n) for p, n in reqs]
    ids = [eng.add_request(p, n) for p, n in reqs]
    want = ref.run(fused=fused)
    got = eng.run(fused=fused)
    assert ids == ref_ids
    assert got == want
    assert eng.last_run_chunks == ref.last_run_chunks
    assert eng.last_run_ticks == ref.last_run_ticks
    assert set(eng.last_latencies) == set(got)
    return got


def _prompts(rng, vocab, shapes):
    return [(rng.randint(0, vocab, (l,)).astype(np.int32), n)
            for l, n in shapes]


class TestAgainstReference:
    def test_mixed_lengths(self, both):
        reqs = _prompts(np.random.RandomState(0), both[0].vocab_size,
                        [(5, 7), (12, 3), (30, 9), (3, 12), (17, 5), (8, 8),
                         (25, 4)])
        out = _serve_both(both, reqs, slots=3, max_len=96, chunk=4,
                          prompt_buckets=(8, 16, 32))
        assert [len(out[rid]) for rid in sorted(out)] == [n for _, n in reqs]

    def test_more_requests_than_slots(self, both):
        rng = np.random.RandomState(1)
        reqs = _prompts(rng, both[0].vocab_size, [(6, 5)] * 7)
        out = _serve_both(both, reqs, slots=2, max_len=96, chunk=8,
                          prompt_buckets=(16,))
        assert all(len(v) == 5 for v in out.values())

    def test_single_token_request(self, both):
        out = _serve_both(both, [(np.arange(4, dtype=np.int32), 1)],
                          slots=2, max_len=96, prompt_buckets=(8,))
        assert [len(v) for v in out.values()] == [1]

    def test_full_window_request(self, both):
        """prompt + generation fill max_len exactly: the finished slot sits
        at pos == max_len while the other slot decodes on."""
        rng = np.random.RandomState(2)
        reqs = _prompts(rng, both[0].vocab_size, [(30, 19), (6, 40)])
        _serve_both(both, reqs, slots=2, max_len=48, chunk=4,
                    prompt_buckets=(8, 32))

    def test_eos_freeze(self, both):
        """EOS mid-generation and EOS at the prefill token: the slot
        freezes on the device and its queue successor takes it."""
        cfg, params, tcfg, tparams = both
        rng = np.random.RandomState(5)
        reqs = _prompts(rng, cfg.vocab_size,
                        [(6 + i, 8) for i in range(5)])
        probe = ServingEngine(tcfg, tparams, slots=2, max_len=96, chunk=4,
                              prompt_buckets=(16,), device="cpu")
        ids = [probe.add_request(p, n) for p, n in reqs]
        plain = probe.run(fused=False)
        for eos in (plain[ids[0]][2], plain[ids[1]][0]):
            out = _serve_both(both, reqs, slots=2, max_len=96, chunk=4,
                              prompt_buckets=(16,), eos_token_id=eos)
            for rid in ids:
                full = plain[rid]
                want = full[:full.index(eos) + 1] if eos in full else full
                assert out[rid] == want


class TestFusedAgainstReference:
    """The cases above through the fused drain on both sides (EOS:
    tests/test_torch_segments.py)."""

    def test_mixed_lengths(self, both):
        reqs = _prompts(np.random.RandomState(0), both[0].vocab_size,
                        [(5, 7), (12, 3), (30, 9), (3, 12), (17, 5), (8, 8),
                         (25, 4)])
        out = _serve_both(both, reqs, fused=True, slots=3, max_len=96,
                          chunk=4, prompt_buckets=(8, 16, 32))
        assert [len(out[rid]) for rid in sorted(out)] == [n for _, n in reqs]

    def test_single_token_request(self, both):
        out = _serve_both(both, [(np.arange(4, dtype=np.int32), 1)],
                          fused=True, slots=2, max_len=96,
                          prompt_buckets=(8,))
        assert [len(v) for v in out.values()] == [1]

    def test_full_window_request(self, both):
        """prompt + generation fill max_len exactly: the finished slot sits
        at pos == max_len while the other slot decodes on."""
        rng = np.random.RandomState(2)
        reqs = _prompts(rng, both[0].vocab_size, [(30, 19), (6, 40)])
        _serve_both(both, reqs, fused=True, slots=2, max_len=48, chunk=4,
                    prompt_buckets=(8, 32))

    def test_more_requests_than_slots(self, both):
        reqs = _prompts(np.random.RandomState(1), both[0].vocab_size,
                        [(6, 5), (4, 1), (9, 5), (6, 1), (3, 7), (8, 2)])
        _serve_both(both, reqs, fused=True, slots=2, max_len=96, chunk=8,
                    prompt_buckets=(16,))


class TestValidation:
    def test_oversized_request_rejected(self, both):
        cfg, params, tcfg, tparams = both
        eng = ServingEngine(tcfg, tparams, slots=2, max_len=96,
                            prompt_buckets=(64,), device="cpu")
        with pytest.raises(ValueError, match="max_len"):
            eng.add_request(np.zeros((60,), np.int32), 64)  # 60+63 > 96
        with pytest.raises(ValueError, match="bucket"):
            eng.add_request(np.zeros((65,), np.int32), 2)

    def test_no_bucket_fits(self, both):
        cfg, params, tcfg, tparams = both
        with pytest.raises(ValueError, match="bucket"):
            ServingEngine(tcfg, tparams, max_len=16, prompt_buckets=(32,),
                          device="cpu")

    def test_params_on_another_dtype_rejected(self, both):
        cfg, params, tcfg, tparams = both
        half = {k: v.to(torch.bfloat16) for k, v in tparams.items()}
        with pytest.raises(ValueError, match="bfloat16"):
            ServingEngine(tcfg, half, device="cpu")

    @pytest.mark.parametrize("paged", [False, True])
    def test_cuda_engine_refuses_head_dims_the_kernels_do_not_take(
            self, monkeypatch, paged):
        """An engine on the card checks its heads against the decode and
        paged kernels' set (``check_heads``) at build, before any tensor
        is made, so the check runs here with the device's resolution
        stubbed; a quantized engine attends through the gather and is
        not held to it."""
        from paddle_tpu_torch.inference import serving

        monkeypatch.setattr(serving, "resolve_device",
                            lambda d: torch.device("cuda", 0))
        for hidden, heads, kv in ((80, 4, 4), (272, 2, 2), (64, 16, 1)):
            cfg = tl.LlamaConfig.tiny(hidden_size=hidden, num_heads=heads,
                                      num_kv_heads=kv)
            with pytest.raises(ValueError, match="head_dim|query heads"):
                ServingEngine(cfg, {}, max_len=64, prompt_buckets=(32,),
                              paged=paged, device="cuda")

    def test_check_heads_takes_every_dim_of_8s_to_128(self):
        from paddle_tpu_torch.ops.kernels import decode_attention as da

        for D in range(8, 129, 8):
            da.check_heads(8, 2, D)
            assert da.padded_dim(D) == (32 if D <= 32 else 64 if D <= 64
                                        else 128)
        da.check_heads(8, 8, tl.LlamaConfig.cpu_small().head_dim)
        for D in (4, 12, 20, 100, 136, 256):
            with pytest.raises(ValueError, match="head_dim"):
                da.check_heads(8, 8, D)
            assert da.padded_dim(D) == 0
        for nH, Hkv in ((16, 1), (12, 8)):
            with pytest.raises(ValueError, match="query heads"):
                da.check_heads(nH, Hkv, 64)
