"""The port's kernels on the card, against their plain versions.

Every test here needs an NVIDIA GPU: each is marked ``cuda`` and skips
(through the ``cuda`` fixture) where ``torch.cuda.is_available()`` is
false, as on a CPU-only machine. The machine with the card has no JAX, so
run this file there without the suite's conftest (which imports JAX):

    python3 -m pytest --noconftest -o "markers=cuda: needs an NVIDIA GPU" \
        tests/test_torch_cuda.py -q

This file imports nothing of JAX or of ``paddle_tpu``.
"""

import math

import numpy as np
import pytest
import torch

from paddle_tpu_torch.models import llama
from paddle_tpu_torch.ops.kernels import decode_attention as da
from paddle_tpu_torch.ops.kernels import paged_attention as pa
from paddle_tpu_torch.ops.kernels import tick_fusion as tf

pytestmark = pytest.mark.cuda

# kernel against plain on the same inputs: fp32 sums run in another order
# (1e-5); bf16 to two ulps of the output (rtol 1.6e-2) with one ulp at the
# inputs' magnitude as atol
TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1.6e-2, 2e-2)}


@pytest.fixture
def cuda():
    """The card, decided when a test runs (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


def _randn(gen, *shape, dtype, scale=1.0):
    return (torch.randn(*shape, generator=gen, device=gen.device)
            * scale).to(dtype)


def _close(out, ref, dtype, atol_floor=0.0):
    rtol, atol = TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), rtol=rtol,
                               atol=max(atol, atol_floor))


class TestDecodeAttention:
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("nH,Hkv,D,max_len", [
        (12, 12, 64, 384),    # the serving shape
        (8, 4, 64, 37),       # GQA, a window that is no multiple of 32
        (12, 4, 128, 100),    # rep 3
        (32, 8, 128, 2048),   # llama-width GQA
        (8, 1, 128, 65),      # rep 8, one kv head
    ])
    def test_matches_plain(self, cuda, dtype, nH, Hkv, D, max_len):
        """Positions 0, max_len - 1, a frozen slot at max_len (clamped to
        the whole window) and interior ones; the cache is one layer's view
        of a stacked [L, ...] cache, at a non-zero offset."""
        gen = torch.Generator(device=cuda).manual_seed(nH * D + max_len)
        B = 6
        kc = _randn(gen, 2, B, max_len, Hkv, D, dtype=dtype)
        vc = _randn(gen, 2, B, max_len, Hkv, D, dtype=dtype)
        q = _randn(gen, B, nH, D, dtype=dtype)
        pos = torch.tensor([0, max_len - 1, max_len // 2, 1, 31 % max_len,
                            max_len], dtype=torch.int32, device=cuda)
        before = da.ragged_decode_attention.launches
        out = da.ragged_decode_attention(q, kc[1], vc[1], pos)
        torch.cuda.synchronize()
        assert da.ragged_decode_attention.launches == before + 1
        ref = da.ragged_decode_attention_plain(
            q, kc[1], vc[1], pos.clamp(max=max_len - 1))
        _close(out, ref, dtype)

    def test_rejects_what_it_does_not_take(self, cuda):
        q = torch.zeros(2, 4, 96, device=cuda)
        kc = torch.zeros(2, 16, 4, 96, device=cuda)
        pos = torch.zeros(2, dtype=torch.int32, device=cuda)
        with pytest.raises(ValueError, match="head_dim"):
            da.ragged_decode_attention(q, kc, kc, pos)
        q = torch.zeros(2, 32, 64, device=cuda)
        kc = torch.zeros(2, 16, 2, 64, device=cuda)
        with pytest.raises(ValueError, match="query heads"):
            da.ragged_decode_attention(q, kc, kc, pos)
        kc = torch.zeros(2, 4, 16, 64, device=cuda).transpose(1, 2)
        with pytest.raises(ValueError, match="contiguous"):
            da.ragged_decode_attention(q[:, :4], kc, kc, pos)


class TestPagedAttention:
    """``ragged_paged_attention`` against its plain version (gather the
    slot's pages, then dense attention) on a shuffled page table. The
    plain version scales the fp32 scores where the kernel pre-scales q in
    its own dtype; in bf16 at D 128 (a scale that is no power of two)
    that is about one bf16 ulp of a score, inside the bf16 tolerance."""

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("case", [
        # name, B, Tq, nH, Hkv, D, max_pages, ctx, q_len
        ("decode", 8, 1, 12, 12, 64, 24,
         [0, 383, 384, 17, 100, 255, 1, 16], None),
        ("prefill_ctx0", 1, 256, 12, 12, 64, 24, [0], None),
        ("prefill_ctx192", 1, 256, 12, 12, 64, 24, [192], None),
        ("mixed_q_len", 4, 8, 4, 2, 64, 8, [0, 5, 37, 100], [1, 8, 3, 1]),
        ("gqa_decode", 8, 1, 32, 8, 128, 128,
         [0, 2047, 2048, 5, 700, 1023, 1024, 64], None),
        ("rep8_prefill", 2, 12, 8, 1, 128, 6, [3, 40], [12, 5]),
    ])
    def test_matches_plain(self, cuda, dtype, case):
        name, B, Tq, nH, Hkv, D, max_pages, ctx, q_len = case
        psz = 16
        gen = torch.Generator(device=cuda).manual_seed(B * Tq + nH)
        P = B * max_pages + 3
        kp = _randn(gen, 2, P, psz, Hkv, D, dtype=dtype)
        vp = _randn(gen, 2, P, psz, Hkv, D, dtype=dtype)
        q = _randn(gen, B, Tq, nH, D, dtype=dtype)
        pt = (torch.randperm(P - 1, generator=gen, device=cuda)[
            :B * max_pages] + 1).to(torch.int32).reshape(B, max_pages)
        ctx_t = torch.tensor(ctx, dtype=torch.int32, device=cuda)
        ql = (None if q_len is None
              else torch.tensor(q_len, dtype=torch.int32, device=cuda))
        before = pa.ragged_paged_attention.launches
        out = pa.ragged_paged_attention(q, kp[1], vp[1], pt, ctx_t, ql)
        torch.cuda.synchronize()
        assert pa.ragged_paged_attention.launches == before + 1
        ref = pa.ragged_paged_attention_plain(q, kp[1], vp[1], pt, ctx_t)
        assert torch.isfinite(out.float()).all()
        rows = [Tq] * B if q_len is None else q_len
        for b in range(B):  # rows past q_len are padding
            _close(out[b, :rows[b]], ref[b, :rows[b]], dtype)

    def test_rejects_what_it_does_not_take(self, cuda):
        pt = torch.zeros(2, 4, dtype=torch.int32, device=cuda)
        ctx = torch.zeros(2, dtype=torch.int32, device=cuda)

        def call(Tq=1, nH=4, Hkv=2, D=64, psz=16):
            q = torch.zeros(2, Tq, nH, D, device=cuda)
            kp = torch.zeros(9, psz, Hkv, D, device=cuda)
            return pa.ragged_paged_attention(q, kp, kp, pt, ctx)

        with pytest.raises(ValueError, match="head_dim"):
            call(D=96)
        with pytest.raises(ValueError, match="query heads"):
            call(nH=32, Hkv=2)
        with pytest.raises(ValueError, match="page_size"):
            call(psz=12)
        with pytest.raises(ValueError, match="Tq"):
            call(Tq=257)


class TestTickFusion:
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("H", [768, 4096, 100])
    def test_norms_match_plain(self, cuda, dtype, H):
        gen = torch.Generator(device=cuda).manual_seed(H)
        x = _randn(gen, 8, H, dtype=dtype, scale=2.0)
        y = _randn(gen, 8, H, dtype=dtype, scale=2.0)
        w = (1 + 0.1 * torch.randn(H, generator=gen, device=cuda)).to(dtype)
        n0 = tf.fused_rms_norm.launches, tf.fused_add_rms_norm.launches
        _close(tf.fused_rms_norm(x, w, 1e-6), tf.rms_norm_plain(x, w, 1e-6),
               dtype)
        s, o = tf.fused_add_rms_norm(x, y, w, 1e-6)
        rs, ro = tf.add_rms_norm_plain(x, y, w, 1e-6)
        _close(s, rs, dtype)
        _close(o, ro, dtype)
        assert (tf.fused_rms_norm.launches,
                tf.fused_add_rms_norm.launches) == (n0[0] + 1, n0[1] + 1)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("nH,Hkv,D,max_len", [(12, 12, 64, 384),
                                                  (32, 8, 128, 2048)])
    def test_rope_matches_plain(self, cuda, dtype, nH, Hkv, D, max_len):
        gen = torch.Generator(device=cuda).manual_seed(D)
        zq = _randn(gen, 8, nH * D, dtype=dtype, scale=2.0)
        zk = _randn(gen, 8, Hkv * D, dtype=dtype, scale=2.0)
        pos = torch.tensor([0, 1, 5, 64, 100, 200, max_len - 2, max_len - 1],
                           dtype=torch.int32, device=cuda)
        oq, ok = tf.fused_rope_qk(zq, zk, pos, D, 10000.0)
        rq, rk = tf.rope_qk_plain(zq, zk, pos, D, 10000.0)
        # angles near max_len carry one fp32 ulp of max_len; a one-ulp
        # difference in the frequency moves them by that much
        ulp = 2.0 ** (math.floor(math.log2(max_len - 1)) - 23)
        floor = 2 * ulp * max(zq.abs().max().item(), zk.abs().max().item())
        _close(oq, rq, dtype, floor)
        _close(ok, rk, dtype, floor)


def test_decode_tick_matches_plain_path(cuda, monkeypatch):
    """A ragged fp32 decode tick of a small model on the card: the kernel
    path's logits against the same tick with every kernel swapped for its
    plain version."""
    cfg = llama.LlamaConfig(vocab_size=512, hidden_size=256,
                            intermediate_size=512, num_layers=2,
                            num_heads=4, num_kv_heads=2, max_seq_len=128,
                            dtype=torch.float32)
    params = llama.init_params(cfg, torch.Generator().manual_seed(0),
                               device=cuda)
    rng = np.random.RandomState(0)
    prompt = torch.from_numpy(rng.randint(0, 512, (4, 16))).to(cuda)
    pos = torch.tensor([16, 3, 9, 127], dtype=torch.int32, device=cuda)
    nxt = torch.from_numpy(rng.randint(0, 512, (4, 1))).to(cuda)

    def tick():
        cache = llama.init_kv_cache(cfg, 4, 128, cuda)
        llama.forward_with_cache(params, prompt, cfg, cache, 0)
        return llama.forward_with_cache(params, nxt, cfg, cache, pos)[0]

    with torch.no_grad():
        got = tick()
        monkeypatch.setattr(tf, "fused_rms_norm", tf.rms_norm_plain)
        monkeypatch.setattr(tf, "fused_add_rms_norm", tf.add_rms_norm_plain)
        monkeypatch.setattr(tf, "fused_rope_qk", tf.rope_qk_plain)
        monkeypatch.setattr(da, "ragged_decode_attention",
                            da.ragged_decode_attention_plain)
        want = tick()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_paged_tick_matches_plain_path(cuda, monkeypatch):
    """``forward_with_pages`` on the card, fp32: a prefill chunk at a
    context offset, then a ragged decode tick with a dead slot, through
    the kernels and again with every kernel swapped for its plain
    version; logits and pools agree."""
    cfg = llama.LlamaConfig(vocab_size=512, hidden_size=256,
                            intermediate_size=512, num_layers=2,
                            num_heads=4, num_kv_heads=2, max_seq_len=128,
                            dtype=torch.float32)
    params = llama.init_params(cfg, torch.Generator().manual_seed(0),
                               device=cuda)
    rng = np.random.RandomState(1)
    pt = torch.from_numpy(rng.permutation(np.arange(1, 33))
                          .reshape(4, 8).astype(np.int32)).to(cuda)
    chunk = torch.from_numpy(rng.randint(0, 512, (1, 24))).to(cuda)
    nxt = torch.from_numpy(rng.randint(0, 512, (4, 1))).to(cuda)
    pos = torch.tensor([40, 3, 127, 64], dtype=torch.int32, device=cuda)
    live = torch.tensor([True, True, False, True], device=cuda)

    def run():
        pool = llama.init_paged_pool(cfg, 33, 16, cuda)
        a, _ = llama.forward_with_pages(
            params, chunk, cfg, pool, pt[:1],
            torch.tensor([16], dtype=torch.int32, device=cuda))
        b, _ = llama.forward_with_pages(params, nxt, cfg, pool, pt, pos,
                                        live=live)
        return a, b, pool

    with torch.no_grad():
        got = run()
        monkeypatch.setattr(tf, "fused_rms_norm", tf.rms_norm_plain)
        monkeypatch.setattr(tf, "fused_add_rms_norm", tf.add_rms_norm_plain)
        monkeypatch.setattr(tf, "fused_rope_qk", tf.rope_qk_plain)
        monkeypatch.setattr(pa, "ragged_paged_attention",
                            pa.ragged_paged_attention_plain)
        want = run()
    for g, w in zip(got[:2], want[:2]):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)
    for kk in ("k", "v"):
        torch.testing.assert_close(got[2][kk], want[2][kk], rtol=1e-4,
                                   atol=1e-4)
