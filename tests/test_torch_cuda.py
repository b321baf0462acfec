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

from paddle_tpu_torch.device import set_device
from paddle_tpu_torch.models import llama
from paddle_tpu_torch.ops.kernels import blocked_matmul as bmm
from paddle_tpu_torch.ops.kernels import decode_attention as da
from paddle_tpu_torch.ops.kernels import flash_attention as fa
from paddle_tpu_torch.ops.kernels import flash_variants as fv
from paddle_tpu_torch.ops.kernels import head_dx as hd
from paddle_tpu_torch.ops.kernels import multi_tensor_update as mtu
from paddle_tpu_torch.ops.kernels import paged_attention as pa
from paddle_tpu_torch.ops.kernels import quant_matmul as qm
from paddle_tpu_torch.ops.kernels import tick_fusion as tf
from paddle_tpu_torch.quantization import serving as qs
from paddle_tpu_torch.vision.models import resnet

pytestmark = pytest.mark.cuda

# kernel against plain on the same inputs: fp32 sums run in another order
# (1e-5); bf16 to two ulps of the output (rtol 1.6e-2) with one ulp at the
# inputs' magnitude as atol
TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1.6e-2, 2e-2)}
# bf16 training, kernel path against plain path: a loss of magnitude ~6
# within 2e-2 (about one bf16 ulp of a logit at magnitude 4, where the two
# paths' attention outputs round differently), and each parameter's
# gradient within 5e-2 of its norm (relative Frobenius error: bf16 keeps
# 2^-8 relative per element, and the rounding differences pass through
# the layers' backward)
LOSS_ATOL = 2e-2
GRAD_RTOL = 5e-2


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


class TestFlashAttention:
    """The forward, dq and dk/dv kernels against their plain versions in
    bf16; the backward kernels get the same out, lse and delta as the plain
    backward. lse is fp32: to 1e-4 (exp2 and log2 on the card's approximate
    units, sums in another order)."""

    @pytest.mark.parametrize("B,Sq,Sk,H,D,causal", [
        (2, 128, 128, 4, 64, True),
        (2, 128, 128, 4, 64, False),
        (1, 512, 512, 4, 64, True),     # bench.py's sequence length
        (1, 1024, 1024, 2, 64, True),   # past 512: the TPU's blocked regime
        (1, 256, 256, 2, 128, True),    # llama7b's head width
        (2, 200, 200, 3, 64, True),     # a ragged edge at 64-row tiles
        (1, 40, 100, 2, 128, True),     # Sq < Sk: causal offset 60
        (1, 72, 136, 2, 64, False),
    ])
    def test_matches_plain(self, cuda, B, Sq, Sk, H, D, causal):
        gen = torch.Generator(device=cuda).manual_seed(Sq * 7 + Sk + D)
        dt = torch.bfloat16
        q = _randn(gen, B, Sq, H, D, dtype=dt)
        k = _randn(gen, B, Sk, H, D, dtype=dt)
        v = _randn(gen, B, Sk, H, D, dtype=dt)
        do = _randn(gen, B, Sq, H, D, dtype=dt)
        n0 = (fa.flash_attention_fwd.launches,
              fa.flash_attention_bwd_dq.launches,
              fa.flash_attention_bwd_dkv.launches)
        out, lse = fa.flash_attention_fwd(q, k, v, causal)
        ref, ref_lse = fa.flash_attention_fwd_plain(q, k, v, causal)
        torch.cuda.synchronize()
        _close(out, ref, dt)
        torch.testing.assert_close(lse, ref_lse, rtol=1e-4, atol=1e-4)
        delta = fa.attention_delta(ref, do)
        dq = fa.flash_attention_bwd_dq(q, k, v, do, ref_lse, delta, causal)
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, ref_lse, delta,
                                            causal)
        torch.cuda.synchronize()
        want_dq = fa.flash_attention_bwd_dq_plain(q, k, v, do, ref_lse,
                                                  delta, causal)
        want_dk, want_dv = fa.flash_attention_bwd_dkv_plain(
            q, k, v, do, ref_lse, delta, causal)
        for g, w in ((dq, want_dq), (dk, want_dk), (dv, want_dv)):
            assert torch.isfinite(g.float()).all()
            _close(g, w, dt)
        assert (fa.flash_attention_fwd.launches,
                fa.flash_attention_bwd_dq.launches,
                fa.flash_attention_bwd_dkv.launches) == tuple(
                    n + 1 for n in n0)

    def test_rejects_what_it_does_not_take(self, cuda):
        q = torch.zeros(1, 64, 2, 64, device=cuda)
        with pytest.raises(ValueError, match="bfloat16"):
            fa.flash_attention_fwd(q, q, q)
        q = torch.zeros(1, 64, 2, 32, device=cuda, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="head_dim"):
            fa.flash_attention_fwd(q, q, q)
        q = torch.zeros(1, 2, 64, 64, device=cuda,
                        dtype=torch.bfloat16).transpose(1, 2)
        with pytest.raises(ValueError, match="contiguous"):
            fa.flash_attention_bwd_dq(
                q, q, q, q, *[torch.zeros(1, 2, 64, device=cuda)] * 2)


class TestHeadDx:
    @pytest.mark.parametrize("M,V,H", [(300, 1000, 64), (256, 4096, 256),
                                       (130, 520, 200)])
    def test_matches_plain(self, cuda, M, V, H):
        """Rows past a 128-row tile, V past a 32-column step and H past a
        128-column tile are masked; scale = weight / sumexp, as the CE
        tail passes it."""
        gen = torch.Generator(device=cuda).manual_seed(M + V + H)
        logits = _randn(gen, M, V, dtype=torch.bfloat16, scale=3.0)
        m = logits.float().max(-1).values
        se = torch.exp(logits.float() - m[:, None]).sum(-1)
        scale = torch.rand(M, generator=gen, device=cuda) / se
        w = _randn(gen, H, V, dtype=torch.bfloat16)
        n0 = hd.head_dx_softmax.launches
        out = hd.head_dx_softmax(logits, m, scale, w).float()
        torch.cuda.synchronize()
        assert hd.head_dx_softmax.launches == n0 + 1
        # the outputs are small beside the shared bf16 atol (a row's
        # probabilities sum to at most 1), so the limit is tied to their
        # size: atol 2^-7 of the largest |output| (two bf16 ulps there),
        # and the relative Frobenius error within 1e-2 (the output's own
        # bf16 rounding is ~2^-9 of it; a dropped V tile moves it more)
        ref = hd.head_dx_softmax_plain(logits, m, scale, w).float()
        torch.testing.assert_close(out, ref, rtol=TOL[torch.bfloat16][0],
                                   atol=2.0 ** -7 * ref.abs().max().item())
        assert ((out - ref).norm() / ref.norm()).item() <= 1e-2

    def test_rejects_what_it_does_not_take(self, cuda):
        m = torch.zeros(4, device=cuda)
        with pytest.raises(ValueError, match="bfloat16"):
            hd.head_dx_softmax(torch.zeros(4, 16, device=cuda), m, m,
                               torch.zeros(8, 16, device=cuda))
        with pytest.raises(ValueError, match="multiples of 8"):
            b = torch.bfloat16
            hd.head_dx_softmax(torch.zeros(4, 12, device=cuda, dtype=b), m,
                               m, torch.zeros(8, 12, device=cuda, dtype=b))


def test_loss_and_grads_match_plain_path(cuda, monkeypatch):
    """``loss_fn`` (the custom CE tail) and its gradients in bf16 with fp32
    master weights at D 64 (GQA, 4 over 2 heads) on the card, through the
    kernels and again with every kernel swapped for its plain version; the
    kernels launch once per layer and the CE tail's once."""
    cfg = llama.LlamaConfig(vocab_size=512, hidden_size=256,
                            intermediate_size=512, num_layers=2,
                            num_heads=4, num_kv_heads=2, max_seq_len=256,
                            remat=False, ce_tail_custom=True)
    params = llama.init_params(cfg, torch.Generator().manual_seed(0),
                               device=cuda, dtype=torch.float32)
    tok = torch.from_numpy(np.random.RandomState(0).randint(
        0, 512, (2, 256))).to(cuda)
    fns = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
           fa.flash_attention_bwd_dkv, hd.head_dx_softmax)

    def run():
        leaves = {k: p.clone().requires_grad_() for k, p in params.items()}
        loss = llama.loss_fn(leaves, tok, tok, cfg)
        loss.backward()
        return loss.item(), {k: p.grad for k, p in leaves.items()}

    n0 = [f.launches for f in fns]
    got = run()
    assert [f.launches - n for f, n in zip(fns, n0)] == [2, 2, 2, 1]
    monkeypatch.setattr(fa, "flash_attention_fwd",
                        fa.flash_attention_fwd_plain)
    monkeypatch.setattr(fa, "flash_attention_bwd_dq",
                        fa.flash_attention_bwd_dq_plain)
    monkeypatch.setattr(fa, "flash_attention_bwd_dkv",
                        fa.flash_attention_bwd_dkv_plain)
    monkeypatch.setattr(hd, "head_dx_softmax", hd.head_dx_softmax_plain)
    want = run()
    assert abs(got[0] - want[0]) <= LOSS_ATOL
    for k, g in want[1].items():
        assert g.dtype == torch.float32
        err = ((got[1][k] - g).norm() / g.norm()).item()
        assert err <= GRAD_RTOL, (k, err)


# quant_matmul against its plain version: fp32 sums over K in another
# order, and the scale applied once per column after the sum instead of
# to each weight; both are a few fp32 ulps of the sum (~sqrt(K) 2^-24
# relative), far inside 1e-4 on outputs of magnitude ~1
QMM_TOL = 1e-4


class TestQuantMatmul:
    @pytest.mark.parametrize("mode", ["int8", "fp8"])
    @pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("B,K,N", [
        (8, 768, 768), (8, 768, 3072), (8, 3072, 768),   # the tick's
        (1, 768, 32000), (8, 768, 32000),                # lm_head
        (3, 100, 200),     # ragged K (no multiple of the 256-row chunk)
        (5, 70, 99),       # N no multiple of 8: the byte-wise loads
        (12, 300, 130),    # more rows than one block holds
        (2, 1000, 64),
    ])
    def test_matches_plain(self, cuda, mode, xdt, B, K, N):
        gen = torch.Generator(device=cuda).manual_seed(B * K + N)
        w, sc = qs.quantize_weight(
            _randn(gen, K, N, dtype=torch.float32, scale=K ** -0.5), mode)
        x = _randn(gen, B, K, dtype=xdt)
        before = qm.quant_matmul.launches
        out = qm.quant_matmul(x, w, sc)
        torch.cuda.synchronize()
        assert qm.quant_matmul.launches == before + 1
        assert out.dtype == torch.float32 and out.shape == (B, N)
        torch.testing.assert_close(out, qm.quant_matmul_plain(x, w, sc),
                                   rtol=QMM_TOL, atol=QMM_TOL)

    def test_rejects_what_it_does_not_take(self, cuda):
        w, sc = qs.quantize_weight(torch.randn(64, 128, device=cuda), "int8")
        x = torch.randn(4, 64, device=cuda)
        with pytest.raises(TypeError, match="int8"):
            qm.quant_matmul(x, w.to(torch.float16), sc)
        with pytest.raises(TypeError, match="float32"):
            qm.quant_matmul(x.half(), w, sc)
        with pytest.raises(ValueError, match="chain"):
            qm.quant_matmul(x[:, :32], w, sc)
        wt, _ = qs.quantize_weight(torch.randn(128, 64, device=cuda), "int8")
        with pytest.raises(ValueError, match="contiguous"):
            qm.quant_matmul(x, wt.t(), sc)
        with pytest.raises(ValueError, match="devices"):
            qm.quant_matmul(x.cpu(), w, sc)


class TestDecodeAttentionQuant:
    """The decode kernel's quant mode (int8 / fp8 rows with per-row fp32
    scales) against its plain version: dequantized in fp32, probabilities
    kept fp32, the output rounded to q's dtype."""

    @pytest.mark.parametrize("mode", ["int8", "fp8"])
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("nH,Hkv,D,max_len", [
        (12, 12, 64, 384),    # the serving shape
        (8, 4, 64, 37),       # GQA, a window that is no multiple of 32
        (32, 32, 128, 2048),  # llama7b width
        (8, 1, 128, 65),      # rep 8, one kv head
    ])
    def test_matches_plain(self, cuda, mode, dtype, nH, Hkv, D, max_len):
        gen = torch.Generator(device=cuda).manual_seed(nH * D + max_len)
        B = 6
        qdt = qs.quant_dtype(mode)
        kc, ks = qs.quantize_kv_rows(
            _randn(gen, 2, B, max_len, Hkv, D, dtype=torch.float32), qdt)
        vc, vs = qs.quantize_kv_rows(
            _randn(gen, 2, B, max_len, Hkv, D, dtype=torch.float32), qdt)
        q = _randn(gen, B, nH, D, dtype=dtype)
        pos = torch.tensor([0, max_len - 1, max_len // 2, 1, 31 % max_len,
                            max_len], dtype=torch.int32, device=cuda)
        before = (da.ragged_decode_attention.launches,
                  da.ragged_decode_attention.quant_launches)
        out = da.ragged_decode_attention(q, kc[1], vc[1], pos, ks[1], vs[1])
        torch.cuda.synchronize()
        assert (da.ragged_decode_attention.launches,
                da.ragged_decode_attention.quant_launches) == (
                    before[0] + 1, before[1] + 1)
        ref = da.ragged_decode_attention_plain(
            q, kc[1], vc[1], pos.clamp(max=max_len - 1), ks[1], vs[1])
        assert out.dtype == dtype
        _close(out, ref, dtype)

    def test_rejects_what_it_does_not_take(self, cuda):
        q = torch.zeros(2, 4, 64, device=cuda)
        kc = torch.zeros(2, 16, 2, 64, dtype=torch.int8, device=cuda)
        sc = torch.ones(2, 16, device=cuda)
        pos = torch.zeros(2, dtype=torch.int32, device=cuda)
        with pytest.raises(ValueError, match="k_scale"):
            da.ragged_decode_attention(q, kc, kc, pos, sc.double(), sc)
        with pytest.raises(TypeError, match="int8"):
            da.ragged_decode_attention(q, kc.float(), kc.float(), pos, sc,
                                       sc)
        with pytest.raises(ValueError, match="contiguous"):
            da.ragged_decode_attention(q, kc, kc, pos, sc.t().contiguous()
                                       .t(), sc)


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_quant_paged_tick_matches_plain_path(cuda, monkeypatch, mode):
    """``forward_with_pages`` of a quantized tree on a quantized pool, fp32:
    a prefill chunk at a context offset, then a ragged tick with a dead
    slot, through ``quant_matmul`` and the tick kernels and again with
    every kernel swapped for its plain version: logits agree, the row
    scales too, and each stored row within one quantization step."""
    cfg = llama.LlamaConfig(vocab_size=512, hidden_size=256,
                            intermediate_size=512, num_layers=2,
                            num_heads=4, num_kv_heads=2, max_seq_len=128,
                            dtype=torch.float32)
    params = qs.quantize_llama_params(
        llama.init_params(cfg, torch.Generator().manual_seed(0),
                          device=cuda), cfg, mode)
    rng = np.random.RandomState(1)
    pt = torch.from_numpy(rng.permutation(np.arange(1, 33))
                          .reshape(4, 8).astype(np.int32)).to(cuda)
    chunk = torch.from_numpy(rng.randint(0, 512, (1, 24))).to(cuda)
    nxt = torch.from_numpy(rng.randint(0, 512, (4, 1))).to(cuda)
    pos = torch.tensor([40, 3, 127, 64], dtype=torch.int32, device=cuda)
    live = torch.tensor([True, True, False, True], device=cuda)

    def run():
        pool = llama.init_paged_pool(cfg, 33, 16, cuda, quant=mode)
        a, _ = llama.forward_with_pages(
            params, chunk, cfg, pool, pt[:1],
            torch.tensor([16], dtype=torch.int32, device=cuda))
        b, _ = llama.forward_with_pages(params, nxt, cfg, pool, pt, pos,
                                        live=live)
        return a, b, pool

    with torch.no_grad():
        before = qm.quant_matmul.launches
        got = run()
        # the tick's 7 projections per layer and its lm_head, the
        # prefill's lm_head
        assert qm.quant_matmul.launches == before + 7 * 2 + 2
        monkeypatch.setattr(tf, "fused_rms_norm", tf.rms_norm_plain)
        monkeypatch.setattr(tf, "fused_add_rms_norm", tf.add_rms_norm_plain)
        monkeypatch.setattr(tf, "fused_rope_qk", tf.rope_qk_plain)
        monkeypatch.setattr(qm, "quant_matmul", qm.quant_matmul_plain)
        want = run()
    for g, w in zip(got[:2], want[:2]):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)
    for kk in ("k", "v"):
        gs, ws = got[2][kk + "s"], want[2][kk + "s"]
        torch.testing.assert_close(gs, ws, rtol=1e-5, atol=1e-9)
        diff = (got[2][kk].float() * gs[..., None, None]
                - want[2][kk].float() * ws[..., None, None]).abs()
        assert (diff <= 1.01 * ws[..., None, None] + 1e-7).all()


# multi_tensor_update against its plain version on the same buffers: both
# round once per operation in the buffer's type, but the bias corrections
# (powf on the card, torch.pow on the host) may differ in their last bit:
# fp32 to rtol 1e-6, bf16 to one ulp. Lamb's trust ratios are segment sums
# of up to 2.4 M squares by atomics, whose order changes from run to run
# (measured on ResNet-50's shapes: 7.5e-6 relative on 4 of 590 k entries;
# 4.8e-7 absolute where an update cancels a parameter to ~1e-5): its
# params to rtol 2e-5 (fp32) or one ulp (bf16) with atol 1e-6
MTU_TOL = {torch.float32: dict(rtol=1e-6, atol=1e-7),
           torch.bfloat16: dict(rtol=2.0 ** -7, atol=1e-7)}
MTU_LAMB_TOL = {torch.float32: dict(rtol=2e-5, atol=1e-6),
                torch.bfloat16: dict(rtol=2.0 ** -7, atol=1e-6)}
MTU_MIXED = [(3, 3, 4, 8), (3, 3, 4, 8), (1, 1, 8, 4), (8,), (8,), (4,),
             (16, 4), (5,), (4,)]
MTU_ADAM = {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}
MTU_VARIANTS = {
    # name: kind, hyper, param dtype, state dtype, master
    "sgd": ("sgd", {}, torch.float32, None, False),
    "sgd_bf16": ("sgd", {}, torch.bfloat16, None, False),
    "momentum": ("momentum", {"momentum": 0.9}, torch.float32,
                 torch.float32, False),
    "momentum_bf16": ("momentum", {"momentum": 0.9}, torch.bfloat16,
                      torch.bfloat16, False),
    "momentum_bf16_fp32_velocity": ("momentum", {"momentum": 0.9},
                                    torch.bfloat16, torch.float32, False),
    "nesterov_bf16": ("momentum", {"momentum": 0.9, "nesterov": True},
                      torch.bfloat16, torch.bfloat16, False),
    "adam": ("adam", MTU_ADAM, torch.float32, torch.float32, False),
    "adamw": ("adam", dict(MTU_ADAM, decay=0.1, decoupled=True),
              torch.float32, torch.float32, False),
    "adamw_bf16": ("adam", dict(MTU_ADAM, decay=0.1, decoupled=True),
                   torch.bfloat16, torch.bfloat16, False),
    "adamw_bf16_master": ("adam", dict(MTU_ADAM, decay=0.1, decoupled=True),
                          torch.bfloat16, torch.float32, True),
    "lamb": ("lamb", dict(MTU_ADAM, epsilon=1e-6, decay=0.01),
             torch.float32, torch.float32, False),
    "lamb_bf16_master": ("lamb", dict(MTU_ADAM, epsilon=1e-6, decay=0.01),
                         torch.bfloat16, torch.float32, True),
}
_STATE = {"sgd": (), "momentum": ("velocity",),
          "adam": ("moment1", "moment2"), "lamb": ("moment1", "moment2")}


def _mtu_group(cuda, name, shapes):
    """One variant's params, grads and state on the card, from a seeded
    generator (second moments non-negative)."""
    kind, hyper, pdt, sdt, master = MTU_VARIANTS[name]
    if shapes == "resnet50":
        prev = set_device("cpu")
        try:
            model = resnet.resnet50(num_classes=1000, data_format="NHWC")
        finally:
            set_device(prev)
        shapes = [tuple(p.shape) for p in model.parameters()]
        del model
    else:
        shapes = MTU_MIXED
    gen = torch.Generator(device=cuda).manual_seed(len(shapes))

    def rand(scale, dtype, positive=False):
        out = [_randn(gen, *s, dtype=torch.float32, scale=scale)
               for s in shapes]
        return [(t.abs() if positive else t).to(dtype) for t in out]

    P, G = rand(0.1, pdt), rand(0.01, pdt)
    S = [{} for _ in shapes]
    for k in _STATE[kind]:
        for st, t in zip(S, rand(0.01, sdt, positive=True)):
            st[k] = t
    if master:
        for st, p in zip(S, P):
            st["master"] = p.float()
    return kind, hyper, mtu.FlatPlan(shapes), P, G, S


class TestMultiTensorUpdate:
    @pytest.mark.parametrize("shapes", ["mixed", "resnet50"])
    @pytest.mark.parametrize("name", list(MTU_VARIANTS))
    def test_matches_plain(self, cuda, monkeypatch, name, shapes):
        """``apply_flat_update`` through the kernel and through its plain
        version on the card: the same shaped params and flat state (lamb's
        trust epilogue included); one launch per call."""
        kind, hyper, plan, P, G, S = _mtu_group(cuda, name, shapes)
        before = mtu.multi_tensor_update.launches
        got = mtu.apply_flat_update(kind, plan, P, G, S, hyper, 0.1, 3)
        assert mtu.multi_tensor_update.launches == before + 1
        monkeypatch.setattr(mtu, "multi_tensor_update",
                            mtu.flat_update_plain)
        want = mtu.apply_flat_update(kind, plan, P, G, S, hyper, 0.1, 3)
        torch.cuda.synchronize()
        def tol(t):
            return (MTU_LAMB_TOL if kind == "lamb" else MTU_TOL)[t.dtype]

        for g, w in zip(got[0], want[0]):
            assert g.dtype == w.dtype and g.shape == w.shape
            torch.testing.assert_close(g, w, **tol(w))
        for g, w in zip(got[1], want[1]):
            for k in w:
                torch.testing.assert_close(g[k], w[k], **tol(w[k]))

    @pytest.mark.parametrize("name", ["sgd", "momentum_bf16", "adamw_bf16",
                                      "adamw_bf16_master", "lamb",
                                      "lamb_bf16_master"])
    def test_skip_leaves_buffers_bit_identical(self, cuda, name):
        """skip, a device float the kernel reads, > 0: every param and
        state value stays bit-identical; 0: the update runs."""
        kind, hyper, plan, P, G, S = _mtu_group(cuda, name, "mixed")
        for flag, same in ((1.0, True), (0.0, False)):
            skip = torch.tensor(flag, device=cuda)
            new_p, new_s = mtu.apply_flat_update(kind, plan, P, G, S, hyper,
                                                 0.1, 3, skip=skip)
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for a, b in zip(new_p, P)) == same
            if same:
                for a, b in zip(new_s, S):
                    for k in b:
                        assert torch.equal(a[k].reshape(-1)[:b[k].numel()]
                                           .view(b[k].shape), b[k])

    def test_rejects_unaligned_and_odd_buffers(self, cuda):
        plan = mtu.FlatPlan([(8,)])
        p = plan.pack([torch.zeros(8, device=cuda)])
        with pytest.raises(ValueError, match="aligned"):
            mtu.multi_tensor_update(
                "sgd", p.reshape(-1)[1:129].view(1, 128),
                p.reshape(-1)[1:129].view(1, 128), {}, {}, 0.1, 1)


# ---------------------------------------------------------------------------
# the kernel experiments: blocked matmul and the flash variants
# ---------------------------------------------------------------------------

class TestBlockedMatmul:
    @pytest.mark.parametrize("tile", bmm.TILES)
    def test_matches_plain(self, cuda, tile):
        """Every tile instance against the plain version's chunked fp32
        sums, both rounded once to bf16 (outputs of magnitude ~30: one
        bf16 ulp is 0.125-0.25)."""
        gen = torch.Generator(device=cuda).manual_seed(0)
        a = _randn(gen, 512, 1024, dtype=torch.bfloat16)
        b = _randn(gen, 1024, 768, dtype=torch.bfloat16)
        n = bmm.blocked_matmul.launches
        out = bmm.blocked_matmul(a, b, *tile)
        torch.cuda.synchronize()
        assert bmm.blocked_matmul.launches == n + 1
        assert out.dtype == torch.bfloat16 and out.shape == (512, 768)
        _close(out, bmm.blocked_matmul_plain(a, b, tile[2]), torch.bfloat16)

    def test_rejects_what_it_does_not_take(self, cuda):
        a = torch.zeros(256, 96, dtype=torch.bfloat16, device=cuda)
        b = torch.zeros(96, 256, dtype=torch.bfloat16, device=cuda)
        with pytest.raises(ValueError, match="divisible"):
            bmm.blocked_matmul(a, b, 128, 128, 64)
        with pytest.raises(ValueError, match="bfloat16"):
            bmm.blocked_matmul(a.float(), b.float(), 128, 128, 32)
        with pytest.raises(ValueError, match="contiguous"):
            bmm.blocked_matmul(a, b.t().contiguous().t(), 128, 128, 32)

    def test_timer_counts_replayed_launches(self, cuda):
        """The experiments' timer counts the launches the device ran: the
        warmup calls, then the captured calls once per replay (a warm
        replay and the timed one), not the capture itself."""
        from paddle_tpu_torch.experiments._timing import time_ms

        a = torch.zeros(256, 256, dtype=torch.bfloat16, device=cuda)
        n = bmm.blocked_matmul.launches
        ms = time_ms(lambda i: bmm.blocked_matmul(a, a, *bmm.TILES[0]),
                     iters=3, warmup=2)
        assert ms > 0
        assert bmm.blocked_matmul.launches == n + 2 + 2 * 3


def _fv_inputs(cuda, B, S, H, D, n=4, seed=0):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    return [_randn(gen, B, S, H, D, dtype=torch.bfloat16) for _ in range(n)]


def _close_of_max(out, ref):
    """bf16 to two ulps, with the atol of two ulps of the largest |ref|:
    the ablations' outputs reach ~1e9 (exp2 of unscaled scores)."""
    rtol = TOL[torch.bfloat16][0]
    atol = max(TOL[torch.bfloat16][1],
               rtol * ref.float().abs().max().item())
    torch.testing.assert_close(out.float(), ref.float(), rtol=rtol,
                               atol=atol)


class TestFlashVariants:
    @pytest.mark.parametrize("B,S,H,D", [(2, 256, 4, 64), (1, 192, 2, 128)])
    @pytest.mark.parametrize("causal", [True, False])
    @pytest.mark.parametrize("nsplit", [1, 2, 4])
    @pytest.mark.parametrize("exp_bf16", [False, True])
    def test_fwd_bwd_match_plain(self, cuda, B, S, H, D, causal, nsplit,
                                 exp_bf16):
        """run_fwd and run_bwd (the backward from the plain forward's out
        and lse) against their plain versions; lse fp32 to 1e-3 (base 2,
        exp2/log2 on the card's units, l summed in another order)."""
        q, k, v, do = _fv_inputs(cuda, B, S, H, D)
        n = (fv.variant_fwd.launches, fv.variant_bwd.launches)
        out, lse = fv.run_fwd(q, k, v, causal, nsplit, exp_bf16)
        ref, ref_lse = fv.run_fwd_plain(q, k, v, causal, nsplit, exp_bf16)
        torch.cuda.synchronize()
        _close(out, ref, torch.bfloat16)
        torch.testing.assert_close(lse, ref_lse, rtol=1e-3, atol=1e-3)
        bwd = (q, k, v, do, ref, ref_lse, causal, nsplit, exp_bf16)
        for g, w in zip(fv.run_bwd(*bwd), fv.run_bwd_plain(*bwd)):
            _close(g, w, torch.bfloat16)
        assert (fv.variant_fwd.launches, fv.variant_bwd.launches) == (
            n[0] + 1, n[1] + 1)

    @pytest.mark.parametrize("B,S,H,D", [(2, 256, 4, 64), (1, 192, 2, 128)])
    @pytest.mark.parametrize("causal", [True, False])
    @pytest.mark.parametrize("p_bf16", [False, True])
    @pytest.mark.parametrize("in_kernel_scale", [False, True])
    def test_fwd2_matches_plain(self, cuda, B, S, H, D, causal, p_bf16,
                                in_kernel_scale):
        """run_fwd2 against its plain version; every qblocks gives the
        same bits (it does not change the CUDA schedule)."""
        q, k, v = _fv_inputs(cuda, B, S, H, D, n=3)
        out, lse = fv.run_fwd2(q, k, v, causal, 1, p_bf16, in_kernel_scale)
        ref, ref_lse = fv.run_fwd2_plain(q, k, v, causal, 1, p_bf16,
                                         in_kernel_scale)
        torch.cuda.synchronize()
        _close(out, ref, torch.bfloat16)
        torch.testing.assert_close(lse, ref_lse, rtol=1e-3, atol=1e-3)
        for qb in (2, 4):
            o2, l2 = fv.run_fwd2(q, k, v, causal, qb, p_bf16,
                                 in_kernel_scale)
            assert torch.equal(o2, out) and torch.equal(l2, lse)

    @pytest.mark.parametrize("B,S,H,D", [(2, 256, 4, 64), (1, 192, 2, 128)])
    @pytest.mark.parametrize("drop", fv.FWD_DROPS,
                             ids=lambda d: "-".join(d) or "none")
    def test_fwd_diag_matches_plain(self, cuda, drop, B, S, H, D):
        q, k, v = _fv_inputs(cuda, B, S, H, D, n=3)
        out, lse = fv.fwd_diag(q, k, v, drop)
        ref, ref_lse = fv.fwd_diag_plain(q, k, v, drop)
        torch.cuda.synchronize()
        _close_of_max(out, ref)
        torch.testing.assert_close(lse, ref_lse, rtol=1e-3, atol=1e-3)

    @pytest.mark.parametrize("B,S,H,D", [(2, 256, 4, 64), (1, 192, 2, 128)])
    @pytest.mark.parametrize("drop", fv.BWD_DROPS,
                             ids=lambda d: "-".join(d) or "none")
    def test_bwd_diag_matches_plain(self, cuda, drop, B, S, H, D):
        q, k, v, do = _fv_inputs(cuda, B, S, H, D)
        out, lse = fv.run_fwd_plain(q, k, v)
        args = (q, k, v, do, out, lse, drop)
        for g, w in zip(fv.bwd_diag(*args), fv.bwd_diag_plain(*args)):
            _close_of_max(g, w)

    def test_rejects_what_it_does_not_take(self, cuda):
        q = torch.zeros(1, 100, 2, 64, dtype=torch.bfloat16, device=cuda)
        with pytest.raises(ValueError, match="multiple of 64"):
            fv.run_fwd(q, q, q)
        q = torch.zeros(1, 128, 2, 64, device=cuda)
        with pytest.raises(ValueError, match="bfloat16"):
            fv.run_fwd(q, q, q)
        q = torch.zeros(1, 128, 1, 32, dtype=torch.bfloat16, device=cuda)
        with pytest.raises(ValueError, match="packed blocks"):
            fv.run_fwd(q, q, q)
        q = torch.zeros(1, 128, 4, 32, dtype=torch.bfloat16, device=cuda)
        with pytest.raises(ValueError, match="D in"):
            fv.run_fwd(q, q, q)
