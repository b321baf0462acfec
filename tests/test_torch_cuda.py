"""The port's kernels on the card, against their plain versions.

Every test here needs an NVIDIA GPU: each is marked ``cuda`` and skips
(through the ``cuda`` fixture) where ``torch.cuda.is_available()`` is
false, as on a CPU-only machine. The machine with the card has no JAX, so
run this file there without the suite's conftest (which imports JAX):

    python3 -m pytest --noconftest -o "markers=cuda: needs an NVIDIA GPU" \
        tests/test_torch_cuda.py -q

This file imports nothing of JAX or of ``paddle_tpu``.
"""

import dataclasses
import json
import math

import numpy as np
import pytest
import torch

from paddle_tpu_torch.device import set_device
from paddle_tpu_torch.models import bert, llama
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


# the head dims of 8s, besides 64 and 128, that the decode and paged
# kernels serve at their padded widths (cpu_small is D 16)
HEAD_DIMS = [16, 24, 32, 48, 80, 96, 112]


def _decode_positions(cuda, max_len):
    """Decode positions for a window of max_len: 0, the last row, a frozen
    slot at max_len, interior ones and the edges of the kernel's key
    chunks, each at most max_len."""
    C = da._CHUNK
    return torch.tensor([min(p, max_len) for p in (
        0, max_len - 1, max_len // 2, 1, 31 % max_len, max_len, C - 1, C,
        C + 1, 2 * C - 1, 2 * C)], dtype=torch.int32, device=cuda)


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
        the whole window), interior ones and the edges of the kernel's key
        chunks (C - 1, C, C + 1, 2C - 1, 2C; slots at 0, 1 and C - 1 have
        only chunk 0 live); the cache is one layer's view of a stacked
        [L, ...] cache, at a non-zero offset."""
        gen = torch.Generator(device=cuda).manual_seed(nH * D + max_len)
        pos = _decode_positions(cuda, max_len)
        B = len(pos)
        kc = _randn(gen, 2, B, max_len, Hkv, D, dtype=dtype)
        vc = _randn(gen, 2, B, max_len, Hkv, D, dtype=dtype)
        q = _randn(gen, B, nH, D, dtype=dtype)
        before = da.ragged_decode_attention.launches
        out = da.ragged_decode_attention(q, kc[1], vc[1], pos)
        torch.cuda.synchronize()
        assert da.ragged_decode_attention.launches == before + 1
        ref = da.ragged_decode_attention_plain(
            q, kc[1], vc[1], pos.clamp(max=max_len - 1))
        _close(out, ref, dtype)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("D", HEAD_DIMS)
    @pytest.mark.parametrize("nH,Hkv", [(8, 8), (8, 2)])
    def test_head_dims(self, cuda, dtype, D, nH, Hkv):
        """Every head dim of 8s the padded instances serve (32, 64, 128
        wide, the true D at run time), MHA and GQA, on the chunk edges."""
        gen = torch.Generator(device=cuda).manual_seed(D + nH + Hkv)
        max_len = 200
        pos = _decode_positions(cuda, max_len)
        B = len(pos)
        kc = _randn(gen, 2, B, max_len, Hkv, D, dtype=dtype)
        vc = _randn(gen, 2, B, max_len, Hkv, D, dtype=dtype)
        q = _randn(gen, B, nH, D, dtype=dtype)
        before = da.ragged_decode_attention.launches
        out = da.ragged_decode_attention(q, kc[1], vc[1], pos)
        torch.cuda.synchronize()
        assert da.ragged_decode_attention.launches == before + 1
        _close(out, da.ragged_decode_attention_plain(
            q, kc[1], vc[1], pos.clamp(max=max_len - 1)), dtype)

    def test_rejects_what_it_does_not_take(self, cuda):
        pos = torch.zeros(2, dtype=torch.int32, device=cuda)
        for D in (100, 136, 4):  # no multiple of 8, past 128, below 8
            q = torch.zeros(2, 4, D, device=cuda)
            kc = torch.zeros(2, 16, 4, D, device=cuda)
            with pytest.raises(ValueError, match="head_dim"):
                da.ragged_decode_attention(q, kc, kc, pos)
        q = torch.zeros(2, 32, 64, device=cuda)
        kc = torch.zeros(2, 16, 2, 64, device=cuda)
        with pytest.raises(ValueError, match="query heads"):
            da.ragged_decode_attention(q, kc, kc, pos)
        kc = torch.zeros(2, 4, 16, 64, device=cuda).transpose(1, 2)
        with pytest.raises(ValueError, match="contiguous"):
            da.ragged_decode_attention(q[:, :4], kc, kc, pos)

    @pytest.mark.parametrize("quant", [None, "int8"])
    def test_graph_replays_on_new_positions(self, cuda, quant):
        """One launch captured into a CUDA graph, replayed three times on
        new positions (one slot on a single chunk, the others over up to
        all six): each output matches the plain version, and the merge's
        ticket buffer is left zero by every replay."""
        gen = torch.Generator(device=cuda).manual_seed(7)
        B, nH, Hkv, D, max_len = 8, 12, 12, 64, 384
        dt = torch.bfloat16
        q = _randn(gen, B, nH, D, dtype=dt)
        if quant is None:
            kc = _randn(gen, B, max_len, Hkv, D, dtype=dt)
            vc = _randn(gen, B, max_len, Hkv, D, dtype=dt)
            scales = ()
        else:
            qdt = qs.quant_dtype(quant)
            kc, ks = qs.quantize_kv_rows(
                _randn(gen, B, max_len, Hkv, D, dtype=torch.float32), qdt)
            vc, vs = qs.quantize_kv_rows(
                _randn(gen, B, max_len, Hkv, D, dtype=torch.float32), qdt)
            scales = (ks, vs)
        pos = torch.zeros(B, dtype=torch.int32, device=cuda)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # warm up off the capture stream
            da.ragged_decode_attention(q, kc, vc, pos, *scales)
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = da.ragged_decode_attention(q, kc, vc, pos, *scales)
        tickets = da._tickets(q.device, B * Hkv)
        for new in ([5, 383, 64, 127, 200, 0, 300, 63],
                    [383] * B,
                    torch.randint(0, max_len, (B,), generator=gen,
                                  device=cuda).tolist()):
            pos.copy_(torch.tensor(new, dtype=torch.int32))
            graph.replay()
            torch.cuda.synchronize()
            _close(out, da.ragged_decode_attention_plain(q, kc, vc, pos,
                                                         *scales), dt)
            assert int(tickets.abs().sum()) == 0


class TestPagedAttention:
    """``ragged_paged_attention`` against its plain version (gather the
    slot's pages, then dense attention) on a shuffled page table. The
    plain version scales the fp32 scores where the kernel pre-scales q in
    its own dtype; in bf16 at D 128 (a scale that is no power of two)
    that is about one bf16 ulp of a score, inside the bf16 tolerance.
    At most 8 query rows a kv head take the split-KV decode family, more
    the prefill family (tensor cores in bf16)."""

    @staticmethod
    def _case(cuda, dtype, B, Tq, nH, Hkv, D, max_pages, ctx, q_len,
              psz=16, seed=0):
        gen = torch.Generator(device=cuda).manual_seed(
            B * Tq + nH + psz + seed)
        P = B * max_pages + 3
        kp = _randn(gen, 2, P, psz, Hkv, D, dtype=dtype)
        vp = _randn(gen, 2, P, psz, Hkv, D, dtype=dtype)
        q = _randn(gen, B, Tq, nH, D, dtype=dtype)
        pt = (torch.randperm(P - 1, generator=gen, device=cuda)[
            :B * max_pages] + 1).to(torch.int32).reshape(B, max_pages)
        ctx_t = torch.tensor(ctx, dtype=torch.int32, device=cuda)
        ql = (None if q_len is None
              else torch.tensor(q_len, dtype=torch.int32, device=cuda))
        # the pool is one layer's view of a stacked [2, ...] pool
        return q, kp[1], vp[1], pt, ctx_t, ql

    def _check(self, cuda, dtype, B, Tq, nH, Hkv, D, max_pages, ctx, q_len,
               psz=16):
        q, kp, vp, pt, ctx_t, ql = self._case(cuda, dtype, B, Tq, nH, Hkv,
                                              D, max_pages, ctx, q_len, psz)
        before = pa.ragged_paged_attention.launches
        out = pa.ragged_paged_attention(q, kp, vp, pt, ctx_t, ql)
        torch.cuda.synchronize()
        assert pa.ragged_paged_attention.launches == before + 1
        ref = pa.ragged_paged_attention_plain(q, kp, vp, pt, ctx_t)
        assert torch.isfinite(out.float()).all()
        rows = [Tq] * B if q_len is None else q_len
        for b in range(B):  # rows past q_len are padding
            _close(out[b, :rows[b]], ref[b, :rows[b]], dtype)

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
        # at most 8 rows a kv head: the decode family with rows at
        # several positions
        ("two_positions_rep4", 3, 2, 8, 2, 128, 8, [0, 63, 126], [2, 1, 2]),
        ("eight_positions", 2, 8, 4, 4, 64, 8, [64, 3], [8, 6]),
    ])
    def test_matches_plain(self, cuda, dtype, case):
        name, B, Tq, nH, Hkv, D, max_pages, ctx, q_len = case
        self._check(cuda, dtype, B, Tq, nH, Hkv, D, max_pages, ctx, q_len)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("psz", [8, 16, 32])
    @pytest.mark.parametrize("nH,Hkv,D", [(12, 12, 64), (4, 4, 128),
                                          (8, 2, 128), (8, 1, 128)])
    def test_decode_on_chunk_edges(self, cuda, dtype, psz, nH, Hkv, D):
        """Decode ticks with contexts on the 64-key chunk edges (0, 63, 64,
        65, 127, 128 and the window's last row), pages of 8, 16 and 32,
        rep 1, 4 and 8 at D 128."""
        max_pages = 384 // psz
        ctx = [0, 63, 64, 65, 127, 128, 383, 200]
        self._check(cuda, dtype, len(ctx), 1, nH, Hkv, D, max_pages, ctx,
                    None, psz)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("psz", [8, 16, 32])
    @pytest.mark.parametrize("Tq", [64, 256])
    @pytest.mark.parametrize("nH,Hkv,D", [(12, 12, 64), (8, 2, 128),
                                          (8, 1, 128)])
    def test_prefill_at_page_boundaries(self, cuda, dtype, psz, Tq, nH, Hkv,
                                        D):
        """Prefill chunks of 64 and 256 rows at context 0 and at a page
        boundary (and one whose window passes the table's width, which
        the clamp pins), with a ragged q_len."""
        max_pages = 512 // psz
        ctx = [0, 4 * psz, 512 - Tq // 2]
        q_len = [Tq, Tq - 5, Tq]
        self._check(cuda, dtype, 3, Tq, nH, Hkv, D, max_pages, ctx, q_len,
                    psz)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("Tq", [512, 1024, 2048])
    @pytest.mark.parametrize("nH,Hkv,D", [(12, 12, 64), (32, 32, 128),
                                          (32, 8, 128)])
    def test_long_prefill(self, cuda, dtype, Tq, nH, Hkv, D):
        """Prefill chunks past 256 rows, as an engine at max_len 2048
        admits them: at bert_base_equiv width, llama7b width and its GQA,
        one slot at context 0 and one past a page boundary (ctx 37, a
        ragged q_len)."""
        max_pages = (Tq + 48) // 16
        self._check(cuda, dtype, 2, Tq, nH, Hkv, D, max_pages, [0, 37],
                    [Tq, Tq - 11])

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("D", HEAD_DIMS)
    @pytest.mark.parametrize("nH,Hkv", [(8, 8), (8, 2)])
    @pytest.mark.parametrize("Tq", [1, 40])
    def test_head_dims(self, cuda, dtype, D, nH, Hkv, Tq):
        """Every head dim of 8s the padded instances serve, MHA and GQA:
        decode ticks (the split-KV family) on the chunk edges, and prefill
        chunks (the tensor-core family in bf16, whose k16 steps pad D to
        16) at context 0, past a page boundary and near the window's end,
        with a ragged q_len."""
        max_pages = 12
        if Tq == 1:
            ctx, q_len = [0, 63, 64, 65, 127, 128, 191, 100], None
        else:
            ctx, q_len = [0, 17, 150], [Tq, Tq - 3, 1]
        self._check(cuda, dtype, len(ctx), Tq, nH, Hkv, D, max_pages, ctx,
                    q_len)

    @pytest.mark.parametrize("Tq", [1, 64])
    def test_two_launches_give_the_same_bits(self, cuda, Tq):
        case = self._case(cuda, torch.bfloat16, 8, Tq, 12, 12, 64, 24,
                          [0, 383, 64, 127, 200, 5, 300, 63], None)
        a = pa.ragged_paged_attention(*case)
        b = pa.ragged_paged_attention(*case)
        torch.cuda.synchronize()
        assert torch.equal(a, b)

    @pytest.mark.parametrize("Tq", [1, 64])
    def test_graph_replays_on_new_contexts_and_tables(self, cuda, Tq):
        """One launch captured into a CUDA graph, replayed on new contexts
        and new page tables (copied into the captured tensors): each
        output matches the plain version, and the decode family's
        tickets are left zero by every replay."""
        dt = torch.bfloat16
        B, nH, Hkv, D, max_pages = 8, 12, 12, 64, 24
        q, kp, vp, pt, ctx, ql = self._case(cuda, dt, B, Tq, nH, Hkv, D,
                                            max_pages, [0] * B, None)
        gen = torch.Generator(device=cuda).manual_seed(11)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # warm up off the capture stream
            pa.ragged_paged_attention(q, kp, vp, pt, ctx)
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = pa.ragged_paged_attention(q, kp, vp, pt, ctx)
        tickets = da._tickets(q.device, B * Hkv)
        W = max_pages * 16
        for new in ([5, 383, 64, 127, 200, 0, 300, 63], [W - Tq] * B,
                    torch.randint(0, W, (B,), generator=gen,
                                  device=cuda).tolist()):
            ctx.copy_(torch.tensor(new, dtype=torch.int32))
            pt.copy_(pt[torch.randperm(B, generator=gen, device=cuda)])
            graph.replay()
            torch.cuda.synchronize()
            ref = pa.ragged_paged_attention_plain(q, kp, vp, pt, ctx)
            _close(out, ref, dt)
            assert int(tickets.abs().sum()) == 0

    def _check_table(self, cuda, dtype, case, pt):
        """``case`` (from ``_case``) on the page table ``pt``: one launch,
        every row against the plain version."""
        q, kp, vp, _, ctx_t, ql = case
        before = pa.ragged_paged_attention.launches
        out = pa.ragged_paged_attention(q, kp, vp, pt, ctx_t, ql)
        torch.cuda.synchronize()
        assert pa.ragged_paged_attention.launches == before + 1
        assert torch.isfinite(out.float()).all()
        _close(out, pa.ragged_paged_attention_plain(q, kp, vp, pt, ctx_t),
               dtype)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("K", [1, 3, 4, 7, 8])
    def test_verify_ticks(self, cuda, dtype, K):
        """A speculative verify tick at bert width: 8 slots of K + 1 rows
        (rep 1: the split-KV decode family with several rows up to K = 7,
        the prefill family at K = 8) at ragged positions. The last two
        slots are dead: frozen at the window's end, their rows past it, and
        their tables' tails the trash page 0, where the engine sends dead
        slots' writes."""
        ctx = [0, 17, 100, 255, 301, 383 - K, 383, 384]
        case = self._case(cuda, dtype, 8, K + 1, 12, 12, 64, 24, ctx, None,
                          seed=K)
        pt = case[3].clone()
        pt[6:, 20:] = 0
        assert pa.family(K + 1, 1) == ("decode" if K < 8 else "prefill")
        self._check_table(cuda, dtype, case, pt)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("C,off", [(8, 29), (16, 37), (32, 45),
                                       (64, 77), (64, 1)])
    def test_prefill_chunks_off_the_page_grid(self, cuda, dtype, C, off):
        """Chunked prefill: a chunk of C rows at a context offset that is
        no multiple of the page size (the rows before it already in the
        pool), one slot as the engine runs it, and three slots at once."""
        self._check(cuda, dtype, 1, C, 12, 12, 64, 24, [off], None)
        self._check(cuda, dtype, 3, C, 12, 12, 64, 24,
                    [off, off + 3 * C, 383 - C], None)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("sp", [2, 4])
    @pytest.mark.parametrize("C", [8, 64])
    def test_sp_slabs_share_one_table_row(self, cuda, dtype, sp, C):
        """A sequence-parallel slab: sp rows of C tokens of one prompt,
        row i at offset base + i * C, every row reading the request's one
        table row (copied for each row). The reservation ends inside the
        slab, so the overrun rows past it read the trash page 0, and the
        last rows pass the window (2048 rows)."""
        max_pages, psz = 128, 16
        base = max_pages * psz - sp * C + C // 2 + 5
        reserved = (base + C // 2 + psz - 1) // psz
        case = self._case(cuda, dtype, sp, C, 12, 12, 64, max_pages,
                          [base + C * i for i in range(sp)], None, seed=sp)
        row = case[3][0].clone()
        row[reserved:] = 0
        self._check_table(cuda, dtype, case,
                          row[None].expand(sp, -1).contiguous())

    def test_rejects_what_it_does_not_take(self, cuda):
        pt = torch.zeros(2, 4, dtype=torch.int32, device=cuda)
        ctx = torch.zeros(2, dtype=torch.int32, device=cuda)

        def call(Tq=1, nH=4, Hkv=2, D=64, psz=16):
            q = torch.zeros(2, Tq, nH, D, device=cuda)
            kp = torch.zeros(9, psz, Hkv, D, device=cuda)
            return pa.ragged_paged_attention(q, kp, kp, pt, ctx)

        for D in (100, 136, 4):  # no multiple of 8, past 128, below 8
            with pytest.raises(ValueError, match="head_dim"):
                call(D=D)
        with pytest.raises(ValueError, match="query heads"):
            call(nH=32, Hkv=2)
        with pytest.raises(ValueError, match="page_size"):
            call(psz=12)
        # more rows a kv head than the prefill's grid holds (fp32: 8 rows a
        # block, 65535 blocks)
        with pytest.raises(ValueError, match="Tq"):
            call(Tq=pa.max_rows(torch.float32) // 2 + 1, D=8)


class TestTickFusion:
    # the norms against their plain versions: s = x + y is one rounding of
    # the same sum, so it must be bit-identical; out goes through the row's
    # mean square, summed in another order than torch.mean's, so out may
    # sit one ulp of T from the plain version's (TOL: fp32 1e-5, bf16 two
    # ulps)
    @staticmethod
    def _norm_inputs(cuda, dtype, B, H, seed=0):
        gen = torch.Generator(device=cuda).manual_seed(seed + B * H)
        x = _randn(gen, B, H, dtype=dtype, scale=2.0)
        y = _randn(gen, B, H, dtype=dtype, scale=2.0)
        w = (1 + 0.1 * torch.randn(H, generator=gen, device=cuda)).to(dtype)
        return x, y, w

    @staticmethod
    def _norms_close(x, y, w, dtype):
        out = tf.fused_rms_norm(x, w, 1e-6)
        s, o = tf.fused_add_rms_norm(x, y, w, 1e-6)
        torch.cuda.synchronize()
        _close(out, tf.rms_norm_plain(x, w, 1e-6), dtype)
        rs, ro = tf.add_rms_norm_plain(x, y, w, 1e-6)
        assert torch.equal(s, rs)
        _close(o, ro, dtype)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("B", [1, 8, 300])
    # the tick's widths (768, 128, 4096, 1536), 100 (no multiple of the
    # 16-byte piece: one value at a time), 8192 (the last width a row keeps
    # in registers in fp32), 2049 (one value at a time past 2048: the
    # strided loop) and 10000 (fp32: the strided loop; bf16: 10 warps)
    @pytest.mark.parametrize("H", [100, 128, 768, 1536, 4096, 8192, 2049,
                                   10000])
    def test_norms_match_plain(self, cuda, dtype, B, H):
        x, y, w = self._norm_inputs(cuda, dtype, B, H)
        n0 = tf.fused_rms_norm.launches, tf.fused_add_rms_norm.launches
        self._norms_close(x, y, w, dtype)
        assert (tf.fused_rms_norm.launches,
                tf.fused_add_rms_norm.launches) == (n0[0] + 1, n0[1] + 1)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("off", ["x", "y", "w"])
    def test_norms_off_a_16_byte_boundary(self, cuda, dtype, off):
        """One input a contiguous view one element (2 bytes in bf16, 4 in
        fp32) past a 16-byte boundary: the kernel reads one value at a
        time."""
        B, H = 8, 768
        x, y, w = self._norm_inputs(cuda, dtype, B, H, seed=1)
        src = {"x": x, "y": y, "w": w}[off]
        buf = torch.empty(src.numel() + 1, dtype=dtype, device=cuda)
        view = buf[1:].view(src.shape)
        view.copy_(src)
        assert view.is_contiguous() and view.data_ptr() % 16 != 0
        args = {"x": x, "y": y, "w": w, off: view}
        self._norms_close(args["x"], args["y"], args["w"], dtype)

    def test_norms_graph_replay_equals_eager(self, cuda):
        """Both norms captured into one CUDA graph and replayed on new
        inputs copied into the captured tensors give the eager calls'
        outputs bit for bit."""
        dt = torch.bfloat16
        x, y, w = self._norm_inputs(cuda, dt, 8, 768)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # warm up off the capture stream
            tf.fused_rms_norm(x, w, 1e-6)
            tf.fused_add_rms_norm(x, y, w, 1e-6)
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = tf.fused_rms_norm(x, w, 1e-6)
            s, o = tf.fused_add_rms_norm(x, y, w, 1e-6)
        for seed in range(3):
            nx, ny, nw = self._norm_inputs(cuda, dt, 8, 768, seed=seed + 2)
            x.copy_(nx)
            y.copy_(ny)
            w.copy_(nw)
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(out, tf.fused_rms_norm(x, w, 1e-6))
            es, eo = tf.fused_add_rms_norm(x, y, w, 1e-6)
            assert torch.equal(s, es) and torch.equal(o, eo)

    def test_norms_same_bits_without_programmatic_launch(self, cuda):
        """``set_pdl(False)`` launches the same kernels without
        programmatic dependent launch: the same outputs, bit for bit."""
        x, y, w = self._norm_inputs(cuda, torch.bfloat16, 8, 768)
        on = (tf.fused_rms_norm(x, w, 1e-6),
              *tf.fused_add_rms_norm(x, y, w, 1e-6))
        assert tf.set_pdl(False)
        try:
            off = (tf.fused_rms_norm(x, w, 1e-6),
                   *tf.fused_add_rms_norm(x, y, w, 1e-6))
        finally:
            assert not tf.set_pdl(True)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(on, off))

    def test_norms_reject_what_they_do_not_take(self, cuda):
        x, y, w = self._norm_inputs(cuda, torch.bfloat16, 8, 64)
        with pytest.raises(ValueError, match="contiguous"):
            tf.fused_rms_norm(x.t().contiguous().t(), w, 1e-6)
        with pytest.raises(ValueError, match="contiguous"):
            tf.fused_add_rms_norm(x, y.t().contiguous().t(), w, 1e-6)
        with pytest.raises(TypeError, match="dtype"):
            tf.fused_rms_norm(x.half(), w.half(), 1e-6)
        with pytest.raises(TypeError, match="dtype"):
            tf.fused_add_rms_norm(x.half(), y.half(), w.half(), 1e-6)

    def test_norms_of_no_rows(self, cuda):
        x, y, w = self._norm_inputs(cuda, torch.bfloat16, 8, 768)
        assert tf.fused_rms_norm(x[:0], w, 1e-6).shape == (0, 768)
        s, o = tf.fused_add_rms_norm(x[:0], y[:0], w, 1e-6)
        assert s.shape == o.shape == (0, 768)

    @staticmethod
    def _rope_case(cuda, dtype, nH, Hkv, D, max_len, seed=0):
        gen = torch.Generator(device=cuda).manual_seed(D + nH + seed)
        zq = _randn(gen, 8, nH * D, dtype=dtype, scale=2.0)
        zk = _randn(gen, 8, Hkv * D, dtype=dtype, scale=2.0)
        pos = torch.tensor([0, 1, 5, 64, 100, 200, max_len - 2, max_len - 1],
                           dtype=torch.int32, device=cuda)
        return zq, zk, pos

    @staticmethod
    def _rope_close(zq, zk, pos, D, max_len, dtype, got):
        rq, rk = tf.rope_qk_plain(zq, zk, pos, D, 10000.0)
        # angles near max_len carry one fp32 ulp of max_len; a one-ulp
        # difference in the frequency moves them by that much
        ulp = 2.0 ** (math.floor(math.log2(max_len - 1)) - 23)
        floor = 2 * ulp * max(zq.abs().max().item(), zk.abs().max().item())
        _close(got[0], rq, dtype, floor)
        _close(got[1], rk, dtype, floor)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("nH,Hkv,D,max_len", [
        (12, 12, 64, 384), (32, 8, 128, 2048),
        (8, 8, 16, 512),     # cpu_small: D 16
        (4, 2, 32, 384),
        (20, 5, 64, 384),    # 25 heads: no multiple of a block's group
        (6, 3, 24, 300),     # D / 2 no multiple of the 16-byte vector
    ])
    def test_rope_matches_plain(self, cuda, dtype, nH, Hkv, D, max_len):
        zq, zk, pos = self._rope_case(cuda, dtype, nH, Hkv, D, max_len)
        before = tf.fused_rope_qk.launches
        got = tf.fused_rope_qk(zq, zk, pos, D, 10000.0)
        torch.cuda.synchronize()
        assert tf.fused_rope_qk.launches == before + 1
        self._rope_close(zq, zk, pos, D, max_len, dtype, got)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("nH,Hkv,D", [(12, 12, 64), (4, 2, 32),
                                          (6, 3, 24)])
    def test_rope_reads_rows_of_a_fused_product(self, cuda, dtype, nH, Hkv,
                                                D):
        """q and k as column slices of one [B, (nH + 2 Hkv) D] product (the
        fused_weights tick): the kernel reads each row by its stride and
        gives the bits of the launch on contiguous copies."""
        g = torch.Generator(device=cuda).manual_seed(5)
        z = torch.randn(8, (nH + 2 * Hkv) * D, generator=g, device=cuda,
                        dtype=dtype)
        pos = torch.randint(0, 384, (8,), generator=g, device=cuda,
                            dtype=torch.int32)
        zq, zk = z[:, :nH * D], z[:, nH * D:(nH + Hkv) * D]
        got = tf.fused_rope_qk(zq, zk, pos, D, 10000.0)
        want = tf.fused_rope_qk(zq.contiguous(), zk.contiguous(), pos, D,
                                10000.0)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        with pytest.raises(ValueError, match="contiguous"):
            tf.fused_rope_qk(z.t().contiguous().t()[:, :nH * D], zk, pos, D,
                             10000.0)

    def test_rope_two_launches_give_the_same_bits(self, cuda):
        zq, zk, pos = self._rope_case(cuda, torch.bfloat16, 12, 12, 64, 384)
        a = tf.fused_rope_qk(zq, zk, pos, 64, 10000.0)
        b = tf.fused_rope_qk(zq, zk, pos, 64, 10000.0)
        torch.cuda.synchronize()
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])

    def test_rope_graph_replays_on_new_positions(self, cuda):
        """One launch captured into a CUDA graph, replayed on new
        positions copied into the captured tensor: each matches the plain
        version."""
        dt, max_len = torch.bfloat16, 384
        zq, zk, pos = self._rope_case(cuda, dt, 12, 12, 64, max_len)
        gen = torch.Generator(device=cuda).manual_seed(3)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # warm up off the capture stream
            tf.fused_rope_qk(zq, zk, pos, 64, 10000.0)
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            got = tf.fused_rope_qk(zq, zk, pos, 64, 10000.0)
        for _ in range(3):
            pos.copy_(torch.randint(0, max_len, (8,), generator=gen,
                                    device=cuda, dtype=torch.int32))
            graph.replay()
            torch.cuda.synchronize()
            self._rope_close(zq, zk, pos, 64, max_len, dt, got)


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


def test_unfused_epilogue_tick_launches_decode_attention(cuda):
    """``fused_tick_epilogue=False`` on the card: a ragged tick of the
    contiguous cache runs the inline rms and rope chains, yet attends
    through ``ragged_decode_attention`` (one launch a layer, no tick kernel
    launched), and its logits match the fused tick's."""
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

    def tick(c):
        cache = llama.init_kv_cache(c, 4, 128, cuda)
        llama.forward_with_cache(params, prompt, c, cache, 0)
        return _tick_launches(
            lambda: llama.forward_with_cache(params, nxt, c, cache, pos)[0])

    with torch.no_grad():
        got, launches = tick(dataclasses.replace(cfg,
                                                 fused_tick_epilogue=False))
        want, _ = tick(cfg)
    assert launches == {n: 2 if n == "ragged_decode_attention" else 0
                        for n in launches}
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


def test_engine_refuses_head_dims_the_kernels_do_not_take(cuda):
    """A ServingEngine built on the card checks its model's heads against
    the decode and paged kernels' set at build, before any tick."""
    from paddle_tpu_torch.inference.serving import ServingEngine

    for hidden, heads in ((80, 4), (272, 2)):  # D 20, then D 136
        cfg = llama.LlamaConfig.tiny(hidden_size=hidden, num_heads=heads,
                                     num_kv_heads=heads)
        for paged in (False, True):
            with pytest.raises(ValueError, match="head_dim"):
                ServingEngine(cfg, {}, max_len=64, prompt_buckets=(32,),
                              paged=paged, device=cuda)


def _plain_kernels(monkeypatch):
    """Every serving kernel of the tick swapped for its plain version."""
    monkeypatch.setattr(tf, "fused_rms_norm", tf.rms_norm_plain)
    monkeypatch.setattr(tf, "fused_add_rms_norm", tf.add_rms_norm_plain)
    monkeypatch.setattr(tf, "fused_rope_qk", tf.rope_qk_plain)
    monkeypatch.setattr(da, "ragged_decode_attention",
                        da.ragged_decode_attention_plain)
    monkeypatch.setattr(pa, "ragged_paged_attention",
                        pa.ragged_paged_attention_plain)


def test_long_admit_matches_plain_path(cuda, monkeypatch):
    """A paged engine at max_len 2048 with a 1024 bucket admits a
    1000-token prompt (one [1, 1024] prefill chunk through the paged
    kernel) and serves it; the same prefill and four ticks, teacher
    forced at bert_base_equiv width (two layers), through the kernels and
    through their plain versions: logits within 0.15 (chip_smoke's
    LOGIT_ATOL: bf16 residual streams rounded at other points)."""
    from paddle_tpu_torch.inference.serving import ServingEngine

    cfg = llama.LlamaConfig.bert_base_equiv(num_layers=2)
    params = llama.init_params(cfg, torch.Generator().manual_seed(0),
                               device=cuda)
    prompt = np.random.RandomState(0).randint(0, cfg.vocab_size, 1000)
    eng = ServingEngine(cfg, params, slots=2, max_len=2048,
                        prompt_buckets=(64, 128, 256, 512, 1024),
                        paged=True, device=cuda)
    before = pa.ragged_paged_attention.launches
    rid = eng.add_request(prompt, 8)
    out = eng.run()
    assert len(out[rid]) == 8
    assert pa.ragged_paged_attention.launches > before

    pt = torch.arange(1, 129, dtype=torch.int32, device=cuda)[None]
    tok = torch.zeros(1, 1024, dtype=torch.int64, device=cuda)
    tok[0, :1000] = torch.from_numpy(prompt)
    zero = torch.zeros(1, dtype=torch.int32, device=cuda)

    def run():
        pool = llama.init_paged_pool(cfg, 129, 16, cuda)
        logits = [llama.forward_with_pages(params, tok, cfg, pool, pt, zero,
                                           logit_pos=999)[0]]
        nxt = torch.tensor([[int(prompt[-1])]], device=cuda)
        for t in range(4):
            pos = torch.tensor([1000 + t], dtype=torch.int32, device=cuda)
            logits.append(llama.forward_with_pages(params, nxt, cfg, pool,
                                                   pt, pos)[0])
            nxt = torch.tensor([[100 + t]], device=cuda)
        return torch.stack(logits)

    with torch.no_grad():
        got = run()
        _plain_kernels(monkeypatch)
        want = run()
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= 0.15


@pytest.mark.parametrize("paged", [False, True])
def test_cpu_small_serves_on_the_card(cuda, monkeypatch, paged):
    """``LlamaConfig.cpu_small`` (8 heads of D 16, fp32) on the card: a
    drain through the engine gives every request its tokens through the
    kernels, and a teacher-forced tick's logits match the plain path's
    (fp32: 1e-4, as the other fp32 tick tests)."""
    from paddle_tpu_torch.inference.serving import ServingEngine

    cfg = llama.LlamaConfig.cpu_small()
    params = llama.init_params(cfg, torch.Generator().manual_seed(0),
                               device=cuda)
    rng = np.random.RandomState(0)
    reqs = [(rng.randint(0, cfg.vocab_size, n), g)
            for n, g in ((40, 16), (100, 24), (17, 9), (64, 30), (128, 5))]
    eng = ServingEngine(cfg, params, slots=4, max_len=256,
                        prompt_buckets=(64, 128), paged=paged, device=cuda)
    attn = pa.ragged_paged_attention if paged else da.ragged_decode_attention
    before = (attn.launches, tf.fused_rope_qk.launches)
    rids = [eng.add_request(p, g) for p, g in reqs]
    out = eng.run()
    assert [len(out[r]) for r in rids] == [g for _, g in reqs]
    assert attn.launches > before[0] and tf.fused_rope_qk.launches > before[1]

    B, max_len = 4, 256
    prompt = torch.from_numpy(rng.randint(0, cfg.vocab_size, (B, 48))).to(
        cuda)
    pos = torch.tensor([48, 3, 17, 200], dtype=torch.int32, device=cuda)
    nxt = torch.from_numpy(rng.randint(0, cfg.vocab_size, (B, 1))).to(cuda)
    pt = torch.from_numpy(rng.permutation(np.arange(1, 65)).reshape(
        B, 16).astype(np.int32)).to(cuda)

    def tick():
        if paged:
            pool = llama.init_paged_pool(cfg, 65, 16, cuda)
            llama.forward_with_pages(params, prompt, cfg, pool, pt,
                                     torch.zeros(B, dtype=torch.int32,
                                                 device=cuda))
            return llama.forward_with_pages(params, nxt, cfg, pool, pt,
                                            pos)[0]
        cache = llama.init_kv_cache(cfg, B, max_len, cuda)
        llama.forward_with_cache(params, prompt, cfg, cache, 0)
        return llama.forward_with_cache(params, nxt, cfg, cache, pos)[0]

    with torch.no_grad():
        got = tick()
        _plain_kernels(monkeypatch)
        want = tick()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


# the two serving widths of the contiguous engine's card tests: cpu_small
# (fp32, D 16: the padded kernel instances) and bert_base_equiv (bf16, D 64)
SERVE_CONFIGS = ["cpu_small", "bert_base_equiv"]


def _serve_model(cuda, name):
    cfg = getattr(llama.LlamaConfig, name)()
    return cfg, llama.init_params(cfg, torch.Generator().manual_seed(0),
                                  device=cuda)


def _tick_launches(fn):
    """Run ``fn`` with the serving kernels' launch counts at 0; returns its
    result and the counts."""
    from paddle_tpu_torch.ops.kernels import launch_counters

    fns = launch_counters()
    for f, attr in fns.values():
        setattr(f, attr, 0)
    out = fn()
    torch.cuda.synchronize()
    return out, {n: getattr(f, attr) for n, (f, attr) in fns.items()}


def _assert_tick_launches(launches, L, ticks):
    """Every decode tick launched the four tick kernels, L or L + 1 times,
    and nothing else launched."""
    want = {"ragged_decode_attention": L * ticks,
            "fused_rms_norm": (L + 1) * ticks,
            "fused_add_rms_norm": L * ticks, "fused_rope_qk": L * ticks}
    assert launches == {n: want.get(n, 0) for n in launches}


@pytest.mark.parametrize("name", SERVE_CONFIGS)
def test_fused_drain_launches_the_tick_kernels(cuda, name):
    """``run()``'s fused drain on the card: every request gets its count,
    each decode tick launches the tick kernels, one fetch for the drain,
    and (fp32) the windowed drain's tokens."""
    from paddle_tpu_torch.inference.serving import ServingEngine

    cfg, params = _serve_model(cuda, name)
    rng = np.random.RandomState(0)
    reqs = [(rng.randint(0, cfg.vocab_size, n), g)
            for n, g in ((40, 16), (100, 24), (17, 9), (64, 30), (128, 5),
                         (9, 12))]

    def engine():
        eng = ServingEngine(cfg, params, slots=4, max_len=256, chunk=8,
                            prompt_buckets=(64, 128), device=cuda)
        return eng, [eng.add_request(p, g) for p, g in reqs]

    eng, rids = engine()
    out, launches = _tick_launches(eng.run)
    assert [len(out[r]) for r in rids] == [g for _, g in reqs]
    assert all(0 <= t < cfg.vocab_size for r in rids for t in out[r])
    assert eng.fetches == 1
    _assert_tick_launches(launches, cfg.num_layers, eng.last_run_ticks)
    if cfg.dtype == torch.float32:
        win, wids = engine()
        windowed = win.run(fused=False)
        assert [windowed[r] for r in wids] == [out[r] for r in rids]


@pytest.mark.parametrize("name", SERVE_CONFIGS)
def test_dense_segment_prefix_hit(cuda, name):
    """Contiguous-engine segments with a row-copy PrefixCache on the card:
    a shared 64-token prefix is harvested and then hit, each decode tick
    launches the tick kernels, and (fp32) the hot streams equal the cold
    ones."""
    from paddle_tpu_torch.inference.prefix_cache import PrefixCache
    from paddle_tpu_torch.inference.serving import ServingEngine

    cfg, params = _serve_model(cuda, name)
    rng = np.random.RandomState(1)
    prefix = rng.randint(0, cfg.vocab_size, 64)
    reqs = [(np.concatenate([prefix, rng.randint(0, cfg.vocab_size, n)]), g)
            for n, g in ((10, 12), (30, 8), (5, 16), (20, 10), (12, 6))]

    def serve(pc):
        eng = ServingEngine(cfg, params, slots=2, max_len=256,
                            prompt_buckets=(32, 64, 128), device=cuda)
        rids = [eng.add_request(p, g) for p, g in reqs]
        steps, admits = [0], [0]

        def drain():
            while eng._queue or eng.free_slot_count() < eng.slots:
                ev = eng.run_segment(16, prefix_cache=pc)
                steps[0] += ev["steps"]
                admits[0] += len(ev["admitted"])
            return eng.collect_finished()

        out, launches = _tick_launches(drain)
        _assert_tick_launches(launches, cfg.num_layers, steps[0] - admits[0])
        return [out[r] for r in rids]

    cold = serve(None)
    pc = PrefixCache(block=32)
    hot = serve(pc)
    assert pc.hits >= 1 and pc.hit_tokens >= 64
    assert [len(t) for t in hot] == [g for _, g in reqs]
    if cfg.dtype == torch.float32:
        assert hot == cold


# paged engine options whose warmups make different ticket buffers: the
# decode tick's (slots x kv heads), a chunk of 8 at one query head a kv
# head (the split-KV family at one row), a verify tick, the int8 pool
WARM_FAMILIES = {"pseg": {}, "cseg": dict(chunked_prefill=True,
                                          prefill_chunks=(8, 32)),
                 "sseg": dict(speculative=2), "qpseg": dict(quant="int8")}


@pytest.mark.parametrize("family", sorted(WARM_FAMILIES))
def test_warmed_serve_builds_nothing(cuda, family):
    """After ``aot_warmup`` a serve inside the envelope loads no kernel
    library, makes no split-KV ticket buffer and dispatches no key the
    engine had not run (``analysis.recompile``); the process's ticket
    buffers are set aside first, so the warmup is what makes them."""
    from paddle_tpu_torch.analysis import recompile
    from paddle_tpu_torch.inference.prefix_cache import PagedPrefixCache
    from paddle_tpu_torch.inference.serving import ServingEngine

    cfg, params = _serve_model(cuda, "bert_base_equiv")
    eng = ServingEngine(cfg, params, slots=4, max_len=256, chunk=8,
                        prompt_buckets=(32, 64, 128), paged=True,
                        page_size=16, device=cuda, **WARM_FAMILIES[family])
    pc = PagedPrefixCache(eng.pager, capacity_pages=32)
    env = eng.default_envelope(seg_steps=(16,), prefix_block=16)
    torch.cuda.synchronize()
    held = list(da._TICKETS.values())     # kept alive, out of the map
    da._TICKETS.clear()
    with recompile.CompileWatch() as warm:
        eng.aot_warmup(env, prefix_cache=pc)
    # a quantized pool attends through the dequantizing gather: no
    # split-KV launch, no ticket buffer
    assert warm.tickets >= (0 if eng.quant else 1)
    assert warm.unenumerated == sum(
        len(v) for v in eng.program_space(env).values())
    rng = np.random.RandomState(4)
    prefix = rng.randint(0, cfg.vocab_size, 48)
    reqs = [(np.concatenate([prefix, rng.randint(0, cfg.vocab_size, n)])
             if i % 2 else rng.randint(0, cfg.vocab_size, n), g)
            for i, (n, g) in enumerate(((40, 12), (20, 9), (70, 16),
                                        (9, 5), (33, 20), (64, 7)))]
    rids = [eng.add_request(p, g) for p, g in reqs]
    with recompile.enforce_zero_compiles(family) as cw:
        while eng._queue or eng.free_slot_count() < eng.slots:
            eng.run_segment(16, prefix_cache=pc)
    out = eng.collect_finished()
    assert cw.as_dict() == {"loads": 0, "tickets": 0, "unenumerated": 0}
    assert [len(out[r]) for r in rids] == [g for _, g in reqs]
    assert pc.hits >= 1


@pytest.mark.parametrize("name", SERVE_CONFIGS)
@pytest.mark.parametrize("num_beams", [1, 4, 8])
def test_beam_search_launches_the_tick_kernels(cuda, name, num_beams):
    """``beam_search_generate`` on the card: one decode tick a generated
    token (the first re-runs the prompt's last token), each through the
    tick kernels; tokens in the vocabulary, and (fp32) one beam is the
    greedy stream."""
    cfg, params = _serve_model(cuda, name)
    prompt = np.random.RandomState(2).randint(0, cfg.vocab_size, (2, 64))
    T = 32
    out, launches = _tick_launches(lambda: llama.beam_search_generate(
        params, prompt, cfg, max_new_tokens=T, num_beams=num_beams,
        device=cuda))
    assert out.shape == (2, T)
    assert ((out >= 0) & (out < cfg.vocab_size)).all()
    _assert_tick_launches(launches, cfg.num_layers, T)
    if num_beams == 1 and cfg.dtype == torch.float32:
        assert torch.equal(out, llama.generate(params, prompt, cfg,
                                               max_new_tokens=T,
                                               device=cuda))


def test_sampled_generate_replays_its_seed(cuda):
    """Sampled ``generate`` on the card (T 0.8, top-k 50, top-p 0.9): the
    same seed twice gives the same tokens, another seed others, and each
    decode tick launches the tick kernels."""
    cfg, params = _serve_model(cuda, "cpu_small")
    prompt = np.random.RandomState(3).randint(0, cfg.vocab_size, (2, 32))
    kw = dict(max_new_tokens=24, temperature=0.8, top_k=50, top_p=0.9,
              device=cuda)
    a, launches = _tick_launches(lambda: llama.generate(
        params, prompt, cfg, seed=1, **kw))
    _assert_tick_launches(launches, cfg.num_layers, 23)
    assert torch.equal(a, llama.generate(params, prompt, cfg, seed=1, **kw))
    assert not torch.equal(a, llama.generate(params, prompt, cfg, seed=2,
                                             **kw))


FLASH_SHAPES = [  # B, Sq, Sk, H, D, causal
    (2, 128, 128, 4, 64, True),
    (2, 128, 128, 4, 64, False),
    (1, 512, 512, 4, 64, True),     # bench.py's sequence length
    (1, 1024, 1024, 2, 64, True),   # past 512: the TPU's blocked regime
    (1, 256, 256, 2, 128, True),    # llama7b's head width
    (2, 200, 200, 3, 64, True),     # a ragged edge at 64-row tiles
    (1, 40, 100, 2, 128, True),     # Sq < Sk: causal offset 60
    (1, 72, 136, 2, 64, False),
]


def _flash_inputs(cuda, B, Sq, Sk, H, D):
    gen = torch.Generator(device=cuda).manual_seed(Sq * 7 + Sk + D)
    dt = torch.bfloat16
    return (_randn(gen, B, Sq, H, D, dtype=dt),
            _randn(gen, B, Sk, H, D, dtype=dt),
            _randn(gen, B, Sk, H, D, dtype=dt),
            _randn(gen, B, Sq, H, D, dtype=dt))


class TestFlashAttention:
    """The forward and the backward kernel (one launch of both roles, and
    each role alone) against their plain versions in bf16; the backward
    gets the same out, lse and delta as the plain backward. lse is fp32:
    to 1e-4 (exp2 and log2 on the card's approximate units, sums in
    another order)."""

    @pytest.mark.parametrize("B,Sq,Sk,H,D,causal", FLASH_SHAPES)
    def test_matches_plain(self, cuda, B, Sq, Sk, H, D, causal):
        dt = torch.bfloat16
        q, k, v, do = _flash_inputs(cuda, B, Sq, Sk, H, D)
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

    @pytest.mark.parametrize("B,Sq,Sk,H,D,causal", FLASH_SHAPES)
    def test_one_launch_backward(self, cuda, B, Sq, Sk, H, D, causal):
        """``flash_attention_bwd``: dq, dk and dv within the plain versions'
        budgets, bit-identical to the role-only launches and to a second
        call, one launch a call."""
        dt = torch.bfloat16
        q, k, v, do = _flash_inputs(cuda, B, Sq, Sk, H, D)
        ref, lse = fa.flash_attention_fwd_plain(q, k, v, causal)
        args = (q, k, v, do, lse, fa.attention_delta(ref, do), causal)
        n0 = fa.flash_attention_bwd.launches
        got = fa.flash_attention_bwd(*args)
        torch.cuda.synchronize()
        assert fa.flash_attention_bwd.launches == n0 + 1
        for g, w in zip(got, fa.flash_attention_bwd_grads_plain(*args)):
            assert torch.isfinite(g.float()).all()
            _close(g, w, dt)
        roles = (fa.flash_attention_bwd_dq(*args),
                 *fa.flash_attention_bwd_dkv(*args))
        again = fa.flash_attention_bwd(*args)
        torch.cuda.synchronize()
        assert fa.flash_attention_bwd.launches == n0 + 2
        for g, r, a in zip(got, roles, again):
            assert torch.equal(g, r)
            assert torch.equal(g, a)

    def test_rejects_what_it_does_not_take(self, cuda):
        q = torch.zeros(1, 64, 2, 64, device=cuda, dtype=torch.float16)
        with pytest.raises(TypeError, match="bfloat16"):
            fa.flash_attention_fwd(q, q, q)
        q = torch.zeros(1, 64, 2, 32, device=cuda)
        with pytest.raises(ValueError, match="head_dim"):
            fa.flash_attention_fwd(q, q, q)
        q = torch.zeros(1, 64, 2, 32, device=cuda, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="head_dim"):
            fa.flash_attention_fwd(q, q, q)
        q = torch.zeros(1, 2, 64, 64, device=cuda,
                        dtype=torch.bfloat16).transpose(1, 2)
        with pytest.raises(ValueError, match="contiguous"):
            fa.flash_attention_bwd_dq(
                q, q, q, q, *[torch.zeros(1, 2, 64, device=cuda)] * 2)
        with pytest.raises(ValueError, match="contiguous"):
            fa.flash_attention_bwd(
                q, q, q, q, *[torch.zeros(1, 2, 64, device=cuda)] * 2)


# the fp32 instance against the plain version: both compute in fp32, in
# other orders (the kernel's online softmax rescales by exp2 of running
# maxima); the fp32 bar on outputs and gradients of magnitude ~1
F32_ATOL = 1e-4
F32_SHAPES = [  # B, Sq, Sk, H, D, causal
    (2, 256, 256, 3, 64, False),
    (2, 200, 200, 3, 64, True),     # ragged 64-row tiles
    (1, 40, 100, 2, 128, True),     # Sq < Sk: causal offset 60
    (1, 72, 136, 2, 64, False),     # cross attention, Sq != Sk
    (1, 130, 70, 2, 128, False),    # Sq > Sk
    (1, 512, 512, 2, 128, True),
    (1, 150, 150, 2, 128, True),    # ragged at the backward's 128 rows
    (2, 1, 77, 2, 64, True),        # Sq 1: one row sees every key
    (1, 1, 1, 1, 128, False),
    (1, 33, 200, 2, 64, True),      # Sq < Sk at D 64: offset 167
    (1, 97, 161, 2, 128, True),     # ragged 32-key tiles, offset 64
    (4, 512, 512, 16, 128, False),  # D 128 at B * H 64: the grid filled
]


class TestFlashAttentionF32:
    """The fp32 instance (``csrc/flash_attention_f32.cu``): forward, the
    one-launch backward and each role alone against the plain versions,
    counted in ``f32_launches`` and never in the bf16 kernels' counts."""

    def _inputs(self, cuda, B, Sq, Sk, H, D):
        gen = torch.Generator(device=cuda).manual_seed(Sq * 3 + Sk + D)
        f = torch.float32
        return (_randn(gen, B, Sq, H, D, dtype=f),
                _randn(gen, B, Sk, H, D, dtype=f),
                _randn(gen, B, Sk, H, D, dtype=f),
                _randn(gen, B, Sq, H, D, dtype=f))

    @pytest.mark.parametrize("B,Sq,Sk,H,D,causal", F32_SHAPES)
    def test_matches_plain(self, cuda, B, Sq, Sk, H, D, causal):
        q, k, v, do = self._inputs(cuda, B, Sq, Sk, H, D)
        fns = (fa.flash_attention_fwd, fa.flash_attention_bwd,
               fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv)
        n0 = [(f.launches, f.f32_launches) for f in fns]
        out, lse = fa.flash_attention_fwd(q, k, v, causal)
        ref, ref_lse = fa.flash_attention_fwd_plain(q, k, v, causal)
        torch.cuda.synchronize()
        torch.testing.assert_close(out, ref, rtol=0, atol=F32_ATOL)
        torch.testing.assert_close(lse, ref_lse, rtol=0, atol=F32_ATOL)
        args = (q, k, v, do, ref_lse, fa.attention_delta(ref, do), causal)
        grads = fa.flash_attention_bwd(*args)
        roles = (fa.flash_attention_bwd_dq(*args),
                 *fa.flash_attention_bwd_dkv(*args))
        torch.cuda.synchronize()
        for g, r, w in zip(grads, roles,
                           fa.flash_attention_bwd_grads_plain(*args)):
            assert g.dtype == torch.float32
            torch.testing.assert_close(g, w, rtol=0, atol=F32_ATOL)
            assert torch.equal(g, r)
        assert [(f.launches, f.f32_launches) for f in fns] == [
            (a, b + 1) for a, b in n0]

    @pytest.mark.parametrize("D", [64, 128])
    def test_smem_bytes_is_the_launch_request(self, cuda, tmp_path, D):
        """``smem_bytes(kind, D, float32)`` equals the shared memory the
        launches of the forward and the one-launch backward asked for, as
        the profiler's trace records it (dynamic plus static: the kernels
        declare no static shared memory)."""
        from torch.profiler import ProfilerActivity, profile

        q, k, v, do = self._inputs(cuda, 1, 128, 128, 2, D)
        out, lse = fa.flash_attention_fwd(q, k, v)
        args = (q, k, v, do, lse, fa.attention_delta(out, do))
        torch.cuda.synchronize()
        got = {}
        # a profiling session may miss a kernel's record: up to three
        # sessions, until both launches are recorded
        for attempt in range(3):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fa.flash_attention_fwd(q, k, v)
                fa.flash_attention_bwd(*args)
                torch.cuda.synchronize()
            trace = tmp_path / f"trace{attempt}.json"
            prof.export_chrome_trace(str(trace))
            for e in json.loads(trace.read_text())["traceEvents"]:
                for kind in ("fwd", "bwd"):
                    if (e.get("cat") == "kernel"
                            and f"flash_{kind}_f32" in e.get("name", "")):
                        got.setdefault(kind, set()).add(
                            e["args"]["shared memory"])
            if len(got) == 2:
                break
        assert got == {kind: {fa.smem_bytes(kind, D, torch.float32)}
                       for kind in ("fwd", "bwd")}

    def test_fp32_never_takes_the_plain_version(self, cuda, monkeypatch):
        """A CUDA fp32 tensor launches the instance or raises: with the
        plain versions poisoned the kernels still answer, and a shape the
        instance does not take raises."""
        def poisoned(*a, **k):
            raise AssertionError("the plain version ran on the card")
        for name in ("flash_attention_fwd_plain",
                     "flash_attention_bwd_grads_plain"):
            monkeypatch.setattr(fa, name, poisoned)
        q, k, v, _ = self._inputs(cuda, 1, 64, 64, 2, 64)
        q.requires_grad_()
        fa.dot_product_attention(q, k, v).sum().backward()
        torch.cuda.synchronize()
        assert torch.isfinite(q.grad).all()
        with pytest.raises(ValueError, match="head_dim"):
            fa.flash_attention_fwd(*(t[..., :48].contiguous()
                                     for t in (q.detach(), k, v)))


@pytest.mark.parametrize("amp", [False, True])
def test_eager_attention_launches_the_flash_kernels(cuda, amp):
    """An eager ``MultiHeadAttention`` on the card: fp32 attention
    launches the fp32 instance, under ``auto_cast`` the bf16 kernels, one
    forward and one backward a call; a mask launches neither."""
    import paddle_tpu_torch as port

    prev = set_device(str(cuda))
    try:
        port.seed(0)
        mha = port.nn.MultiHeadAttention(128, 2)
        x = torch.randn(2, 96, 128, device=cuda)
        fwd, bwd = fa.flash_attention_fwd, fa.flash_attention_bwd
        attr = "launches" if amp else "f32_launches"
        n0 = (getattr(fwd, attr), getattr(bwd, attr))
        with port.amp.auto_cast(enable=amp, dtype="bfloat16"):
            out = mha(x, x, x)
        out.float().sum().backward()
        torch.cuda.synchronize()
        assert (getattr(fwd, attr), getattr(bwd, attr)) == (n0[0] + 1,
                                                            n0[1] + 1)
        mask = torch.ones(2, 1, 1, 96, dtype=torch.bool, device=cuda)
        mha(x, attn_mask=mask).sum().backward()
        assert (getattr(fwd, attr), getattr(bwd, attr)) == (n0[0] + 1,
                                                            n0[1] + 1)
    finally:
        set_device(prev)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_bert_loss_and_grads_match_plain_path(cuda, monkeypatch, dtype):
    """``bert.loss_fn`` at D 64 (2 heads of 64, 2 layers, remat on: the
    attention outside the checkpointed halves) through the kernels and
    through their plain versions: one forward and one backward launch a
    layer, non-causal; bf16 within the training budgets, fp32 within
    1e-4 of the loss and 1e-3 of each gradient's norm."""
    cfg = bert.BertConfig.tiny(hidden_size=128, intermediate_size=256,
                               num_heads=2, max_seq_len=256, dtype=dtype,
                               remat=True)
    params = bert.init_params(cfg, torch.Generator().manual_seed(0),
                              device=cuda)
    tok, lab = bert.random_mlm_batch(cfg, 2, 256, device=cuda)
    attr = "launches" if dtype == torch.bfloat16 else "f32_launches"

    def run():
        leaves = {k: p.clone().requires_grad_() for k, p in params.items()}
        loss = bert.loss_fn(leaves, tok, lab, cfg)
        loss.backward()
        return loss.item(), {k: p.grad for k, p in leaves.items()}

    fns = (fa.flash_attention_fwd, fa.flash_attention_bwd)
    n0 = [getattr(f, attr) for f in fns]
    got = run()
    assert [getattr(f, attr) - n for f, n in zip(fns, n0)] == [2, 2]
    monkeypatch.setattr(fa, "flash_attention_fwd",
                        fa.flash_attention_fwd_plain)
    monkeypatch.setattr(fa, "flash_attention_bwd",
                        fa.flash_attention_bwd_grads_plain)
    want = run()
    loss_atol, grad_rtol = ((LOSS_ATOL, GRAD_RTOL) if dtype == torch.bfloat16
                            else (1e-4, 1e-3))
    assert abs(got[0] - want[0]) <= loss_atol
    for k, g in want[1].items():
        err = ((got[1][k] - g).norm() / g.norm().clamp(min=1e-12)).item()
        assert err <= grad_rtol, (k, err)


def _head_dx_inputs(cuda, M, V, H, seed=0):
    """The CE tail's inputs: logits at scale 3, m their row max, scale =
    weight / sumexp, W at scale 1/sqrt(H) (its init) or 1."""
    gen = torch.Generator(device=cuda).manual_seed(M + V + H + seed)
    logits = _randn(gen, M, V, dtype=torch.bfloat16, scale=3.0)
    m = logits.float().max(-1).values
    se = torch.exp(logits.float() - m[:, None]).sum(-1)
    scale = torch.rand(M, generator=gen, device=cuda) / se
    w = _randn(gen, H, V, dtype=torch.bfloat16)
    return logits, m, scale, w


def _head_dx_close(out, ref):
    """The outputs are small beside the shared bf16 atol (a row's
    probabilities sum to at most 1), so the limit is tied to their size:
    atol 2^-7 of the largest |output| (two bf16 ulps there), and the
    relative Frobenius error within 1e-2 (the output's own bf16 rounding
    is ~2^-9 of it; a dropped V tile moves it more)."""
    out, ref = out.float(), ref.float()
    torch.testing.assert_close(out, ref, rtol=TOL[torch.bfloat16][0],
                               atol=2.0 ** -7 * ref.abs().max().item())
    assert ((out - ref).norm() / ref.norm()).item() <= 1e-2


class TestHeadDx:
    @pytest.mark.parametrize("M,V,H", [
        (300, 1000, 64), (256, 4096, 256), (130, 520, 200),
        (22528, 32000, 768),   # the CE tail's (bench.py's 44 x 512 rows)
        (22529, 32000, 768),   # a ragged last row tile
        (1000, 32000, 64), (1000, 32000, 200),  # H below one column tile
    ])
    def test_matches_plain(self, cuda, M, V, H):
        """Rows past a 128-row tile, V past a 64-column step and H past a
        256-column tile are masked; scale = weight / sumexp, as the CE
        tail passes it."""
        logits, m, scale, w = _head_dx_inputs(cuda, M, V, H)
        n0 = hd.head_dx_softmax.launches
        out = hd.head_dx_softmax(logits, m, scale, w)
        torch.cuda.synchronize()
        assert hd.head_dx_softmax.launches == n0 + 1
        _head_dx_close(out, hd.head_dx_softmax_plain(logits, m, scale, w))

    def test_negative_and_zero_scales(self, cuda):
        """A row's scale carries the cotangent's sign and its weight: rows
        of negative, zero and positive scale, and an m below a row's max
        (where the clamp at 0 binds), all as the plain version."""
        logits, m, scale, w = _head_dx_inputs(cuda, 700, 4096, 200)
        scale[::3] *= -1.0
        scale[1::7] = 0.0
        m[5::11] -= 2.0
        _head_dx_close(hd.head_dx_softmax(logits, m, scale, w),
                       hd.head_dx_softmax_plain(logits, m, scale, w))

    def test_two_launches_give_the_same_bits(self, cuda):
        args = _head_dx_inputs(cuda, 2000, 32000, 768)
        a = hd.head_dx_softmax(*args)
        b = hd.head_dx_softmax(*args)
        torch.cuda.synchronize()
        assert torch.equal(a, b)

    def test_graph_replays_on_new_logits(self, cuda):
        """One launch captured into a CUDA graph (its TMA maps are kernel
        parameters), replayed on new logits, m and scale copied into the
        captured tensors: each matches the plain version."""
        logits, m, scale, w = _head_dx_inputs(cuda, 1000, 4096, 768)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # warm up off the capture stream
            hd.head_dx_softmax(logits, m, scale, w)
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = hd.head_dx_softmax(logits, m, scale, w)
        for seed in (1, 2):
            new = _head_dx_inputs(cuda, 1000, 4096, 768, seed=seed)
            for t, n in zip((logits, m, scale), new[:3]):
                t.copy_(n)
            graph.replay()
            torch.cuda.synchronize()
            _head_dx_close(out, hd.head_dx_softmax_plain(logits, m, scale,
                                                         w))

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
    forward and the one-launch backward launch once per layer (the role-only
    backward entries never) and the CE tail's once."""
    cfg = llama.LlamaConfig(vocab_size=512, hidden_size=256,
                            intermediate_size=512, num_layers=2,
                            num_heads=4, num_kv_heads=2, max_seq_len=256,
                            remat=False, ce_tail_custom=True)
    params = llama.init_params(cfg, torch.Generator().manual_seed(0),
                               device=cuda, dtype=torch.float32)
    tok = torch.from_numpy(np.random.RandomState(0).randint(
        0, 512, (2, 256))).to(cuda)
    fns = (fa.flash_attention_fwd, fa.flash_attention_bwd,
           fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv,
           hd.head_dx_softmax)

    def run():
        leaves = {k: p.clone().requires_grad_() for k, p in params.items()}
        loss = llama.loss_fn(leaves, tok, tok, cfg)
        loss.backward()
        return loss.item(), {k: p.grad for k, p in leaves.items()}

    n0 = [f.launches for f in fns]
    got = run()
    assert [f.launches - n for f, n in zip(fns, n0)] == [2, 2, 0, 0, 1]
    monkeypatch.setattr(fa, "flash_attention_fwd",
                        fa.flash_attention_fwd_plain)
    monkeypatch.setattr(fa, "flash_attention_bwd",
                        fa.flash_attention_bwd_grads_plain)
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
        (3, 100, 200),     # ragged K (no multiple of a 64-row stage)
        (5, 70, 99),       # N no multiple of 16: the byte-wise loads
        (12, 300, 130),    # more rows than one block holds
        (2, 1000, 64),
        # the K splits' edges: the deepest tick shape, K no multiple of a
        # split's stages, N no multiple of a column tile, B across the
        # 8-row batch tiles
        (1, 3072, 768), (9, 3072, 768), (17, 770, 999), (8, 770, 999),
        (9, 770, 256), (1, 770, 999),
        # 128-column strips (the warps split the columns): a ragged last
        # strip, then N odd (the byte-wise copies)
        (3, 200, 17040), (9, 770, 20001),
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

    @pytest.mark.parametrize("mode", ["int8", "fp8"])
    @pytest.mark.parametrize("B,K,N", [(8, 3072, 768), (8, 768, 3072),
                                       (17, 770, 999)])
    def test_two_launches_give_the_same_bits(self, cuda, mode, B, K, N):
        """The K splits merge in rank order: no run-to-run difference."""
        gen = torch.Generator(device=cuda).manual_seed(K + N)
        w, sc = qs.quantize_weight(
            _randn(gen, K, N, dtype=torch.float32, scale=K ** -0.5), mode)
        x = _randn(gen, B, K, dtype=torch.bfloat16)
        a = qm.quant_matmul(x, w, sc)
        b = qm.quant_matmul(x, w, sc)
        torch.cuda.synchronize()
        assert torch.equal(a, b)

    def test_graph_replays_on_new_x(self, cuda):
        """One launch captured into a CUDA graph (the cluster merge keeps
        no state between launches), replayed on new x: equal to the plain
        version each time."""
        gen = torch.Generator(device=cuda).manual_seed(5)
        K, N = 3072, 768
        w, sc = qs.quantize_weight(
            _randn(gen, K, N, dtype=torch.float32, scale=K ** -0.5), "int8")
        x = _randn(gen, 8, K, dtype=torch.bfloat16)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            qm.quant_matmul(x, w, sc)
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = qm.quant_matmul(x, w, sc)
        for _ in range(3):
            x.copy_(_randn(gen, 8, K, dtype=torch.bfloat16))
            graph.replay()
            torch.cuda.synchronize()
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
        pos = _decode_positions(cuda, max_len)
        B = len(pos)
        qdt = qs.quant_dtype(mode)
        kc, ks = qs.quantize_kv_rows(
            _randn(gen, 2, B, max_len, Hkv, D, dtype=torch.float32), qdt)
        vc, vs = qs.quantize_kv_rows(
            _randn(gen, 2, B, max_len, Hkv, D, dtype=torch.float32), qdt)
        q = _randn(gen, B, nH, D, dtype=dtype)
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

    @pytest.mark.parametrize("mode", ["int8", "fp8"])
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("D", HEAD_DIMS)
    @pytest.mark.parametrize("nH,Hkv", [(8, 8), (8, 2)])
    def test_head_dims(self, cuda, mode, dtype, D, nH, Hkv):
        """Every head dim of 8s in quant mode, MHA and GQA: the padded
        instances copy one-byte rows in 8-byte pieces (rows of D % 16 ==
        8, 24, 80 and 112, start on 8-byte boundaries)."""
        gen = torch.Generator(device=cuda).manual_seed(D * nH + Hkv)
        max_len = 200
        pos = _decode_positions(cuda, max_len)
        B = len(pos)
        qdt = qs.quant_dtype(mode)
        kc, ks = qs.quantize_kv_rows(
            _randn(gen, 2, B, max_len, Hkv, D, dtype=torch.float32), qdt)
        vc, vs = qs.quantize_kv_rows(
            _randn(gen, 2, B, max_len, Hkv, D, dtype=torch.float32), qdt)
        q = _randn(gen, B, nH, D, dtype=dtype)
        out = da.ragged_decode_attention(q, kc[1], vc[1], pos, ks[1], vs[1])
        torch.cuda.synchronize()
        _close(out, da.ragged_decode_attention_plain(
            q, kc[1], vc[1], pos.clamp(max=max_len - 1), ks[1], vs[1]),
            dtype)

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

    @pytest.mark.parametrize("tile", bmm.TILES)
    def test_persistent_grid_tail(self, cuda, tile):
        """More output tiles than the persistent grid has blocks (one per
        SM), and no multiple of it: some blocks walk one tile fewer."""
        gen = torch.Generator(device=cuda).manual_seed(1)
        M, K, N = 4864, 256, 1024
        sms = torch.cuda.get_device_properties(cuda).multi_processor_count
        tiles = (M // tile[0]) * (N // tile[1])
        assert tiles > sms and tiles % sms
        a = _randn(gen, M, K, dtype=torch.bfloat16)
        b = _randn(gen, K, N, dtype=torch.bfloat16)
        out = bmm.blocked_matmul(a, b, *tile)
        torch.cuda.synchronize()
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

    @pytest.mark.parametrize("D", [64, 128])
    @pytest.mark.parametrize("S,nsplit", [(512, 8), (512, 16), (64, 1),
                                          (2048, 1), (2048, 4)])
    def test_tilings_match_plain(self, cuda, S, nsplit, D):
        """Tilings the TMA ring and the per-row extents must handle: R 64
        and R 32 (two extents inside one 64-row tile) at S 512, a single
        tile (S 64), and 32 key tiles (S 2048), causal and not."""
        q, k, v, do = _fv_inputs(cuda, 1, S, 2, D, seed=2)
        for causal in (True, False):
            out, lse = fv.run_fwd(q, k, v, causal, nsplit)
            ref, ref_lse = fv.run_fwd_plain(q, k, v, causal, nsplit)
            torch.cuda.synchronize()
            _close(out, ref, torch.bfloat16)
            torch.testing.assert_close(lse, ref_lse, rtol=1e-3, atol=1e-3)
            bwd = (q, k, v, do, ref, ref_lse, causal, nsplit)
            for g, w in zip(fv.run_bwd(*bwd), fv.run_bwd_plain(*bwd)):
                _close(g, w, torch.bfloat16)

    @pytest.mark.parametrize("D", [64, 128])
    @pytest.mark.parametrize("flags", sorted(fv.FWD_INSTANCES))
    def test_every_fwd_instance(self, cuda, flags, D):
        """Each forward template instance at nsplit 2 against the plain
        version (q prescaled, or scaled in the kernel for SCALE_IN)."""
        q, k, v = _fv_inputs(cuda, 1, 256, 2, D, n=3, seed=3)
        c = fv._scale(D) * fv.LOG2_E
        if not flags & fv.SCALE_IN:
            q = fv._prescale(q, c)
        out, lse = fv.variant_fwd(q, k, v, flags, 2, c)
        ref, ref_lse = fv.variant_fwd_plain(q, k, v, flags, 2, c)
        torch.cuda.synchronize()
        if flags & fv.DIAG:
            _close_of_max(out, ref)
        else:
            _close(out, ref, torch.bfloat16)
        torch.testing.assert_close(lse, ref_lse, rtol=1e-3, atol=1e-3)

    @pytest.mark.parametrize("D", [64, 128])
    @pytest.mark.parametrize("flags", sorted(fv.BWD_INSTANCES))
    def test_every_bwd_instance(self, cuda, flags, D):
        """Each backward template instance at nsplit 2 against the plain
        version, from the plain forward's out and lse (same mask)."""
        q, k, v, do = _fv_inputs(cuda, 1, 256, 2, D, seed=4)
        q = fv._prescale(q, fv._scale(D) * fv.LOG2_E)
        o, lse = fv.variant_fwd_plain(q, k, v,
                                      flags & (fv.CAUSAL | fv.EXP_BF16), 2)
        args = (q, k, v, do, o, lse, flags, 2, fv._scale(D), 1 / fv.LOG2_E)
        for g, w in zip(fv.variant_bwd(*args), fv.variant_bwd_plain(*args)):
            if flags & fv.DIAG:
                _close_of_max(g, w)
            else:
                _close(g, w, torch.bfloat16)

    @pytest.mark.parametrize("D", [64, 128])
    def test_two_calls_give_the_same_bits(self, cuda, D):
        """No atomics and a fixed order of sums: a second call repeats
        the first bit for bit."""
        q, k, v, do = _fv_inputs(cuda, 2, 512, 2, D, seed=5)
        first = fv.run_fwd(q, k, v, True, 4)
        again = fv.run_fwd(q, k, v, True, 4)
        assert all(torch.equal(a, b) for a, b in zip(first, again))
        g1 = fv.run_bwd(q, k, v, do, *first, True, 4)
        g2 = fv.run_bwd(q, k, v, do, *first, True, 4)
        assert all(torch.equal(a, b) for a, b in zip(g1, g2))

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


# ---------------------------------------------------------------------------
# the host KV tier: stage and restore on the card
# ---------------------------------------------------------------------------


def _tier_pool(cuda, quant, seed=0):
    """A bert-width-by-head paged pool (12 heads of D 64, two layers) in
    bf16 or a narrow dtype, every plane filled with random bytes, behind a
    prefix cache with a host tier."""
    from paddle_tpu_torch.inference.kv_tiers import HostTier
    from paddle_tpu_torch.inference.paged_kv import PagedKVCache
    from paddle_tpu_torch.inference.prefix_cache import PagedPrefixCache

    cfg = llama.LlamaConfig.tiny(hidden_size=768, num_heads=12,
                                 num_kv_heads=12, dtype=torch.bfloat16)
    pgr = PagedKVCache(cfg, slots=2, page_size=16, num_pages=24,
                       max_pages=6, device=cuda, quant=quant)
    gen = torch.Generator(device=cuda).manual_seed(seed)
    for a in pgr.pool.values():
        raw = a.view(torch.uint8)
        raw.copy_(torch.randint(0, 256, raw.shape, dtype=torch.uint8,
                                device=cuda, generator=gen))
    tier = HostTier(pgr, capacity_pages=64)
    return pgr, tier, PagedPrefixCache(pgr, capacity_pages=8,
                                       host_tier=tier)


def _bytes(t):
    return t.contiguous().view(torch.uint8).cpu()


@pytest.mark.parametrize("quant", [None, "int8", "fp8"])
def test_host_tier_round_trip_bits(cuda, quant):
    """Stage a 3-page entry, spill it, let its pages be reused, restore it
    into other pages: the pinned host copy and the restored pages equal
    the original bytes in every plane (a narrow pool's scale planes
    included)."""
    pgr, tier, pc = _tier_pool(cuda, quant)
    toks = np.arange(48, dtype=np.int32)
    pages = pgr.reserve(48)[0]
    before = {p: _bytes(a[:, pages]) for p, a in pgr.pool.items()}
    pc.insert(toks, pages)
    tier.flush()
    host = tier.get(toks.tobytes())
    assert set(tier.planes()) == set(before)
    for p in before:
        assert host[p].is_pinned() and host[p].dtype == pgr.pool[p].dtype
        assert torch.equal(_bytes(host[p]), before[p]), p
    pgr.release_pages(pages)
    pc.evict_until(pgr.num_pages)
    assert pc.spills == 1 and pc.pages_held == 0
    hold = pgr.reserve(64)[0]          # the old pages go to someone else
    for a in pgr.pool.values():
        a.view(torch.uint8)[:, hold] = 0
    m = pc.match(np.concatenate([toks, toks[:3]]))
    assert m.tier == "host"
    got = pc.restore(m.key, m.length)
    assert len(got) == 3 and set(got).isdisjoint(hold)
    for p, a in pgr.pool.items():
        assert torch.equal(_bytes(a[:, got]), before[p]), p
    assert tier.flushes == 1
    pc.clear()
    pgr.release_pages(hold)
    assert pgr.leak_report() == []


@pytest.mark.parametrize("quant", [None, "int8"])
def test_host_tier_stage_and_upload_do_not_synchronise(cuda, quant):
    """A stage (gather, then a non-blocking D2H copy into pinned memory)
    and an upload (a non-blocking H2D copy, then ``index_copy_``) issue no
    synchronising call: PyTorch raises on any under the sync-debug mode
    "error". Only the tier's flush waits."""
    pgr, tier, pc = _tier_pool(cuda, quant, seed=1)
    src = pgr.reserve(48)[0]
    dst = pgr.reserve(48)[0]
    span = pgr.reserve(32)[0]
    before = {p: _bytes(a[:, src]) for p, a in pgr.pool.items()}
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tier.stage(b"entry", src)
        staged = tier.take_pending()
        tier.upload(dst, dict(zip(tier.planes(), staged[0][2:])))
        pc.insert(np.arange(32, dtype=np.int32), span)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    with pytest.raises(RuntimeError, match="synchroniz"):
        torch.cuda.set_sync_debug_mode("error")
        try:
            tier.flush()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    tier.complete(staged)
    for p, a in pgr.pool.items():
        assert torch.equal(_bytes(a[:, dst]), before[p]), p
        assert torch.equal(_bytes(tier.get(b"entry")[p]), before[p]), p


@pytest.mark.parametrize("name", SERVE_CONFIGS)
def test_interleaved_paged_replicas_share_the_stream(cuda, name):
    """Two paged engines on the card's current stream with their segments
    interleaved as a fleet runs them (dispatch A, dispatch B, finish A,
    finish B): every request gets the tokens its engine gives it alone,
    each finish counts one fetch (its wait on the event behind the
    segment's staged log), and the split-KV ticket buffers the replicas
    share are all zero afterwards."""
    from paddle_tpu_torch.inference.serving import ServingEngine

    cfg, params = _serve_model(cuda, name)
    rng = np.random.RandomState(5)
    work = [[(rng.randint(0, cfg.vocab_size, n), g)
             for n, g in ((40, 16), (100, 24), (17, 9), (64, 30))],
            [(rng.randint(0, cfg.vocab_size, n), g)
             for n, g in ((120, 12), (33, 20), (8, 28), (70, 6))]]

    def engine(reqs):
        eng = ServingEngine(cfg, params, slots=4, max_len=256,
                            prompt_buckets=(64, 128), paged=True,
                            device=cuda)
        return eng, [eng.add_request(p, g) for p, g in reqs]

    def busy(eng):
        return bool(eng._queue) or eng.free_slot_count() < eng.slots

    alone = []
    for reqs in work:
        eng, rids = engine(reqs)
        while busy(eng):
            eng.run_segment(8)
        out = eng.collect_finished()
        alone.append([out[r] for r in rids])

    (a, arids), (b, brids) = engine(work[0]), engine(work[1])
    while busy(a) or busy(b):
        ha = a.dispatch_segment(8) if busy(a) else None
        hb = b.dispatch_segment(8) if busy(b) else None
        for eng, h in ((a, ha), (b, hb)):
            if h is not None:
                before = eng.fetches
                eng.finish_segment(h)
                assert eng.fetches == before + 1
    outa, outb = a.collect_finished(), b.collect_finished()
    assert [outa[r] for r in arids] == alone[0]
    assert [outb[r] for r in brids] == alone[1]
    torch.cuda.synchronize()
    assert da._TICKETS and all(not t.any() for t in da._TICKETS.values())


# -- BASELINE config 0: the high-level API on the card ----------------------

def test_loader_batches_reach_the_card(cuda):
    """Serial and thread-worker loaders yield batches on the current
    device (CUDA by default), equal to the CPU collation."""
    from paddle_tpu_torch import io as tio
    from paddle_tpu_torch.vision.datasets import MNIST

    ds = MNIST(mode="test", synthetic_size=100)
    want = [tio.default_collate_fn([ds[i] for i in range(s, min(s + 32,
                                                                100))])
            for s in range(0, 100, 32)]
    for workers in (0, 2):
        got = list(tio.DataLoader(ds, batch_size=32, num_workers=workers))
        assert len(got) == len(want)
        for (x, y), (wx, wy) in zip(got, want):
            assert x.device == cuda and y.device == cuda
            assert torch.equal(x.cpu(), wx) and torch.equal(y.cpu(), wy)


def test_lenet_fit_kernel_matches_plain(cuda, monkeypatch):
    """Four unshuffled ``Model.fit`` steps of LeNet on MNIST (batch 256)
    from the same seed, under deterministic cuDNN, through
    ``multi_tensor_update`` (one launch a step) and through its plain
    version (none): losses and parameters within the fp32 update's
    tolerance (rtol 1e-6, atol 1e-7; the bias corrections' powf on the
    card may differ from torch.pow on the host in the last bit)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.vision.datasets import MNIST
    from paddle_tpu_torch.vision.models import LeNet

    train = MNIST(mode="train", synthetic_size=1024)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)

    class Losses(pt.callbacks.Callback):
        def on_train_begin(self, logs=None):
            self.seen = []

        def on_train_batch_end(self, step, logs=None):
            self.seen.append(logs["loss"])

    runs = []
    for plain in (False, True):
        pt.seed(0)
        net = LeNet()
        model = pt.Model(net)
        model.prepare(pt.optimizer.Adam(learning_rate=1e-3,
                                        parameters=net.parameters()),
                      pt.nn.CrossEntropyLoss(), pt.metric.Accuracy())
        rec = Losses()
        before = mtu.multi_tensor_update.launches
        with monkeypatch.context() as m:
            if plain:
                m.setattr(mtu, "multi_tensor_update", mtu.flat_update_plain)
            model.fit(train, epochs=1, batch_size=256, shuffle=False,
                      verbose=0, callbacks=[rec])
        assert mtu.multi_tensor_update.launches - before == (0 if plain
                                                             else 4)
        runs.append((rec.seen, [p.detach().clone()
                                for p in net.parameters()]))
    (lk, pk), (lp, pp) = runs
    np.testing.assert_allclose(lk, lp, rtol=1e-6, atol=1e-7)
    for a, b in zip(pk, pp):
        assert a.device == cuda
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_other_optimizers_match_cpu(cuda):
    """Each optimizer that steps parameters one by one (``Adagrad`` to
    ``LBFGS("strong_wolfe")``): three full-batch steps of a five-layer MLP
    on ``UCIHousing`` on the card and on the CPU from the same weights,
    every parameter within 1e-5, and the card's loss falling over 50
    steps (``chip_smoke.py`` phase 6e(c))."""
    from paddle_tpu_torch.experiments import parity

    out = parity.optimizer_parity(cuda)
    assert sorted(out) == sorted(parity.OPTIMIZERS)


@pytest.mark.parametrize("names", [["ctc_loss"], None], ids=["ctc", "all"])
def test_losses_match_cpu(cuda, names):
    """``ctc_loss`` at T 200, B 32, C 30 and label length 40, then every
    loss of the sweep, forward and backward on the card against the CPU
    within 1e-5 (``chip_smoke.py`` phase 6e(d))."""
    from paddle_tpu_torch.experiments import parity

    out = parity.loss_parity(cuda, names=names)
    assert sorted(out) == sorted(names or parity.LOSS_SWEEP)


def test_detection_ops_match_cpu(cuda):
    """Every ``vision.ops`` operator at ``parity.DETECTION_SMALL`` on the
    card against the CPU (``chip_smoke.py`` phase 6f(b) at a few pixels
    and channels): outputs and the RoI and deformable operators'
    gradients within 1e-5, kept indices, proposals and priors equal."""
    from paddle_tpu_torch.experiments import parity

    out = parity.detection_parity(cuda, parity.DETECTION_SMALL)
    assert {"generate_proposals", "nms", "nms_categories", "fpn",
            "roi_pool", "psroi_pool", "prior_box", "box_coder_decode",
            "box_coder_encode"} <= set(out)
    assert out["nms"]["kept"] > 0 and out["prior_box"]["priors"] == 8732
    assert any(k.startswith("deform_conv2d") for k in out)
    assert any(lv.get("compared_rois") for lv in out["fpn"]["levels"])


@pytest.mark.parametrize("M,K,N", [(5, 120, 84), (1, 30, 10), (17, 7, 3),
                                   (16, 768, 30522), (32, 16, 24),
                                   (17, 120, 88), (33, 120, 88),
                                   (100, 50, 7), (4096, 768, 3072)])
def test_int8_linear_padded_exact(cuda, M, K, N):
    """``Int8Linear`` through ``torch._int_mm`` at shapes outside its card
    rules (M <= 16, K or N no multiple of 8; LeNet's 120 -> 84, BERT's
    30522-word head at one row), at shapes inside them that cuBLASLt
    refuses unpadded (M 17, K 120, N 88), and at BERT-base's FFN:
    zero-padded to multiples of 16, exact against int32 numpy. The
    unpadded call at a shape outside the rules raises, which is why the
    padding is there."""
    from paddle_tpu_torch import quantization as Q

    rng = np.random.RandomState(M + K + N)
    w = rng.randn(K, N).astype(np.float32)
    w_scales = np.abs(w).max(axis=0)
    wi8 = np.round(w / w_scales * 127).astype(np.int8)
    bias = rng.randn(N).astype(np.float32)
    x = np.clip(rng.randn(M, K), -2, 2).astype(np.float32)
    lin = Q.Int8Linear(wi8, w_scales, 2.0,
                       bias=torch.from_numpy(bias).to(cuda))
    got = lin(torch.from_numpy(x).to(cuda))
    assert got.device == cuda
    xi8 = np.clip(np.round(x / np.float32(2.0) * np.float32(127)), -127,
                  127).astype(np.int32)
    acc = xi8 @ wi8.astype(np.int32)
    want = (acc.astype(np.float32) * (w_scales * np.float32(2.0)
                                      / np.float32(127 * 127)) + bias)
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    if M <= 16 or K % 8 or N % 8:
        with pytest.raises(RuntimeError):
            torch._int_mm(torch.from_numpy(xi8.astype(np.int8)).to(cuda),
                          torch.from_numpy(wi8).to(cuda))


# tiny's depth at a head dim of 64 (4 heads of H 256)
MESH_WIDTH = dict(hidden_size=256, intermediate_size=512)


def test_sharded_step_on_a_mesh_of_one_is_make_train_step(cuda):
    """A world of one on NCCL and ``create_hybrid_mesh()`` with every degree
    1: ``make_sharded_train_step`` takes the single-device path, as the
    reference does there, so its losses equal ``make_train_step``'s bit
    for bit, with the flash forward and backward once a layer and
    ``head_dx_softmax`` once a step."""
    import torch.distributed as dist

    from paddle_tpu_torch.distributed import init_parallel_env
    from paddle_tpu_torch.ops.kernels import launch_counters
    from paddle_tpu_torch.parallel import create_hybrid_mesh, set_mesh

    # D 64: a head dim the flash kernels take
    cfg = llama.LlamaConfig.tiny(dtype=torch.bfloat16, ce_tail_custom=True,
                                 **MESH_WIDTH)
    gen = torch.Generator(device="cuda").manual_seed(0)
    full = llama.init_params(cfg, gen, device="cuda", dtype=torch.float32)
    tok = torch.randint(0, cfg.vocab_size, (4, 128), device="cuda",
                        generator=gen, dtype=torch.int32)
    p1 = {k: v.clone() for k, v in full.items()}
    o1 = llama.init_opt_state(p1)
    single = llama.make_train_step(cfg, lr=1e-3)
    want = [single(p1, o1, tok, tok)[2].item() for _ in range(3)]
    fns = launch_counters()
    init_parallel_env(device="cuda")
    try:
        assert dist.get_backend() == "nccl" and dist.get_world_size() == 1
        mesh = create_hybrid_mesh()
        p, o = llama.shard_state(cfg, mesh, full, llama.init_opt_state(full))
        step = llama.make_sharded_train_step(cfg, mesh, lr=1e-3)
        got = []
        for _ in range(3):
            for fn, attr in fns.values():
                setattr(fn, attr, 0)
            got.append(step(p, o, tok, tok)[2].item())
            n = {k: getattr(fn, attr) for k, (fn, attr) in fns.items()}
            assert n["flash_attention_fwd"] == cfg.num_layers
            assert n["flash_attention_bwd"] == cfg.num_layers
            assert n["head_dx_softmax"] == 1
        assert got == want
    finally:
        set_mesh(None)
        dist.destroy_process_group()


def test_bert_sharded_step_on_a_mesh_of_one_is_make_train_step(cuda):
    import torch.distributed as dist

    from paddle_tpu_torch.distributed import init_parallel_env
    from paddle_tpu_torch.parallel import create_hybrid_mesh, set_mesh

    cfg = bert.BertConfig.tiny(dtype=torch.bfloat16, hidden_size=256,
                               intermediate_size=512)
    full = bert.init_params(cfg, torch.Generator(device="cuda").manual_seed(1),
                            device="cuda")
    tok, lab = bert.random_mlm_batch(cfg, 4, 64, seed=2)
    p1 = {k: v.clone() for k, v in full.items()}
    o1 = bert.init_opt_state(p1)
    single = bert.make_train_step(cfg, lr=1e-3)
    want = [single(p1, o1, tok, lab)[2].item() for _ in range(2)]
    init_parallel_env(device="cuda")
    try:
        mesh = create_hybrid_mesh()
        p, o = bert.shard_state(cfg, mesh, full, bert.init_opt_state(full))
        step = bert.make_sharded_train_step(cfg, mesh, lr=1e-3)
        assert [step(p, o, tok, lab)[2].item() for _ in range(2)] == want
    finally:
        set_mesh(None)
        dist.destroy_process_group()


def test_mesh_layouts_on_gloo_ranks_sharing_the_card(cuda):
    """Phase 6i (b) (``mesh_train.layouts_vs_single``) at tiny width in
    bf16: three layouts of 4 gloo ranks on one card, each held to one
    rank's step (it asserts LOSS_ATOL and GRAD_RATIO, and each rank's
    flash launches: once a layer and step under remat)."""
    from paddle_tpu_torch.experiments import mesh_train

    tok = np.random.RandomState(0).randint(0, 256, (8, 64)).astype(np.int32)
    ranks = mesh_train.spawn(mesh_train.layouts_vs_single, 4, args=(
        dict(dtype=torch.bfloat16, num_kv_heads=4, **MESH_WIDTH), tok, 2,
        1e-4, 0, "tiny", "cuda"),
        device="cuda", backend="gloo", timeout=240)
    rep = ranks[0]["report"]
    assert set(rep) == {n for n, _, _ in mesh_train.LAYOUTS} | {"one_rank"}
    for r in ranks:
        assert r["launches"]["dp2_mp2_zero3"]["flash_attention_fwd"] == 4
        assert r["launches"]["mp2_sep2_ring"]["flash_attention_fwd"] == 0
    assert rep["dp2_mp2_zero3"]["flash_heads_rows"] == [(2, 64)]
    assert rep["mp2_sep2_ulysses"]["flash_heads_rows"] == [(1, 64)]
    assert rep["mp2_sep2_ring"]["flash_heads_rows"] == []


def _fleet_batch(n, size):
    rng = np.random.RandomState(0)
    return (rng.rand(n, size, size, 3).astype(np.float32),
            rng.randint(0, 1000, (n,)))


def test_fleet_world_of_one_is_the_eager_loop(cuda):
    """Phase 6j (a) (``fleet_dp.world1``) on ResNet-18 at 64 x 64: the
    Fleet loop's losses equal the loop's without Fleet bit for bit, one
    ``multi_tensor_update`` launch a flat plan and step."""
    import paddle_tpu_torch as port
    from paddle_tpu_torch.experiments import fleet_dp
    from paddle_tpu_torch.ops.kernels import launch_counters

    fns = launch_counters()
    counts = (lambda: [setattr(f, a, 0) for f, a in fns.values()],
              lambda: {n: getattr(f, a) for n, (f, a) in fns.items()})
    x, y = _fleet_batch(16, 64)
    w1 = fleet_dp.world1(port, torch.from_numpy(x).to(cuda),
                         torch.from_numpy(y).to(cuda), 2, counts,
                         size_model=fleet_dp.resnet18_nhwc)
    assert w1["losses"] == w1["plain_losses"]
    assert w1["backend"] == "nccl" and w1["world_size"] == 1
    for n in w1["launches"]:
        assert n["multi_tensor_update"] == w1["plans"] == 1


def test_fleet_data_parallel_on_gloo_ranks_sharing_the_card(cuda):
    """Phase 6j (b) (``fleet_dp.dp_ranks``) on ResNet-18 at 64 x 64 with
    4 gloo ranks on one card: each synced gradient within the sum-order
    bound of the mean of the four ranks' own, the parameters equal on
    every rank, one fp32 all-reduce a bucket and one
    ``multi_tensor_update`` launch a rank and step; SyncBatchNorm's step
    adds three all-reduces a BatchNorm layer."""
    from paddle_tpu_torch.experiments import fleet_dp, mesh_train

    x, y = _fleet_batch(16, 64)
    ranks = mesh_train.spawn(fleet_dp.dp_ranks, 4, args=(
        x, y, 2, fleet_dp.resnet18_nhwc), device="cuda", backend="gloo",
        timeout=240)
    plain, sync = ranks[0]["plain"], ranks[0]["sync"]
    assert plain["wrapped"] == ("DataParallel", "HybridParallelOptimizer")
    for i in range(2):
        assert plain["mean_checks"][i]["over_bound"] == 0
        assert len(set(plain["digests"][i])) == 1
        assert plain["bucket_syncs"][i] == plain["buckets"]
        assert plain["calls"][i] == {"calls": {
            "all_reduce": plain["buckets"]}, "staged": {}}
    n_bn = 20  # ResNet-18's BatchNorm layers
    assert sync["calls"][0]["calls"]["all_reduce"] == \
        plain["buckets"] + 3 * n_bn
    for r in ranks:
        assert [len(r["launches"][k]) for k in ("plain", "sync")] == [2, 1]
        for n in r["launches"]["plain"] + r["launches"]["sync"]:
            assert n == {k: int(k == "multi_tensor_update") for k in n}


def test_collectives_on_gloo_ranks_with_cuda_tensors(cuda):
    """The collectives of ``distributed/collective.py`` on CUDA tensors in
    2 gloo ranks sharing the card (``fleet_dp.collectives_on``): the
    reference's results, and the operations gloo does not take on CUDA
    tensors (point to point, broadcast, scatter) staged through the host
    and counted, the others not."""
    from paddle_tpu_torch.experiments import fleet_dp, mesh_train

    ranks = mesh_train.spawn(fleet_dp.collectives_on, 2, args=("cuda",),
                             device="cuda", backend="gloo", timeout=120)
    full = lambda v, n=4: np.full((n,), float(v), np.float32)  # noqa: E731
    for r, res in enumerate(ranks):
        prev = 1 - r
        for op, want in (("SUM", 3), ("AVG", 1.5), ("MAX", 2), ("MIN", 1),
                         ("PROD", 2)):
            np.testing.assert_array_equal(res[f"all_reduce_{op}"][0],
                                          full(want))
        np.testing.assert_array_equal(res["all_reduce_bf16"][0], full(3))
        np.testing.assert_array_equal(res["all_gather"][1],
                                      np.r_[full(0, 2), full(1, 2)])
        np.testing.assert_array_equal(res["broadcast"], full(8, 3))
        np.testing.assert_array_equal(res["scatter"], full(100 + r, 2))
        np.testing.assert_array_equal(res["reduce_scatter_max"],
                                      np.arange(1, 5, dtype=np.float32)[
                                          2 * r:2 * r + 2] + 1)
        np.testing.assert_array_equal(res["send_recv"],
                                      full(5 if r == 1 else 0, 3))
        np.testing.assert_array_equal(res["isend_irecv"], full(20 + prev, 2))
        np.testing.assert_array_equal(res["batch_isend_irecv"],
                                      full(30 + prev, 2))
        np.testing.assert_array_equal(res["recv_prev"], full(50 + prev, 2))
        staged = res["staged"]
        assert {"broadcast", "scatter", "recv", "ring_shift"} <= set(staged)
        assert not set(staged) & {"all_reduce", "all_gather",
                                  "reduce_scatter", "all_to_all"}
