"""The port's quantized paged serving against the JAX package's, on the CPU.

The same numpy weights, rows and requests go through ``paddle_tpu`` and
``paddle_tpu_torch``:

* the recipe (``quantization/serving.py``): narrow bytes and scales equal
  to the JAX package's, for int8 and fp8, the fp8 saturation edge
  included; a quantized JAX tree crosses through ``params_from_numpy``
  byte for byte;
* ``quant_matmul_plain`` against the Pallas ``quant_matmul`` in interpret
  mode (atol/rtol 1e-4 in fp32, the bar of tests/test_quantized_serving.py)
  and the decode kernel's plain quant mode against the Pallas kernel's
  ``k_scale``/``v_scale`` mode (atol 1e-5 in fp32);
* ``forward_with_pages`` on a quantized pool: logits to rtol 2e-4 (XLA's
  fp32 transcendentals are fast approximations), row scales to 2e-5, and
  each narrow row within one quantization step of JAX's (a value within
  fp32 rounding of a rounding boundary may land one step away), on the
  JAX package's default CPU path and, at hidden 128, with its tick kernels
  and ``quant_matmul`` forced through the interpreter;
* the quantized paged engine under ``OnlineScheduler``: tokens, segment
  counts and pool statistics identical to the JAX engine's, quality
  digests with the logits at the same tolerance and the top-k ids equal;
* ``compare_pair`` against the JAX package's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.ops.pallas.decode_attention as jda
import paddle_tpu.ops.pallas.tick_fusion as jtf
from paddle_tpu.inference import scheduler as jsched
from paddle_tpu.inference.serving import ServingEngine as JaxEngine
from paddle_tpu.models import llama as jl
from paddle_tpu.observability.quality import compare_pair as jax_compare
from paddle_tpu.parallel import set_mesh
from paddle_tpu.quantization import serving as jq
from paddle_tpu_torch.inference import scheduler as tsched
from paddle_tpu_torch.inference.paged_kv import PagedKVCache
from paddle_tpu_torch.inference.prefix_cache import PagedPrefixCache
from paddle_tpu_torch.inference.serving import ServingEngine
from paddle_tpu_torch.models import llama as tl
from paddle_tpu_torch.models.convert import params_from_numpy
from paddle_tpu_torch.observability.quality import compare_pair
from paddle_tpu_torch.ops.kernels import decode_attention as da
from paddle_tpu_torch.ops.kernels import quant_matmul as qm
from paddle_tpu_torch.quantization import serving as tq

MODES = ["int8", "fp8"]
ENGINE = dict(slots=2, max_len=96, prompt_buckets=(8, 16, 32, 64),
              paged=True, page_size=16, num_pages=24)


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


def _t(a) -> torch.Tensor:
    """A JAX or numpy array as a torch tensor; fp8 through its bytes."""
    a = np.asarray(a)
    if a.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(a.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    return torch.from_numpy(a.copy())


def _bytes(x) -> np.ndarray:
    """The raw bytes of a narrow tensor or array, for exact comparison."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.uint8).numpy() if x.element_size() == 1 \
            else x.numpy()
    a = np.asarray(x)
    return a.view(np.uint8) if a.itemsize == 1 else a


def _close(a, b, rtol=2e-4, atol=1e-5):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=rtol,
                               atol=atol)


# ---------------------------------------------------------------------------
# the recipe
# ---------------------------------------------------------------------------


class TestRecipe:
    @pytest.mark.parametrize("mode", MODES)
    @pytest.mark.parametrize("shape", [(2, 64, 48), (64, 48)])
    def test_weight_bytes_match_jax(self, mode, shape):
        w = np.random.RandomState(1).randn(*shape).astype(np.float32)
        w[..., 3] = 0.0                     # an all-zero channel: the floor
        jqw, js = jq.quantize_weight(jnp.asarray(w), mode)
        tqw, ts = tq.quantize_weight(torch.from_numpy(w), mode)
        assert tqw.dtype == tq.quant_dtype(mode)
        np.testing.assert_array_equal(_bytes(tqw), _bytes(jqw))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_array_equal(
            tq.dequantize_weight(tqw, ts).numpy(),
            np.asarray(jq.dequantize_weight(jqw, js)))

    def test_fp8_saturation_edge(self):
        """Channel maxima whose scaled value lands above 448 by fp32
        rounding: both casts give 448, the same byte."""
        amax = np.float32(1.0) + np.arange(4096, dtype=np.float32) * \
            np.float32(2.0 ** -20)
        over = amax / (amax / np.float32(448.0)) > np.float32(448.0)
        assert over.any()
        w = np.stack([amax[over][:64], -amax[over][:64] / 3]).astype(
            np.float32)                                     # [2, 64]
        jqw, _ = jq.quantize_weight(jnp.asarray(w), "fp8")
        tqw, _ = tq.quantize_weight(torch.from_numpy(w), "fp8")
        np.testing.assert_array_equal(_bytes(tqw), _bytes(jqw))
        assert (tqw[0].float() == 448.0).all()

    @pytest.mark.parametrize("mode", MODES)
    def test_kv_rows_match_jax(self, mode):
        x = np.random.RandomState(2).randn(2, 5, 2, 8).astype(np.float32)
        x[1, 2] = 0.0
        jrow, js = jq.quantize_kv_rows(jnp.asarray(x), jq.quant_dtype(mode))
        trow, ts = tq.quantize_kv_rows(torch.from_numpy(x),
                                       tq.quant_dtype(mode))
        assert ts.shape == (2, 5) and trow.shape == x.shape
        np.testing.assert_array_equal(_bytes(trow), _bytes(jrow))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))

    @pytest.mark.parametrize("mode", MODES)
    def test_params_match_jax_and_cross_over(self, both, mode):
        """``quantize_llama_params`` on the same fp32 tree gives the JAX
        package's bytes for every key; the JAX quantized tree crosses
        through ``params_from_numpy`` unchanged; quantizing twice
        raises."""
        cfg, params, tcfg, tparams = both
        jqp = jq.quantize_llama_params(params, cfg, mode)
        tqp = tq.quantize_llama_params(tparams, tcfg, mode)
        assert set(tqp) == set(jqp)
        crossed = params_from_numpy({k: np.asarray(v) for k, v in
                                     jqp.items()}, tcfg, "cpu")
        for k in jqp:
            np.testing.assert_array_equal(_bytes(tqp[k]), _bytes(jqp[k]))
            assert crossed[k].dtype == tqp[k].dtype
            np.testing.assert_array_equal(_bytes(crossed[k]), _bytes(tqp[k]))
        with pytest.raises(ValueError, match="double-quantize"):
            tq.quantize_llama_params(tqp, tcfg, mode)
        with pytest.raises(ValueError, match="quant mode"):
            tq.quant_dtype("int4")


# ---------------------------------------------------------------------------
# the kernels' plain versions against the Pallas kernels
# ---------------------------------------------------------------------------


class TestQuantMatmul:
    @pytest.mark.parametrize("mode", MODES)
    @pytest.mark.parametrize("B", [1, 4])
    @pytest.mark.parametrize("K,N", [(64, 256), (128, 384)])
    def test_plain_matches_pallas(self, mode, B, K, N):
        rng = np.random.RandomState(K + N + B)
        w = rng.randn(K, N).astype(np.float32)
        x = rng.randn(B, K).astype(np.float32)
        jw, js = jq.quantize_weight(jnp.asarray(w), mode)
        ref = jtf.quant_matmul(jnp.asarray(x), jw, js, interpret=True)
        out = qm.quant_matmul(torch.from_numpy(x), _t(jw), _t(js))
        assert out.dtype == torch.float32 and out.shape == (B, N)
        _close(out.numpy(), ref, rtol=1e-4, atol=1e-4)

    @pytest.mark.parametrize("mode", MODES)
    @pytest.mark.parametrize("B", [1, 9])
    def test_plain_matches_pallas_past_the_splits(self, mode, B):
        """K 770: no multiple of the card kernel's 64-row stages, which its
        splits share unevenly; B 1 (the admit's lm_head) and 9 (past one
        8-row batch tile)."""
        K, N = 770, 256
        nt, splits = qm.tiling(K, N)
        assert K % 64 and -(-K // 64) % splits
        rng = np.random.RandomState(B + 7)
        w = rng.randn(K, N).astype(np.float32)
        x = rng.randn(B, K).astype(np.float32)
        jw, js = jq.quantize_weight(jnp.asarray(w), mode)
        ref = jtf.quant_matmul(jnp.asarray(x), jw, js, interpret=True)
        out = qm.quant_matmul(torch.from_numpy(x), _t(jw), _t(js))
        assert out.dtype == torch.float32 and out.shape == (B, N)
        _close(out.numpy(), ref, rtol=1e-4, atol=1e-4)

    def test_tiling_fills_the_card_on_every_tick_shape(self):
        """The wrapper's tiling from (K, N) alone: every projection of the
        decode tick and the lm_head, at B 8 and B 1, reaches the H100's
        132 SMs; splits stay within the cluster (8) and K's stages."""
        for K, N in [(768, 768), (768, 3072), (3072, 768), (768, 32000)]:
            nt, splits = qm.tiling(K, N)
            assert nt in (32, 128)
            assert 1 <= splits <= min(8, -(-K // 64))
            assert qm.blocks(8, K, N) >= 132 and qm.blocks(1, K, N) >= 132
        assert qm.tiling(64, 128) == (32, 1)   # one stage: no split
        assert qm.tiling(768, 32000) == (128, 1)  # lm_head: whole strips
        assert qm.tiling(3072, 768) == (32, 8)  # 6 stages a split
        assert qm.blocks(17, 770, 999) == 3 * qm.blocks(8, 770, 999)

    def test_cpu_tensors_take_the_plain_version(self, monkeypatch):
        def no_kernel():
            raise AssertionError("the CUDA kernel was reached on the CPU")

        monkeypatch.setattr(qm, "_kernel", no_kernel)
        x = torch.randn(3, 40, dtype=torch.bfloat16)
        w, s = tq.quantize_weight(torch.randn(40, 200), "fp8")
        before = qm.quant_matmul.launches
        out = qm.quant_matmul(x, w, s)
        torch.testing.assert_close(out, qm.quant_matmul_plain(x, w, s))
        assert qm.quant_matmul.launches == before

    def test_rejects_bad_inputs(self):
        w, s = tq.quantize_weight(torch.randn(16, 32), "int8")
        x = torch.randn(2, 16)
        with pytest.raises(ValueError, match="chain"):
            qm.quant_matmul(torch.randn(2, 8), w, s)
        with pytest.raises(ValueError, match="expected"):
            qm.quant_matmul(x[0], w, s)
        with pytest.raises(TypeError, match="int8"):
            qm.quant_matmul(x, w.float(), s)
        with pytest.raises(TypeError, match="float32"):
            qm.quant_matmul(x.double(), w, s)
        with pytest.raises(ValueError, match="devices"):
            qm.quant_matmul(x, w, s.to("meta"))
        with pytest.raises(ValueError, match="empty"):
            qm.quant_matmul(x[:0], w, s)


class TestDecodeQuantMode:
    @pytest.mark.parametrize("mode", MODES)
    @pytest.mark.parametrize("nH,Hkv,pos", [(4, 2, [5, 97]),
                                            (8, 2, [0, 127])])
    def test_plain_matches_pallas(self, mode, nH, Hkv, pos):
        """The JAX test's shape (B 2, S 128, 4 query heads over 2 kv heads,
        D 128, pos [5, 97]) and a GQA rep 4 one at the window's ends."""
        rng = np.random.RandomState(nH)
        B, S, D = 2, 128, 128
        kc = rng.randn(B, S, Hkv, D).astype(np.float32)
        vc = rng.randn(B, S, Hkv, D).astype(np.float32)
        q = rng.randn(B, nH, D).astype(np.float32)
        dt = jq.quant_dtype(mode)
        kq, ks = jq.quantize_kv_rows(jnp.asarray(kc), dt)
        vq, vs = jq.quantize_kv_rows(jnp.asarray(vc), dt)
        p = np.asarray(pos, np.int32)
        ref = jda.ragged_decode_attention(jnp.asarray(q), kq, vq,
                                          jnp.asarray(p), interpret=True,
                                          k_scale=ks, v_scale=vs)
        out = da.ragged_decode_attention(
            torch.from_numpy(q), _t(kq), _t(vq), torch.from_numpy(p),
            k_scale=_t(ks), v_scale=_t(vs))
        _close(out.numpy(), ref, rtol=1e-5, atol=1e-5)

    def test_cpu_takes_plain_and_rejects_bad_scales(self):
        q = torch.randn(2, 4, 64)
        kq, ks = tq.quantize_kv_rows(torch.randn(2, 32, 2, 64), torch.int8)
        pos = torch.tensor([3, 31], dtype=torch.int32)
        before = (da.ragged_decode_attention.launches,
                  da.ragged_decode_attention.quant_launches)
        out = da.ragged_decode_attention(q, kq, kq, pos, ks, ks)
        torch.testing.assert_close(
            out, da.ragged_decode_attention_plain(q, kq, kq, pos, ks, ks))
        assert (da.ragged_decode_attention.launches,
                da.ragged_decode_attention.quant_launches) == before
        with pytest.raises(ValueError, match="together"):
            da.ragged_decode_attention(q, kq, kq, pos, k_scale=ks)
        with pytest.raises(ValueError, match="k_scale"):
            da.ragged_decode_attention(q, kq, kq, pos, ks[:, :8], ks)
        with pytest.raises(TypeError, match="int8"):
            da.ragged_decode_attention(q, kq.float(), kq.float(), pos, ks, ks)


# ---------------------------------------------------------------------------
# forward_with_pages on a quantized pool
# ---------------------------------------------------------------------------


def _quant_pool(cfg, mode, rng, num_pages=17, psz=16):
    """A random quantized pool, the JAX and the port's copy of the same
    bytes."""
    L, Hkv, D = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    jpool, tpool = {}, {}
    for kk in "kv":
        x = rng.randn(L * num_pages, psz, Hkv, D).astype(np.float32) * 0.1
        rows, sc = jq.quantize_kv_rows(jnp.asarray(x), jq.quant_dtype(mode))
        jpool[kk] = rows.reshape(L, num_pages, psz, Hkv, D)
        jpool[kk + "s"] = sc.reshape(L, num_pages, psz)
    for name, a in jpool.items():
        tpool[name] = _t(a)
    return jpool, tpool


def _check_pools(tpool, jpool):
    """Scales to 2e-5; each narrow row within one quantization step of the
    JAX row (and nearly all bytes equal)."""
    for kk in "kv":
        ts, js = tpool[kk + "s"].numpy(), np.asarray(jpool[kk + "s"])
        _close(ts, js, rtol=2e-5, atol=1e-9)
        tr = tpool[kk].float().numpy() * ts[..., None, None]
        jr = np.asarray(jpool[kk], np.float32) * js[..., None, None]
        step = np.maximum(ts, js)[..., None, None]
        assert (np.abs(tr - jr) <= 1.01 * step + 1e-7).all()
        same = (_bytes(tpool[kk]) == _bytes(jpool[kk])).mean()
        assert same > 0.99, same


def _fwd_pair(cfg, params, tcfg, tparams, mode, tokens, pt, pos, live,
              logit_pos=None, seed=0):
    jpool, tpool = _quant_pool(cfg, mode, np.random.RandomState(seed))

    @jax.jit
    def jfwd(p, tok, pool, table, ps, lv, lp):
        return jl.forward_with_pages(p, tok, cfg, pool, table, ps, live=lv,
                                     logit_pos=lp)

    jlog, jpool = jfwd(params, jnp.asarray(tokens), jpool, jnp.asarray(pt),
                       jnp.asarray(pos), jnp.asarray(live),
                       None if logit_pos is None else jnp.asarray(logit_pos))
    tlog, tpool = tl.forward_with_pages(
        tparams, torch.from_numpy(tokens), tcfg, tpool, torch.from_numpy(pt),
        torch.from_numpy(pos), live=torch.from_numpy(live),
        logit_pos=None if logit_pos is None else torch.from_numpy(logit_pos))
    _close(tlog.numpy(), jlog)
    _check_pools(tpool, jpool)


def _prefill_and_tick(cfg, params, tcfg, tparams, mode):
    rng = np.random.RandomState(4)
    # a prefill chunk at context offset 20 (a live row reading its true
    # last token, a dead one writing to the trash page)
    pt = rng.permutation(np.arange(1, 17))[:8].reshape(2, 4).astype(np.int32)
    tokens = rng.randint(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    _fwd_pair(cfg, params, tcfg, tparams, mode, tokens, pt,
              np.asarray([20, 5], np.int32), np.asarray([True, False]),
              logit_pos=np.asarray([5, 7], np.int32), seed=1)
    # a ragged tick: a dead slot, one at max_len (past the table)
    pt = rng.permutation(np.arange(1, 17))[:12].reshape(4, 3).astype(
        np.int32)
    tokens = rng.randint(0, cfg.vocab_size, (4, 1)).astype(np.int32)
    _fwd_pair(cfg, params, tcfg, tparams, mode, tokens, pt,
              np.asarray([9, 37, 20, 48], np.int32),
              np.asarray([True, True, False, True]), seed=2)


class TestForwardWithPagesQuant:
    @pytest.mark.parametrize("mode", MODES)
    def test_default_cpu_path(self, both, mode):
        """(a) the tiny fp32 config: JAX dequantizes every projection
        densely, the port runs the tick's through ``quant_matmul``'s plain
        version; prefill and tick attend through the gather."""
        cfg, params, tcfg, tparams = both
        jqp = jq.quantize_llama_params(params, cfg, mode)
        tqp = tq.quantize_llama_params(tparams, tcfg, mode)
        _prefill_and_tick(cfg, jqp, tcfg, tqp, mode)

    @pytest.mark.parametrize("mode", MODES)
    def test_pallas_quant_matmul_path(self, monkeypatch, mode):
        """(b) hidden 128, every projection width a multiple of 128: with
        the tick kernels forced through the interpreter, the JAX tick
        reaches the Pallas ``quant_matmul`` as the port's does its
        kernel's plain version."""
        monkeypatch.setattr(jtf, "FORCE_INTERPRET", True)
        cfg = jl.LlamaConfig(vocab_size=256, hidden_size=128,
                             intermediate_size=256, num_layers=2,
                             num_heads=2, num_kv_heads=2, max_seq_len=64,
                             dtype=jnp.float32, remat=False,
                             scan_layers=False)
        assert jtf.quant_matmul_active(128, 128)
        assert jtf.quant_matmul_active(256, 128)
        params = jl.init_params(cfg, jax.random.PRNGKey(1))
        tcfg = tl.LlamaConfig(vocab_size=256, hidden_size=128,
                              intermediate_size=256, num_layers=2,
                              num_heads=2, num_kv_heads=2, max_seq_len=64,
                              dtype=torch.float32)
        tparams = params_from_numpy({k: np.asarray(v)
                                     for k, v in params.items()}, tcfg, "cpu")
        _prefill_and_tick(cfg, jq.quantize_llama_params(params, cfg, mode),
                          tcfg, tq.quantize_llama_params(tparams, tcfg, mode),
                          mode)


# ---------------------------------------------------------------------------
# the quantized paged engine against the JAX engine
# ---------------------------------------------------------------------------


def _arrivals(vocab, seed=3, n=4, plen=16, gen=8):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, vocab, (plen,)).astype(np.int32), gen)
            for _ in range(n)]


def _serve(both, port: bool, reqs, pc_pages=None, seg_steps=8, **kw):
    """Serve ``reqs`` (all at t = 0) through ``OnlineScheduler`` on one
    engine. Returns what both engines must agree on, and the engine."""
    cfg, params, tcfg, tparams = both
    kw = {**ENGINE, **kw}
    if port:
        eng = ServingEngine(tcfg, tparams, device="cpu", **kw)
        pc = (PagedPrefixCache(eng.pager, capacity_pages=pc_pages)
              if pc_pages else None)
        mod = tsched
    else:
        from paddle_tpu.inference.prefix_cache import PagedPrefixCache as JPC

        eng = JaxEngine(cfg, params, **kw)
        pc = JPC(eng.pager, capacity_pages=pc_pages) if pc_pages else None
        mod = jsched
    sch = mod.OnlineScheduler(eng, seg_steps=seg_steps, prefix_cache=pc)
    rep = sch.serve([mod.Arrival(0.0, p, n) for p, n in reqs])
    res = sch.results()
    rids = sorted(res)
    out = {"tokens": [res[r] for r in rids], "segments": rep.segments,
           "ticks": rep.ticks, "pages": rep.pages,
           "prefix": rep.prefix if pc is not None else None}
    digests = [sch._reqs[r].digests for r in rids]
    return out, digests, eng


# digests' logits: rtol 2e-4 as the logits above, plus an atol for the
# quantized pool: a K/V value within fp32 rounding of a rounding boundary
# is stored one step away from JAX's (int8: 1/127 of its row's largest
# magnitude; e4m3: 1/16 to 1/8 of the value), and each such row moves the
# later logits of its serve by up to ~1e-3
DIGEST_ATOL = {"int8": 2e-3, "fp8": 5e-3}


def _check_digests(got, want, mode, k=4):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g is not None and len(g) == len(w)
        for (gl, gi, gv), (wl, wi, wv) in zip(g, w):
            assert gi == wi and len(gi) == k
            _close([gl] + gv, [wl] + wv, atol=DIGEST_ATOL[mode])


class TestQuantEngine:
    def test_validation(self, both):
        tcfg, tparams = both[2], both[3]
        kw = dict(slots=2, max_len=96, prompt_buckets=(8, 16), device="cpu")
        with pytest.raises(ValueError, match="quant"):
            ServingEngine(tcfg, tparams, paged=True, quant="int4", **kw)
        with pytest.raises(ValueError, match="paged"):
            ServingEngine(tcfg, tparams, quant="int8", **kw)
        with pytest.raises(ValueError, match="paged"):
            ServingEngine(tcfg, tparams, quality_digest=True, **kw)
        with pytest.raises(ValueError, match="digest_top_k"):
            ServingEngine(tcfg, tparams, paged=True, quality_digest=True,
                          digest_top_k=0, **kw)

    @pytest.mark.parametrize("mode", MODES)
    def test_serve_matches_jax_with_digests(self, both, mode):
        reqs = _arrivals(both[0].vocab_size, n=5, gen=9)
        want, wdig, _ = _serve(both, False, reqs, quant=mode,
                               quality_digest=True)
        got, gdig, eng = _serve(both, True, reqs, quant=mode,
                                quality_digest=True)
        assert got == want
        assert [len(t) for t in got["tokens"]] == [n for _, n in reqs]
        _check_digests(gdig, wdig, mode)
        assert eng.pager.pool["k"].dtype == tq.quant_dtype(mode)
        assert set(eng.params) >= {k + "_scale" for k in
                                   tq.quantized_weight_keys(eng.cfg)}
        assert not eng.quant_kernel_active()       # the CPU: plain versions
        assert not eng.paged_kernel_active()
        assert eng.pager.leak_report() == []

    def test_eos_digests_trimmed_and_aligned(self, both):
        """With EOS the tokens stop at the first EOS and the digests with
        them, as in the JAX engine."""
        reqs = _arrivals(both[0].vocab_size, seed=5, n=3, gen=10)
        plain, _, _ = _serve(both, True, reqs, quant="int8")
        eos = plain["tokens"][0][2]
        want, wdig, _ = _serve(both, False, reqs, quant="int8",
                               quality_digest=True, eos_token_id=eos)
        got, gdig, _ = _serve(both, True, reqs, quant="int8",
                              quality_digest=True, eos_token_id=eos)
        assert got == want
        full = plain["tokens"][0]
        assert got["tokens"][0] == full[:full.index(eos) + 1]
        assert [len(d) for d in gdig] == [len(t) for t in got["tokens"]]
        _check_digests(gdig, wdig, "int8")

    def test_one_fetch_per_segment_without_eos(self, both):
        eng = ServingEngine(both[2], both[3], device="cpu", quant="int8",
                            quality_digest=True, **ENGINE)
        for p, n in _arrivals(both[0].vocab_size, n=4):
            eng.add_request(p, n)
        segments = 0
        while eng._queue or eng.free_slot_count() < eng.slots:
            before = eng.fetches
            assert eng.run_segment(6)["steps"] > 0
            segments += 1
            assert eng.fetches == before + 1
        assert segments > 1

    def test_matched_prefix_against_fp32_above_floor(self, both):
        """The JAX test's bar on random weights: the int8 serve's
        matched-prefix rate against the unquantized serve is >= 0.5."""
        reqs = _arrivals(both[0].vocab_size, n=4)
        q, qdig, _ = _serve(both, True, reqs, quant="int8",
                            quality_digest=True)
        f, fdig, _ = _serve(both, True, reqs, quality_digest=True)
        matched = compared = 0
        for a, b, da_, db in zip(q["tokens"], f["tokens"], qdig, fdig):
            r = compare_pair(a, b, da_, db)
            matched += r["tokens_matched"]
            compared += r["compared"]
            assert r["logit_positions"] == r["tokens_matched"]
        assert compared > 0 and matched / compared >= 0.5


class TestQuantPages:
    def test_prefix_hit_token_identity(self, both):
        """Four prompts over one 32-token prefix through the paged prefix
        cache: later admits map the cached quantized pages (and their
        scales) by reference and serve token-identically to the uncached
        quantized serve."""
        rng = np.random.RandomState(11)
        vocab = both[0].vocab_size
        prefix = rng.randint(0, vocab, (32,)).astype(np.int32)
        reqs = [(np.concatenate([prefix, rng.randint(0, vocab, (8,))])
                 .astype(np.int32), 8) for _ in range(4)]
        cold, _, _ = _serve(both, True, reqs, quant="int8")
        hit, _, eng = _serve(both, True, reqs, pc_pages=8, quant="int8")
        assert hit["prefix"]["hits"] > 0
        assert hit["tokens"] == cold["tokens"]

    @pytest.mark.parametrize("mode", MODES)
    def test_cow_break_copies_scale_planes(self, both, mode):
        """Breaking a shared page copies every plane: the narrow rows and
        their ``ks``/``vs`` scales."""
        pgr = PagedKVCache(both[2], slots=2, page_size=8, num_pages=9,
                           max_pages=4, device="cpu", quant=mode)
        assert set(pgr.pool) == {"k", "v", "ks", "vs"}
        assert pgr.pool["ks"].shape == pgr.pool["k"].shape[:3]
        pages, row = pgr.reserve(16)
        pgr.install(0, pages)
        pgr.page_table[0] = torch.from_numpy(row)
        for name, plane in pgr.pool.items():
            plane[:, pages[0]] = torch.full_like(plane[:, pages[0]],
                                                 3 if name in "kv" else 0.25)
        pgr.fork_slot(0, 1)
        new = pgr.ensure_writable(1, 0)
        assert new != pages[0] and pgr.cow_breaks == 1
        for plane in pgr.pool.values():
            assert torch.equal(plane[:, new].float(),
                               plane[:, pages[0]].float())
        pgr.free_slot(0)
        pgr.free_slot(1)
        assert pgr.leak_report() == []


# ---------------------------------------------------------------------------
# compare_pair
# ---------------------------------------------------------------------------


class TestComparePair:
    def test_matches_jax(self):
        rng = np.random.RandomState(7)

        def dig(n, shift=0.0):
            out = []
            for _ in range(n):
                ids = [int(i) for i in rng.choice(50, 4, replace=False)]
                vals = sorted((float(v) + shift for v in rng.randn(4)),
                              reverse=True)
                out.append((float(rng.randn()), ids, vals))
            return out

        a = [int(t) for t in rng.randint(0, 50, 12)]
        cases = [
            (a, list(a), dig(12), dig(12)),               # full match
            (a, a[:5] + [99] + a[6:], dig(12), dig(12)),  # diverge at 5
            (a, a[:8], dig(12), dig(8)),                  # strict prefix
            (a, list(a), None, None),                     # tokens only
            ([], [], [], []),
        ]
        shared = dig(6)
        cases.append((a[:6], a[:6], shared,               # shared top-k ids
                      [(l + 0.1, i, [v * 1.1 for v in vs])
                       for l, i, vs in shared]))
        for p, s, pd, sd in cases:
            assert compare_pair(p, s, pd, sd) == jax_compare(p, s, pd, sd)
