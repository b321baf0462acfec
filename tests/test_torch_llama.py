"""The port's KV-cache LLaMA decoder against the JAX package, on the CPU.

The same numpy weights and tokens go through ``paddle_tpu.models.llama``
and ``paddle_tpu_torch.models.llama`` in float32. The JAX ``tiny`` config
runs its layers under ``lax.scan``; the GQA config (4 query heads over 2
kv heads, the geometry of tests/test_decode_attention.py) runs them
unrolled; the port always unrolls. Logits agree to rtol 2e-4 (XLA's
float32 transcendentals are fast approximations) and greedy tokens are
identical.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models import llama as jl
from paddle_tpu.parallel import set_mesh
from paddle_tpu_torch.models import llama as tl
from paddle_tpu_torch.models.convert import params_from_numpy


def _port_cfg(cfg):
    """The port's config with the JAX config's numbers, in float32."""
    return tl.LlamaConfig(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
        intermediate_size=cfg.intermediate_size, num_layers=cfg.num_layers,
        num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
        max_seq_len=cfg.max_seq_len, rope_theta=cfg.rope_theta,
        rms_eps=cfg.rms_eps, dtype=torch.float32)


def _pair(cfg):
    params = jl.init_params(cfg, jax.random.PRNGKey(0))
    np_params = {k: np.asarray(v) for k, v in params.items()}
    tcfg = _port_cfg(cfg)
    return cfg, params, tcfg, params_from_numpy(np_params, tcfg, "cpu")


@pytest.fixture(scope="module", params=["tiny", "gqa"])
def pair(request):
    set_mesh(None)
    if request.param == "tiny":
        cfg = jl.LlamaConfig.tiny(max_seq_len=96)
    else:
        cfg = jl.LlamaConfig(
            vocab_size=128, hidden_size=256, intermediate_size=512,
            num_layers=2, num_heads=4, num_kv_heads=2, max_seq_len=256,
            dtype=jnp.float32, remat=False, scan_layers=False)
    return _pair(cfg)


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=2e-4,
                               atol=1e-5)


class TestParams:
    def test_round_trip(self):
        cfg, params, tcfg, tparams = _pair(jl.LlamaConfig.tiny())
        assert set(tparams) == set(params)
        for k, v in params.items():
            assert tuple(tparams[k].shape) == v.shape
            np.testing.assert_array_equal(tparams[k].numpy(), np.asarray(v))

    def test_rejects_foreign_trees(self):
        """A fused tree loads under a fused config and raises under an
        unfused one; a wrong shape raises."""
        cfg = jl.LlamaConfig.tiny(fused_weights=True)
        params = {k: np.asarray(v) for k, v in jl.init_params(cfg).items()}
        fused = params_from_numpy(params, dataclasses.replace(
            _port_cfg(cfg), fused_weights=True), "cpu")
        assert set(fused) == set(params)
        with pytest.raises(KeyError, match="wqkv"):
            params_from_numpy(params, _port_cfg(cfg), "cpu")
        cfg = jl.LlamaConfig.tiny()
        params = {k: np.asarray(v) for k, v in jl.init_params(cfg).items()}
        params["wq"] = params["wq"][:, :, :8]
        with pytest.raises(ValueError, match="wq"):
            params_from_numpy(params, _port_cfg(cfg), "cpu")

    def test_init_params_keys_shapes_and_scales(self):
        cfg = jl.LlamaConfig.tiny()
        ref = jl.init_params(cfg)
        out = tl.init_params(_port_cfg(cfg), torch.Generator().manual_seed(1),
                             device="cpu")
        assert {k: tuple(v.shape) for k, v in out.items()} == \
            {k: v.shape for k, v in ref.items()}
        for k in ref:
            np.testing.assert_allclose(out[k].std().item(),
                                       float(np.std(np.asarray(ref[k]))),
                                       rtol=0.2, atol=1e-6)


class TestForwardWithCache:
    def test_prefill_then_ragged_decode(self, pair):
        """Prefill logits at a bucket-padded prompt's true last tokens,
        then one ragged decode tick with mixed positions including 0 and
        max_len-1: logits and the written cache rows agree."""
        cfg, params, tcfg, tparams = pair
        rng = np.random.RandomState(0)
        B, S, max_len = 4, 12, cfg.max_seq_len
        prompt = rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
        true_lens = np.asarray([12, 5, 9, 1], np.int32)
        jc = jl.init_kv_cache(cfg, B, max_len)
        jlog, jc = jl.forward_with_cache(
            params, jnp.asarray(prompt), cfg, jc, jnp.int32(0),
            logit_pos=jnp.asarray(true_lens - 1))
        tc = tl.init_kv_cache(tcfg, B, max_len, "cpu")
        tlog, tc = tl.forward_with_cache(
            tparams, torch.from_numpy(prompt), tcfg, tc, 0,
            logit_pos=torch.from_numpy(true_lens - 1))
        _close(tlog.numpy(), jlog)
        for kk in ("k", "v"):
            _close(tc[kk].numpy(), jc[kk])

        nxt = rng.randint(0, cfg.vocab_size, (B, 1)).astype(np.int32)
        posv = np.asarray([0, 5, 40, max_len - 1], np.int32)
        jlog, jc = jl.forward_with_cache(params, jnp.asarray(nxt), cfg, jc,
                                         jnp.asarray(posv))
        tlog, tc = tl.forward_with_cache(tparams, torch.from_numpy(nxt),
                                         tcfg, tc, torch.from_numpy(posv))
        _close(tlog.numpy(), jlog)
        for kk in ("k", "v"):
            _close(tc[kk].numpy(), jc[kk])

    def test_ragged_pos_requires_one_token(self, pair):
        cfg, params, tcfg, tparams = pair
        tc = tl.init_kv_cache(tcfg, 2, 16, "cpu")
        with pytest.raises(ValueError, match="T=1"):
            tl.forward_with_cache(tparams, torch.zeros(2, 3, dtype=torch.int64),
                                  tcfg, tc, torch.zeros(2, dtype=torch.int32))


class TestGenerate:
    def test_greedy_tokens_identical(self, pair):
        cfg, params, tcfg, tparams = pair
        rng = np.random.RandomState(4)
        prompt = rng.randint(0, cfg.vocab_size, (2, 10)).astype(np.int32)
        ref = np.asarray(jl.generate(params, jnp.asarray(prompt), cfg,
                                     max_new_tokens=8, max_len=64))
        out = tl.generate(tparams, prompt, tcfg, max_new_tokens=8,
                          max_len=64, device="cpu")
        assert out.dtype == torch.int32
        np.testing.assert_array_equal(out.numpy(), ref)

    def test_rejects_overlong(self, pair):
        cfg, params, tcfg, tparams = pair
        with pytest.raises(ValueError, match="max_len"):
            tl.generate(tparams, np.zeros((1, 10), np.int32), tcfg,
                        max_new_tokens=8, max_len=16, device="cpu")


class TestCpuSmallTick:
    def test_tick_rope_matches_pallas_at_d16(self, monkeypatch):
        """``LlamaConfig.cpu_small`` (8 heads of D 16): a decode tick's
        q and k projections at ragged positions, roped by the port's
        ``fused_rope_qk`` (its plain version on the CPU) and by the JAX
        package's Pallas kernel in interpret mode; the tick's own q and k
        (``_decode_qkv``) are those values. rtol 2e-4: XLA's float32
        cos/sin are fast approximations."""
        import paddle_tpu.ops.pallas.tick_fusion as jtf
        from paddle_tpu_torch.ops.kernels import tick_fusion as tf

        monkeypatch.setattr(jtf, "FORCE_INTERPRET", True)
        set_mesh(None)
        cfg, _, tcfg, tparams = _pair(jl.LlamaConfig.cpu_small())
        D = tcfg.head_dim
        assert D == 16
        rng = np.random.RandomState(4)
        B = 4
        x = torch.from_numpy(rng.randn(B, tcfg.hidden_size)
                             .astype(np.float32))
        pos = torch.tensor([0, 7, 300, 511], dtype=torch.int32)
        lp = tl._layer(tl.layer_params(tparams, tcfg), 1)
        h = tf.rms_norm_plain(x, lp["ln_attn"], tcfg.rms_eps)
        zq = tl._mm(h, lp, "wq", tcfg.dtype)
        zk = tl._mm(h, lp, "wk", tcfg.dtype)
        oq, ok = tf.fused_rope_qk(zq, zk, pos, D, tcfg.rope_theta)
        rq, rk = jtf.fused_rope_qk(jnp.asarray(zq.numpy()),
                                   jnp.asarray(zk.numpy()),
                                   jnp.asarray(pos.numpy()), D,
                                   cfg.rope_theta)
        _close(oq.numpy(), rq)
        _close(ok.numpy(), rk)
        q, k, _ = tl._decode_qkv(tcfg, x, lp, pos)
        torch.testing.assert_close(q.reshape(B, -1), oq)
        torch.testing.assert_close(k.reshape(B, -1), ok)
