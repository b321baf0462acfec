"""LLaMA's single-device options in the port against the JAX package, on
the CPU: ``fused_weights``, ``bf16_grads``, ``bwd_barriers`` and
``fused_tick_epilogue``, with the config fields they come with.

The same numpy weights and tokens go through ``paddle_tpu.models.llama``
and ``paddle_tpu_torch.models.llama``; the JAX side runs jitted (its
``tiny`` layers under ``lax.scan``, the port's unrolled). Tolerances, as
tests/test_torch_train.py states them for fp32: logits, losses and
gradients to rtol 2e-4 with an atol of 1e-5 of the largest entry. The
bf16 cases: every product rounds to bf16 in both packages, XLA's and
torch's accumulation orders differ, so a value may land one bf16 step
(2^-8 relative) apart and carry it on; the loss to rtol 2e-3 (measured
4.1e-4), the gradients to 5e-2 of their largest entry (measured at most
2.4e-2), the parameters after two AdamW steps to 2e-4 relative with an
atol of 4.2 lr: AdamW moves an entry by at most about lr (1 + wd |p|) a
step, so an entry whose gradient's sign two roundings of a near-0 value
decide may end up to twice that a step apart (measured at most 3.56 lr,
on 0-2 % of a weight's entries). The port's own bf16 gradients equal its
fp32-leaf gradients bit for bit: the forward is the same arithmetic.
"""

import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models import llama as jl
from paddle_tpu.parallel import set_mesh
from paddle_tpu.quantization import serving as jqs
from paddle_tpu_torch.models import llama as tl
from paddle_tpu_torch.models.convert import params_from_numpy
from paddle_tpu_torch.ops.kernels import decode_attention as da
from paddle_tpu_torch.ops.kernels import tick_fusion as tf
from paddle_tpu_torch.quantization import serving as tqs

LR = 1e-3
_DT = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _port_cfg(cfg):
    """The port's config with every field of the JAX config."""
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    kw["dtype"] = _DT[kw["dtype"]]
    return tl.LlamaConfig(**kw)


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _close(a, b, rtol=2e-4, frac=1e-5):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    np.testing.assert_allclose(a, b, rtol=rtol,
                               atol=frac * max(np.abs(b).max(), 1e-30))


@pytest.fixture(scope="module")
def fused():
    """(JAX config, JAX params, port config, port params), fused, fp32."""
    set_mesh(None)
    cfg = jl.LlamaConfig.tiny(fused_weights=True)
    params = jl.init_params(cfg, jax.random.PRNGKey(0))
    tcfg = _port_cfg(cfg)
    return cfg, params, tcfg, params_from_numpy(_np(params), tcfg, "cpu")


def _tokens(cfg, B=2, S=16, seed=0):
    return np.random.RandomState(seed).randint(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


class TestConfig:
    def test_fields_defaults_and_presets(self):
        """Every field of the JAX config with its default; the presets
        equal JAX's on every field but the dtype's spelling."""
        jd = {f.name: f.default for f in dataclasses.fields(jl.LlamaConfig)}
        td = {f.name: f.default for f in dataclasses.fields(tl.LlamaConfig)}
        assert set(td) == set(jd)
        assert {k: td[k] for k in td if k != "dtype"} == \
            {k: jd[k] for k in jd if k != "dtype"}
        for name in ("tiny", "bert_base_equiv", "cpu_small", "llama7b"):
            j, t = getattr(jl.LlamaConfig, name)(), getattr(
                tl.LlamaConfig, name)()
            for k in jd:
                if k != "dtype":
                    assert getattr(t, k) == getattr(j, k), (name, k)
            assert t.dtype == _DT[j.dtype], name

    def test_validation(self):
        with pytest.raises(ValueError, match="sp_impl"):
            tl.LlamaConfig.tiny(sp_impl="bogus")
        with pytest.raises(ValueError, match="bwd_barriers"):
            tl.LlamaConfig.tiny(bwd_barriers="mlp,bogus")
        tl.LlamaConfig.tiny(bwd_barriers="mlp,qkv,logits",
                            sp_impl="ulysses")

    def test_mesh_options_change_nothing_on_one_device(self, fused):
        """scan_layers, sharding_stage and sequence_parallel (both sp_impl)
        leave the loss and its gradients bit for bit."""
        _, _, tcfg, tparams = fused
        tok = torch.from_numpy(_tokens(tcfg))
        base = None
        for kw in ({}, dict(scan_layers=False, sharding_stage=3),
                   dict(sequence_parallel=True),
                   dict(sequence_parallel=True, sp_impl="ulysses")):
            cfg = dataclasses.replace(tcfg, **kw)
            leaves = {k: v.clone().requires_grad_() for k, v in
                      tparams.items()}
            loss = tl.loss_fn(leaves, tok, tok, cfg)
            grads = torch.autograd.grad(loss, list(leaves.values()))
            got = [loss.detach()] + list(grads)
            if base is None:
                base = got
            assert all(torch.equal(a, b) for a, b in zip(got, base)), kw


class TestFusedWeights:
    def test_tree(self, fused):
        """Keys and shapes as JAX's; the port's fused init is its split
        init under the same generator, concatenated."""
        cfg, params, tcfg, _ = fused
        assert tl.param_shapes(tcfg) == {k: v.shape
                                         for k, v in params.items()}
        assert tl.layer_keys(tcfg) == jl.layer_keys(cfg)
        f = tl.init_params(tcfg, torch.Generator().manual_seed(3), "cpu")
        s = tl.init_params(dataclasses.replace(tcfg, fused_weights=False),
                           torch.Generator().manual_seed(3), "cpu")
        assert torch.equal(f["wqkv"], torch.cat([s["wq"], s["wk"], s["wv"]],
                                                -1))
        assert torch.equal(f["w_gate_up"], torch.cat([s["w_gate"],
                                                      s["w_up"]], -1))

    def test_forward_loss_and_grads(self, fused):
        cfg, params, tcfg, tparams = fused
        tok = _tokens(cfg)
        jlog = jax.jit(jl.forward, static_argnums=2)(params, tok, cfg)
        _close(tl.forward(tparams, torch.from_numpy(tok), tcfg).detach(),
               jlog)
        jloss, jg = jax.jit(jax.value_and_grad(jl.loss_fn),
                            static_argnums=3)(params, tok, tok, cfg)
        leaves = {k: v.clone().requires_grad_() for k, v in tparams.items()}
        loss = tl.loss_fn(leaves, torch.from_numpy(tok),
                          torch.from_numpy(tok), tcfg)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        _close(loss.item(), float(jloss))
        for k, g in zip(leaves, grads):
            _close(g, jg[k])

    @pytest.mark.parametrize("epilogue", [True, False])
    def test_prefill_and_ticks(self, fused, epilogue):
        """Prefill, then two ragged decode ticks: logits and the cache
        rows, with the tick kernels' plain versions (epilogue on) or the
        inline chains (off); the decode attention wrapper runs either
        way."""
        cfg, params, tcfg, tparams = fused
        cfg = dataclasses.replace(cfg, fused_tick_epilogue=epilogue)
        tcfg = dataclasses.replace(tcfg, fused_tick_epilogue=epilogue)
        B, S, L = 3, 8, cfg.max_seq_len
        prompt = _tokens(cfg, B, S)
        jc = jl.init_kv_cache(cfg, B, L)
        jfwd = jax.jit(jl.forward_with_cache, static_argnums=2)
        jlog, jc = jfwd(params, jnp.asarray(prompt), cfg, jc, jnp.int32(0))
        tc = tl.init_kv_cache(tcfg, B, L, "cpu")
        tlog, tc = tl.forward_with_cache(tparams, torch.from_numpy(prompt),
                                         tcfg, tc, 0)
        _close(tlog, jlog)
        rng = np.random.RandomState(1)
        posv = np.asarray([S, S + 3, L - 1], np.int32)
        names = ("fused_rms_norm", "fused_add_rms_norm", "fused_rope_qk")
        spies = [mock.patch.object(tf, n, wraps=getattr(tf, n))
                 for n in names] + [mock.patch.object(
                     da, "ragged_decode_attention",
                     wraps=da.ragged_decode_attention)]
        calls = [sp.start() for sp in spies]
        try:
            for _ in range(2):
                nxt = rng.randint(0, cfg.vocab_size, (B, 1)).astype(np.int32)
                jlog, jc = jfwd(params, jnp.asarray(nxt), cfg, jc,
                                jnp.asarray(posv))
                tlog, tc = tl.forward_with_cache(
                    tparams, torch.from_numpy(nxt), tcfg, tc,
                    torch.from_numpy(posv))
                _close(tlog, jlog)
                posv = np.minimum(posv + 1, L - 1)
        finally:
            for sp in spies:
                sp.stop()
        # the tick kernels' wrappers run only with the epilogue on, the
        # decode attention's with it off too
        L = cfg.num_layers
        tick = [2 * (L + 1), 2 * L, 2 * L] if epilogue else [0, 0, 0]
        assert [c.call_count for c in calls] == tick + [2 * L]
        for kk in ("k", "v"):
            _close(tc[kk], jc[kk])

    def test_paged_chunk_and_tick(self, fused):
        """A paged prefill chunk and a decode tick on the fused tree."""
        cfg, params, tcfg, tparams = fused
        B, S, psz = 2, 8, 8
        pt = np.asarray([[1, 2, 3], [4, 5, 6]], np.int32)
        jp = jl.init_paged_pool(cfg, 8, psz)
        tp = tl.init_paged_pool(tcfg, 8, psz, "cpu")
        jfwd = jax.jit(jl.forward_with_pages, static_argnums=2)
        prompt = _tokens(cfg, B, S, seed=2)
        pos = np.zeros(B, np.int32)
        for toks in (prompt, prompt[:, -1:]):
            jlog, jp = jfwd(params, jnp.asarray(toks), cfg, jp,
                            jnp.asarray(pt), jnp.asarray(pos))
            tlog, tp = tl.forward_with_pages(
                tparams, torch.from_numpy(toks), tcfg, tp,
                torch.from_numpy(pt), torch.from_numpy(pos))
            _close(tlog, jlog)
            pos = pos + toks.shape[1]
        for kk in ("k", "v"):
            _close(tp[kk], jp[kk])

    def test_int8_tree_bytes_and_tick(self, fused):
        """The quantized fused tree equals JAX's byte for byte and the
        concatenation of the quantized split trees (a column's absmax runs
        over the contraction dim); a decode tick on it matches JAX's."""
        cfg, params, tcfg, tparams = fused
        jq = jqs.quantize_llama_params(params, cfg, "int8")
        tq = tqs.quantize_llama_params(tparams, tcfg, "int8")
        assert set(tq) == set(jq)
        assert tqs.quantized_weight_keys(tcfg) == \
            jqs.quantized_weight_keys(cfg)
        for k in jq:
            np.testing.assert_array_equal(tq[k].numpy(), np.asarray(jq[k]))
        H, Hkv = tcfg.hidden_size, tcfg.num_kv_heads * tcfg.head_dim
        split = {k: v for k, v in tparams.items()
                 if k not in ("wqkv", "w_gate_up")}
        split.update(zip(("wq", "wk", "wv"), tparams["wqkv"].split(
            [H, Hkv, Hkv], -1)))
        split.update(zip(("w_gate", "w_up"), tparams["w_gate_up"].split(
            tcfg.intermediate_size, -1)))
        sq = tqs.quantize_llama_params(
            split, dataclasses.replace(tcfg, fused_weights=False), "int8")
        for fk, parts in (("wqkv", ("wq", "wk", "wv")),
                          ("w_gate_up", ("w_gate", "w_up"))):
            for suf in ("", "_scale"):
                assert torch.equal(tq[fk + suf], torch.cat(
                    [sq[p + suf] for p in parts], -1)), fk + suf
        B, L = 2, 16
        tok = _tokens(cfg, B, 1, seed=3)
        pos = np.asarray([0, 0], np.int32)
        jlog, _ = jax.jit(jl.forward_with_cache, static_argnums=2)(
            jq, jnp.asarray(tok), cfg, jl.init_kv_cache(cfg, B, L),
            jnp.asarray(pos))
        tlog, _ = tl.forward_with_cache(
            tq, torch.from_numpy(tok), tcfg, tl.init_kv_cache(tcfg, B, L,
                                                              "cpu"),
            torch.from_numpy(pos))
        _close(tlog, jlog)

    def test_greedy_tokens(self, fused):
        cfg, params, tcfg, tparams = fused
        prompt = _tokens(cfg, 2, 6, seed=4)
        want = np.asarray(jl.generate(params, jnp.asarray(prompt), cfg,
                                      max_new_tokens=8))
        got = tl.generate(tparams, prompt, tcfg, max_new_tokens=8,
                          device="cpu")
        np.testing.assert_array_equal(got.numpy(), want)

    def test_rope_reads_strided_rows(self):
        """The tick's rope on q and k taken as column slices of one fused
        product equals the rope on contiguous copies (the wrapper takes
        the row stride; the kernel reads by it)."""
        g = torch.Generator().manual_seed(0)
        z = torch.randn(4, 3 * 64, generator=g)
        pos = torch.tensor([0, 5, 17, 63], dtype=torch.int32)
        zq, zk = z[:, :64], z[:, 64:128]
        assert not zq.is_contiguous()
        oq, ok = tf.fused_rope_qk(zq, zk, pos, 16, 1e4)
        rq, rk = tf.rope_qk_plain(zq.contiguous(), zk.contiguous(), pos, 16,
                                  1e4)
        assert torch.equal(oq, rq) and torch.equal(ok, rk)


class TestBf16Grads:
    def test_loss_grads_and_two_steps(self):
        set_mesh(None)
        cfg = jl.LlamaConfig.tiny(dtype=jnp.bfloat16, bf16_grads=True)
        params = jl.init_params(cfg, jax.random.PRNGKey(1))  # fp32 masters
        tcfg = _port_cfg(cfg)
        tparams = params_from_numpy(_np(params), tcfg, "cpu",
                                    dtype=torch.float32)
        tok = _tokens(cfg, seed=5)
        diff = jax.tree.map(lambda p: p.astype(jnp.bfloat16), params)
        jloss, jg = jax.jit(jax.value_and_grad(jl.loss_fn),
                            static_argnums=3)(diff, tok, tok, cfg)
        gnorm = np.sqrt(sum(np.sum(np.square(np.asarray(g, np.float32)))
                            for g in jg.values()))
        clip = min(1.0, 1.0 / (gnorm + 1e-6))
        seen = {}
        real = tl.adamw_update

        def spy(p, grads, *a, **kw):
            seen.setdefault("grads", dict(grads))
            return real(p, grads, *a, **kw)

        jstep = jax.jit(jl.train_step, static_argnums=4)
        jp, jo = params, jl.init_opt_state(params)
        to = tl.init_opt_state(tparams)
        losses = []
        with mock.patch.object(tl, "adamw_update", spy):
            for _ in range(2):
                jp, jo, jl_ = jstep(jp, jo, tok, tok, cfg, LR)
                tparams, to, tl_ = tl.train_step(
                    tparams, to, torch.from_numpy(tok),
                    torch.from_numpy(tok), tcfg, lr=LR)
                losses.append((tl_.item(), float(jl_)))
        np.testing.assert_allclose(losses[0][0], float(jloss), rtol=2e-3)
        for got, want in losses:
            np.testing.assert_allclose(got, want, rtol=2e-3)
        for k, g in seen["grads"].items():
            assert g.dtype == torch.bfloat16, k
            want = np.asarray(jg[k], np.float32) * clip
            np.testing.assert_allclose(
                g.float().numpy(), want, rtol=0,
                atol=5e-2 * np.abs(want).max(), err_msg=k)
        for k in params:
            assert tparams[k].dtype == torch.float32
            np.testing.assert_allclose(tparams[k].numpy(), np.asarray(jp[k]),
                                       rtol=2e-4, atol=4.2 * LR, err_msg=k)

    def test_same_gradients_as_fp32_leaves(self):
        cfg = tl.LlamaConfig.tiny(dtype=torch.bfloat16, bf16_grads=True)
        p = tl.init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                           dtype=torch.float32)
        tok = torch.from_numpy(_tokens(cfg, seed=7))

        def grads(leaves, c):
            loss = tl.loss_fn(leaves, tok, tok, c)
            return [loss] + list(torch.autograd.grad(
                loss, list(leaves.values())))

        a = grads({k: v.to(torch.bfloat16).requires_grad_()
                   for k, v in p.items()}, cfg)
        b = grads({k: v.clone().requires_grad_() for k, v in p.items()},
                  dataclasses.replace(cfg, bf16_grads=False))
        assert all(x.dtype == torch.bfloat16 for x in a[1:])
        assert all(torch.equal(x.float(), y) for x, y in zip(a, b))


class TestBwdBarriers:
    @pytest.mark.parametrize("site", ["mlp", "qkv", "logits"])
    def test_identity_in_both_packages(self, fused, site):
        """With a barrier at ``site`` the port's gradients equal JAX's with
        one (the port validates the name and changes nothing)."""
        _, _, tcfg, tparams = fused
        cfg = jl.LlamaConfig.tiny(fused_weights=True, bwd_barriers=site)
        params = jl.init_params(cfg, jax.random.PRNGKey(0))
        tok = _tokens(cfg, seed=6)
        jloss, jg = jax.jit(jax.value_and_grad(jl.loss_fn),
                            static_argnums=3)(params, tok, tok, cfg)

        leaves = {k: v.clone().requires_grad_() for k, v in tparams.items()}
        loss = tl.loss_fn(leaves, torch.from_numpy(tok),
                          torch.from_numpy(tok),
                          dataclasses.replace(tcfg, bwd_barriers=site))
        _close(loss.item(), jloss)
        for k, g in zip(leaves, torch.autograd.grad(loss,
                                                    list(leaves.values()))):
            _close(g, jg[k])


def test_phase_6h_b_c_rehearsal():
    """Phase 6h (b) and (c)'s functions on the CPU at ``tiny``: the fused
    bf16-gradient steps from the unfused weights follow the unfused fp32
    steps (to rtol 1e-5: the CPU's fp32 products block the wider N another
    way, a few ulps after two AdamW steps), and the fused int8 and
    bf16-layout drains give the unfused drains' tokens and first-tick
    logits."""
    from paddle_tpu_torch.experiments import runtime_llama_opts as rlo
    from paddle_tpu_torch.inference.serving import ServingEngine
    from paddle_tpu_torch.ops.kernels import quant_matmul as qm

    cfg = tl.LlamaConfig.tiny(max_seq_len=128)
    p = tl.init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                       dtype=torch.float32)
    tok = torch.from_numpy(_tokens(cfg, 2, 16, seed=8))
    out, n = rlo.fused_train(tl, cfg, p, tok, warmup=1, steps=2)
    step = tl.make_train_step(cfg, lr=1e-4, device="cpu")
    opt = tl.init_opt_state(p)
    want = [step(p, opt, tok, tok)[2].item() for _ in range(3)]
    np.testing.assert_allclose(out["losses"], want, rtol=1e-5)
    assert n == {}
    rng = np.random.RandomState(0)
    reqs = [(rng.randint(0, 256, rng.randint(8, 40)).astype(np.int32),
             int(rng.randint(3, 8))) for _ in range(4)]
    bp = tl.init_params(cfg, torch.Generator().manual_seed(2), "cpu")
    for quant in ("int8", None):
        st, _ = rlo.fused_serve(tl, ServingEngine, cfg, bp, reqs,
                                quant=quant, max_len=128, page_size=16,
                                prompt_buckets=(64,), tick_rows=4)
        assert st["identical_requests"] == len(reqs), st
        assert st["tick_logit_max_abs_err"] == 0.0, st
    col = rlo.quant_column_check(tl, qm, cfg, bp)
    assert col["fp32_max_abs_diff"] == 0.0
    rope = rlo.strided_rope_check(tf, "cpu", cfg)
    assert rope["against_contiguous"] == 0.0 and rope["plain_ok"]
