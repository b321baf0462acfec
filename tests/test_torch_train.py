"""The port's LLaMA training step against the JAX package's, on the CPU.

The same numpy weights and tokens go through ``paddle_tpu.models.llama``
and ``paddle_tpu_torch.models.llama`` in float32, at ``tiny`` (layers
under ``lax.scan`` on the JAX side) and at the GQA geometry of
tests/test_torch_llama.py (4 query heads over 2 kv heads, D 64, unrolled).
On the CPU the port's attention is the flash forward and backward written
out (the kernels' plain versions) and the CE tail's dx is
``head_dx_softmax``'s plain version; the JAX side takes its XLA
formulations.

Tolerances: logits, losses and gradients to rtol 2e-4 (XLA's float32
transcendentals are fast approximations, tests/test_torch_llama.py), with
an atol of 1e-5 of the gradient's largest entry, for entries that cancel
to near 0. The loss trajectory to rtol 2e-5, as tests/test_ce_tail.py
holds its two trajectories. ``adamw_update`` alone, on identical inputs,
to rtol 1e-6 (the same float32 operations in the same order, up to XLA's
contraction of a multiply and an add into one fused operation), with an
atol of 1e-6 of the largest entry on the moments, for entries that cancel,
and of 1e-5 * lr on the parameters, into whose update such an ulp of m
passes divided by sqrt(v). After whole train steps, the parameters to rtol 2e-4 with
an atol of 0.2 * lr: AdamW's update m / (sqrt(v) + eps) is about sign(g)
for any gradient well above eps, so for the few entries whose gradient
lies within the two packages' rounding of 0 the sign, and so a step of up
to 2 * lr, is decided by the last digits (measured: at most 0.11 * lr, on
1 to 56 entries of a weight, at these sizes). The moments to rtol 2e-4
with an atol of 1e-4 of their largest entry: after step 2 they carry
those entries' parameter differences into the second gradient.
"""

import dataclasses
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models import llama as jl
from paddle_tpu.parallel import set_mesh
from paddle_tpu_torch.models import llama as tl
from paddle_tpu_torch.models.convert import (opt_state_from_numpy,
                                             params_from_numpy)
from paddle_tpu_torch.ops.kernels import flash_attention as fa

LR = 1e-3
BRANCHES = {"chunked": dict(ce_chunks=2), "custom": dict(ce_tail_custom=True),
            "plain": dict()}


def _port_cfg(cfg):
    """The port's config with the JAX config's numbers, in float32."""
    return tl.LlamaConfig(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
        intermediate_size=cfg.intermediate_size, num_layers=cfg.num_layers,
        num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
        max_seq_len=cfg.max_seq_len, rope_theta=cfg.rope_theta,
        rms_eps=cfg.rms_eps, dtype=torch.float32, remat=cfg.remat,
        ce_chunks=cfg.ce_chunks, ce_tail_custom=cfg.ce_tail_custom)


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


@pytest.fixture(scope="module", params=["tiny", "gqa"])
def setup(request):
    """(JAX config, JAX params, port params in fp32, tokens [4, 32])."""
    set_mesh(None)
    if request.param == "tiny":
        cfg = jl.LlamaConfig.tiny()
    else:
        cfg = jl.LlamaConfig(
            vocab_size=128, hidden_size=256, intermediate_size=512,
            num_layers=2, num_heads=4, num_kv_heads=2, max_seq_len=256,
            dtype=jnp.float32, remat=False, scan_layers=False)
    params = jl.init_params(cfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(_np(params), _port_cfg(cfg), "cpu",
                                torch.float32)
    tokens = np.random.RandomState(0).randint(
        0, cfg.vocab_size, (4, 32)).astype(np.int32)
    return cfg, params, tparams, tokens


@pytest.fixture(scope="module")
def jax_grads(setup):
    """JAX loss and gradients of each CE branch, computed once."""
    cfg, params, _, tokens = setup
    tok = jnp.asarray(tokens)
    out = {}
    for name, kw in BRANCHES.items():
        c = dataclasses.replace(cfg, **kw)
        loss, g = jax.jit(jax.value_and_grad(jl.loss_fn),
                          static_argnums=3)(params, tok, tok, c)
        out[name] = (float(loss), _np(g))
    return out


@pytest.fixture(scope="module")
def jax_steps(setup):
    """Two JAX train steps from the start (custom CE tail): the states
    after each and the losses."""
    cfg, params, _, tokens = setup
    c = dataclasses.replace(cfg, ce_tail_custom=True)
    step = jax.jit(lambda p, s, t: jl.train_step(p, s, t, t, c, lr=LR))
    tok = jnp.asarray(tokens)
    opt = jl.init_opt_state(params)
    p1, s1, l1 = step(params, opt, tok)
    p2, s2, l2 = step(p1, s1, tok)
    state = lambda p, s: (_np(p), {"step": np.asarray(s["step"]),
                                   "m": _np(s["m"]), "v": _np(s["v"])})
    return state(p1, s1), state(p2, s2), [float(l1), float(l2)]


def _close_tree(got, want, rtol=2e-4, atol_rel=1e-5, atol=0.0):
    for k, w in want.items():
        g = got[k].detach().numpy() if torch.is_tensor(got[k]) else got[k]
        np.testing.assert_allclose(
            g, w, rtol=rtol,
            atol=max(atol, atol_rel * float(np.abs(w).max())), err_msg=k)


def test_forward_logits(setup):
    cfg, params, tparams, tokens = setup
    ref = jax.jit(jl.forward, static_argnums=2)(params, jnp.asarray(tokens),
                                                cfg)
    out = tl.forward(tparams, torch.from_numpy(tokens), _port_cfg(cfg))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-4,
                               atol=1e-5)


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_loss_and_grads(setup, jax_grads, branch):
    """Each CE branch: the loss, and every parameter's gradient."""
    cfg, _, tparams, tokens = setup
    tcfg = _port_cfg(dataclasses.replace(cfg, **BRANCHES[branch]))
    leaves = {k: p.clone().requires_grad_() for k, p in tparams.items()}
    tok = torch.from_numpy(tokens)
    loss = tl.loss_fn(leaves, tok, tok, tcfg)
    loss.backward()
    want_loss, want_grads = jax_grads[branch]
    np.testing.assert_allclose(loss.item(), want_loss, rtol=2e-5)
    assert set(want_grads) == set(leaves)
    _close_tree({k: p.grad for k, p in leaves.items()}, want_grads)


def test_two_train_steps(setup, jax_steps):
    """Two steps from the start give JAX's losses, parameters and moments;
    a second step started from JAX's state after step 1 gives JAX's state
    after step 2."""
    cfg, _, tparams, tokens = setup
    tcfg = _port_cfg(dataclasses.replace(cfg, ce_tail_custom=True))
    (p1, s1), (p2, s2), losses = jax_steps
    tok = torch.from_numpy(tokens)
    params = {k: v.clone() for k, v in tparams.items()}
    opt = tl.init_opt_state(params)
    step = tl.make_train_step(tcfg, lr=LR, device="cpu")
    traj = []
    for (pw, sw) in ((p1, s1), (p2, s2)):
        out_p, out_s, loss = step(params, opt, tok, tok)
        assert out_p is params and out_s is opt      # updated in place
        traj.append(loss.item())
        _close_tree(params, pw, atol=0.2 * LR)
        _close_tree(opt["m"], sw["m"], atol_rel=1e-4)
        _close_tree(opt["v"], sw["v"], atol_rel=1e-4)
        assert int(opt["step"]) == int(sw["step"])
    np.testing.assert_allclose(traj, losses, rtol=2e-5)

    params = params_from_numpy(p1, tcfg, "cpu", torch.float32)
    opt = opt_state_from_numpy(s1, tcfg, "cpu")
    assert opt["step"].dtype == torch.int32 and int(opt["step"]) == 1
    _, _, loss = tl.train_step(params, opt, tok, tok, tcfg, lr=LR)
    np.testing.assert_allclose(loss.item(), losses[1], rtol=2e-5)
    _close_tree(params, p2, atol=0.2 * LR)
    _close_tree(opt["m"], s2["m"], atol_rel=1e-4)
    _close_tree(opt["v"], s2["v"], atol_rel=1e-4)
    assert int(opt["step"]) == 2


def test_adamw_update_matches_jax(setup):
    """One AdamW update at step 3 on the same parameters, gradients and
    moments: decayed and undecayed keys alike."""
    _, params, _, _ = setup
    rng = np.random.RandomState(1)
    p = _np(params)
    g = {k: rng.randn(*v.shape).astype(np.float32) * 1e-2
         for k, v in p.items()}
    m = {k: rng.randn(*v.shape).astype(np.float32) * 1e-3
         for k, v in p.items()}
    v = {k: rng.rand(*x.shape).astype(np.float32) * 1e-5
         for k, x in p.items()}
    jp, js = jax.jit(functools.partial(jl.adamw_update, lr=LR))(
        {k: jnp.asarray(x) for k, x in p.items()},
        {k: jnp.asarray(x) for k, x in g.items()},
        {"step": jnp.int32(2), "m": {k: jnp.asarray(x) for k, x in m.items()},
         "v": {k: jnp.asarray(x) for k, x in v.items()}})
    tens = lambda d: {k: torch.from_numpy(x.copy()) for k, x in d.items()}
    tp = tens(p)
    ts = {"step": torch.tensor(2, dtype=torch.int32), "m": tens(m),
          "v": tens(v)}
    tl.adamw_update(tp, tens(g), ts, lr=LR)
    assert int(ts["step"]) == 3
    _close_tree(tp, _np(jp), rtol=1e-6, atol_rel=0.0, atol=1e-5 * LR)
    for mine, ref in ((ts["m"], js["m"]), (ts["v"], js["v"])):
        _close_tree(mine, _np(ref), rtol=1e-6, atol_rel=1e-6)


@pytest.mark.parametrize("structure", ["whole_layer", "flash_split"])
def test_remat_gives_the_same_numbers(setup, structure):
    """remat on, in both checkpoint structures (the split one is the card's
    flash path, reached here by reporting the flash path active), against
    remat off: the same loss and gradients."""
    cfg, _, tparams, tokens = setup
    tok = torch.from_numpy(tokens)
    out = []
    for remat in (False, True):
        tcfg = _port_cfg(dataclasses.replace(cfg, remat=remat,
                                             ce_tail_custom=True))
        leaves = {k: p.clone().requires_grad_() for k, p in tparams.items()}
        with mock.patch.object(fa, "flash_path_active",
                               lambda t: structure == "flash_split"):
            loss = tl.loss_fn(leaves, tok, tok, tcfg)
            loss.backward()
        out.append((loss.item(), {k: p.grad for k, p in leaves.items()}))
    assert out[0][0] == out[1][0]
    for k, g in out[0][1].items():
        torch.testing.assert_close(out[1][1][k], g, rtol=1e-6, atol=1e-7)


def test_make_train_step_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tl.make_train_step(tl.LlamaConfig.tiny())


def test_config_presets():
    """As in the JAX package: no remat at tiny and bert_base_equiv, the
    custom CE tail at bert_base_equiv."""
    assert not tl.LlamaConfig.tiny().remat
    b = tl.LlamaConfig.bert_base_equiv()
    jb = jl.LlamaConfig.bert_base_equiv()
    assert (b.remat, b.ce_tail_custom, b.ce_chunks) == (
        jb.remat, jb.ce_tail_custom, jb.ce_chunks)
