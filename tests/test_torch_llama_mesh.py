"""The port's sharded LLaMA and BERT trainers (``make_sharded_train_step``
on explicit shards, ``parallel/sharded.py``) against the JAX package's
GSPMD ones, on the CPU.

The JAX side runs in this process on the 8 virtual CPU devices that
``conftest.py`` sets up, one jitted program a case; the port's runs in one
world of 8 spawned gloo ranks (``experiments.mesh_train.spawn``: a
``file://`` store under a temporary directory, one thread a rank, a join
deadline), fed the same numpy weights and batches, every case of the
file in that one world. Tolerances are the reference's own:
``tests/test_llama_parallel.py`` (loss rtol 2e-5, gradients rtol 1e-4 /
atol 1e-5) for dp 2 x sharding 2 x mp 2, ``tests/test_sharding_sp.py``
(1e-4) for dp 2 x mp 2 x sep 2 under sequence parallelism, and 1e-5 for
the moments after a sharded AdamW step. Gradients are compared where the
reference compares them, summed over the data axes before the clip; the
single-device JAX gradient is the yardstick for every layout (the
reference's tests hold its mesh programs to that same one).
"""

import functools

import jax
import numpy as np
import pytest

from paddle_tpu.models import bert as jbert
from paddle_tpu.models import llama as jl
from paddle_tpu.parallel import create_hybrid_mesh as jmesh
from paddle_tpu.parallel import set_mesh as jset_mesh
from paddle_tpu_torch.experiments import mesh_train
from paddle_tpu_torch.models import bert, llama

LAYOUT = dict(dp=2, sharding=2, mp=2)
SP_LAYOUT = dict(dp=2, mp=2, sep=2)
LR = 1e-3


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _params(shapes, seed):
    """Seeded numpy weights of ``shapes``: normal / sqrt(fan-in) for the
    matrices, 0.02 normal for the embeddings, gains and biases near 1 and
    0 (off the constants, so every term of a gradient is exercised)."""
    rng = np.random.RandomState(seed)
    out = {}
    for k, s in shapes.items():
        x = rng.standard_normal(s).astype(np.float32)
        if len(s) == 1 or k.startswith("ln") or k.endswith(("_g", "_b")) \
                or k in ("bqkv", "bo", "b_in", "b_out", "mlm_bias"):
            x = (k.endswith("_g") or k.startswith("ln")) + 0.1 * x
        elif "embed" in k:
            x = 0.02 * x
        else:
            x = x / np.sqrt(s[-2])
        out[k] = np.asarray(x, np.float32)
    return out


def _tokens(vocab, batch=8, seed=0):
    return np.random.RandomState(seed).randint(
        0, vocab, (batch, 64)).astype(np.int32)


def _jax_grads(mod, cfg, params, tokens, labels):
    jset_mesh(None)
    f = jax.jit(jax.value_and_grad(mod.loss_fn), static_argnums=(3,))
    loss, g = f(params, tokens, labels, cfg)
    return float(loss), _np(g)


def _jax_steps(mod, cfg, params, tokens, labels, steps, mesh=None):
    """The reference's ``make_sharded_train_step`` on ``mesh`` (or its
    single-device ``train_step``): each loss, and the moments after step
    1."""
    jset_mesh(None)
    if mesh is None:
        step = jax.jit(functools.partial(mod.train_step, cfg=cfg, lr=LR))
        p, o = params, mod.init_opt_state(params)
    else:
        step = mod.make_sharded_train_step(cfg, mesh, lr=LR)
        p, o = _jax_place(mod, cfg, mesh, params)
    try:
        losses, m1 = [], None
        for i in range(steps):
            p, o, loss = step(p, o, tokens, labels)
            losses.append(float(loss))
            if i == 0:
                m1 = (_np(o["m"]), _np(o["v"]))
        return losses, m1
    finally:
        jset_mesh(None)


def _jax_place(mod, cfg, mesh, params):
    from jax.sharding import NamedSharding

    ps = {k: NamedSharding(mesh, v) for k, v in mod.param_specs(cfg).items()}
    os_ = {k: NamedSharding(mesh, v)
           for k, v in mod.opt_state_specs(cfg).items()}
    o = mod.init_opt_state(params)
    return jax.device_put(params, ps), {
        "step": o["step"], "m": jax.device_put(o["m"], os_),
        "v": jax.device_put(o["v"], os_)}


@pytest.fixture(scope="module")
def run():
    """Every case of the file: the JAX references here, the port's in one
    world of 8 ranks."""
    cfg = jl.LlamaConfig.tiny()
    params = _params(llama.param_shapes(llama.LlamaConfig.tiny()), 3)
    tok = _tokens(cfg.vocab_size)
    fcfg = jl.LlamaConfig.tiny(fused_weights=True)
    fparams = _params(llama.param_shapes(llama.LlamaConfig.tiny(
        fused_weights=True)), 4)
    gcfg = jl.LlamaConfig.tiny(num_heads=4, num_kv_heads=2)
    gparams = _params(llama.param_shapes(llama.LlamaConfig.tiny(
        num_heads=4, num_kv_heads=2)), 5)
    bcfg = jbert.BertConfig.tiny()
    bparams = _params(bert.param_shapes(bert.BertConfig.tiny()), 6)
    btok, blab = map(np.asarray, jbert.random_mlm_batch(bcfg, 8, 64, seed=1))

    ref = {"llama": _jax_grads(jl, cfg, params, tok, tok),
           "fused": _jax_grads(jl, fcfg, fparams, tok, tok),
           "gqa": _jax_grads(jl, gcfg, gparams, tok, tok),
           "bert": _jax_grads(jbert, bcfg, bparams, btok, blab),
           # ZeRO's stage moves no number: the stage-3 program is the
           # reference for both stages' steps
           "steps": _jax_steps(jl, jl.LlamaConfig.tiny(sharding_stage=3),
                               params, tok, tok, 3, mesh=jmesh(**LAYOUT)),
           "bert_steps": _jax_steps(jbert, bcfg, bparams, btok, blab, 3)}

    def case(layout, cfg_kw, p, steps=0, grads=True, **kw):
        return dict(layout=layout, cfg=cfg_kw, params=p, tokens=tok, lr=LR,
                    steps=steps, grads=grads, **kw)

    lcases = [case(LAYOUT, dict(sharding_stage=1), params, steps=3),
              case(LAYOUT, dict(sharding_stage=3), params, steps=3),
              case(SP_LAYOUT, dict(sequence_parallel=True, sp_impl="ring"),
                   params),
              case(SP_LAYOUT, dict(sequence_parallel=True,
                                   sp_impl="ulysses"), params),
              case(LAYOUT, dict(fused_weights=True, sharding_stage=3),
                   fparams, steps=1),
              case(LAYOUT, dict(num_heads=4, num_kv_heads=2), gparams),
              # sequence parallel on a mesh whose sep axis is 1: the rows
              # stay whole, as the reference's dense branch computes
              case(LAYOUT, dict(sequence_parallel=True), params),
              # remat through the same block as one device's
              case(LAYOUT, dict(sharding_stage=3, remat=True), params),
              case(SP_LAYOUT, dict(sequence_parallel=True, sp_impl="ring",
                                   remat=True), params)]
    bcases = [dict(layout=LAYOUT, cfg=dict(sharding_stage=st, remat=remat),
                   params=bparams, tokens=btok, labels=blab, lr=LR,
                   steps=3 if st == 1 else 0, grads=True)
              for st, remat in ((1, False), (3, False), (1, True))]
    port = mesh_train.spawn(mesh_train.model_cases, 8,
                            args=(lcases, bcases), timeout=120)[0]
    return ref, port


def _close_grads(got, want, rtol, atol):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   err_msg=k)


@pytest.mark.parametrize("i,stage", [(0, 1), (1, 3)])
def test_hybrid_loss_and_grads_match_the_reference(run, i, stage):
    ref, port = run
    r = port["llama"][i]
    loss, g = ref["llama"]
    np.testing.assert_allclose(r["loss"], loss, rtol=2e-5)
    _close_grads(r["grads"], g, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("i,stage", [(0, 1), (1, 3)])
def test_three_sharded_adamw_steps_match_the_reference(run, i, stage):
    """Losses of 3 steps, and the moments after step 1 (moments, not the
    post-AdamW parameters: the reference's test explains why)."""
    ref, port = run
    r = port["llama"][i]
    losses, (m1, v1) = ref["steps"]
    np.testing.assert_allclose(r["losses"], losses, rtol=1e-5)
    _close_grads(r["m1"], m1, rtol=1e-5, atol=1e-5)
    _close_grads(r["v1"], v1, rtol=1e-5, atol=1e-8)
    assert r["opt"]["step"] == 3


@pytest.mark.parametrize("i,impl", [(2, "ring"), (3, "ulysses")])
def test_sequence_parallel_matches_the_single_device(run, i, impl):
    ref, port = run
    r = port["llama"][i]
    loss, g = ref["llama"]
    assert abs(r["loss"] - loss) < 1e-4
    for k in g:
        assert np.abs(r["grads"][k] - g[k]).max() < 1e-4, k


def test_sequence_parallel_without_a_sep_axis_is_dense(run):
    ref, port = run
    r = port["llama"][6]
    np.testing.assert_allclose(r["loss"], ref["llama"][0], rtol=2e-5)
    _close_grads(r["grads"], ref["llama"][1], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("i,layout", [(7, "dp2_sharding2_mp2_zero3"),
                                      (8, "dp2_mp2_sep2_ring")])
def test_remat_on_a_mesh_matches_the_reference(run, i, layout):
    """``remat=True`` (llama7b's default) on a mesh checkpoints the same
    block the single device does, collectives inside."""
    ref, port = run
    r = port["llama"][i]
    loss, g = ref["llama"]
    if i == 7:
        np.testing.assert_allclose(r["loss"], loss, rtol=2e-5)
        _close_grads(r["grads"], g, rtol=1e-4, atol=1e-5)
    else:
        assert abs(r["loss"] - loss) < 1e-4
        for k in g:
            assert np.abs(r["grads"][k] - g[k]).max() < 1e-4, k


def test_fused_weights_at_mp2_keep_the_reference_layout(run):
    """``wqkv`` and ``w_gate_up`` are laid out per mp rank as [q_r | k_r |
    v_r] by ``shard_state`` and put back by ``gather_state``: gradients
    and the gathered parameters are in the reference's column order."""
    ref, port = run
    r = port["llama"][4]
    loss, g = ref["fused"]
    np.testing.assert_allclose(r["loss"], loss, rtol=2e-5)
    _close_grads(r["grads"], g, rtol=1e-4, atol=1e-5)
    assert set(r["params"]) == set(g)
    assert r["params"]["wqkv"].shape == g["wqkv"].shape


def test_gqa_four_heads_over_two_kv_heads_at_mp2(run):
    ref, port = run
    r = port["llama"][5]
    loss, g = ref["gqa"]
    np.testing.assert_allclose(r["loss"], loss, rtol=2e-5)
    _close_grads(r["grads"], g, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("i,stage", [(0, 1), (1, 3)])
def test_zero_splits_moments_and_stage3_params(run, i, stage):
    """Each rank holds 1 / (dp * sharding) of every moment (of what its
    mp shard holds), and at stage 3 of the parameters too."""
    ref, port = run
    r = port["llama"][i]
    cfg = llama.LlamaConfig.tiny(sharding_stage=stage)
    shapes = llama.param_shapes(cfg)
    for k, (p_local, m_local) in r["local_numel"].items():
        full = int(np.prod(shapes[k]))
        mp = 2 if "mp" in llama.param_specs(cfg)[k] else 1
        assert m_local == full // (4 * mp), k
        want_p = full // mp // (4 if stage == 3 and k not in (
            "ln_attn", "ln_mlp", "ln_f") else 1)
        assert p_local == want_p, k


@pytest.mark.parametrize("i,stage", [(0, 1), (1, 3), (2, "1_remat")])
def test_bert_sharded_loss_and_grads(run, i, stage):
    ref, port = run
    r = port["bert"][i]
    loss, g = ref["bert"]
    np.testing.assert_allclose(r["loss"], loss, rtol=2e-5)
    _close_grads(r["grads"], g, rtol=1e-4, atol=1e-5)


def test_bert_three_sharded_adamw_steps(run):
    ref, port = run
    r = port["bert"][0]
    losses, (m1, v1) = ref["bert_steps"]
    np.testing.assert_allclose(r["losses"], losses, rtol=1e-5)
    _close_grads(r["m1"], m1, rtol=1e-5, atol=1e-5)
    _close_grads(r["v1"], v1, rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
@pytest.mark.parametrize("fused", [False, True])
def test_llama_spec_tables_equal_the_reference(stage, fused):
    jc = jl.LlamaConfig.tiny(sharding_stage=stage, fused_weights=fused)
    pc = llama.LlamaConfig.tiny(sharding_stage=stage, fused_weights=fused)
    for mine, theirs in ((llama.param_specs(pc), jl.param_specs(jc)),
                         (llama.opt_state_specs(pc),
                          jl.opt_state_specs(jc))):
        assert {k: tuple(v) for k, v in mine.items()} == \
            {k: tuple(v) for k, v in theirs.items()}
    assert tuple(llama._act_spec(pc)) == tuple(jl._act_spec(jc))


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_bert_spec_tables_equal_the_reference(stage):
    jc = jbert.BertConfig.tiny(sharding_stage=stage)
    pc = bert.BertConfig.tiny(sharding_stage=stage)
    for mine, theirs in ((bert.param_specs(pc), jbert.param_specs(jc)),
                         (bert.opt_state_specs(pc),
                          jbert.opt_state_specs(jc))):
        assert {k: tuple(v) for k, v in mine.items()} == \
            {k: tuple(v) for k, v in theirs.items()}
