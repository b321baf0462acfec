"""The port's BERT/ERNIE MLM trainer (``paddle_tpu_torch/models/bert.py``)
against the JAX package's ``paddle_tpu/models/bert.py``, on the CPU.

The JAX model's parameters (``BertConfig.tiny``: vocab 256, H 64, 4 heads
of D 16, 2 layers, fp32) cross as numpy (``convert.bert_params_from_numpy``)
and both sides run on the same numpy batches; the JAX side is jitted. On
the CPU the JAX attention is its dense ``_xla_attention`` and the port's
the flash kernels' plain versions, so the two differ only in fp32 sum
order: logits and gradients to 1e-5, three AdamW steps to rtol 1e-4.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models import bert as jbert
from paddle_tpu_torch.models import bert, convert

TOL = dict(rtol=1e-5, atol=1e-5)


def _cfgs(**kw):
    return jbert.BertConfig.tiny(**kw), bert.BertConfig.tiny(**kw)


@functools.lru_cache(maxsize=None)
def _jax_params(seed=0):
    cfg = jbert.BertConfig.tiny()
    p = jbert.init_params(cfg, jax.random.PRNGKey(seed))
    # the biases and gains (initialized constant) moved away from 0 and 1,
    # so every term of the gradient is exercised
    rng = np.random.RandomState(seed + 1)
    out = {}
    for k, v in p.items():
        a = np.asarray(v)
        if np.all(a == a.flat[0]):
            a = a + 0.1 * rng.randn(*a.shape).astype(np.float32)
        out[k] = a
    return out


def _port_params(np_params, cfg):
    return convert.bert_params_from_numpy(np_params, cfg, device="cpu")


def _batch(cfg, B, S, seed=0):
    tokens, labels = jbert.random_mlm_batch(cfg, B, S, seed=seed)
    return np.asarray(tokens), np.asarray(labels)


def _t(a):
    return torch.from_numpy(np.array(a))


@functools.lru_cache(maxsize=None)
def _jit_forward():
    jcfg = jbert.BertConfig.tiny()
    return jax.jit(lambda p, t, tt, pm: jbert.forward(
        p, t, jcfg, token_type_ids=tt, pad_mask=pm))


def test_forward_logits_equal_jax():
    jcfg, cfg = _cfgs()
    npp = _jax_params()
    tokens, _ = _batch(jcfg, 3, 24)
    tt = np.random.RandomState(3).randint(0, 2, tokens.shape).astype(np.int32)
    want = _jit_forward()({k: jnp.asarray(v) for k, v in npp.items()},
                          jnp.asarray(tokens), jnp.asarray(tt), None)
    got = bert.forward(_port_params(npp, cfg), _t(tokens), cfg,
                       token_type_ids=_t(tt))
    assert got.shape == (3, 24, cfg.vocab_size)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def test_pad_mask_encode_equals_jax_and_blocks_padding():
    """The reference's test on the port: padding keys do not move the
    real positions' encodings; and the masked encode equals JAX's."""
    jcfg, cfg = _cfgs()
    npp = _jax_params()
    params = _port_params(npp, cfg)
    rng = np.random.RandomState(1)
    toks = rng.randint(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    other = np.concatenate([toks[:, :8], rng.randint(
        0, cfg.vocab_size, (2, 8)).astype(np.int32)], axis=1)
    pad = np.array([[True] * 8 + [False] * 8] * 2)
    e1 = bert.encode(params, _t(toks), cfg, pad_mask=_t(pad))
    e2 = bert.encode(params, _t(other), cfg, pad_mask=_t(pad))
    np.testing.assert_allclose(e1[:, :8].detach().numpy(),
                               e2[:, :8].detach().numpy(), **TOL)
    want = jax.jit(lambda p, t, m: jbert.encode(p, t, jcfg, pad_mask=m))(
        {k: jnp.asarray(v) for k, v in npp.items()}, jnp.asarray(toks),
        jnp.asarray(pad))
    np.testing.assert_allclose(e1.detach().numpy(), np.asarray(want), **TOL)


def test_loss_scores_only_the_labelled_position():
    jcfg, cfg = _cfgs()
    npp = _jax_params()
    tokens, _ = _batch(jcfg, 2, 16)
    labels = np.full_like(tokens, bert.IGNORE_INDEX)
    labels[:, 3] = tokens[:, 3]
    labels[0, 3] = bert.IGNORE_INDEX  # one scored position in the batch
    labels[1, 5] = 7
    labels[1, 3] = bert.IGNORE_INDEX
    jloss = jax.jit(lambda p, t, l: jbert.loss_fn(p, t, l, jcfg))(
        {k: jnp.asarray(v) for k, v in npp.items()}, jnp.asarray(tokens),
        jnp.asarray(labels))
    params = _port_params(npp, cfg)
    loss = bert.loss_fn(params, _t(tokens), _t(labels), cfg)
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
    logits = bert.forward(params, _t(tokens), cfg).float()[1, 5]
    want = torch.logsumexp(logits, -1) - logits[7]
    np.testing.assert_allclose(loss.item(), want.item(), **TOL)
    # every label ignored: 0, not a division by zero
    none = torch.full_like(_t(labels), bert.IGNORE_INDEX)
    assert bert.loss_fn(params, _t(tokens), none, cfg).item() == 0.0


def test_every_gradient_equals_jax_grad():
    """``embed`` takes gradient from the gather and from the tied decoder;
    every parameter's gradient against ``jax.grad(loss_fn)``."""
    jcfg, cfg = _cfgs()
    npp = _jax_params()
    tokens, labels = _batch(jcfg, 2, 32, seed=4)
    jgrads = jax.jit(jax.grad(lambda p, t, l: jbert.loss_fn(p, t, l, jcfg)))(
        {k: jnp.asarray(v) for k, v in npp.items()}, jnp.asarray(tokens),
        jnp.asarray(labels))
    params = {k: v.requires_grad_() for k, v in _port_params(npp,
                                                             cfg).items()}
    loss = bert.loss_fn(params, _t(tokens), _t(labels), cfg)
    grads = torch.autograd.grad(loss, list(params.values()))
    assert set(params) == set(jgrads)
    for k, g in zip(params, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jgrads[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    # the tied embedding's two terms are both there: the decoder's alone
    # leaves the gathered rows' gradient short
    assert np.abs(np.asarray(jgrads["embed"])[tokens[0, 1]]).max() > 1e-4


def test_three_train_steps_equal_jax():
    """At the trainer's default rate, 1e-4: AdamW divides each moment by
    its root, so an element whose gradient is a few ulps of the others'
    (the two sides sum in another order) moves by up to lr a step, which
    the parameters' atol of 1e-6 bounds only at this rate."""
    jcfg, cfg = _cfgs()
    npp = _jax_params()
    tokens, labels = _batch(jcfg, 4, 32, seed=2)
    jstep = jax.jit(functools.partial(jbert.train_step, cfg=jcfg, lr=1e-4))
    jp = {k: jnp.asarray(v) for k, v in npp.items()}
    jo = jbert.init_opt_state(jp)
    params = _port_params(npp, cfg)
    opt = bert.init_opt_state(params)
    step = bert.make_train_step(cfg, lr=1e-4, device="cpu")
    for i in range(3):
        jp, jo, jloss = jstep(jp, jo, jnp.asarray(tokens),
                              jnp.asarray(labels))
        params, opt, loss = step(params, opt, tokens.copy(), labels.copy())
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4,
                                   err_msg=f"step {i}")
    assert int(opt["step"]) == int(jo["step"]) == 3
    for k, v in params.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jp[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
        np.testing.assert_allclose(opt["m"][k].numpy(),
                                   np.asarray(jo["m"][k]), rtol=1e-4,
                                   atol=1e-7, err_msg=k)


def test_opt_state_carried_from_jax_resumes_the_trajectory():
    """A JAX step's parameters and AdamW state carried across
    (``bert_opt_state_from_numpy``): the port's next step equals JAX's."""
    jcfg, cfg = _cfgs()
    npp = _jax_params()
    tokens, labels = _batch(jcfg, 2, 16, seed=5)
    jstep = jax.jit(functools.partial(jbert.train_step, cfg=jcfg, lr=1e-3))
    jp = {k: jnp.asarray(v) for k, v in npp.items()}
    jo = jbert.init_opt_state(jp)
    jp, jo, _ = jstep(jp, jo, jnp.asarray(tokens), jnp.asarray(labels))
    params = _port_params({k: np.asarray(v) for k, v in jp.items()}, cfg)
    opt = convert.bert_opt_state_from_numpy(
        {"step": np.asarray(jo["step"]),
         "m": {k: np.asarray(v) for k, v in jo["m"].items()},
         "v": {k: np.asarray(v) for k, v in jo["v"].items()}}, cfg,
        device="cpu")
    jp, jo, jloss = jstep(jp, jo, jnp.asarray(tokens), jnp.asarray(labels))
    params, opt, loss = bert.train_step(params, opt, _t(tokens), _t(labels),
                                        cfg, lr=1e-3)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    for k, v in params.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jp[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)


def test_remat_on_and_off_equal():
    _, cfg = _cfgs()
    rcfg = bert.BertConfig.tiny(remat=True)
    npp = _jax_params()
    tokens, labels = _batch(jbert.BertConfig.tiny(), 2, 16, seed=6)
    out = []
    for c in (cfg, rcfg):
        params = {k: v.requires_grad_() for k, v in _port_params(
            npp, c).items()}
        loss = bert.loss_fn(params, _t(tokens), _t(labels), c)
        out.append((loss, torch.autograd.grad(loss, list(params.values()))))
    (l0, g0), (l1, g1) = out
    assert l0.item() == l1.item()
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)


@pytest.mark.parametrize("B,S,seed", [(2, 16, 0), (4, 32, 7), (3, 64, 11)])
def test_random_mlm_batch_equals_jax(B, S, seed):
    jcfg, cfg = _cfgs()
    jt, jl = jbert.random_mlm_batch(jcfg, B, S, seed=seed)
    t, l = bert.random_mlm_batch(cfg, B, S, seed=seed, device="cpu")
    assert t.dtype == l.dtype == torch.int32
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(l.numpy(), np.asarray(jl))
    assert (l[:, 0] != bert.IGNORE_INDEX).all()


@pytest.mark.parametrize("preset", ["tiny", "bert_base", "bert_large",
                                    "ernie_base"])
def test_presets_and_shapes_equal_jax(preset):
    jcfg = getattr(jbert.BertConfig, preset)()
    cfg = getattr(bert.BertConfig, preset)()
    for f in ("vocab_size", "hidden_size", "intermediate_size",
              "num_layers", "num_heads", "max_seq_len", "type_vocab_size",
              "ln_eps", "remat", "head_dim"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert str(cfg.dtype).split(".")[-1] == jnp.dtype(jcfg.dtype).name
    shapes = jax.eval_shape(lambda: jbert.init_params(jcfg))
    assert {k: tuple(v.shape) for k, v in shapes.items()} == \
        bert.param_shapes(cfg)
    assert bert.LAYER_KEYS == jbert.LAYER_KEYS
    assert bert.NO_DECAY_KEYS == jbert.NO_DECAY_KEYS


def test_init_params_scales_and_the_converter_checks():
    cfg = bert.BertConfig.tiny()
    p = bert.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert p["embed"].dtype == torch.float32
    assert abs(p["wqkv"].std().item() - 0.02) < 2e-3
    assert torch.equal(p["ln1_g"], torch.ones_like(p["ln1_g"]))
    assert torch.equal(p["mlm_bias"], torch.zeros_like(p["mlm_bias"]))
    npp = dict(_jax_params())
    bad = dict(npp, extra=np.zeros(3, np.float32))
    with pytest.raises(KeyError, match="BERT tree"):
        convert.bert_params_from_numpy(bad, cfg, device="cpu")
    bad = dict(npp, bo=np.zeros((3, 64), np.float32))
    with pytest.raises(ValueError, match="bo"):
        convert.bert_params_from_numpy(bad, cfg, device="cpu")
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="CUDA"):
            bert.init_params(cfg)
