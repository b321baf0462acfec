"""The port's eager transformer stack (``nn`` layers, ``nn.functional``'s
attention, dropout, norms and ``flash_attention`` module) against the JAX
package's, on the CPU.

Each layer is built on both packages, the JAX layer's ``state_dict()``
carried across as numpy (``models.convert.layer_state_from_numpy``: the
keys must match), and both run on the same numpy inputs at d_model 32,
4 heads of D 8, 2 layers, fp32, dropout 0. Outputs and every parameter's
gradient after ``backward()`` of ``sum(out * w)`` (w fixed, random) agree
to 1e-5: the JAX side attends with its dense ``_xla_attention``, the port
with the flash kernels' plain versions (unmasked) or the same dense path
(masked), so the two differ in fp32 sum order only.

Dropout cannot draw ``jax.random``'s bits, so it is held by its
statistics and by where it sits (on the probabilities when p > 0).
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional.flash_attention as jfl
import paddle_tpu_torch as port
from paddle_tpu_torch.device import set_device
from paddle_tpu_torch.models.convert import layer_state_from_numpy
from paddle_tpu_torch.nn import functional as F
import paddle_tpu_torch.nn.functional.flash_attention as tfl
from paddle_tpu_torch.ops.kernels import flash_attention as fa

TOL = dict(rtol=1e-5, atol=1e-5)
B, S, E, NH, FF = 2, 8, 32, 4, 64
SM = 10  # the decoder's memory length: cross attention has Sq != Sk


@pytest.fixture(autouse=True)
def cpu():
    prev = set_device("cpu")
    yield
    set_device(prev)


def _np(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _carry(jlayer, tlayer):
    """The JAX layer's weights into the port's layer (keys must match)."""
    state = {k: np.asarray(v.numpy()) for k, v in jlayer.state_dict().items()}
    return layer_state_from_numpy(tlayer, state, device="cpu")


def _jax_run(layer, inputs, w_seed=99, **kw):
    """Output, parameter grads (by state-dict key) and input grads of
    ``sum(layer(*inputs) * w)`` on the JAX package."""
    xs = [paddle.to_tensor(a, stop_gradient=False) for a in inputs]
    out = layer(*xs, **kw)
    first = out[0] if isinstance(out, tuple) else out
    w = paddle.to_tensor(_np(w_seed, *first.shape))
    (first * w).sum().backward()
    grads = {k: p.grad.numpy() for k, p in layer.state_dict().items()}
    return out, grads, [x.grad.numpy() for x in xs]


def _port_run(layer, inputs, w_seed=99, **kw):
    xs = [torch.from_numpy(a.copy()).requires_grad_() for a in inputs]
    out = layer(*xs, **kw)
    first = out[0] if isinstance(out, tuple) else out
    w = torch.from_numpy(_np(w_seed, *first.shape))
    (first * w).sum().backward()
    grads = {k: p.grad.numpy() for k, p in layer.named_parameters()}
    return out, grads, [x.grad.numpy() for x in xs]


def _same(jres, tres):
    (jo, jg, jx), (to, tg, tx) = jres, tres
    jfirst = jo[0] if isinstance(jo, tuple) else jo
    tfirst = to[0] if isinstance(to, tuple) else to
    np.testing.assert_allclose(tfirst.detach().numpy(), jfirst.numpy(),
                               **TOL)
    assert set(tg) == set(jg)
    for k in jg:
        np.testing.assert_allclose(tg[k], jg[k], err_msg=k, **TOL)
    for a, b in zip(tx, jx):
        np.testing.assert_allclose(a, b, **TOL)


# ---------------------------------------------------------------------------
# MultiHeadAttention
# ---------------------------------------------------------------------------

def _masks():
    keep = np.ones((B, 1, 1, S), bool)
    keep[0, :, :, 5:] = False
    keep[1, :, :, 2] = False
    additive = (_np(7, S, S) * 0.5).astype(np.float32)
    additive[:, 6] = -1e9
    return {"none": None, "bool": keep, "additive": additive}


@pytest.mark.parametrize("mask", ["none", "bool", "additive"])
def test_multi_head_attention_equals_jax(mask):
    jm = paddle.nn.MultiHeadAttention(E, NH)
    tm = _carry(jm, port.nn.MultiHeadAttention(E, NH))
    m = _masks()[mask]
    x, kv = _np(1, B, S, E), _np(2, B, S, E)
    jkw = {} if m is None else {"attn_mask": paddle.to_tensor(m)}
    tkw = {} if m is None else {"attn_mask": torch.from_numpy(m)}
    _same(_jax_run(jm, [x, kv, kv], **jkw), _port_run(tm, [x, kv, kv], **tkw))


def test_multi_head_attention_cache_equals_jax():
    """``cache`` (k, v) goes before the new keys: 3 queries over 3 + 7
    keys, unmasked (the flash path, Sq < Sk, not causal)."""
    jm = paddle.nn.MultiHeadAttention(E, NH)
    tm = _carry(jm, port.nn.MultiHeadAttention(E, NH))
    x = _np(3, B, 3, E)
    ck, cv = _np(4, B, 7, NH, E // NH), _np(5, B, 7, NH, E // NH)
    jout, jcache = jm(paddle.to_tensor(x), cache=(paddle.to_tensor(ck),
                                                  paddle.to_tensor(cv)))
    tout, tcache = tm(torch.from_numpy(x), cache=(torch.from_numpy(ck),
                                                  torch.from_numpy(cv)))
    np.testing.assert_allclose(tout.detach().numpy(), jout.numpy(), **TOL)
    for a, b in zip(tcache, jcache):
        assert tuple(a.shape) == (B, 10, NH, E // NH)
        np.testing.assert_allclose(a.detach().numpy(), b.numpy(), **TOL)


def test_unmasked_attention_runs_the_flash_entry(monkeypatch):
    """No mask, no dropout: the flash autograd Function (the kernels on a
    card); a mask: the dense path, no flash launch."""
    calls = []
    real = fa._FlashAttention.apply
    monkeypatch.setattr(fa._FlashAttention, "apply",
                        lambda *a: calls.append(a[0].dtype) or real(*a))
    tm = port.nn.MultiHeadAttention(E, NH)
    x = torch.from_numpy(_np(1, B, S, E))
    tm(x)
    assert calls == [torch.float32]
    tm(x, attn_mask=torch.from_numpy(_masks()["bool"]))
    assert len(calls) == 1
    with port.amp.auto_cast(dtype="bfloat16"):
        out = tm(x)
    assert calls == [torch.float32, torch.bfloat16]
    assert out.dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# encoder, decoder, Transformer
# ---------------------------------------------------------------------------

LN_ACT = [(False, "relu"), (False, "gelu"), (True, "relu"), (True, "gelu")]


@pytest.mark.parametrize("normalize_before,activation", LN_ACT)
def test_encoder_equals_jax(normalize_before, activation):
    kw = dict(dropout=0.0, activation=activation,
              normalize_before=normalize_before)
    jl = paddle.nn.TransformerEncoder(
        paddle.nn.TransformerEncoderLayer(E, NH, FF, **kw), 2,
        paddle.nn.LayerNorm(E) if normalize_before else None)
    tl = port.nn.TransformerEncoder(
        port.nn.TransformerEncoderLayer(E, NH, FF, **kw), 2,
        port.nn.LayerNorm(E) if normalize_before else None)
    assert list(tl.state_dict()) == list(jl.state_dict())
    _carry(jl, tl)
    _same(_jax_run(jl, [_np(1, B, S, E)]), _port_run(tl, [_np(1, B, S, E)]))


@pytest.mark.parametrize("normalize_before,activation", LN_ACT)
def test_decoder_equals_jax(normalize_before, activation):
    kw = dict(dropout=0.0, activation=activation,
              normalize_before=normalize_before)
    jl = paddle.nn.TransformerDecoder(
        paddle.nn.TransformerDecoderLayer(E, NH, FF, **kw), 2)
    tl = _carry(jl, port.nn.TransformerDecoder(
        port.nn.TransformerDecoderLayer(E, NH, FF, **kw), 2))
    ins = [_np(1, B, S, E), _np(2, B, SM, E)]
    _same(_jax_run(jl, ins), _port_run(tl, ins))


def test_transformer_with_square_mask_equals_jax():
    kw = dict(d_model=E, nhead=NH, num_encoder_layers=2,
              num_decoder_layers=2, dim_feedforward=FF, dropout=0.0)
    jl = paddle.nn.Transformer(**kw)
    tl = _carry(jl, port.nn.Transformer(**kw))
    jmask = paddle.nn.Transformer.generate_square_subsequent_mask(S)
    tmask = port.nn.Transformer.generate_square_subsequent_mask(S)
    assert tmask.dtype == torch.float32
    np.testing.assert_array_equal(tmask.numpy(), jmask.numpy())
    ins = [_np(1, B, SM, E), _np(2, B, S, E)]
    _same(_jax_run(jl, ins, tgt_mask=jmask),
          _port_run(tl, ins, tgt_mask=tmask))


def test_deepcopied_layers_are_fresh_and_keep_names():
    layer = port.nn.TransformerEncoderLayer(E, NH, FF)
    enc = port.nn.TransformerEncoder(layer, 3)
    assert enc.layers[0] is layer
    a = enc.layers[1].self_attn.q_proj.weight
    b = enc.layers[2].self_attn.q_proj.weight
    assert a is not b and a.data_ptr() != b.data_ptr()
    assert a.name == b.name == layer.self_attn.q_proj.weight.name
    assert "layers.2.self_attn.q_proj.weight" in enc.state_dict()
    assert len(enc.parameters()) == 3 * len(layer.parameters())


# ---------------------------------------------------------------------------
# nn.functional.flash_attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_return_softmax_equals_jax(causal):
    q, k, v = (_np(i, B, S, NH, 16) for i in (1, 2, 3))
    jout, jsm = jfl.flash_attention(*map(paddle.to_tensor, (q, k, v)),
                                    causal=causal, return_softmax=True)
    tout, tsm = tfl.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                    causal=causal, return_softmax=True)
    np.testing.assert_allclose(tout.numpy(), jout.numpy(), **TOL)
    assert tuple(tsm.shape) == (B, NH, S, S)
    np.testing.assert_allclose(tsm.numpy(), jsm.numpy(), **TOL)
    assert tfl.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v))[1] is None


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attn_unpadded_equals_jax(causal):
    """Three packed segments (query lengths 5, 7, 4 over key lengths 6, 7,
    4) with an explicit scale."""
    cq, ck = np.array([0, 5, 12, 16]), np.array([0, 6, 13, 17])
    q, k, v = _np(1, 16, NH, 16), _np(2, 17, NH, 16), _np(3, 17, NH, 16)
    jout, _ = jfl.flash_attn_unpadded(
        *map(paddle.to_tensor, (q, k, v)), cq.astype(np.int32),
        ck.astype(np.int32), 7, 7, 0.3, causal=causal)
    tout, none = tfl.flash_attn_unpadded(
        *map(torch.from_numpy, (q, k, v)),
        torch.from_numpy(cq.astype(np.int32)), ck.astype(np.int32), 7, 7,
        0.3, causal=causal)
    assert none is None and tuple(tout.shape) == (16, NH, 16)
    np.testing.assert_allclose(tout.numpy(), jout.numpy(), **TOL)


@pytest.mark.parametrize("cq,ck,match", [
    ([0, 5, 16], [0, 6, 13, 17], "disagree on batch"),
    ([0, 5, 15], [0, 6, 17], "must cover the packed tokens"),
    ([1, 5, 16], [0, 6, 17], "cu_seqlens_q must start at 0"),
    ([0, 9, 5, 16], [0, 6, 7, 17], "non-decreasing"),
])
def test_flash_attn_unpadded_errors_equal_jax(cq, ck, match):
    q, k = _np(1, 16, NH, 16), _np(2, 17, NH, 16)
    with pytest.raises(ValueError, match=match) as jerr:
        jfl.flash_attn_unpadded(paddle.to_tensor(q), paddle.to_tensor(k),
                                paddle.to_tensor(k), np.array(cq),
                                np.array(ck), 8, 8, 0.25)
    with pytest.raises(ValueError, match=match) as terr:
        tfl.flash_attn_unpadded(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(k), np.array(cq),
                                np.array(ck), 8, 8, 0.25)
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(NotImplementedError, match="ragged"):
        tfl.flash_attn_unpadded(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(k), np.array(cq),
                                np.array(ck), 8, 8, 0.25,
                                return_softmax=True)


# ---------------------------------------------------------------------------
# the layers under them
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [[E], [S, E]])
def test_layer_norm_equals_jax(shape):
    """The population variance (``jnp.var``), not torch's unbiased one."""
    jl = paddle.nn.LayerNorm(shape, epsilon=1e-5)
    tl = port.nn.LayerNorm(shape, epsilon=1e-5)
    state = {"weight": _np(5, *shape), "bias": _np(6, *shape)}
    jl.set_state_dict(state)
    layer_state_from_numpy(tl, state, device="cpu")
    x = _np(1, B, S, E) * 3 + 1
    _same(_jax_run(jl, [x]), _port_run(tl, [x]))
    assert port.nn.LayerNorm(E, weight_attr=False).weight is None


def test_embedding_padding_row_equals_jax():
    jl = paddle.nn.Embedding(20, E, padding_idx=2)
    tl = port.nn.Embedding(20, E, padding_idx=2)
    assert not tl.weight[2].any()
    _carry(jl, tl)
    ids = np.array([[1, 2, 5, 2], [19, 0, 2, 7]], np.int64)
    jout = jl(paddle.to_tensor(ids))
    tout = tl(torch.from_numpy(ids))
    np.testing.assert_allclose(tout.detach().numpy(), jout.numpy(), **TOL)
    assert not tout[ids == 2].any()
    w = _np(9, *tout.shape)
    (jout * paddle.to_tensor(w)).sum().backward()
    (tout * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(tl.weight.grad.numpy(),
                               jl.weight.grad.numpy(), **TOL)
    assert not tl.weight.grad[2].any() and tl.weight.grad[5].any()


def test_gelu_softmax_and_sequence_mask_equal_jax():
    x = _np(1, B, S, E) * 2
    jx, tx = paddle.to_tensor(x), torch.from_numpy(x)
    for approx in (False, True):
        np.testing.assert_allclose(
            port.nn.GELU(approx)(tx).numpy(),
            paddle.nn.GELU(approx)(jx).numpy(), **TOL)
    np.testing.assert_allclose(port.nn.Softmax(axis=1)(tx).numpy(),
                               paddle.nn.Softmax(axis=1)(jx).numpy(), **TOL)
    lengths = np.array([[3, 0], [8, 5]], np.int64)
    jm = paddle.nn.functional.sequence_mask(paddle.to_tensor(lengths),
                                            maxlen=6, dtype="float32")
    tm = F.sequence_mask(torch.from_numpy(lengths), maxlen=6,
                         dtype="float32")
    np.testing.assert_array_equal(tm.numpy(), jm.numpy())
    tm = F.sequence_mask(torch.from_numpy(lengths))
    assert tm.dtype == torch.int64 and tm.shape == (2, 2, 8)


def test_layer_list_equals_jax_keys():
    jl = paddle.nn.LayerList([paddle.nn.Linear(4, 4) for _ in range(2)])
    tl = port.nn.LayerList([port.nn.Linear(4, 4) for _ in range(2)])
    jl.append(paddle.nn.Linear(4, 2))
    tl.append(port.nn.Linear(4, 2))
    jl.insert(1, paddle.nn.Linear(4, 3))
    tl.insert(1, port.nn.Linear(4, 3))
    tl.extend([port.nn.Linear(2, 2)])
    jl.extend([paddle.nn.Linear(2, 2)])
    assert list(tl.state_dict()) == list(jl.state_dict())
    assert len(tl) == 5 and tl[-1] is list(tl)[4]
    assert tl[1].weight.shape == (4, 3)
    assert [m.weight.shape[1] for m in tl[1:3]] == [3, 4]
    _carry(jl, tl)


def test_dropout_statistics():
    """Kept share within 3 sigma of 1 - p, kept values scaled by 1 / (1 -
    p) (``upscale_in_train``) or left (``downscale_in_infer``), the input
    unchanged outside training, masks along ``axis``, one seed one
    mask."""
    n, p = 200_000, 0.3
    x = torch.ones(n)
    y = F.dropout(x, p)
    kept = (y != 0).float().mean().item()
    assert abs(kept - (1 - p)) < 3 * (p * (1 - p) / n) ** 0.5
    assert torch.allclose(y[y != 0], torch.tensor(1 / (1 - p)))
    z = F.dropout(x, p, mode="downscale_in_infer")
    assert set(z.unique().tolist()) == {0.0, 1.0}
    for mode in ("upscale_in_train", "downscale_in_infer"):
        assert F.dropout(x, p, training=False, mode=mode) is x
    assert not F.dropout(x, 1.0).any()
    a = F.dropout(torch.ones(4, 50, 3), 0.5, axis=1)
    assert (a == a[:1, :, :1]).all()  # one draw per position of axis 1
    port.seed(5)
    m1 = F.dropout(x, p)
    port.seed(5)
    assert torch.equal(m1, F.dropout(x, p))
    layer = port.nn.Dropout(p)
    assert (layer(x) == 0).any()
    layer.eval()
    assert layer(x) is x


def test_attention_dropout_sits_on_the_probabilities(monkeypatch):
    """p > 0 while training: the dense probabilities, dropped, times v
    (no flash entry); the same seed gives the same output. Outside
    training: the flash path."""
    q, k, v = (torch.from_numpy(_np(i, B, S, NH, 16)) for i in (1, 2, 3))
    flash = []
    real = fa._FlashAttention.apply
    monkeypatch.setattr(fa._FlashAttention, "apply",
                        lambda *a: flash.append(1) or real(*a))
    port.seed(11)
    out = F.scaled_dot_product_attention(q, k, v, dropout_p=0.5)
    port.seed(11)
    probs = F.dropout(fa.attention_probs(q, k), 0.5)
    assert torch.equal(out, fa.attention_apply(probs, v))
    assert flash == []
    again = F.scaled_dot_product_attention(q, k, v, dropout_p=0.5,
                                           training=False)
    assert flash == [1]
    torch.testing.assert_close(again, F.scaled_dot_product_attention(q, k, v))


def test_amp_casts_follow_the_lists():
    """Under ``auto_cast``: SDPA and the projections in bf16 (white list),
    ``layer_norm`` and ``softmax`` in fp32 (black list)."""
    x = torch.from_numpy(_np(1, B, S, E))
    enc = port.nn.TransformerEncoderLayer(E, NH, FF, dropout=0.0)
    with port.amp.auto_cast(dtype="bfloat16"):
        out = enc(x)
        assert F.layer_norm(x.bfloat16(), [E]).dtype == torch.float32
        assert F.softmax(x.bfloat16()).dtype == torch.float32
        assert F.scaled_dot_product_attention(
            *(torch.from_numpy(_np(i, B, S, NH, 16)) for i in (1, 2, 3))
        ).dtype == torch.bfloat16
    assert out.dtype == torch.float32  # the post-LN output
