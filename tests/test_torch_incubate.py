"""The port's ``incubate.nn`` (the fused entry points PaddleNLP's ERNIE
code calls, and their layers) against the JAX package's, on the CPU.

Each function runs on both packages on the same numpy inputs (fp32, B 2,
S 8, H 32, 4 heads of D 8, dropout rates 0); its output and the gradient
of ``sum(out * w)`` with respect to every input agree to rtol 1e-5 and an
atol of 1e-5 of the largest magnitude of the reference tensor (at least
1e-5): fp32 sums in another order, whose error scales with the terms
summed (the qkv weight's gradient reaches ~7 and cancels to ~1e-2). The layers carry the JAX layer's ``state_dict()``
across (``layer_state_from_numpy``) and compare every parameter's
gradient.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.incubate.nn as jinc
import paddle_tpu.incubate.nn.functional as jIF
import paddle_tpu_torch as port
import paddle_tpu_torch.incubate.nn.functional as IF
from paddle_tpu_torch.device import set_device
from paddle_tpu_torch.models.convert import layer_state_from_numpy

B, S, H, NH = 2, 8, 32, 4
D = H // NH


@pytest.fixture(autouse=True)
def cpu():
    prev = set_device("cpu")
    yield
    set_device(prev)


def _np(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _close(got, want, err_msg=""):
    atol = 1e-5 * max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol,
                               err_msg=err_msg)


def _grad(t):
    """A tensor's gradient as numpy; zeros where it took none (an unused
    LayerNorm of a post-LN block: None on both packages)."""
    g = t.grad
    if g is None:
        return np.zeros(tuple(t.shape), np.float32)
    return g.numpy()


def _both(jfn, tfn, arrays, consts=()):
    """``jfn`` / ``tfn`` on the arrays as differentiable tensors of each
    package (``consts`` as tensors without gradient): outputs and every
    array's gradient of ``sum(out * w)`` (over each output) equal."""
    jx = [paddle.to_tensor(a, stop_gradient=False) for a in arrays]
    tx = [torch.from_numpy(a.copy()).requires_grad_() for a in arrays]
    jc = [paddle.to_tensor(c) for c in consts]
    tc = [torch.from_numpy(c.copy()) for c in consts]
    jo, to = jfn(*jx, *jc), tfn(*tx, *tc)
    jo = [o for o in (jo if isinstance(jo, tuple) else (jo,)) if o is not None]
    to = [o for o in (to if isinstance(to, tuple) else (to,)) if o is not None]
    assert len(jo) == len(to)
    jloss = tloss = 0.0
    for i, (a, b) in enumerate(zip(jo, to)):
        _close(b.detach().numpy(), a.numpy())
        w = _np(50 + i, *b.shape)
        jloss = jloss + (a * paddle.to_tensor(w)).sum()
        tloss = tloss + (b * torch.from_numpy(w)).sum()
    jloss.backward()
    tloss.backward()
    for i, (a, b) in enumerate(zip(jx, tx)):
        assert (a.grad is None) == (b.grad is None), f"input {i}"
        _close(_grad(b), _grad(a), f"input {i}")


@pytest.mark.parametrize("transpose", [False, True])
def test_fused_linear(transpose):
    w = _np(2, *((16, H) if transpose else (H, 16)))
    _both(lambda x, w, b: jIF.fused_linear(x, w, b, transpose),
          lambda x, w, b: IF.fused_linear(x, w, b, transpose),
          [_np(1, B, S, H), w, _np(3, 16)])


@pytest.mark.parametrize("bias", [False, True])
def test_fused_rms_norm(bias):
    arrays = [_np(1, B, S, H), 1 + _np(2, H, scale=0.1)]
    if bias:
        arrays.append(_np(3, H))
    _both(lambda *a: jIF.fused_rms_norm(*a, epsilon=1e-6),
          lambda *a: IF.fused_rms_norm(*a, epsilon=1e-6), arrays)


def test_fused_layer_norm():
    _both(lambda x, g, b: jIF.fused_layer_norm(x, g, b, 1e-5),
          lambda x, g, b: IF.fused_layer_norm(x, g, b, 1e-5),
          [_np(1, B, S, H, scale=2), _np(2, H), _np(3, H)])


ROPE_CASES = [  # neox, tables given, position ids
    (True, False, None), (False, False, None), (True, False, "1d"),
    (False, False, "2d"), (True, True, None), (False, True, "2d")]


@pytest.mark.parametrize("neox,tables,pos", ROPE_CASES)
def test_fused_rotary_position_embedding(neox, tables, pos):
    q, k = _np(1, B, S, NH, 16), _np(2, B, S, NH, 16)
    pid = {None: None,
           "1d": np.array([3, 1, 4, 1, 5, 9, 2, 6], np.int64),
           "2d": np.random.RandomState(4).randint(0, 12, (B, S))}[pos]
    sin = cos = None
    if tables:
        ang = np.outer(np.arange(12 if pos else S), np.linspace(0.1, 1, 8))
        sin, cos = (np.sin(ang).astype(np.float32),
                    np.cos(ang).astype(np.float32))

    def run(fn, T, q, k):
        kw = dict(use_neox_rotary_style=neox)
        if pid is not None:
            kw["position_ids"] = T(pid)
        if tables:
            kw["sin"], kw["cos"] = T(sin), T(cos)
        return fn(q, k, **kw)

    _both(lambda q, k: run(jIF.fused_rotary_position_embedding,
                           paddle.to_tensor, q, k)[:2],
          lambda q, k: run(IF.fused_rotary_position_embedding,
                           torch.from_numpy, q, k)[:2], [q, k])


@pytest.mark.parametrize("pre_ln,activation", [(False, "relu"),
                                                (True, "gelu")])
def test_fused_feedforward(pre_ln, activation):
    arrays = [_np(1, B, S, H), _np(2, H, 64, scale=0.2),
              _np(3, 64, H, scale=0.2), _np(4, 64), _np(5, H), _np(6, H),
              _np(7, H), _np(8, H), _np(9, H)]

    def call(fn):
        return lambda x, w1, w2, b1, b2, g1, c1, g2, c2: fn(
            x, w1, w2, b1, b2, g1, c1, g2, c2, dropout1_rate=0.0,
            dropout2_rate=0.0, activation=activation, pre_layer_norm=pre_ln)
    _both(call(jIF.fused_feedforward), call(IF.fused_feedforward), arrays)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention(causal):
    arrays = [_np(i, B, S, NH, 16) for i in (1, 2, 3)]
    _both(lambda q, k, v: jIF.flash_attention(q, k, v, causal=causal)[0],
          lambda q, k, v: IF.flash_attention(q, k, v, causal=causal)[0],
          arrays)
    t = [torch.from_numpy(a) for a in arrays]
    assert IF.flash_attention(*t, return_softmax=True)[1] is None


@pytest.mark.parametrize("pre_ln,mask", [(False, False), (True, False),
                                          (False, True), (True, True)])
def test_fused_multi_head_attention(pre_ln, mask):
    """The qkv weight in the reference's ``[3, heads, head_dim, H]``
    layout; a 2-D additive mask is broadcast to 4 axes."""
    arrays = [_np(1, B, S, H), _np(2, 3, NH, D, H, scale=0.2),
              _np(3, H, H, scale=0.2), _np(4, H), _np(5, H), _np(6, H),
              _np(7, H), _np(8, 3, NH, D), _np(9, H)]
    consts = ()
    if mask:
        m = _np(10, S, S, scale=0.5)
        m[:, 3] = -1e9
        consts = (m,)

    def call(fn):
        def f(x, qkv, lw, g0, b0, g1, b1, qb, lb, *m):
            return fn(x, qkv, lw, pre_layer_norm=pre_ln, pre_ln_scale=g0,
                      pre_ln_bias=b0, ln_scale=g1, ln_bias=b1, qkv_bias=qb,
                      linear_bias=lb, attn_mask=m[0] if m else None,
                      dropout_rate=0.0, attn_dropout_rate=0.0)
        return f
    _both(call(jIF.fused_multi_head_attention),
          call(IF.fused_multi_head_attention), arrays, consts)


def test_swiglu_and_memory_efficient_attention():
    _both(jIF.swiglu, IF.swiglu, [_np(1, B, S, H), _np(2, B, S, H)])
    _both(jIF.swiglu, IF.swiglu, [_np(3, B, S, H)])
    with pytest.raises(ValueError, match="even"):
        IF.swiglu(torch.zeros(2, 3))
    arrays = [_np(i, B, S, NH, 16) for i in (4, 5, 6)]
    _both(lambda q, k, v: jinc.memory_efficient_attention(q, k, v,
                                                          scale=0.2),
          lambda q, k, v: port.incubate.nn.memory_efficient_attention(
              q, k, v, scale=0.2), arrays)


def _layers():
    return [
        (lambda m: m.FusedLinear(H, 16), lambda m: m.FusedLinear(H, 16)),
        (lambda m: m.FusedLinear(H, 16, transpose_weight=True), None),
        (lambda m: m.FusedFeedForward(H, 64, dropout_rate=0.0,
                                      activation="gelu"), None),
        (lambda m: m.FusedFeedForward(H, 64, dropout_rate=0.0,
                                      normalize_before=True), None),
        (lambda m: m.FusedMultiHeadAttention(H, NH, dropout_rate=0.0,
                                             attn_dropout_rate=0.0), None),
        (lambda m: m.FusedMultiHeadAttention(
            H, NH, dropout_rate=0.0, attn_dropout_rate=0.0,
            normalize_before=True), None),
        (lambda m: m.FusedTransformerEncoderLayer(H, NH, 64,
                                                  dropout_rate=0.0), None),
    ]


@pytest.mark.parametrize("index", range(7))
def test_fused_layers(index):
    build = _layers()[index][0]
    jl, tl = build(jinc), build(port.incubate.nn)
    state = {k: np.asarray(v.numpy()) for k, v in jl.state_dict().items()}
    # the gains and biases moved from their constant init
    for i, (k, v) in enumerate(sorted(state.items())):
        if np.all(v == v.flat[0]):
            state[k] = v + _np(20 + i, *v.shape, scale=0.1)
    jl.set_state_dict(state)
    layer_state_from_numpy(tl, state, device="cpu")
    x = _np(1, B, S, H)
    jx = paddle.to_tensor(x, stop_gradient=False)
    tx = torch.from_numpy(x.copy()).requires_grad_()
    jo, to = jl(jx), tl(tx)
    _close(to.detach().numpy(), jo.numpy())
    w = _np(30, *to.shape)
    (jo * paddle.to_tensor(w)).sum().backward()
    (to * torch.from_numpy(w)).sum().backward()
    _close(tx.grad.numpy(), jx.grad.numpy())
    jp, tp = jl.state_dict(), dict(tl.named_parameters())
    assert set(tp) == set(jp)
    for k in jp:
        assert (jp[k].grad is None) == (tp[k].grad is None), k
    jg = {k: _grad(p) for k, p in jp.items()}
    tg = {k: _grad(p) for k, p in tp.items()}
    for k in jg:
        _close(tg[k], jg[k], k)
