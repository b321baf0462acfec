"""The port's QAT / PTQ (``paddle_tpu_torch.quantization``) against the JAX
package's, on the CPU.

- ``fake_quant``: values and the straight-through gradient equal the
  reference's bit for bit (the same fp32 operations in the same order),
  at 8 and 4 bits, per-tensor and per-channel scales, values on the clip
  edge included.
- A QAT step: LeNet, and a narrow ``TransformerEncoder`` with a
  ``Linear`` head, carried from the JAX layers by
  ``layer_state_from_numpy``, quantized with ``FakeQuanterWithAbsMax``
  on activations and weights, trained by SGD on the same batches: each
  step's loss, the quanters' scales and the parameters within 1e-5.
  (The quanters round ``x / s * 127``: an input within fp32 rounding of
  a rounding boundary could take the next code in one package, a
  difference of one quantization step that no tolerance here would
  pass; these cases meet none.)
- PTQ: ``AbsmaxObserver`` and ``MovingAverageAbsmaxObserver`` calibrated
  over 4 batches give the reference's scales (rtol 1e-6); ``convert``
  gives the same int8 weights and per-column scales bit for bit, the
  activation scale and the bias; each ``Int8Linear`` then equals the
  reference's on the same input.
- ``Int8Linear`` through ``torch._int_mm``: exact against int32 numpy, at
  shapes of multiples of 16 (no padding) and at others (padded with
  zeros to what the card's cuBLASLt takes), 2-D and 3-D.
- ``state_dict`` keys (the quanters' sublayer names under
  ``QuantedLinear``, ``weight_i8`` / ``w_scales`` under ``Int8Linear``)
  equal the reference's; the reference's own cases
  (``tests/test_quantization.py``) run on the port.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.quantization as JQ
import paddle_tpu_torch as port
import paddle_tpu_torch.quantization as TQ
from paddle_tpu import nn as jnn
from paddle_tpu.vision.models import LeNet as JLeNet
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.device import set_device
from paddle_tpu_torch.models.convert import layer_state_from_numpy
from paddle_tpu_torch.vision.models import LeNet as TLeNet

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def cpu():
    prev = set_device("cpu")
    yield
    set_device(prev)


def _np(seed, *shape, scale=1.0):
    return np.asarray(np.random.RandomState(seed).randn(*shape) * scale,
                      np.float32)


def _carry(jmodel, tmodel):
    layer_state_from_numpy(tmodel, {k: np.asarray(v.numpy()) for k, v in
                                    jmodel.state_dict().items()},
                           device="cpu")
    return tmodel


def _cfg(Q, act=None, weight=None):
    act = Q.FakeQuanterWithAbsMax if act is None else act
    return Q.QuantConfig(activation=Q.quanter(act),
                         weight=None if weight is False else Q.quanter(
                             weight or Q.FakeQuanterWithAbsMax))


# ---------------------------------------------------------------------------
# fake_quant
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("scale", [1.0, 0.37, 2.5, "per_channel"])
def test_fake_quant_equal(bits, scale):
    x = _np(1, 6, 5, scale=1.2)
    x[0, :3] = [1.0, -1.0, 0.37]  # on the clip edge of some scales
    s = (np.abs(_np(2, 1, 5)) + 0.3 if scale == "per_channel"
         else scale)
    jx = paddle.to_tensor(x, stop_gradient=False)
    jy = JQ.fake_quant(jx, paddle.to_tensor(s) if scale == "per_channel"
                       else s, bits)
    w = _np(3, 6, 5)
    (jy * paddle.to_tensor(w)).sum().backward()
    tx = torch.from_numpy(x).requires_grad_()
    ty = TQ.fake_quant(tx, torch.from_numpy(s) if scale == "per_channel"
                       else s, bits)
    (ty * torch.from_numpy(w)).sum().backward()
    np.testing.assert_array_equal(ty.detach().numpy(), jy.numpy())
    np.testing.assert_array_equal(tx.grad.numpy(), jx.grad.numpy())


def test_fake_quant_values_and_ste():
    """``test_quantization.py::test_fake_quant_values_and_ste`` on the
    port."""
    x = torch.tensor([-2.0, -0.5, 0.0, 0.3, 1.7], requires_grad=True)
    y = TQ.fake_quant(x, scale=1.0, bits=8)
    got = y.detach().numpy()
    assert abs(got[0] + 1.0) < 1e-6 and abs(got[4] - 1.0) < 1e-6
    np.testing.assert_allclose(got[3], round(0.3 * 127) / 127, rtol=1e-6)
    y.sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), [0.0, 1.0, 1.0, 1.0, 0.0],
                               atol=1e-6)


# ---------------------------------------------------------------------------
# QAT against the reference
# ---------------------------------------------------------------------------

def _qat_run(Q, model, batches, loss_fn, steps, opt_cls):
    model = Q.QAT(_cfg(Q)).quantize(model)
    opt = opt_cls(learning_rate=0.05, parameters=model.parameters())
    losses, scales = [], []
    for x, y in batches[:steps]:
        loss = loss_fn(model, x, y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.detach() if isinstance(loss, torch.Tensor)
                            else loss))
        scales.append([m.scales() for m in _quanters(model)])
    return model, losses, scales


def _sublayers(model):
    """(name, layer) below ``model``, in the JAX ``named_sublayers``
    order (a port layer is a ``torch.nn.Module``)."""
    if isinstance(model, torch.nn.Module):
        return list(model.named_modules())[1:]
    return list(model.named_sublayers())


def _quanters(model):
    return [m for _, m in _sublayers(model)
            if isinstance(m, (JQ.BaseQuanter, TQ.BaseQuanter))]


class _Encoder:
    """A narrow ``TransformerEncoder`` (2 layers, width 16, 2 heads, no
    dropout) with a ``Linear`` head, built on either package."""

    @staticmethod
    def build(nn):
        layer = nn.TransformerEncoderLayer(16, 2, 32, dropout=0.0)
        return nn.Sequential(nn.TransformerEncoder(layer, 2),
                             nn.Linear(16, 5))


def _lenet_batches(n=3, B=4):
    return [(_np(40 + i, B, 1, 28, 28),
             np.random.RandomState(50 + i).randint(0, 10, (B,)).astype(
                 np.int64)) for i in range(n)]


def _encoder_batches(n=3, B=2, S=6):
    return [(_np(60 + i, B, S, 16), _np(70 + i, B, S, 5))
            for i in range(n)]


def _jax_ce(model, x, y):
    return paddle.nn.functional.cross_entropy(
        model(paddle.to_tensor(x)), paddle.to_tensor(y))


def _port_ce(model, x, y):
    return port.nn.functional.cross_entropy(
        model(torch.from_numpy(x)), torch.from_numpy(y))


def _jax_mse(model, x, y):
    return ((model(paddle.to_tensor(x)) - paddle.to_tensor(y)) ** 2).mean()


def _port_mse(model, x, y):
    return ((model(torch.from_numpy(x)) - torch.from_numpy(y)) ** 2).mean()


QAT_MODELS = {
    "lenet": (lambda: JLeNet(), lambda: TLeNet(), _lenet_batches, _jax_ce,
              _port_ce),
    "encoder": (lambda: _Encoder.build(jnn), lambda: _Encoder.build(tnn),
                _encoder_batches, _jax_mse, _port_mse),
}


@pytest.mark.parametrize("name", sorted(QAT_MODELS))
def test_qat_steps_match(name):
    jbuild, tbuild, batches, jloss, tloss = QAT_MODELS[name]
    paddle.seed(0)
    jm = jbuild()
    tm = _carry(jm, tbuild())
    data = batches()
    jq, jl, js = _qat_run(JQ, jm, data, jloss, 2, paddle.optimizer.SGD)
    tq, tl, ts = _qat_run(TQ, tm, data, tloss, 2, port.optimizer.SGD)
    np.testing.assert_allclose(tl, jl, **TOL)
    np.testing.assert_allclose(np.asarray(ts), np.asarray(js), rtol=1e-5)
    jstate = {k: np.asarray(v.numpy()) for k, v in jq.state_dict().items()}
    tstate = {k: v.detach().numpy() for k, v in tq.state_dict().items()}
    assert list(tstate) == list(jstate)
    for k in jstate:
        np.testing.assert_allclose(tstate[k], jstate[k], err_msg=k, **TOL)


@pytest.mark.parametrize("name", sorted(QAT_MODELS))
def test_quantized_keys_and_sublayers(name):
    jbuild, tbuild, batches, _, _ = QAT_MODELS[name]
    paddle.seed(0)
    jm = JQ.QAT(_cfg(JQ)).quantize(jbuild())
    tm = TQ.QAT(_cfg(TQ)).quantize(tbuild())
    assert list(tm.state_dict()) == list(jm.state_dict())
    assert [n for n, _ in _sublayers(tm)] == [n for n, _ in _sublayers(jm)]
    x = batches()[0][0]
    jm(paddle.to_tensor(x))
    tm(torch.from_numpy(x))
    jc, tc = JQ.QAT(None).convert(jm), TQ.QAT(None).convert(tm)
    assert list(tc.state_dict()) == list(jc.state_dict())
    assert [n for n, _ in _sublayers(tc)] == [n for n, _ in _sublayers(jc)]
    ints = [m for m in tc.modules() if isinstance(m, TQ.Int8Linear)]
    assert ints and all(m.weight_i8.dtype == torch.int8
                        and m.w_scales.dtype == torch.float32
                        for m in ints)
    n_linear = 3 if name == "lenet" else 2 * 6 + 1
    assert len(ints) == n_linear


# ---------------------------------------------------------------------------
# PTQ against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("observer", ["AbsmaxObserver",
                                      "MovingAverageAbsmaxObserver"])
def test_ptq_calibrate_and_convert(observer):
    paddle.seed(1)
    jm = _Encoder.build(jnn)
    tm = _carry(jm, _Encoder.build(tnn))
    cfg_j = _cfg(JQ, act=getattr(JQ, observer), weight=False)
    cfg_t = _cfg(TQ, act=getattr(TQ, observer), weight=False)
    jm = JQ.PTQ(cfg_j).quantize(jm)
    tm = TQ.PTQ(cfg_t).quantize(tm)
    calib = [b[0] for b in _encoder_batches(4)]
    for x in calib:
        jm(paddle.to_tensor(x))
        tm(torch.from_numpy(x))
    js = [m.scales() for _, m in jm.named_sublayers()
          if isinstance(m, JQ.BaseObserver)]
    ts = [m.scales() for m in tm.modules() if isinstance(m, TQ.BaseObserver)]
    assert len(ts) == len(js) == 13
    np.testing.assert_allclose(ts, js, rtol=1e-6)
    jc = JQ.PTQ(cfg_j).convert(jm)
    tc = TQ.PTQ(cfg_t).convert(tm)
    jl = [m for _, m in jc.named_sublayers() if isinstance(m, JQ.Int8Linear)]
    tl = [m for m in tc.modules() if isinstance(m, TQ.Int8Linear)]
    assert len(jl) == len(tl) == 13
    x = _np(80, 5, 16)
    for j, t in zip(jl, tl):
        np.testing.assert_array_equal(t.weight_i8.numpy(),
                                      np.asarray(j.weight_i8.numpy()))
        np.testing.assert_array_equal(t.w_scales.numpy(),
                                      np.asarray(j.w_scales.numpy()))
        np.testing.assert_allclose(t.act_scale, j.act_scale, rtol=1e-6)
        np.testing.assert_array_equal(t.bias.detach().numpy(),
                                      np.asarray(j.bias.numpy()))
        # the same scale on both sides: the same codes, the same output
        t.act_scale = j.act_scale
        xi = x[:, :t.weight_i8.shape[0]] if t.weight_i8.shape[0] <= 16 \
            else _np(81, 5, t.weight_i8.shape[0])
        np.testing.assert_allclose(
            t(torch.from_numpy(xi)).detach().numpy(),
            j(paddle.to_tensor(xi)).numpy(), rtol=1e-6, atol=1e-6)


def test_ptq_calibrate_convert_parity():
    """``test_quantization.py::test_ptq_calibrate_convert_parity`` on the
    port."""
    port.seed(0)
    model = _mlp(tnn)
    cfg = TQ.QuantConfig(activation=TQ.quanter(
        TQ.MovingAverageAbsmaxObserver), weight=None)
    ptq = TQ.PTQ(cfg)
    model = ptq.quantize(model)
    rng = np.random.RandomState(1)
    calib = [torch.from_numpy(rng.randn(32, 8).astype(np.float32))
             for _ in range(4)]
    ref_out = [model(x).detach().numpy() for x in calib]
    assert model.fc1.activation_quanter.scales() is not None
    model = ptq.convert(model)
    assert isinstance(model.fc1, TQ.Int8Linear)
    got = model(calib[0]).detach().numpy()
    err = np.abs(got - ref_out[0]).mean() / (np.abs(ref_out[0]).mean()
                                             + 1e-9)
    assert err < 0.05, err


def test_convert_zero_scale_and_inplace():
    """An activation scale of 0 or ``None`` converts to 1.0;
    ``inplace=False`` leaves the quantized model as it was."""
    port.seed(0)
    model = TQ.PTQ(TQ.QuantConfig(activation=TQ.quanter(TQ.AbsmaxObserver))
                   ).quantize(_mlp(tnn))
    model.fc1.activation_quanter._scale = 0.0   # never observed: None
    conv = TQ.PTQ(None).convert(model, inplace=False)
    assert isinstance(model.fc1, TQ.QuantedLinear)
    assert conv.fc1.act_scale == 1.0 and conv.fc2.act_scale == 1.0


# ---------------------------------------------------------------------------
# Int8Linear and torch._int_mm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("M,K,N,padded", [
    (32, 16, 32, False),   # multiples of 16: no padding
    (64, 48, 16, False),
    (17, 8, 8, True),      # inside _int_mm's checks, padded to 16s
    (5, 8, 4, True),       # LeNet's fc3 at a small batch: M, N
    (16, 120, 84, True),   # LeNet's fc2: M, N (84)
    (40, 7, 3, True),      # K and N
    (1, 30, 30522 % 64, True)])
def test_int8_linear_exact(M, K, N, padded, monkeypatch):
    rng = np.random.RandomState(M * 1000 + K)
    w = rng.randn(K, N).astype(np.float32)
    w_scales = np.abs(w).max(axis=0)
    wi8 = np.round(w / w_scales * 127).astype(np.int8)
    bias = torch.from_numpy(rng.randn(N).astype(np.float32))
    x = np.clip(rng.randn(M, K).astype(np.float32), -2, 2)
    shapes = []
    real = torch._int_mm

    def spy(a, b):
        shapes.append((tuple(a.shape), tuple(b.shape)))
        return real(a, b)
    monkeypatch.setattr(torch, "_int_mm", spy)
    lin = TQ.Int8Linear(wi8, w_scales, act_scale=2.0, bias=bias)
    got = lin(torch.from_numpy(x)).detach().numpy()
    (a_shape, b_shape), = shapes
    assert (a_shape != (M, K) or b_shape != (K, N)) == padded
    assert a_shape[0] >= 32 and a_shape[1] % 16 == 0 and b_shape[1] % 16 == 0
    xi8 = np.clip(np.round(x / np.float32(2.0) * np.float32(127)), -127,
                  127).astype(np.int32)
    acc = xi8 @ wi8.astype(np.int32)
    want = acc.astype(np.float32) * (w_scales * np.float32(2.0)
                                     / np.float32(127 * 127)) + bias.numpy()
    np.testing.assert_array_equal(got, want.astype(np.float32))
    jlin = JQ.Int8Linear(wi8, w_scales, 2.0, bias=paddle.to_tensor(
        bias.numpy()))
    np.testing.assert_array_equal(got, jlin(paddle.to_tensor(x)).numpy())


def test_int8_linear_3d_input():
    rng = np.random.RandomState(7)
    w = rng.randn(16, 8).astype(np.float32)
    w_scales = np.abs(w).max(axis=0)
    wi8 = np.round(w / w_scales * 127).astype(np.int8)
    x = rng.randn(2, 3, 16).astype(np.float32)
    got = TQ.Int8Linear(wi8, w_scales, 1.5)(torch.from_numpy(x))
    want = JQ.Int8Linear(wi8, w_scales, 1.5)(paddle.to_tensor(x))
    assert tuple(got.shape) == (2, 3, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want.numpy()))


def test_int8_linear_rescale_follows_w_scales():
    """The rescale vector kept between calls equals the one computed anew
    after ``w_scales`` changes: in place (``set_state_dict``), as a new
    tensor, or on a copy."""
    rng = np.random.RandomState(11)
    w = rng.randn(24, 8).astype(np.float32)
    w_scales = np.abs(w).max(axis=0)
    wi8 = np.round(w / w_scales * 127).astype(np.int8)
    x = torch.from_numpy(rng.randn(5, 24).astype(np.float32))
    lin = TQ.Int8Linear(wi8, w_scales, 1.5)
    lin(x)
    for other in (w_scales * 2, w_scales / 3):
        lin.set_state_dict({"w_scales": other})
        want = TQ.Int8Linear(wi8, other, 1.5)(x)
        assert torch.equal(lin(x), want)
    lin.w_scales = torch.from_numpy(w_scales.copy())
    want = TQ.Int8Linear(wi8, w_scales, 1.5)(x)
    assert torch.equal(lin(x), want)
    assert torch.equal(copy.deepcopy(lin)(x), want)


def test_int8_linear_matmul_correctness():
    """``test_quantization.py::test_int8_linear_matmul_correctness`` on the
    port."""
    rng = np.random.RandomState(2)
    w = rng.randn(8, 4).astype(np.float32)
    w_scales = np.abs(w).max(axis=0)
    wi8 = np.round(w / w_scales * 127).astype(np.int8)
    lin = TQ.Int8Linear(wi8, w_scales, act_scale=2.0)
    x = np.clip(rng.randn(5, 8).astype(np.float32), -2, 2)
    got = lin(torch.from_numpy(x)).numpy()
    xi8 = np.round(x / 2.0 * 127).astype(np.int32)
    want = (xi8 @ wi8.astype(np.int32)) * (w_scales * 2.0 / (127 * 127))
    np.testing.assert_allclose(got, want.astype(np.float32), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# the reference's other cases, on the port
# ---------------------------------------------------------------------------

def _mlp(nn):
    class MLP(nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc1 = nn.Linear(8, 16)
            self.relu = nn.ReLU()
            self.fc2 = nn.Linear(16, 4)

        def forward(self, x):
            return self.fc2(self.relu(self.fc1(x)))
    return MLP()


def test_qat_quantize_and_train():
    port.seed(0)
    model = TQ.QAT(_cfg(TQ)).quantize(_mlp(tnn))
    assert isinstance(model.fc1, TQ.QuantedLinear)
    assert isinstance(model.fc2, TQ.QuantedLinear)
    opt = port.optimizer.SGD(learning_rate=0.1,
                             parameters=model.parameters())
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(16, 8).astype(np.float32))
    target = torch.from_numpy(rng.randn(16, 4).astype(np.float32))
    losses = []
    for _ in range(10):
        loss = ((model(x) - target) ** 2).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(loss.item())
    assert losses[-1] < losses[0], losses


def test_type_and_name_config():
    cfg = TQ.QuantConfig()
    cfg.add_type_config(tnn.Linear,
                        weight=TQ.quanter(TQ.FakeQuanterWithAbsMax))
    model = TQ.QAT(cfg).quantize(_mlp(tnn))
    assert isinstance(model.fc1, TQ.QuantedLinear)
    assert model.fc1.activation_quanter is None
    assert model.fc1.weight_quanter is not None
    # a name config matches the child's attribute name, not a dotted path
    cfg = TQ.QuantConfig()
    cfg.add_name_config("fc2", activation=TQ.quanter(TQ.AbsmaxObserver))
    cfg.add_name_config("net.fc1", activation=TQ.quanter(TQ.AbsmaxObserver))
    outer = tnn.Sequential(_mlp(tnn))
    TQ.PTQ(cfg).quantize(outer)
    inner = outer[0]
    assert isinstance(inner.fc2, TQ.QuantedLinear)
    assert not isinstance(inner.fc1, TQ.QuantedLinear)


def test_names():
    assert TQ.__all__ == JQ.__all__ and len(TQ.__all__) == 12
    assert TQ.MovingAverageAbsmaxQuanter is TQ.FakeQuanterWithAbsMax
    assert hasattr(copy.deepcopy(TQ.FakeQuanterWithAbsMax()), "forward")
    assert jnp is not None


def test_qat_bert_driver_on_cpu():
    """``chip_smoke.py`` phase 6f(c)'s driver on a two-layer encoder of
    width 16: every ``Linear`` wrapped, the QAT steps, ``convert``, the
    int8 forward against the same model on the CPU (equal here), PTQ."""
    from paddle_tpu_torch.experiments import vision_quant

    def build():
        port.seed(0)
        layer = tnn.TransformerEncoderLayer(16, 2, 32, dropout=0.1,
                                            activation="gelu",
                                            attn_dropout=0.0)
        model = tnn.Sequential(tnn.Embedding(100, 16),
                               tnn.TransformerEncoder(layer, 2),
                               tnn.Linear(16, 100))
        return model, port.optimizer.AdamW(
            learning_rate=1e-4, parameters=model.parameters(),
            weight_decay=0.01)
    rng = np.random.RandomState(0)
    tokens = torch.from_numpy(rng.randint(0, 100, (4, 32)))
    labels = torch.from_numpy(np.where(rng.rand(4, 32) < 0.15,
                                       rng.randint(0, 100, (4, 32)), -100))
    report, _ = vision_quant.qat_bert(build, tokens, labels, layers=2)
    assert report["quanted_linears"] == 13
    against = report["int8_against_cpu"]
    assert against["logit_max_abs_err"] == 0.0
    assert against["products"] == 13 and against["pinned_logits_equal"]
    assert sum(against["pinned_flips"]) == sum(against["free_flips"]) == 0
    assert report["ptq"]["top1_agreement"] > 0.5
    assert all(np.isfinite(report["losses"]))
