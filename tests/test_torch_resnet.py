"""The port's ResNet training path against the JAX package's, on the CPU.

A narrow bottleneck net, ``ResNet(BottleneckBlock, 18, width=16,
num_classes=10, data_format="NHWC")`` (89 parameters, 4.43 M elements),
built by the JAX package and carried into the port through
``layer_state_from_numpy``; one ``fused_train_step`` with
``Momentum(0.1, 0.9, weight_decay=1e-4)`` on both sides, the JAX update
through its Pallas kernel in interpret mode (``FORCE_INTERPRET``), the
port's through ``multi_tensor_update``'s plain version; and the full
``resnet50``'s structure.

Batch 8 at 32x32, numpy inputs from ``RandomState(0)``. At 32x32 the last
stage runs at 1x1, so BatchNorm there normalizes each channel over the
batch alone; at batch 2 (two values) a float32 gradient is off the float64
one by 7x (measured), so nothing can be compared there. At batch 8 the
float32 step is well defined, and the tolerances follow what float32
resolves (measured on both packages against a float64 run of the port):
- loss within 1e-4 (the packages differ by 5e-6), logits within 1e-3
  (6.6e-5 of a largest |logit| of 4.4), BN running statistics within 1e-5
  (9e-7);
- each parameter's update within 5e-2 of its norm: each package's float32
  gradient is up to 1.9e-2 (relative norm) from the float64 one through
  this random-init net's BatchNorm backward, and the two packages differ
  by at most 1.4e-2.
In bf16 (O2) the train-mode forward of the random-init net amplifies
rounding ~100x (float32 logits within 1e-5 of float64, bf16 logits 20-25 %
off at every size tried), so the O2 step is compared in eval mode, where
BatchNorm is the affine map of its running statistics: loss within 1e-4
(1.6e-5 measured), logits within 4 bf16 ulps of their largest entry (1
measured); each velocity, the bf16 gradient plus decay, within 0.25 of its
norm (0.125 measured: bf16 rounds in another order through 26 layers);
each updated parameter within two bf16 ulps (rtol 1.6e-2) plus its
largest update (an update is one to three ulps of the parameter, so its
rounding decides it).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.ops.pallas import multi_tensor_update as jmtu
from paddle_tpu.vision.models import resnet as jresnet
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import jit as tjit
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.device import set_device
from paddle_tpu_torch.models.convert import layer_state_from_numpy
from paddle_tpu_torch.vision.models import resnet as tresnet

B, S, CLASSES = 8, 32, 10
LR, MU, WD = 0.1, 0.9, 1e-4


def _narrow(pkg):
    return pkg.ResNet(pkg.BottleneckBlock, 18, width=16,
                      num_classes=CLASSES, data_format="NHWC")


@pytest.fixture
def cpu():
    prev = set_device("cpu")
    yield
    set_device(prev)


@pytest.fixture(scope="module")
def nets():
    """The JAX net, the port's net and the JAX net's initial state as
    numpy, built once; each test reloads the state into both."""
    paddle.seed(0)
    jnet = _narrow(jresnet)
    state0 = {k: np.asarray(v._value) for k, v in jnet.state_dict().items()}
    prev = set_device("cpu")
    try:
        tnet = _narrow(tresnet)
    finally:
        set_device(prev)
    return jnet, tnet, state0


@pytest.fixture(scope="module")
def batch():
    rng = np.random.RandomState(0)
    return (rng.rand(B, S, S, 3).astype(np.float32),
            rng.randint(0, CLASSES, (B,)))


def _reset(nets, train):
    jnet, tnet, state0 = nets
    for k, v in jnet.state_dict().items():  # exact values and types
        v._inplace_set(jnp.asarray(state0[k]))
    layer_state_from_numpy(tnet, state0, device="cpu")
    for net in (jnet, tnet):
        net.train() if train else net.eval()
    return jnet, tnet, state0


def _steps(nets, batch, train, o2):
    """One fused Momentum step through each package (with the logits of
    the step's forward as aux): returns ((loss, logits) JAX, the same
    port, the JAX optimizer, the port optimizer)."""
    jnet, tnet, _ = _reset(nets, train)
    kw = dict(learning_rate=LR, momentum=MU, weight_decay=WD)
    jopt = paddle.optimizer.Momentum(parameters=jnet.parameters(), **kw)
    topt_ = topt.Momentum(parameters=tnet.parameters(), **kw)
    if o2:
        paddle.amp.decorate(models=jnet, optimizers=jopt, level="O2",
                            dtype="bfloat16")
        tamp.decorate(models=tnet, optimizers=topt_, level="O2",
                      dtype="bfloat16")
    jce, tce = jnn.CrossEntropyLoss(), tnn.CrossEntropyLoss()

    def jloss(x, y):
        with paddle.amp.auto_cast(enable=o2, level="O2", dtype="bfloat16"):
            logits = jnet(x)
            return jce(logits, y), logits

    def tloss(x, y):
        with tamp.auto_cast(enable=o2, level="O2", dtype="bfloat16"):
            logits = tnet(x)
            return tce(logits, y), logits

    x, y = batch
    prev = jmtu.FORCE_INTERPRET
    jmtu.FORCE_INTERPRET = True
    try:
        jout = paddle.jit.fused_train_step(jloss, jopt, model=jnet,
                                           has_aux=True)(
            paddle.to_tensor(x), paddle.to_tensor(y))
    finally:
        jmtu.FORCE_INTERPRET = prev
    tout = tjit.fused_train_step(tloss, topt_, model=tnet, has_aux=True)(
        torch.from_numpy(x), torch.from_numpy(y))
    return ([np.asarray(t._value).astype(np.float32) for t in jout],
            [t.float().numpy() for t in tout], jopt, topt_)


def _f32(t):
    return (np.asarray(t._value) if hasattr(t, "_value")
            else t.detach().float().numpy()).astype(np.float32)


def test_converter_loads_and_checks(nets, cpu):
    """Every parameter and buffer takes the array's values and type, and
    stays the same object; bf16 stays bf16; a missing or extra key or a
    wrong shape raises."""
    _, tnet, state0 = nets
    before = {k: id(v) for k, v in tnet.state_dict().items()}
    layer_state_from_numpy(tnet, state0, device="cpu")
    sd = tnet.state_dict()
    assert list(sd) == list(state0)
    for k, v in sd.items():
        assert id(v) == before[k] and v.dtype == torch.float32
        np.testing.assert_array_equal(v.detach().numpy(), state0[k])
    bf = {k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in state0.items()}
    layer_state_from_numpy(tnet, {k: np.asarray(v) for k, v in bf.items()},
                           device="cpu")
    w = tnet.state_dict()["conv1.weight"]
    assert w.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        _f32(w), np.asarray(bf["conv1.weight"]).astype(np.float32))
    with pytest.raises(KeyError, match="missing"):
        layer_state_from_numpy(tnet, {k: v for k, v in state0.items()
                                      if k != "fc.bias"}, device="cpu")
    with pytest.raises(KeyError, match="extra"):
        layer_state_from_numpy(tnet, {**state0, "fc.scale": state0["fc.bias"]},
                               device="cpu")
    with pytest.raises(ValueError, match="shape"):
        layer_state_from_numpy(
            tnet, {**state0, "fc.bias": np.zeros(3, np.float32)},
            device="cpu")


def test_fp32_step_matches_jax(nets, batch):
    """Train mode, float32: the step's logits and loss, every updated
    parameter and every BN running statistic against JAX
    ``fused_train_step``; the port's update is one flat group, its state
    flat."""
    (jl, jlog), (tl, tlog), jopt, topt_ = _steps(nets, batch, True, False)
    jnet, tnet, state0 = nets
    assert abs(float(tl) - float(jl)) < 1e-4
    np.testing.assert_allclose(tlog, jlog, rtol=0, atol=1e-3)
    jsd, tsd = jnet.state_dict(), tnet.state_dict()
    for k in state0:
        if k.endswith(("._mean", "._variance")):
            np.testing.assert_allclose(_f32(tsd[k]), _f32(jsd[k]), rtol=0,
                                       atol=1e-5, err_msg=k)
            assert not np.array_equal(_f32(tsd[k]), state0[k])  # updated
        else:
            dj = _f32(jsd[k]) - state0[k]
            dt = _f32(tsd[k]) - state0[k]
            rel = np.linalg.norm(dt - dj) / np.linalg.norm(dj)
            assert rel < 5e-2, (k, rel)
    assert len(topt_._plans) == 1
    for p in tnet.parameters():
        v = topt_._accumulators[id(p)]["velocity"]
        assert v.dim() == 2 and v.shape[1] == 128 and v.dtype == torch.float32


def test_o2_step_matches_jax(nets, batch):
    """AMP O2 (bf16 params and velocity, fp32 BN statistics and loss), eval
    mode: the step's logits and loss, every updated parameter and every
    velocity (the bf16 gradient with its decay) against the JAX package's
    O2 step, at bf16 tolerances."""
    (jl, jlog), (tl, tlog), jopt, topt_ = _steps(nets, batch, False, True)
    jnet, tnet, state0 = nets
    assert abs(float(tl) - float(jl)) < 1e-4
    scale = float(np.abs(jlog).max())
    np.testing.assert_allclose(tlog, jlog, rtol=0, atol=4 * 2.0 ** -8 * scale)
    jsd, tsd = jnet.state_dict(), tnet.state_dict()
    for k in state0:
        t, j = tsd[k], _f32(jsd[k])
        if k.endswith(("._mean", "._variance")):
            assert t.dtype == torch.float32
            np.testing.assert_array_equal(_f32(t), state0[k])  # eval
            continue
        assert t.dtype == torch.bfloat16
        p0 = np.asarray(jnp.asarray(state0[k]).astype(jnp.bfloat16),
                        np.float32)
        np.testing.assert_allclose(_f32(t), j, rtol=1.6e-2,
                                   atol=float(np.abs(j - p0).max()),
                                   err_msg=k)
    for jp, tp in zip(jnet.parameters(), tnet.parameters()):
        vj = _f32(jopt._accumulators[id(jp)]["velocity"])
        vt = topt_._accumulators[id(tp)]["velocity"]
        assert vt.dtype == torch.bfloat16 and vt.dim() == 2
        rel = np.linalg.norm(_f32(vt) - vj) / np.linalg.norm(vj)
        assert rel < 0.25, (tp.name, rel)


def test_o2_train_mode_types(nets, batch, cpu):
    """O2 in train mode: bf16 parameters, logits and velocity; fp32 loss
    and BN running statistics, which the step updates."""
    _, tnet, state0 = _reset(nets, True)
    opt = topt.Momentum(learning_rate=LR, momentum=MU, weight_decay=WD,
                        parameters=tnet.parameters())
    tamp.decorate(models=tnet, optimizers=opt, level="O2", dtype="bfloat16")
    ce = tnn.CrossEntropyLoss()

    def loss_fn(x, y):
        with tamp.auto_cast(level="O2", dtype="bfloat16"):
            logits = tnet(x)
            return ce(logits, y), logits

    x, y = batch
    loss, logits = tjit.fused_train_step(loss_fn, opt, has_aux=True)(
        torch.from_numpy(x), torch.from_numpy(y))
    assert loss.dtype == torch.float32 and torch.isfinite(loss)
    assert logits.dtype == torch.bfloat16
    assert opt._step_count == 1
    sd = tnet.state_dict()
    assert sd["bn1._mean"].dtype == torch.float32
    assert not np.array_equal(sd["bn1._mean"].numpy(), state0["bn1._mean"])
    assert all(p.dtype == torch.bfloat16 for p in tnet.parameters())
    vels = [opt._accumulators[id(p)]["velocity"] for p in tnet.parameters()]
    assert all(v.dtype == torch.bfloat16 and v.dim() == 2 for v in vels)


def test_resnet50_structure_matches_jax(cpu):
    """The full resnet50 (NHWC): state_dict keys in order, shapes, and
    parameters() order equal the JAX model's (no forward)."""
    jnet = jresnet.resnet50(num_classes=1000, data_format="NHWC")
    tnet = tresnet.resnet50(num_classes=1000, data_format="NHWC")
    jsd, tsd = jnet.state_dict(), tnet.state_dict()
    assert list(tsd) == list(jsd)
    for k in jsd:
        assert tuple(tsd[k].shape) == tuple(jsd[k].shape), k
    assert [n for n, _ in tnet.named_parameters()] == [
        n for n, _ in jnet.named_parameters()]
    assert [tuple(p.shape) for p in tnet.parameters()] == [
        tuple(p.shape) for p in jnet.parameters()]
    assert len(tnet.parameters()) == 161
    assert sum(p.numel() for p in tnet.parameters()) == 25_557_032
    assert all(b.dtype == torch.float32 for b in tnet.buffers())


def _amp_case(pkg_F, to_t, name):
    """One functional op on fixed numpy inputs (fp32, except bf16 logits
    and bf16 BN input with a bf16 weight, as O2 hands them over)."""
    rng = np.random.RandomState(3)
    a = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    bf = jnp.bfloat16
    cases = {
        "conv2d": lambda: pkg_F.conv2d(
            to_t(a(2, 5, 5, 3)), to_t(a(4, 3, 3, 3)), padding=1,
            data_format="NHWC"),
        "linear": lambda: pkg_F.linear(to_t(a(2, 3)), to_t(a(3, 4)),
                                      to_t(a(4))),
        "relu": lambda: pkg_F.relu(to_t(a(2, 3))),
        "max_pool2d": lambda: pkg_F.max_pool2d(to_t(a(2, 5, 5, 3)), 3, 2, 1,
                                              data_format="NHWC"),
        "adaptive_avg_pool2d": lambda: pkg_F.adaptive_avg_pool2d(
            to_t(a(2, 4, 4, 3)), 1, data_format="NHWC"),
        "cross_entropy": lambda: pkg_F.cross_entropy(
            to_t(a(4, 5), bf), to_t(np.array([0, 3, 1, 4]))),
        "batch_norm": lambda: pkg_F.batch_norm(
            to_t(a(2, 3, 3, 4), bf), to_t(np.zeros(4, np.float32)),
            to_t(np.ones(4, np.float32)), to_t(1 + a(4), bf), to_t(a(4)),
            training=True, data_format="NHWC"),
    }
    return cases[name]()


@pytest.mark.parametrize("level", [None, "O1", "O2"])
@pytest.mark.parametrize("name", ["conv2d", "linear", "relu", "max_pool2d",
                                  "adaptive_avg_pool2d", "cross_entropy",
                                  "batch_norm"])
def test_amp_casts_match_jax(name, level):
    """Each ported functional op under ``auto_cast`` (off, O1, O2) gives
    the JAX package's output type and values: white-listed ops in bf16
    under O1, every op but the black and mixed-I/O lists under O2,
    cross_entropy upcast to fp32, batch_norm bf16 out of bf16 in. Values
    to fp32 rounding (1e-5) or, in bf16, two ulps."""
    from paddle_tpu.nn import functional as jF
    from paddle_tpu_torch.nn import functional as tF

    def jt(x, dt=None):
        return paddle.to_tensor(jnp.asarray(x) if dt is None
                                else jnp.asarray(x).astype(dt))

    def tt(x, dt=None):
        t = torch.from_numpy(np.asarray(x))
        return t if dt is None else t.to(torch.bfloat16)

    with paddle.amp.auto_cast(enable=level is not None, level=level or "O1"):
        j = _amp_case(jF, jt, name)
    with tamp.auto_cast(enable=level is not None, level=level or "O1"):
        t = _amp_case(tF, tt, name)
    jv = np.asarray(j._value)
    assert str(t.dtype).split(".")[-1] == str(jv.dtype)
    tol = (dict(rtol=1.6e-2, atol=1.6e-2) if t.dtype == torch.bfloat16
           else dict(rtol=1e-5, atol=1e-5))
    np.testing.assert_allclose(_f32(t), jv.astype(np.float32), **tol)
