"""The port's LR schedulers, gradient clipping, regularizers and the
optimizer API around them, against the JAX package's, on the CPU.

- Every scheduler of ``optimizer/lr.py`` steps 30 times on both packages:
  ``last_lr`` and ``get_lr()`` after each step equal (Python floats on
  both sides, the same arithmetic: exact); a ``state_dict`` taken at step
  15 and loaded into a fresh scheduler continues the same sequence;
  ``ReduceOnPlateau`` on a fixed metric sequence, in both modes.
- Each clip on the same numpy gradients (fp32, atol 1e-6: the norms sum
  in another order), with ``need_clip`` False on one parameter and a bf16
  gradient (to one bf16 ulp, rtol 2^-7).
- ``L2Decay`` steps equal the float decay's and the reference's; a
  nonzero ``L1Decay`` is refused, ``L1Decay(0.0)`` decays nothing, as the
  reference's (rtol 1e-5, atol 1e-7: fp32 rounding, as in
  ``test_torch_optimizer_decay.py``).
- An optimizer with a scheduler: ``set_lr`` refused, the
  ``LR_Scheduler`` state equal to the reference's and restored.
- ``fused_train_step`` with ``CosineAnnealingDecay``, ``ClipGradByGlobalNorm``
  and ``L2Decay`` on five ``Linear`` layers (10 parameters, so Adam takes
  the flat update) over 3 steps and ``Optimizer.step`` with each clip:
  losses within 1e-5 and parameters within rtol 1e-5 / atol 1e-6 of the
  JAX package's; the learning rate each flat update received equals the
  scheduler's sequence.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.nn import clip as jclip
from paddle_tpu.ops.pallas import multi_tensor_update as jmtu
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu.optimizer import optimizer as jopt_mod
from paddle_tpu_torch import jit as tjit
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.device import set_device
from paddle_tpu_torch.models.convert import layer_state_from_numpy
from paddle_tpu_torch.nn import clip as tclip
from paddle_tpu_torch.ops.kernels import multi_tensor_update as tmtu
from paddle_tpu_torch.optimizer import lr as tlr


@pytest.fixture(autouse=True)
def cpu():
    prev = set_device("cpu")
    yield
    set_device(prev)


# name -> (constructor args, keyword args), the same on both packages
SCHEDULERS = {
    "NoamDecay": ((64, 10), dict(learning_rate=2.0)),
    "PiecewiseDecay": (([5, 12, 20], [0.1, 0.05, 0.01, 0.001]), {}),
    "NaturalExpDecay": ((0.5, 0.1), {}),
    "InverseTimeDecay": ((0.5, 0.2), {}),
    "PolynomialDecay": ((0.5, 10), dict(end_lr=0.01, power=2.0)),
    "PolynomialDecay_cycle": ((0.5, 7), dict(end_lr=0.01, cycle=True)),
    "LinearWarmup": ((0.5, 8, 0.0, 0.5), {}),
    "ExponentialDecay": ((0.5, 0.9), {}),
    "MultiStepDecay": ((0.5, [4, 9, 17]), dict(gamma=0.5)),
    "StepDecay": ((0.5, 6), dict(gamma=0.3)),
    "LambdaDecay": ((0.5, lambda e: 0.95 ** e), {}),
    "MultiplicativeDecay": ((0.5, lambda e: 0.97), {}),
    "CosineAnnealingDecay": ((0.5, 12), dict(eta_min=0.01)),
    "CosineAnnealingWarmRestarts": ((0.5, 4), dict(T_mult=2,
                                                   eta_min=0.001)),
    "LinearLR": ((0.5, 10), dict(start_factor=0.2)),
    "OneCycleLR": ((1.0, 25), {}),
    "CyclicLR": ((0.01, 0.1, 4), dict(step_size_down=6,
                                     mode="triangular2")),
    "CyclicLR_exp": ((0.01, 0.1, 5), dict(mode="exp_range",
                                         exp_gamma=0.95)),
}


def _sched(pkg, name):
    args, kw = SCHEDULERS[name]
    return getattr(pkg, name.split("_")[0])(*args, **kw)


def _warmup_after(pkg):
    """LinearWarmup into a scheduler (its state nests the inner one)."""
    return pkg.LinearWarmup(pkg.CosineAnnealingDecay(0.5, 10), 5, 0.0, 0.5)


def _sequence(s, n=30):
    out = [(s.last_epoch, s.last_lr)]
    for _ in range(n):
        s.step()
        out.append((s.last_epoch, s.last_lr))
    return out


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_scheduler_sequence(name):
    assert _sequence(_sched(tlr, name)) == _sequence(_sched(jlr, name))
    j, t = _sched(jlr, name), _sched(tlr, name)
    for _ in range(7):
        j.step()
        t.step()
    assert t.get_lr() == j.get_lr()
    j.step(3)
    t.step(3)
    assert (t.last_epoch, t.last_lr) == (j.last_epoch, j.last_lr)


@pytest.mark.parametrize("name", sorted(SCHEDULERS) + ["LinearWarmup_sched"])
def test_scheduler_state_dict_round_trip(name):
    make = ((lambda pkg: _warmup_after(pkg)) if name == "LinearWarmup_sched"
            else (lambda pkg: _sched(pkg, name)))
    j, t = make(jlr), make(tlr)
    for _ in range(15):
        j.step()
        t.step()
    js, ts = j.state_dict(), t.state_dict()
    assert ts == js
    resumed = make(tlr)
    resumed.set_state_dict(dict(ts))
    assert _sequence(resumed, 15) == _sequence(j, 15)


@pytest.mark.parametrize("mode,threshold_mode", [("min", "rel"),
                                                 ("max", "abs")])
def test_reduce_on_plateau(mode, threshold_mode):
    metrics = [1.0, 0.9, 0.95, 0.91, 0.92, 0.93, 0.5, 0.6, 0.61, 0.62,
               0.63, 0.64, 0.65, 0.4, 0.41, 0.42, 0.43, 0.44]
    seqs = []
    for pkg in (jlr, tlr):
        s = pkg.ReduceOnPlateau(0.5, mode=mode, factor=0.5, patience=2,
                                threshold=0.01,
                                threshold_mode=threshold_mode, cooldown=1,
                                min_lr=0.05)
        seq = []
        for m in metrics:
            s.step(m)
            seq.append((s.last_epoch, s.last_lr, s.best, s.num_bad,
                        s.cooldown_counter))
        s.step()  # no metric: counts the epoch only
        seq.append((s.last_epoch, s.get_lr()))
        seqs.append(seq)
    assert seqs[1] == seqs[0]
    t = tlr.ReduceOnPlateau(0.5)
    t.step(torch.tensor(2.0))
    assert t.best == 2.0


def test_warm_restarts_refuse_bad_periods():
    with pytest.raises(ValueError):
        tlr.CosineAnnealingWarmRestarts(0.5, 0)
    with pytest.raises(ValueError):
        jlr.CosineAnnealingWarmRestarts(0.5, 0)


# -- clipping ----------------------------------------------------------------

SHAPES = [(4, 8), (8,), (3, 3, 2, 4), (5,)]


def _rand(shapes, seed, scale):
    rng = np.random.RandomState(seed)
    return [(rng.randn(*s) * scale).astype(np.float32) for s in shapes]


class _P:
    """A parameter stand-in: clipping reads ``need_clip`` only."""

    def __init__(self, need_clip=True):
        self.need_clip = need_clip


CLIPS = {
    "value": lambda pkg: pkg.ClipGradByValue(0.5, min=-0.3),
    "value_sym": lambda pkg: pkg.ClipGradByValue(0.4),
    "norm": lambda pkg: pkg.ClipGradByNorm(1.0),
    "global_norm": lambda pkg: pkg.ClipGradByGlobalNorm(2.0),
    "global_norm_loose": lambda pkg: pkg.ClipGradByGlobalNorm(100.0),
}


@pytest.mark.parametrize("name", sorted(CLIPS))
def test_clip_matches_reference(name):
    grads = _rand(SHAPES, 0, 1.0)
    ps = [_P(), _P(), _P(False), _P()]
    jout = CLIPS[name](jclip)([(p, jnp.asarray(g))
                               for p, g in zip(ps, grads)] + [(_P(), None)])
    tout = CLIPS[name](tclip)([(p, torch.from_numpy(g))
                               for p, g in zip(ps, grads)] + [(_P(), None)])
    assert tout[-1][1] is None and jout[-1][1] is None
    np.testing.assert_array_equal(tout[2][1].numpy(), grads[2])
    for (_, tg), (_, jg) in zip(tout[:-1], jout[:-1]):
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=0,
                                   atol=1e-6)


@pytest.mark.parametrize("name", ["norm", "global_norm"])
def test_clip_bf16_grads(name):
    """A bf16 gradient is scaled in fp32 and cast back, as the reference's
    promotion does: within one bf16 ulp."""
    grads = _rand(SHAPES, 1, 1.0)
    jg = [jnp.asarray(g, dtype=jnp.bfloat16) for g in grads]
    tg = [torch.from_numpy(g).to(torch.bfloat16) for g in grads]
    jout = CLIPS[name](jclip)([(_P(), g) for g in jg])
    tout = CLIPS[name](tclip)([(_P(), g) for g in tg])
    for (_, a), (_, b) in zip(tout, jout):
        assert a.dtype == torch.bfloat16
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b, np.float32),
                                   rtol=2.0 ** -7, atol=1e-6)


def test_clip_reads_nothing_back():
    """The scale is a device tensor chosen by ``torch.where``: no Python
    number is made from a norm (a spy on ``Tensor.item``)."""
    grads = [torch.from_numpy(g) for g in _rand(SHAPES, 2, 1.0)]
    calls = []
    orig = torch.Tensor.item

    def spy(self):
        calls.append(self)
        return orig(self)
    torch.Tensor.item = spy
    try:
        for name in CLIPS:
            CLIPS[name](tclip)([(_P(), g) for g in grads])
    finally:
        torch.Tensor.item = orig
    assert calls == []


# -- regularizers and the optimizer API -------------------------------------

def _jax_params(seed=0):
    return [jnn.Parameter(jnp.asarray(a)) for a in _rand(SHAPES, seed, 0.1)]


def _port_params(seed=0):
    return [tnn.Parameter(torch.from_numpy(a))
            for a in _rand(SHAPES, seed, 0.1)]


def _steps(pkg, opt, params, steps=3, scale=0.01):
    for s in range(steps):
        for p, g in zip(params, _rand(SHAPES, s + 1, scale)):
            p.grad = (paddle.to_tensor(jnp.asarray(g)) if pkg == "jax"
                      else torch.from_numpy(g))
        opt.step()
        opt.clear_grad()
    return [np.asarray(p._value, np.float32) if pkg == "jax"
            else p.detach().numpy() for p in params]


@pytest.mark.parametrize("cls", ["SGD", "Momentum", "Adam"])
def test_l2_decay_equals_float_decay(cls):
    jp = _jax_params()
    jout = _steps("jax", getattr(paddle.optimizer, cls)(
        learning_rate=0.1, parameters=jp,
        weight_decay=jopt_mod.L2Decay(0.01)), jp)
    outs = []
    for wd in (topt.L2Decay(0.01), 0.01):
        tp = _port_params()
        opt = getattr(topt, cls)(learning_rate=0.1, parameters=tp,
                                 weight_decay=wd)
        assert opt._l2_coeff == 0.01
        outs.append(_steps("port", opt, tp))
    for a, b, c in zip(*outs, jout):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(a, c, rtol=1e-5, atol=1e-7)


def test_l1_decay_refused_unless_zero():
    """The reference accepts an ``L1Decay`` and decays nothing; the port
    refuses a nonzero one and takes ``L1Decay(0.0)`` as no decay."""
    jp = _jax_params()
    jo = paddle.optimizer.Adam(learning_rate=0.1, parameters=jp,
                               weight_decay=jopt_mod.L1Decay(0.5))
    assert jo._l2_coeff == 0.0
    with pytest.raises(TypeError, match="decays nothing"):
        topt.Adam(learning_rate=0.1, parameters=_port_params(),
                  weight_decay=topt.L1Decay(0.5))
    tp = _port_params()
    to = topt.Adam(learning_rate=0.1, parameters=tp,
                   weight_decay=topt.L1Decay(0.0))
    assert to._l2_coeff == 0.0
    for a, b in zip(_steps("port", to, tp), _steps("jax", jo, jp)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)


def test_optimizer_with_scheduler_state():
    j = paddle.optimizer.Momentum(learning_rate=jlr.StepDecay(0.5, 2),
                                  parameters=_jax_params())
    t = topt.Momentum(learning_rate=tlr.StepDecay(0.5, 2),
                      parameters=_port_params())
    with pytest.raises(RuntimeError, match="LRScheduler"):
        t.set_lr(0.1)
    for _ in range(5):
        j._learning_rate.step()
        t._learning_rate.step()
    assert t.get_lr() == j.get_lr()
    assert t.state_dict()["LR_Scheduler"] == j.state_dict()["LR_Scheduler"]
    fresh = topt.Momentum(learning_rate=tlr.StepDecay(0.5, 2),
                          parameters=_port_params())
    fresh.set_state_dict(t.state_dict())
    assert fresh._learning_rate.last_epoch == 5
    assert fresh.get_lr() == j.get_lr()


@pytest.mark.parametrize("kwargs", [dict(learning_rate="0.1"),
                                    dict(grad_clip=0.5),
                                    dict(weight_decay="l2")])
def test_bad_options_refused(kwargs):
    with pytest.raises(TypeError):
        topt.SGD(parameters=_port_params(), **kwargs)


@pytest.mark.parametrize("name", sorted(CLIPS))
def test_step_with_grad_clip(name):
    """``Optimizer.step`` clips before the update, as the reference's."""
    jp = _jax_params()
    jo = paddle.optimizer.Momentum(learning_rate=0.1, parameters=jp,
                                   grad_clip=CLIPS[name](jclip))
    tp = _port_params()
    to = topt.Momentum(learning_rate=0.1, parameters=tp,
                       grad_clip=CLIPS[name](tclip))
    # gradients of scale 1: every clip bites
    for a, b in zip(_steps("port", to, tp, scale=1.0),
                    _steps("jax", jo, jp, scale=1.0)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


# -- the fused step with a scheduler, a clip and L2Decay --------------------

WIDTHS = [6, 8, 8, 8, 8, 4]  # five Linear layers: 10 parameters


def _mlp(pkg):
    return pkg.Sequential(*[pkg.Linear(a, b)
                            for a, b in zip(WIDTHS[:-1], WIDTHS[1:])])


def _fused_run(pkg, state, steps=3):
    rng = np.random.RandomState(7)
    xs = [rng.randn(16, WIDTHS[0]).astype(np.float32) for _ in range(steps)]
    ys = [rng.randint(0, WIDTHS[-1], (16, 1)).astype(np.int64)
          for _ in range(steps)]
    if pkg == "jax":
        net = _mlp(jnn)
        for k, v in net.state_dict().items():
            v._inplace_set(jnp.asarray(state[k]))
        opt = paddle.optimizer.Adam(
            learning_rate=jlr.CosineAnnealingDecay(0.05, 4),
            parameters=net.parameters(),
            weight_decay=jopt_mod.L2Decay(1e-3),
            grad_clip=jclip.ClipGradByGlobalNorm(0.5))
        ce = jnn.CrossEntropyLoss()
        step = paddle.jit.fused_train_step(lambda x, y: ce(net(x), y), opt,
                                           model=net)
        losses = []
        for x, y in zip(xs, ys):
            losses.append(float(step(paddle.to_tensor(x),
                                     paddle.to_tensor(y))))
            opt._learning_rate.step()
        return losses, [np.asarray(v._value) for v in
                        net.state_dict().values()], None
    prev = set_device("cpu")
    try:
        net = _mlp(tnn)
    finally:
        set_device(prev)
    layer_state_from_numpy(net, state, device="cpu")
    opt = topt.Adam(learning_rate=tlr.CosineAnnealingDecay(0.05, 4),
                    parameters=net.parameters(),
                    weight_decay=topt.L2Decay(1e-3),
                    grad_clip=tclip.ClipGradByGlobalNorm(0.5))
    ce = tnn.CrossEntropyLoss()
    step = tjit.fused_train_step(lambda x, y: ce(net(x), y), opt, model=net)
    lrs = []
    orig = tmtu.apply_flat_update

    def spy(kind, plan, pvals, gvals, svals, hyper, lr, step_, skip=None):
        lrs.append(lr)
        return orig(kind, plan, pvals, gvals, svals, hyper, lr, step_, skip)
    tmtu.apply_flat_update = spy
    try:
        losses = []
        for x, y in zip(xs, ys):
            losses.append(step(torch.from_numpy(x),
                               torch.from_numpy(y)).item())
            opt._learning_rate.step()
    finally:
        tmtu.apply_flat_update = orig
    return losses, [v.detach().numpy() for v in
                    net.state_dict().values()], lrs


def test_fused_step_with_scheduler_clip_and_l2():
    paddle.seed(3)
    state = {k: np.asarray(v._value) for k, v in
             _mlp(jnn).state_dict().items()}
    prev = jmtu.FORCE_INTERPRET
    jmtu.FORCE_INTERPRET = True
    try:
        jl, jparams, _ = _fused_run("jax", state)
    finally:
        jmtu.FORCE_INTERPRET = prev
    tl, tparams, lrs = _fused_run("port", state)
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-5)
    for a, b in zip(tparams, jparams):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    # one flat update a step (10 fp32 params, one group), each at the
    # scheduler's rate for that step
    s = tlr.CosineAnnealingDecay(0.05, 4)
    want = []
    for _ in range(3):
        want.append(s.get_lr())
        s.step()
    assert lrs == want
    assert len(set(lrs)) == 3 and all(math.isfinite(v) for v in lrs)
