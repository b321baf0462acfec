"""The port's multi-tensor optimizer update and eager optimizers against
the JAX package's, on the CPU.

The same numpy params, grads and state go through
``paddle_tpu.ops.pallas.multi_tensor_update`` (its Pallas kernels in
interpret mode: ``FORCE_INTERPRET``, restored after each use) and
``paddle_tpu_torch.ops.kernels.multi_tensor_update`` (on the CPU, the CUDA
kernel's plain version), per kind and variant; then whole optimizers
(``Momentum``, ``AdamW``, ``Lamb``, O2 ``AdamW``) for three steps.

Tolerances. Both sides round once per operation in the buffer's type, but
XLA may contract a multiply and an add into one fused operation and, in
bf16, keep a chain of operations in fp32 before it rounds: so fp32 results
to rtol 1e-5 with atol 1e-7 (a few ulps of values of magnitude 0.1), bf16
results to rtol 1.6e-2 (two bf16 ulps: a chain of two roundings in the
port may be one in XLA) with atol 1e-6. A skipped update
leaves every buffer bit-identical on both sides: compared exactly.
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.ops.pallas import multi_tensor_update as jmtu
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.ops.kernels import multi_tensor_update as tmtu
from paddle_tpu_torch.vision.models import resnet as tresnet

MIXED_SHAPES = [(3, 3, 4, 8), (3, 3, 4, 8), (1, 1, 8, 4), (8,), (8,),
                (4,), (16, 4), (5,), (4,)]  # conv + 1-D rows, n > 8
TOL = {"float32": dict(rtol=1e-5, atol=1e-7),
       "bfloat16": dict(rtol=1.6e-2, atol=1e-6)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@contextlib.contextmanager
def interpret(on=True):
    """The JAX package's flat path through its Pallas kernels (interpret
    mode), restored after."""
    prev = jmtu.FORCE_INTERPRET
    jmtu.FORCE_INTERPRET = on
    try:
        yield
    finally:
        jmtu.FORCE_INTERPRET = prev


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      np.asarray(x).astype(np.float32), np.float32)


def _close(port, ref, dtype):
    np.testing.assert_allclose(_np(port), _np(ref), **TOL[dtype])


def _rand(shapes, seed, scale, positive=False):
    rng = np.random.RandomState(seed)
    out = [(rng.randn(*s) * scale).astype(np.float32) for s in shapes]
    return [np.abs(a) for a in out] if positive else out


# ---------------------------------------------------------------------------
# FlatPlan
# ---------------------------------------------------------------------------

def _resnet50_shapes():
    from paddle_tpu_torch.device import set_device

    prev = set_device("cpu")
    try:
        model = tresnet.resnet50(num_classes=1000, data_format="NHWC")
    finally:
        set_device(prev)
    return [tuple(p.shape) for p in model.parameters()]


@pytest.mark.parametrize("shapes", [
    MIXED_SHAPES, [(16, 8), (8,), (3, 3, 2, 4)], [(129,)], [(128, 128)],
    [(), (1,), (127,), (128,), (4096, 3)], "resnet50"])
def test_flat_plan_matches_jax(shapes):
    """Rows, offsets, padded total, block rows and segment ids equal the
    JAX package's (ResNet-50: 161 tensors, 25.56 M elements)."""
    if shapes == "resnet50":
        shapes = _resnet50_shapes()
        assert len(shapes) == 161
        assert sum(int(np.prod(s)) for s in shapes) == 25_557_032
    j, t = jmtu.FlatPlan(shapes), tmtu.FlatPlan(shapes)
    assert t.rows == j.rows and t.sizes == j.sizes
    np.testing.assert_array_equal(t.row_offsets, j.row_offsets)
    assert (t.total_rows, t.block_rows, t.grid) == (
        j.total_rows, j.block_rows, j.grid)
    np.testing.assert_array_equal(t.seg_ids, j.seg_ids)


def test_pack_unpack_round_trip():
    """Packing pads each tensor's tail lanes and the tail rows with zeros;
    unpack and segment are views that give the tensors back."""
    plan = tmtu.FlatPlan(MIXED_SHAPES)
    vals = [torch.from_numpy(a) for a in _rand(MIXED_SHAPES, 0, 1.0)]
    buf = plan.pack(vals)
    assert tuple(buf.shape) == (plan.total_rows, 128)
    mask = torch.zeros(buf.numel(), dtype=torch.bool)
    for i, v in enumerate(vals):
        out = plan.unpack(buf, i)
        assert out.data_ptr() >= buf.data_ptr()  # a view into the buffer
        torch.testing.assert_close(out, v, rtol=0, atol=0)
        r0 = int(plan.row_offsets[i]) * 128
        mask[r0:r0 + v.numel()] = True
    assert not buf.reshape(-1)[~mask].any()
    segs = [plan.segment(buf, i) for i in range(len(vals))]
    torch.testing.assert_close(plan.pack(segs), buf, rtol=0, atol=0)
    assert plan.pack(vals, dtype=torch.bfloat16).dtype == torch.bfloat16


def test_fused_update_active():
    assert tmtu.fused_update_active(2, "momentum")
    assert not tmtu.fused_update_active(1, "adam")
    assert not tmtu.fused_update_active(9, "adagrad")
    assert not tmtu.fused_update_active(9, None)


# ---------------------------------------------------------------------------
# one group's update, kind by kind
# ---------------------------------------------------------------------------

ADAM = {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}
LAMB = {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-6, "decay": 0.01}
VARIANTS = {
    # name: kind, hyper, param dtype, state dtype, state keys, master
    "sgd": ("sgd", {}, "float32", None, (), False),
    "sgd_bf16": ("sgd", {}, "bfloat16", None, (), False),
    "momentum": ("momentum", {"momentum": 0.9}, "float32", "float32",
                 ("velocity",), False),
    "momentum_bf16": ("momentum", {"momentum": 0.9}, "bfloat16", "bfloat16",
                      ("velocity",), False),
    "momentum_bf16_fp32_velocity": ("momentum", {"momentum": 0.9},
                                    "bfloat16", "float32", ("velocity",),
                                    False),
    "nesterov": ("momentum", {"momentum": 0.9, "nesterov": True}, "float32",
                 "float32", ("velocity",), False),
    "nesterov_bf16": ("momentum", {"momentum": 0.9, "nesterov": True},
                      "bfloat16", "bfloat16", ("velocity",), False),
    "adam": ("adam", ADAM, "float32", "float32", ("moment1", "moment2"),
             False),
    "adamw_decoupled": ("adam", dict(ADAM, decay=0.1, decoupled=True),
                        "float32", "float32", ("moment1", "moment2"), False),
    "adamw_bf16": ("adam", dict(ADAM, decay=0.1, decoupled=True), "bfloat16",
                   "bfloat16", ("moment1", "moment2"), False),
    "adam_bf16_master": ("adam", ADAM, "bfloat16", "float32",
                         ("moment1", "moment2"), True),
    "adamw_bf16_master": ("adam", dict(ADAM, decay=0.1, decoupled=True),
                          "bfloat16", "float32", ("moment1", "moment2"),
                          True),
    "lamb": ("lamb", LAMB, "float32", "float32", ("moment1", "moment2"),
             False),
    "lamb_bf16": ("lamb", LAMB, "bfloat16", "float32",
                  ("moment1", "moment2"), False),
    "lamb_bf16_master": ("lamb", LAMB, "bfloat16", "float32",
                         ("moment1", "moment2"), True),
}


def _group(name, seed=0):
    """One variant's inputs as numpy: params, grads, states (moments
    non-negative where adam's second moment needs it)."""
    kind, hyper, pdt, sdt, keys, master = VARIANTS[name]
    P = _rand(MIXED_SHAPES, seed, 0.1)
    G = _rand(MIXED_SHAPES, seed + 1, 0.01)
    S = [{} for _ in MIXED_SHAPES]
    for k in keys:
        for st, a in zip(S, _rand(MIXED_SHAPES, seed + 2 + len(k), 0.01,
                                  positive=True)):
            st[k] = a
    if master:
        for st, p in zip(S, P):
            st["master"] = p.copy()
    return kind, hyper, pdt, sdt, P, G, S


def _both(name, skip=None, step=3, lr=0.1):
    """The variant through both packages' ``apply_flat_update``."""
    kind, hyper, pdt, sdt, P, G, S = _group(name)
    sdts = {k: sdt for k in ("velocity", "moment1", "moment2")}
    sdts["master"] = "float32"
    with interpret():
        jp, js = jmtu.apply_flat_update(
            kind, jmtu.FlatPlan(MIXED_SHAPES),
            [jnp.asarray(p).astype(JDT[pdt]) for p in P],
            [jnp.asarray(g).astype(JDT[pdt]) for g in G],
            [{k: jnp.asarray(v).astype(JDT[sdts[k]]) for k, v in s.items()}
             for s in S],
            hyper, jnp.float32(lr), jnp.float32(step),
            skip=None if skip is None else jnp.float32(skip))
    tp, ts = tmtu.apply_flat_update(
        kind, tmtu.FlatPlan(MIXED_SHAPES),
        [torch.from_numpy(p).to(TDT[pdt]) for p in P],
        [torch.from_numpy(g).to(TDT[pdt]) for g in G],
        [{k: torch.from_numpy(v).to(TDT[sdts[k]]) for k, v in s.items()}
         for s in S], hyper, lr, step, skip=skip)
    return (P, S), (jp, js), (tp, ts)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_flat_update_matches_jax(name):
    """Params (shaped) and state (flat row segments) equal the JAX
    package's kernel results within the stated tolerance."""
    pdt, sdt = VARIANTS[name][2], VARIANTS[name][3]
    _, (jp, js), (tp, ts) = _both(name)
    for a, b, shape in zip(tp, jp, MIXED_SHAPES):
        assert tuple(a.shape) == shape and a.dtype == TDT[pdt]
        _close(a, b, pdt)
    for a, b in zip(ts, js):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dim() == 2 and a[k].shape[1] == 128
            _close(a[k], b[k], "float32" if k == "master" else sdt)


@pytest.mark.parametrize("name", ["sgd", "momentum_bf16", "nesterov",
                                  "adamw_bf16_master", "lamb",
                                  "lamb_bf16_master"])
def test_skip_leaves_buffers_bit_identical(name):
    """skip = 1 (the found_inf flag, here a tensor the kernel reads)
    leaves every param and state value bit-identical, as in the JAX
    package; skip = 0 updates."""
    (P, S), (jp, js), (tp, ts) = _both(name, skip=torch.tensor(1.0))
    pdt = VARIANTS[name][2]
    for a, b, p in zip(tp, jp, P):
        ref = torch.from_numpy(p).to(TDT[pdt])
        assert torch.equal(a, ref)
        np.testing.assert_array_equal(_np(a), _np(b))
    for a, b, s in zip(ts, js, S):
        for k in a:
            np.testing.assert_array_equal(_np(a[k]), _np(b[k]))
    _, _, (tp0, _) = _both(name, skip=0.0)
    assert any(not torch.equal(a, torch.from_numpy(p).to(TDT[pdt]))
               for a, p in zip(tp0, P))


def test_plain_rounds_in_bf16():
    """The bf16 momentum rounds mu and lr to bf16 (0.9 -> 0.8984375, 0.1 ->
    0.10009765625) and every operation's result to bf16."""
    plan = tmtu.FlatPlan([(8,)])
    p = torch.full((8,), 1.0, dtype=torch.bfloat16)
    g = torch.full((8,), 0.5, dtype=torch.bfloat16)
    v = torch.full((8,), 0.25, dtype=torch.bfloat16)
    (newp,), (st,) = tmtu.apply_flat_update(
        "momentum", plan, [p], [g], [{"velocity": v}], {"momentum": 0.9},
        0.1, 1)
    mu, lr = 0.8984375, 0.10009765625
    v_ref = torch.tensor(mu * 0.25, dtype=torch.bfloat16).float() + 0.5
    v_ref = v_ref.to(torch.bfloat16)
    p_ref = (1.0 - (lr * v_ref.float()).to(torch.bfloat16).float()).to(
        torch.bfloat16)
    assert torch.equal(st["velocity"].reshape(-1)[:8],
                       v_ref.expand(8))
    assert torch.equal(newp, p_ref.expand(8))


def test_kernel_wrapper_rejects_bad_buffers():
    plan = tmtu.FlatPlan([(8,)])
    p = plan.pack([torch.zeros(8)])
    with pytest.raises(ValueError, match="state"):
        tmtu.multi_tensor_update("momentum", p, p.clone(), {}, {}, 0.1, 1)
    with pytest.raises(TypeError, match="moments"):
        tmtu.multi_tensor_update(
            "lamb", p, p.clone(), {"moment1": p.to(torch.bfloat16),
                                   "moment2": p.to(torch.bfloat16)},
            LAMB, 0.1, 1)
    with pytest.raises(ValueError, match="unknown"):
        tmtu.multi_tensor_update("adagrad", p, p.clone(), {}, {}, 0.1, 1)


# ---------------------------------------------------------------------------
# optimizers: three-step trajectories against the JAX fused path
# ---------------------------------------------------------------------------

def _jax_params(dtype, shapes=MIXED_SHAPES, seed=0):
    return [jnn.Parameter(jnp.asarray(a).astype(JDT[dtype]))
            for a in _rand(shapes, seed, 0.1)]


def _port_params(dtype, shapes=MIXED_SHAPES, seed=0):
    out = []
    for i, a in enumerate(_rand(shapes, seed, 0.1)):
        p = tnn.Parameter(torch.from_numpy(a).to(TDT[dtype]))
        p.name = f"p{i}"
        out.append(p)
    return out


def _run_jax(opt_cls, kwargs, dtype, steps=3, shapes=MIXED_SHAPES,
             o2=False):
    params = _jax_params("float32" if o2 else dtype, shapes)
    opt = opt_cls(parameters=params, **kwargs)
    if o2:
        layer = jnn.Layer()
        for i, p in enumerate(params):
            layer.add_parameter(f"p{i}", p)
        paddle.amp.decorate(models=layer, optimizers=opt, level="O2",
                            dtype="bfloat16")
    with interpret():
        for s in range(steps):
            for p, g in zip(params, _rand(shapes, s + 1, 0.01)):
                p.grad = paddle.to_tensor(
                    jnp.asarray(g).astype(p._value.dtype))
            opt.step()
            opt.clear_grad()
    return params, opt


def _run_port(opt_cls, kwargs, dtype, steps=3, shapes=MIXED_SHAPES,
              o2=False, check_flat=True):
    params = _port_params("float32" if o2 else dtype, shapes)
    opt = opt_cls(parameters=params, **kwargs)
    if o2:
        layer = tnn.Layer()
        for i, p in enumerate(params):
            layer.register_parameter(f"p{i}", p)
        tamp.decorate(models=layer, optimizers=opt, level="O2",
                      dtype="bfloat16")
    for s in range(steps):
        for p, g in zip(params, _rand(shapes, s + 1, 0.01)):
            p.grad = torch.from_numpy(g).to(p.dtype)
        opt.step()
        opt.clear_grad()
        if check_flat:  # state stays in the flat layout between steps
            for st in opt._accumulators.values():
                for v in st.values():
                    assert v.dim() == 2 and v.shape[1] == 128, v.shape
    return params, opt


TRAJECTORIES = {
    "momentum_wd": (paddle.optimizer.Momentum, topt.Momentum,
                    dict(learning_rate=0.05, momentum=0.9,
                         weight_decay=1e-4), "float32", False),
    "adamw": (paddle.optimizer.AdamW, topt.AdamW,
              dict(learning_rate=0.01, weight_decay=0.1), "float32", False),
    "lamb": (paddle.optimizer.Lamb, topt.Lamb,
             dict(learning_rate=0.01, lamb_weight_decay=0.01), "float32",
             False),
    "o2_adamw": (paddle.optimizer.AdamW, topt.AdamW,
                 dict(learning_rate=0.01, weight_decay=0.1), "bfloat16",
                 True),
    "momentum_bf16_nesterov": (paddle.optimizer.Momentum, topt.Momentum,
                               dict(learning_rate=0.05, momentum=0.9,
                                    use_nesterov=True, weight_decay=1e-4),
                               "bfloat16", False),
}


@pytest.mark.parametrize("name", list(TRAJECTORIES))
def test_trajectory_matches_jax(name):
    """Three steps on the mixed-shape population: params and state equal
    the JAX package's kernel path; an O2 AdamW keeps fp32 moments and an
    fp32 master, flat."""
    jcls, tcls, kwargs, dtype, o2 = TRAJECTORIES[name]
    jp, jopt = _run_jax(jcls, kwargs, dtype, o2=o2)
    tp, topt_ = _run_port(tcls, kwargs, dtype, o2=o2)
    for a, b in zip(tp, jp):
        assert a.dtype == TDT[dtype]
        _close(a.detach(), b.numpy(), dtype)
    for a, b in zip(tp, jp):
        ts, js = topt_._accumulators[id(a)], jopt._accumulators[id(b)]
        assert ts.keys() == js.keys()
        for k in ts:
            sdt = "float32" if ts[k].dtype == torch.float32 else "bfloat16"
            _close(ts[k], js[k], sdt)
    if o2:
        st = next(iter(topt_._accumulators.values()))
        assert st["master"].dtype == torch.float32
        assert st["moment1"].dtype == torch.float32


def test_state_dict_shaped_and_equal_to_jax():
    """state_dict exports param-shaped state equal to the JAX package's;
    a fresh optimizer restored from it continues the trajectory."""
    kwargs = dict(learning_rate=0.01)
    jp, jopt = _run_jax(paddle.optimizer.Adam, kwargs, "float32", steps=2)
    tp, topt_ = _run_port(topt.Adam, kwargs, "float32", steps=2)
    jsd, tsd = jopt.state_dict(), topt_.state_dict()
    assert tsd["@step"] == jsd["@step"] == 2
    for a, b in zip(tp, jp):
        for k in ("moment1", "moment2"):
            ts, js = tsd[f"{a.name}.{k}"], jsd[f"{b.name}.{k}"]
            assert tuple(ts.shape) == tuple(a.shape) == tuple(js.shape)
            _close(ts, js.numpy(), "float32")
    params2 = _port_params("float32")
    with torch.no_grad():
        for p2, p in zip(params2, tp):
            p2.copy_(p)
    opt2 = topt.Adam(parameters=params2, **kwargs)
    opt2.set_state_dict({k: (v.clone() if isinstance(v, torch.Tensor)
                             else v) for k, v in tsd.items()})
    for ps, o in ((tp, topt_), (params2, opt2)):
        for p, g in zip(ps, _rand(MIXED_SHAPES, 9, 0.01)):
            p.grad = torch.from_numpy(g)
        o.step()
    for a, b in zip(tp, params2):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_adamw_decay_groups_split():
    """apply_decay_param_fun splits the population into a decay and a
    no-decay group (each one flat update); with zero grads the decay
    group shrinks by lr * wd and the other stays."""
    params = _port_params("float32")
    for i, p in enumerate(params):
        p.name = f"{'w' if i % 2 == 0 else 'b'}_{i}"
    opt = topt.AdamW(learning_rate=0.1, weight_decay=0.5, parameters=params,
                     apply_decay_param_fun=lambda n: n.startswith("w"))
    before = [p.detach().clone() for p in params]
    for p in params:
        p.grad = torch.zeros_like(p)
    opt.step()
    assert len(opt._plans) == 2
    for p, b in zip(params, before):
        want = b * (1 - 0.1 * 0.5) if p.name.startswith("w") else b
        torch.testing.assert_close(p.detach(), want, rtol=1e-6, atol=0)


def test_grad_scaler_forced_overflow_skips():
    """A forced overflow leaves params and flat state untouched and halves
    the scale; the next finite step updates again (the JAX package's
    GradScaler semantics)."""
    params = _port_params("float32")
    opt = topt.Momentum(learning_rate=1.0, momentum=0.9, parameters=params)
    scaler = tamp.GradScaler(init_loss_scaling=4.0, decr_every_n_nan_or_inf=1)
    for p, g in zip(params, _rand(MIXED_SHAPES, 1, 0.01)):
        p.grad = torch.from_numpy(g)
    scaler.step(opt)
    scaler.update()
    before_p = [p.detach().clone() for p in params]
    before_v = [opt._accumulators[id(p)]["velocity"].clone() for p in params]
    for i, (p, g) in enumerate(zip(params, _rand(MIXED_SHAPES, 2, 0.01))):
        if i == 0:
            g.flat[0] = np.inf
        p.grad = torch.from_numpy(g)
    scaler.step(opt)
    scaler.update()
    for p, b in zip(params, before_p):
        assert torch.equal(p.detach(), b)
    for p, b in zip(params, before_v):
        assert torch.equal(opt._accumulators[id(p)]["velocity"], b)
    assert scaler._scale == 2.0
    for p, g in zip(params, _rand(MIXED_SHAPES, 3, 0.01)):
        p.grad = torch.from_numpy(g)
    scaler.step(opt)
    assert any(not torch.equal(p.detach(), b)
               for p, b in zip(params, before_p))


def test_small_and_singleton_groups_take_update_one(monkeypatch):
    """n <= 8 parameters, and a group of one, take ``_update_one`` (no
    flat update); results equal the JAX package's on the same split."""
    calls = []
    real = tmtu.apply_flat_update

    def spy(kind, plan, *a, **kw):
        calls.append(len(plan.shapes))
        return real(kind, plan, *a, **kw)

    monkeypatch.setattr(tmtu, "apply_flat_update", spy)
    kwargs = dict(learning_rate=0.05, momentum=0.9, weight_decay=1e-4)
    few = MIXED_SHAPES[:5]
    jp, _ = _run_jax(paddle.optimizer.Momentum, kwargs, "float32",
                     shapes=few)
    tp, topt_ = _run_port(topt.Momentum, kwargs, "float32", shapes=few,
                          check_flat=False)
    assert calls == []
    for a, b in zip(tp, jp):
        _close(a.detach(), b.numpy(), "float32")
        v = topt_._accumulators[id(a)]["velocity"]
        assert tuple(v.shape) == tuple(a.shape)  # shaped, never flat

    # nine params, one of them bf16: the fp32 eight share one flat update,
    # the bf16 one updates alone
    jps = _jax_params("float32")
    jps[3]._inplace_set(jps[3]._value.astype(jnp.bfloat16))
    tps = _port_params("float32")
    tps[3].data = tps[3].data.to(torch.bfloat16)
    jo = paddle.optimizer.Momentum(parameters=jps, **kwargs)
    to = topt.Momentum(parameters=tps, **kwargs)
    with interpret():
        for s in range(2):
            for jp_, tp_, g in zip(jps, tps, _rand(MIXED_SHAPES, s + 1,
                                                   0.01)):
                jp_.grad = paddle.to_tensor(
                    jnp.asarray(g).astype(jp_._value.dtype))
                tp_.grad = torch.from_numpy(g).to(tp_.dtype)
            jo.step()
            to.step()
    assert calls == [8, 8]
    for i, (a, b) in enumerate(zip(tps, jps)):
        _close(a.detach(), b.numpy(), "bfloat16" if i == 3 else "float32")
    assert tuple(to._accumulators[id(tps[3])]["velocity"].shape) == (8,)


@pytest.mark.parametrize("kwargs,exc", [
    (dict(grad_clip=object()), TypeError),
    (dict(learning_rate=object()), TypeError),
    (dict(weight_decay=object()), TypeError),
])
def test_unported_options_raise(kwargs, exc):
    """Gradient clipping, LR schedulers and regularizers are ported
    (``tests/test_torch_lr_clip.py``); an object that is none of them
    (not callable as a clip, not a number or ``LRScheduler``, not a float
    or ``L2Decay``) raises instead of being ignored."""
    with pytest.raises(exc):
        topt.Momentum(parameters=_port_params("float32"), **kwargs)


def _seq(pkg, state=None):
    """``Sequential(Linear(4, 3), Linear(3, 2))`` of either package, its
    weights set from ``state`` (numpy by state-dict key) when given."""
    from paddle_tpu_torch.device import set_device
    from paddle_tpu_torch.models.convert import layer_state_from_numpy

    if pkg == "jax":
        net = jnn.Sequential(jnn.Linear(4, 3), jnn.Linear(3, 2))
        if state is not None:
            for k, v in net.state_dict().items():
                v._inplace_set(jnp.asarray(state[k]))
        return net
    prev = set_device("cpu")
    try:
        net = tnn.Sequential(tnn.Linear(4, 3), tnn.Linear(3, 2))
    finally:
        set_device(prev)
    if state is not None:
        layer_state_from_numpy(net, state, device="cpu")
    return net


def _seq_steps(pkg, net, opt, seeds):
    """Momentum steps on numpy gradients, one per seed (the same in both
    packages, by parameter order)."""
    params = list(net.parameters())
    for s in seeds:
        for p, g in zip(params, _rand([tuple(p.shape) for p in params], s,
                                      0.1)):
            p.grad = (paddle.to_tensor(jnp.asarray(g)) if pkg == "jax"
                      else torch.from_numpy(g))
        opt.step()
        opt.clear_grad()


def _seq_state(net):
    return {k: _np(v._value if hasattr(v, "_value") else v.detach())
            for k, v in net.state_dict().items()}


def test_set_state_dict_resumes_a_rebuilt_model():
    """The ordinary resume: step, save the optimizer's state, rebuild the
    same model (its parameters get new process-global names), load the
    weights and the state, step on. No saved name matches, so the state
    maps by position, as in the JAX package: the continued trajectory
    equals the JAX package's over two more steps, and the port's own
    uninterrupted one."""
    kw = dict(learning_rate=0.1, momentum=0.9)
    paddle.seed(0)
    w0 = _seq_state(_seq("jax"))
    out = {}
    for pkg, Momentum in (("jax", paddle.optimizer.Momentum),
                          ("port", topt.Momentum)):
        net = _seq(pkg, w0)
        opt = Momentum(parameters=net.parameters(), **kw)
        _seq_steps(pkg, net, opt, (1, 2))
        # saved as numpy, as a checkpoint is (the JAX step donates its
        # state buffers)
        saved = {k: v if k == "@step" or isinstance(v, dict) else _np(
            v._value if hasattr(v, "_value") else v.detach())
            for k, v in opt.state_dict().items()}
        w2 = _seq_state(net)
        net2 = _seq(pkg, w2)
        names = {p.name for p in net.parameters()}
        assert not names & {p.name for p in net2.parameters()}
        opt2 = Momentum(parameters=net2.parameters(), **kw)
        opt2.set_state_dict(saved)
        _seq_steps(pkg, net2, opt2, (3, 4))
        _seq_steps(pkg, net, opt, (3, 4))
        out[pkg] = (_seq_state(net2), _seq_state(net))
    (jres, jcont), (tres, tcont) = out["jax"], out["port"]
    for k in jres:
        _close(tres[k], jres[k], "float32")
        np.testing.assert_array_equal(tres[k], tcont[k])
    assert any(not np.array_equal(tres[k], w0[k]) for k in w0)


def test_set_state_dict_loads_matching_names_only():
    """Some names match: their state loads, a name no parameter has is
    ignored and the other parameters start from zero velocity; the next
    step equals the JAX package's."""
    kw = dict(learning_rate=0.1, momentum=0.9)
    vel = _rand(MIXED_SHAPES, 7, 0.1)
    res = []
    for params, Momentum, wrap in (
            (_jax_params("float32"), paddle.optimizer.Momentum,
             jnp.asarray),
            (_port_params("float32"), topt.Momentum, torch.from_numpy)):
        opt = Momentum(parameters=params, **kw)
        opt.set_state_dict({f"{params[0].name}.velocity": wrap(vel[0]),
                            f"{params[5].name}.velocity": wrap(vel[5]),
                            "nope.velocity": wrap(vel[1]), "@step": 1})
        with interpret():
            for p, g in zip(params, _rand(MIXED_SHAPES, 8, 0.01)):
                p.grad = (torch.from_numpy(g) if wrap is torch.from_numpy
                          else paddle.to_tensor(jnp.asarray(g)))
            opt.step()
        res.append((params, opt.state_dict()))
    (jp, jsd), (tp, tsd) = res
    for i, (a, b) in enumerate(zip(tp, jp)):
        _close(a.detach(), b.numpy(), "float32")
        _close(tsd[f"{a.name}.velocity"], jsd[f"{b.name}.velocity"].numpy(),
               "float32")
    assert "nope.velocity" not in tsd and tsd["@step"] == jsd["@step"] == 2
