"""The port's other optimizers, ``LBFGS``, ``nn.utils``, ``Layer``'s
hooks and the slice's names against the JAX package's, on the CPU.

Each of ``Adagrad``, ``Adadelta``, ``RMSProp`` (plain and centered with
momentum), ``ASGD``, ``Rprop``, ``Lion``, ``Adamax``, ``NAdam`` and
``RAdam`` steps the same numpy parameters and gradients on both packages
three times (RAdam also eight times at ``beta2`` 0.9, past the step where
its rectification switches on), on ten parameters, one of which has no
gradient: more than 8, so an ``adam`` flat kind inherited by ``Adamax``,
``NAdam`` or ``RAdam`` would take the Adam kernel's arithmetic (a spy shows
no flat update runs). Parameters agree to rtol 1e-6 (atol 1e-7 for values
near 0); each optimizer's ``state_dict`` holds the reference's state keys
in its order and resumes an interrupted run exactly. ``LBFGS`` runs both
ways (no line search, ``"strong_wolfe"``) on Rosenbrock's function. Then
``nn.utils`` (the weight and spectral norms' outputs and gradients, the
clips, the parameter vector), the forward hooks, and a name diff over the
ported modules' ASTs.
"""

import ast
from pathlib import Path
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.ops.pallas import multi_tensor_update as jmtu
import paddle_tpu_torch as port
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.device import set_device
from paddle_tpu_torch.models.convert import layer_state_from_numpy
from paddle_tpu_torch.ops.kernels import multi_tensor_update as tmtu

ROOT = Path(__file__).resolve().parents[1]
SHAPES = [(4, 8), (8,), (3, 3, 2, 4), (5,), (2, 6), (6,), (3, 4), (4,),
          (7,), (2, 2)]
NO_GRAD = 3  # the parameter whose gradient stays None
TOL = dict(rtol=1e-6, atol=1e-7)

OPTS = {
    "Adagrad": dict(learning_rate=0.05, initial_accumulator_value=0.1,
                    weight_decay=0.01),
    "Adadelta": dict(learning_rate=0.5, rho=0.9),
    "RMSProp": dict(learning_rate=0.01),
    "RMSProp_centered_momentum": dict(learning_rate=0.01, centered=True,
                                      momentum=0.9),
    "ASGD": dict(learning_rate=0.05, batch_num=2),
    "Rprop": dict(learning_rate=0.01, etas=(0.4, 1.3)),
    "Lion": dict(learning_rate=0.01, weight_decay=0.1),
    "Adamax": dict(learning_rate=0.01),
    "NAdam": dict(learning_rate=0.01),
    "RAdam": dict(learning_rate=0.01),
    "RAdam_rectified": dict(learning_rate=0.01, beta2=0.9),
}
STEPS = {"RAdam_rectified": 8}


@pytest.fixture(autouse=True)
def cpu():
    prev = set_device("cpu")
    yield
    set_device(prev)


def _rand(seed, scale):
    rng = np.random.RandomState(seed)
    return [(rng.randn(*s) * scale).astype(np.float32) for s in SHAPES]


def _grads(step):
    """Step ``step``'s gradients: a sign flip on odd steps for half of each
    tensor (Rprop's shrink), None for ``NO_GRAD``."""
    gs = _rand(step + 1, 0.01)
    if step % 2:
        gs = [np.where(np.arange(g.size).reshape(g.shape) % 2, -g, g)
              for g in gs]
    return [None if i == NO_GRAD else g for i, g in enumerate(gs)]


def _cls(case):
    return case.split("_")[0]


def _jax_run(case, steps):
    params = [jnn.Parameter(jnp.asarray(a)) for a in _rand(0, 0.1)]
    opt = getattr(paddle.optimizer, _cls(case))(parameters=params,
                                                **OPTS[case])
    prev = jmtu.FORCE_INTERPRET
    jmtu.FORCE_INTERPRET = True
    try:
        for s in range(steps):
            for p, g in zip(params, _grads(s)):
                p.grad = None if g is None else paddle.to_tensor(
                    jnp.asarray(g))
            opt.step()
            opt.clear_grad()
    finally:
        jmtu.FORCE_INTERPRET = prev
    return [np.asarray(p._value) for p in params], opt


def _port_params():
    params = [tnn.Parameter(torch.from_numpy(a)) for a in _rand(0, 0.1)]
    for i, p in enumerate(params):
        p.name = f"w{i}"  # state_dict keys are "<param name>.<state key>"
    return params


def _port_steps(opt, params, steps, first=0):
    for s in range(first, steps):
        for p, g in zip(params, _grads(s)):
            p.grad = None if g is None else torch.from_numpy(g)
        opt.step()
        opt.clear_grad()


@pytest.mark.parametrize("case", sorted(OPTS))
def test_steps_match_reference(case):
    steps = STEPS.get(case, 3)
    jp, jopt = _jax_run(case, steps)
    params = _port_params()
    opt = getattr(topt, _cls(case))(parameters=params, **OPTS[case])
    assert opt._FUSED_KIND is None
    with mock.patch.object(tmtu, "apply_flat_update",
                           side_effect=AssertionError("flat update")):
        _port_steps(opt, params, steps)
    for i, (p, want) in enumerate(zip(params, jp)):
        np.testing.assert_allclose(p.detach().numpy(), want, err_msg=str(i),
                                   **TOL)
    # the state: each parameter's keys and values the reference's (its
    # jitted update returns each state dict with sorted keys)
    jst, tst = _by_param(jopt.state_dict()), _by_param(opt.state_dict())
    assert [sorted(d) for d in tst] == [sorted(d) for d in jst]
    assert len(tst) == len(SHAPES) - 1
    assert opt.state_dict()["@step"] == jopt.state_dict()["@step"] == steps
    for t, j in zip(tst, jst):
        for k in j:
            np.testing.assert_allclose(t[k].numpy(), np.asarray(j[k].numpy()),
                                       err_msg=k, rtol=1e-5, atol=1e-7)


def _by_param(sd):
    """A state dict's entries as one ``{state key: value}`` per parameter,
    in the order the parameters first appear."""
    out = {}
    for key, v in sd.items():
        if "." in key:
            pname, _, skey = key.rpartition(".")
            out.setdefault(pname, {})[skey] = v
    return list(out.values())


@pytest.mark.parametrize("case", ["ASGD", "NAdam", "Rprop", "Lion"])
def test_state_dict_round_trip(case):
    """Two steps, ``state_dict``, a fresh optimizer on copies of the
    parameters ``set_state_dict``, the third step: equal to three steps in
    one run (NAdam's scalar ``mu_product`` and ASGD's ``ys`` included)."""
    params = _port_params()
    opt = getattr(topt, _cls(case))(parameters=params, **OPTS[case])
    _port_steps(opt, params, 2)
    saved = {k: (v.clone() if isinstance(v, torch.Tensor) else v)
             for k, v in opt.state_dict().items()}
    params2 = [tnn.Parameter(p.detach().clone()) for p in params]
    for p, p2 in zip(params, params2):
        p2.name = p.name
    opt2 = getattr(topt, _cls(case))(parameters=params2, **OPTS[case])
    opt2.set_state_dict(saved)
    _port_steps(opt, params, 3, first=2)
    _port_steps(opt2, params2, 3, first=2)
    for p, p2 in zip(params, params2):
        assert torch.equal(p, p2)


def test_multi_precision_refused_where_reference_raises():
    for cls in (topt.Adamax, topt.RAdam):
        with pytest.raises(NotImplementedError, match="multi_precision"):
            cls(parameters=_port_params(), multi_precision=True)


def _rosenbrock(x):
    return (1 - x[0]) ** 2 + 100 * (x[1] - x[0] ** 2) ** 2


def _lbfgs_pair(line_search, lr, max_iter):
    start = np.array([-1.5, 2.0], np.float32)
    jx = jnn.Parameter(jnp.asarray(start))
    tx = tnn.Parameter(torch.from_numpy(start.copy()))
    kw = dict(learning_rate=lr, max_iter=max_iter, history_size=5,
              line_search_fn=line_search)
    jopt = paddle.optimizer.LBFGS(parameters=[jx], **kw)
    topt_ = topt.LBFGS(parameters=[tx], **kw)

    def step():
        """One ``step(closure)`` on each package: their losses."""
        out = []
        for opt, x in ((jopt, jx), (topt_, tx)):
            def closure():
                loss = _rosenbrock(x)
                loss.backward()
                return loss
            out.append(float(np.asarray(opt.step(closure).numpy() if
                                        opt is jopt else
                                        opt.step(closure).item())))
            opt.clear_grad()
        return out
    return jopt, topt_, jx, tx, step


def test_lbfgs_rosenbrock_no_line_search():
    """Three calls of ten iterations at ``learning_rate`` 1e-3: the same
    iterates and losses."""
    jopt, topt_, jx, tx, step = _lbfgs_pair(None, 1e-3, 10)
    for _ in range(3):
        jl, tl = step()
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
        np.testing.assert_allclose(tx.detach().numpy(), np.asarray(jx._value),
                                   rtol=1e-5, atol=1e-6)
    assert topt_._step_count == jopt._step_count == 30


def test_lbfgs_rosenbrock_strong_wolfe():
    """The backtracking search: five iterations give the same iterate on
    both packages (Rosenbrock's valley turns a one-ulp difference into a
    visible one a few iterations later, so the trajectories are compared
    there); then three calls of twenty iterations bring both to the
    minimum at (1, 1)."""
    jopt, topt_, jx, tx, step = _lbfgs_pair("strong_wolfe", 1.0, 5)
    jl, tl = step()
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    np.testing.assert_allclose(tx.detach().numpy(), np.asarray(jx._value),
                               rtol=1e-5, atol=1e-6)
    assert topt_._step_count == jopt._step_count
    jopt._max_iter = topt_._max_iter = 20
    for _ in range(3):
        jl, tl = step()
    assert tl < 1e-6 and jl < 1e-6
    np.testing.assert_allclose(tx.detach().numpy(), [1.0, 1.0], atol=1e-3)
    np.testing.assert_allclose(np.asarray(jx._value), [1.0, 1.0], atol=1e-3)


# ---------------------------------------------------------------------------
# nn.utils
# ---------------------------------------------------------------------------

def _np(seed, *shape):
    return np.asarray(np.random.RandomState(seed).randn(*shape), np.float32)


def _linears(fn, **kw):
    """A ``Linear(6, 4)`` on each package from the same weights, with the
    reparametrization ``fn`` (a name of ``nn.utils``) applied to both."""
    paddle.seed(7)
    jl = paddle.nn.Linear(6, 4)
    tl = port.nn.Linear(6, 4)
    layer_state_from_numpy(tl, {k: np.asarray(v.numpy()) for k, v in
                                jl.state_dict().items()}, device="cpu")
    getattr(paddle.nn.utils, fn)(jl, **kw)
    getattr(port.nn.utils, fn)(tl, **kw)
    assert list(tl.state_dict()) == list(jl.state_dict())
    return jl, tl


@pytest.mark.parametrize("fn,kw", [
    ("weight_norm", {}), ("weight_norm", dict(dim=1)),
    ("spectral_norm", {}), ("spectral_norm", dict(n_power_iterations=3,
                                                  dim=1))],
    ids=["weight_norm", "weight_norm_dim1", "spectral_norm",
         "spectral_norm_3_dim1"])
def test_reparametrizations(fn, kw):
    """Two forward calls (spectral norm's state refreshes between them);
    the outputs and every parameter's gradient agree within 1e-5."""
    jl, tl = _linears(fn, **kw)
    for call in range(2):
        x = _np(call, 3, 6)
        jy = jl(paddle.to_tensor(x))
        ty = tl(torch.from_numpy(x))
        np.testing.assert_allclose(ty.detach().numpy(), jy.numpy(),
                                   rtol=1e-5, atol=1e-5)
    w = _np(9, 3, 4)
    (jy * paddle.to_tensor(w)).sum().backward()
    (ty * torch.from_numpy(w)).sum().backward()
    for (k, jp), tp in zip(jl.state_dict().items(), tl.parameters()):
        np.testing.assert_allclose(tp.grad.numpy(), jp.grad.numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=k)


def test_remove_weight_norm():
    jl, tl = _linears("weight_norm")
    paddle.nn.utils.remove_weight_norm(jl)
    port.nn.utils.remove_weight_norm(tl)
    assert list(tl.state_dict()) == list(jl.state_dict()) == ["bias",
                                                              "weight"]
    np.testing.assert_allclose(tl.weight.detach().numpy(),
                               jl.weight.numpy(), rtol=1e-6, atol=1e-7)
    x = _np(1, 3, 6)
    np.testing.assert_allclose(tl(torch.from_numpy(x)).detach().numpy(),
                               jl(paddle.to_tensor(x)).numpy(), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("norm_type", [2.0, float("inf"), 1.0])
def test_clip_grad_norm_and_value(norm_type):
    grads = [_np(i, *s) for i, s in enumerate([(3, 4), (5,), (2, 2)])]
    jps = [jnn.Parameter(jnp.zeros(g.shape)) for g in grads]
    tps = [tnn.Parameter(torch.zeros(g.shape)) for g in grads]
    for jp, tp, g in zip(jps, tps, grads):
        jp.grad = paddle.to_tensor(g)
        tp.grad = torch.from_numpy(g.copy())
    jn = paddle.nn.utils.clip_grad_norm_(jps, 1.5, norm_type=norm_type)
    tn = port.nn.utils.clip_grad_norm_(tps, 1.5, norm_type=norm_type)
    np.testing.assert_allclose(tn.item(), float(jn.numpy()), rtol=1e-6)
    paddle.nn.utils.clip_grad_value_(jps, 0.2)
    port.nn.utils.clip_grad_value_(tps, 0.2)
    for jp, tp in zip(jps, tps):
        np.testing.assert_allclose(tp.grad.numpy(), jp.grad.numpy(),
                                   rtol=1e-6, atol=1e-7)


def test_parameter_vector_round_trip():
    ps = [tnn.Parameter(torch.from_numpy(_np(i, *s)))
          for i, s in enumerate([(3, 4), (5,), (2, 2)])]
    jps = [jnn.Parameter(jnp.asarray(p.detach().numpy())) for p in ps]
    vec = port.nn.utils.parameters_to_vector(ps)
    np.testing.assert_array_equal(
        vec.numpy(), paddle.nn.utils.parameters_to_vector(jps).numpy())
    port.nn.utils.vector_to_parameters(vec * 2, ps)
    assert torch.equal(ps[0], 2 * torch.from_numpy(_np(0, 3, 4)))


def test_forward_hooks_order_and_removal():
    """Pre-hooks see (layer, inputs) and may replace the inputs, post-hooks
    see (layer, inputs, outputs) and may replace the outputs, in
    registration order on both packages; ``remove()`` drops one."""
    logs = {}
    for name, pkg, tensor in (("jax", paddle, paddle.to_tensor),
                              ("port", port, torch.tensor)):
        layer = pkg.nn.Linear(2, 2)
        log = logs[name] = []
        h1 = layer.register_forward_pre_hook(
            lambda l, inp: log.append("pre1") or (inp[0] * 0,))
        layer.register_forward_pre_hook(lambda l, inp: log.append("pre2"))
        layer.register_forward_post_hook(
            lambda l, inp, out: log.append("post") or out + 1)
        out = layer(tensor(np.ones((1, 2), np.float32)))
        np.testing.assert_allclose(np.asarray(out.detach().numpy() if
                                              name == "port" else
                                              out.numpy()),
                                   np.asarray(layer.bias.detach().numpy()
                                              if name == "port" else
                                              layer.bias.numpy())[None] + 1)
        h1.remove()
        layer(tensor(np.ones((1, 2), np.float32)))
    assert logs["port"] == logs["jax"] == ["pre1", "pre2", "post", "pre2",
                                           "post"]


# ---------------------------------------------------------------------------
# names
# ---------------------------------------------------------------------------

def _public_names(path: Path):
    tree = ast.parse(path.read_text())
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            out.update(t.id for t in node.targets if isinstance(t, ast.Name))
    return {n for n in out if not n.startswith("_") and n != "Tensor"}


MODULES = [
    ("paddle_tpu/nn/functional/__init__.py", "nn.functional"),
    *[(f"paddle_tpu/nn/layer/{f}.py", "nn") for f in (
        "activation", "common", "container", "conv", "norm", "pooling",
        "loss", "rnn", "extras", "transformer")],
    ("paddle_tpu/nn/utils/__init__.py", "nn.utils"),
    ("paddle_tpu/optimizer/optimizer.py", "optimizer"),
    ("paddle_tpu/optimizer/adam.py", "optimizer"),
    ("paddle_tpu/optimizer/lbfgs.py", "optimizer"),
    ("paddle_tpu/text/__init__.py", "text"),
]
# module-level names of the reference that are no part of the API: the
# type alias of its functional module
NOT_API = {"Axis"}


@pytest.mark.parametrize("path,where", MODULES,
                         ids=[m[0].split("paddle_tpu/")[1] for m in MODULES])
def test_every_reference_name_is_ported(path, where):
    """Every public function, class and module-level name of the JAX
    package's file has a counterpart in the port's namespace."""
    ns = port
    for part in where.split("."):
        ns = getattr(ns, part)
    missing = sorted(n for n in _public_names(ROOT / path) - NOT_API
                     if not hasattr(ns, n))
    assert missing == []


def test_sparse_embedding_still_raises():
    with pytest.raises(NotImplementedError, match="sparse=True"):
        port.nn.functional.embedding(torch.tensor([1]), torch.zeros(3, 2),
                                     sparse=True)


# ---------------------------------------------------------------------------
# the rest of nn.functional and the extras layers
# ---------------------------------------------------------------------------

def _float(a):
    return np.issubdtype(a.dtype, np.floating)


def _same(jfn, tfn, arrays, tol=dict(rtol=1e-5, atol=1e-5)):
    """Outputs and the gradients of ``sum(out * w)`` for each float input,
    the JAX side one ``jit.to_static`` program."""
    jxs = [paddle.to_tensor(a, stop_gradient=not _float(a)) for a in arrays]

    def program(*ts):
        return jfn(*ts)
    jo = paddle.jit.to_static(program)(*jxs)
    txs = [torch.from_numpy(a.copy()).requires_grad_(_float(a))
           for a in arrays]
    to = tfn(*txs)
    w = _np(99, *to.shape)
    (jo * paddle.to_tensor(w)).sum().backward()
    (to * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(to.detach().numpy(), jo.numpy(), **tol)
    for j, t, a in zip(jxs, txs, arrays):
        if _float(a):
            jg = np.zeros_like(a) if j.grad is None else j.grad.numpy()
            tg = np.zeros_like(a) if t.grad is None else t.grad.numpy()
            np.testing.assert_allclose(tg, jg, **tol)


EXTRAS = [
    ("pixel_unshuffle", [_np(1, 2, 3, 4, 6)], dict(downscale_factor=2)),
    ("pixel_unshuffle", [_np(1, 2, 4, 6, 3)],
     dict(downscale_factor=2, data_format="NHWC")),
    ("channel_shuffle", [_np(1, 2, 6, 3, 3)], dict(groups=3)),
    ("channel_shuffle", [_np(1, 2, 3, 3, 6)],
     dict(groups=2, data_format="NHWC")),
    ("fold", [_np(1, 2, 3 * 4, 12)],
     dict(output_sizes=[4, 5], kernel_sizes=2, strides=1, paddings=0)),
    ("fold", [_np(1, 2, 2 * 9, 9)],
     dict(output_sizes=[5, 5], kernel_sizes=3, strides=2, paddings=1,
          dilations=1)),
    ("fold", [_np(1, 1, 2 * 4, 9)],
     dict(output_sizes=[5, 5], kernel_sizes=2, dilations=2)),
    ("zeropad2d", [_np(1, 2, 3, 4, 5)], dict(padding=[1, 2, 0, 3])),
    ("zeropad2d", [_np(1, 2, 4, 5, 3)], dict(padding=1, data_format="NHWC")),
    ("temperature_scaled_softmax", [_np(1, 4, 7)], dict(temperature=0.5)),
    ("affine_grid", [_np(1, 2, 2, 3)], dict(out_shape=[2, 3, 4, 5])),
    ("affine_grid", [_np(1, 2, 2, 3)],
     dict(out_shape=[2, 3, 4, 5], align_corners=False)),
    ("rrelu", [_np(1, 3, 8)], dict(training=False)),
]


@pytest.mark.parametrize("name,arrays,kw", EXTRAS,
                         ids=[f"{c[0]}{i}" for i, c in enumerate(EXTRAS)])
def test_extras_functional(name, arrays, kw):
    _same(lambda *xs: getattr(paddle.nn.functional, name)(*xs, **kw),
          lambda *xs: getattr(port.nn.functional, name)(*xs, **kw), arrays)


@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
def test_grid_sample(mode, padding_mode, align_corners):
    """Sampling points inside and past the borders; the input's and the
    grid's gradients."""
    kw = dict(mode=mode, padding_mode=padding_mode,
              align_corners=align_corners)
    grid = 1.3 * np.tanh(_np(2, 2, 3, 4, 2)).astype(np.float32)
    _same(lambda x, g: paddle.nn.functional.grid_sample(x, g, **kw),
          lambda x, g: port.nn.functional.grid_sample(x, g, **kw),
          [_np(1, 2, 3, 5, 6), grid])


LAYERS = [
    ("PixelUnshuffle", (2,), {}, _np(1, 2, 3, 4, 4)),
    ("ChannelShuffle", (2,), {}, _np(1, 2, 4, 3, 3)),
    ("Fold", ([3, 4], 2), {}, _np(1, 2, 8, 6)),
    ("ZeroPad2D", ([1, 0, 2, 1],), {}, _np(1, 2, 3, 4, 4)),
    ("Unflatten", (1, [2, 3]), {}, _np(1, 4, 6, 5)),
]


@pytest.mark.parametrize("name,args,kw,x", LAYERS,
                         ids=[c[0] for c in LAYERS])
def test_extras_layers(name, args, kw, x):
    _same(getattr(paddle.nn, name)(*args, **kw),
          getattr(port.nn, name)(*args, **kw), [x])


def test_rrelu_layer_and_training_slopes():
    """Eval: the mean slope, as the reference; training: each negative
    value's slope drawn from [lower, upper) with their mean near the
    middle, positives untouched."""
    jl, tl = paddle.nn.RReLU(0.1, 0.3), port.nn.RReLU(0.1, 0.3)
    jl.eval()
    tl.eval()
    _same(jl, tl, [_np(1, 4, 6)])
    tl.train()
    x = -torch.rand(20000) - 0.5
    slope = tl(x) / x
    assert 0.1 <= slope.min() and slope.max() < 0.3
    assert abs(slope.mean().item() - 0.2) < 0.005
    pos = torch.rand(100)
    assert torch.equal(tl(pos), pos)


def test_gumbel_softmax_statistics():
    """Soft samples are distributions; hard ones are one-hot with no
    gradient (the reference's straight-through lines cancel); the hard
    sample's class frequencies follow ``softmax(x)`` (the Gumbel-max
    trick): within 0.02 over 20000 draws."""
    logits = torch.tensor([[1.0, 0.0, -1.0, 0.5]]).repeat(20000, 1)
    port.seed(0)
    soft = port.nn.functional.gumbel_softmax(logits, temperature=0.7)
    torch.testing.assert_close(soft.sum(-1), torch.ones(20000))
    x = logits.clone().requires_grad_()
    hard = port.nn.functional.gumbel_softmax(x, hard=True)
    assert set(hard.unique().tolist()) == {0.0, 1.0}
    assert torch.equal(hard.sum(-1), torch.ones(20000))
    hard.sum().backward()
    assert not x.grad.any()
    freq = hard.detach().mean(0)
    torch.testing.assert_close(freq, torch.softmax(logits[0], -1), rtol=0,
                               atol=0.02)
    jh = paddle.nn.functional.gumbel_softmax(paddle.to_tensor(
        logits[:4].numpy()), hard=True)
    assert np.asarray(jh.numpy()).sum(-1).tolist() == [1.0] * 4


def test_class_center_sample():
    """Every positive class kept: with as many positives as samples the
    result is deterministic and equal to the reference's; with fewer, the
    sampled set is sorted, holds the positives and ``num_samples`` classes,
    and the remapped labels index it."""
    label = np.array([5, 2, 9, 2, 5, 7], np.int64)
    jr, js = paddle.nn.functional.class_center_sample(
        paddle.to_tensor(label), 12, 4)
    tr, ts = port.nn.functional.class_center_sample(torch.from_numpy(label),
                                                    12, 4)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr.numpy()))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js.numpy()))
    tr, ts = port.nn.functional.class_center_sample(torch.from_numpy(label),
                                                    12, 8)
    s = ts.numpy()
    assert len(s) == 8 and list(s) == sorted(set(s))
    assert {2, 5, 7, 9} <= set(s.tolist())
    np.testing.assert_array_equal(s[tr.numpy()], label)
