"""The port's autograd (``core.autograd``, ``autograd``, ``paddle.grad``)
against the JAX package's: the numeric cases of ``tests/test_autograd.py``
as scripts run through both packages, ``PyLayer``, the functional
transforms, the backward-end callbacks, and the README's quickstart
script with its two import lines changed (less ``to_static``)."""

import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as pp
from torch_ops_common import R, assert_close, on_cpu  # noqa: F401


def _chain(P):
    x = P.to_tensor([1.0, 2.0, 3.0], stop_gradient=False)
    P.sum(x * x + 2 * x).backward()
    return x.grad


def _multi_use(P):
    x = P.to_tensor([2.0], stop_gradient=False)
    (x * x + x * 3).backward()
    return x.grad


def _repeated(P):
    x = P.to_tensor([1.0], stop_gradient=False)
    (x * 2).backward()
    (x * 3).backward()
    return x.grad


def _stop(P):
    x = P.to_tensor([1.0, 2.0], stop_gradient=False)
    y = P.to_tensor([3.0, 4.0])
    P.sum(x * y).backward()
    assert y.grad is None
    return x.grad


def _detach(P):
    x = P.to_tensor([3.0], stop_gradient=False)
    y = (x * x).detach()
    assert y.stop_gradient
    (y * x).backward()
    return x.grad


def _retain(P):
    x = P.to_tensor([2.0], stop_gradient=False)
    y = x * x
    y.backward(retain_graph=True)
    y.backward()
    return x.grad


def _grad_intermediate(P):
    x = P.to_tensor([2.0], stop_gradient=False)
    y = x * x
    (gy,) = P.grad(y * 3, [y])
    assert x.grad is None
    return gy


def _grad_unused(P):
    x = P.to_tensor([1.0], stop_gradient=False)
    u = P.to_tensor([1.0], stop_gradient=False)
    gx, gu = P.grad(x * 2, [x, u], allow_unused=True)
    assert gu is None
    return gx


def _grad_outputs(P):
    x = P.to_tensor(np.array([1.0, 2.0, 3.0], np.float32),
                    stop_gradient=False)
    (g,) = P.grad([x * x], [x], grad_outputs=[P.to_tensor(
        np.array([1.0, 0.5, 2.0], np.float32))])
    return g


def _hook(P):
    x = P.to_tensor([1.0], stop_gradient=False)
    seen = []

    def hook(g):
        seen.append(float(g.numpy()[0]))
        return g * 2

    x.register_hook(hook)
    (x * 3).backward()
    assert seen == [3.0]
    return x.grad


def _intermediate_hook(P):
    x = P.to_tensor([1.0, 2.0], stop_gradient=False)
    y = x * 2
    y.register_hook(lambda g: g * 10)
    P.sum(y * y).backward()
    return x.grad


def _topk_grad(P):
    x = P.to_tensor(np.arange(6, dtype="float32").reshape(2, 3),
                    stop_gradient=False)
    v, _ = P.topk(x, k=1, axis=1)
    P.sum(v).backward()
    return x.grad


def _backward_fn(P):
    x = P.to_tensor([1.0, 2.0], stop_gradient=False)
    y = P.to_tensor([3.0, 5.0], stop_gradient=False)
    P.autograd.backward([P.sum(x * y), P.sum(x)],
                        [P.to_tensor(2.0), P.to_tensor(1.0)])
    return x.grad, y.grad


def _no_grad(P):
    x = P.to_tensor([1.0], stop_gradient=False)
    with P.no_grad():
        y = x * 2
    assert y.stop_gradient
    with P.no_grad():
        with P.enable_grad():
            z = x * 2
    assert not z.stop_gradient

    @P.no_grad()
    def f(t):
        return t * 3

    assert f(x).stop_gradient
    prev = P.is_grad_enabled()
    P.set_grad_enabled(False)
    try:
        assert (x * 4).stop_gradient
    finally:
        P.set_grad_enabled(prev)
    return x * 1


SCRIPTS = [_chain, _multi_use, _repeated, _stop, _detach, _retain,
           _grad_intermediate, _grad_unused, _grad_outputs, _hook,
           _intermediate_hook, _topk_grad, _backward_fn, _no_grad]


@pytest.mark.parametrize("script", SCRIPTS, ids=[s.__name__[1:]
                                                 for s in SCRIPTS])
def test_script_through_both_packages(script):
    want, got = script(pt), script(pp)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for g, w in zip(got, want):
        assert_close(g, w)


def test_errors_match():
    for P in (pt, pp):
        x = P.to_tensor([1.0], stop_gradient=False)
        y = x * x
        y.backward()
        with pytest.raises(RuntimeError):
            y.backward()  # the graph was freed
        v = P.to_tensor([1.0, 2.0], stop_gradient=False) * 2
        with pytest.raises(ValueError, match="grad_tensors"):
            v.backward()
        u = P.to_tensor([1.0], stop_gradient=False)
        with pytest.raises(ValueError, match="unreachable"):
            P.grad(P.to_tensor([1.0], stop_gradient=False) * 2, [u])


def test_pylayer():
    def make(P):
        class Cube(P.autograd.PyLayer):
            @staticmethod
            def forward(ctx, a, k):
                ctx.save_for_backward(a)
                return a ** 3 * k

            @staticmethod
            def backward(ctx, grad):
                (a,) = ctx.saved_tensor
                return grad * 3 * a ** 2 * 2.0

        return Cube

    out = {}
    for P in (pt, pp):
        x = P.to_tensor([1.5, -2.0], stop_gradient=False)
        y = make(P).apply(x, 2.0)
        P.sum(y).backward()
        out[P.__name__] = (y, x.grad)
    for g, w in zip(out["paddle_tpu_torch"], out["paddle_tpu"]):
        assert_close(g, w)


def test_pylayer_two_inputs_and_outputs():
    def make(P):
        class MulAdd(P.autograd.PyLayer):
            @staticmethod
            def forward(ctx, a, b):
                ctx.save_for_backward(a, b)
                return a * b, a + b

            @staticmethod
            def backward(ctx, g1, g2):
                a, b = ctx.saved_tensors()
                return g1 * b + g2, g1 * a + g2

        return MulAdd

    out = {}
    for P in (pt, pp):
        a = P.to_tensor([1.0, 2.0], stop_gradient=False)
        b = P.to_tensor([3.0, -1.0])  # needs no gradient
        m, s = make(P).apply(a, b)
        P.sum(m * 2 + s).backward()
        out[P.__name__] = (m, s, a.grad)
    for g, w in zip(out["paddle_tpu_torch"], out["paddle_tpu"]):
        assert_close(g, w)


def test_functional_transforms():
    r = R("functional")
    a, b, v = r.n(3), r.n(3), r.n(3)

    def f(P):
        return lambda x: P.sum(x * x * x)

    def g(P):
        return lambda x, y: x * y + P.sin(x)

    jr = pt.autograd.jacobian(lambda x: x * pt.sin(x), pt.to_tensor(a))
    jp = pp.autograd.jacobian(lambda x: x * pp.sin(x), pp.to_tensor(a))
    assert_close(jp, jr)
    jr = pt.autograd.jacobian(g(pt), [pt.to_tensor(a), pt.to_tensor(b)])
    jp = pp.autograd.jacobian(g(pp), [pp.to_tensor(a), pp.to_tensor(b)])
    assert len(jr) == len(jp) == 2
    for x, y in zip(jp, jr):
        assert_close(x, y)
    assert_close(pp.autograd.hessian(f(pp), pp.to_tensor(a)),
                 pt.autograd.hessian(f(pt), pt.to_tensor(a)))
    hr = pt.autograd.hessian(lambda x, y: pt.sum(x * x * y),
                             [pt.to_tensor(a), pt.to_tensor(b)])
    hp = pp.autograd.hessian(lambda x, y: pp.sum(x * x * y),
                             [pp.to_tensor(a), pp.to_tensor(b)])
    for row_p, row_r in zip(hp, hr):
        for x, y in zip(row_p, row_r):
            assert_close(x, y)
    for fn in ("jvp", "vjp"):
        orr, tr = getattr(pt.autograd, fn)(lambda x: pt.tanh(x) * 2,
                                           pt.to_tensor(a), pt.to_tensor(v))
        op, tp = getattr(pp.autograd, fn)(lambda x: pp.tanh(x) * 2,
                                          pp.to_tensor(a), pp.to_tensor(v))
        assert_close(op, orr)
        assert_close(tp, tr)
        orr, tr = getattr(pt.autograd, fn)(lambda x: pt.tanh(x) * 2,
                                           pt.to_tensor(a))
        op, tp = getattr(pp.autograd, fn)(lambda x: pp.tanh(x) * 2,
                                          pp.to_tensor(a))
        assert_close(tp, tr)
    _, gr = pt.autograd.vjp(lambda x, y: x * y, [pt.to_tensor(a),
                                                 pt.to_tensor(b)])
    _, gp = pp.autograd.vjp(lambda x, y: x * y, [pp.to_tensor(a),
                                                 pp.to_tensor(b)])
    for x, y in zip(gp, gr):
        assert_close(x, y)
    with pytest.raises(ValueError, match="OUTPUT structure"):
        pp.autograd.vjp(lambda x: x * 2, pp.to_tensor(a),
                        [pp.to_tensor(v), pp.to_tensor(v)])


def test_double_grad_is_taken():
    """The reference refuses ``create_graph=True``; the port's engine
    differentiates twice."""
    x = pp.to_tensor([2.0], stop_gradient=False)
    (g,) = pp.grad(x ** 3, [x], create_graph=True)
    (gg,) = pp.grad(g, [x])
    assert float(g) == 12.0 and float(gg) == 12.0


def test_backward_end_callbacks_and_saved_hooks():
    from paddle_tpu_torch.core import autograd as eng

    fired = []

    def cb():
        fired.append(1)

    eng.register_backward_end_callback(cb)
    try:
        x = pp.to_tensor([1.0], stop_gradient=False)
        (x * 2).backward()
        pp.autograd.backward([x * 3])
        pp.grad(x * 4, [x])  # a capture pass fires none
    finally:
        eng.unregister_backward_end_callback(cb)
    assert fired == [1, 1]
    packed = []
    with pp.autograd.saved_tensors_hooks(
            lambda t: packed.append(1) or t * 1, lambda t: t):
        x = pp.to_tensor([3.0], stop_gradient=False)
        y = x * x
    y.backward()
    assert packed and float(x.grad) == 6.0


def test_readme_quickstart_runs_on_the_cpu():
    """``README.md``'s lines 10-29, only the two import lines changed, run
    under ``set_device("cpu")``; then phase 6g (b)'s code on the CPU
    (the CPU standing in for the card)."""
    from paddle_tpu_torch.experiments import op_corpus

    src = op_corpus.readme_script()
    assert "import paddle_tpu_torch as paddle" in src
    assert "to_static" not in src
    g = {"__name__": "__main__"}
    pp.seed(0)
    np.random.seed(0)
    exec(compile(src, "README.md", "exec"), g)
    loss = g["loss"]
    assert isinstance(loss, pp.Tensor) and np.isfinite(float(loss.numpy()))
    assert all(p.grad is None for p in g["net"].parameters())  # clear_grad
    out = op_corpus.readme_phase("cpu", steps=3)
    assert out["loss_max_rel_err"] == 0.0 and len(out["losses"]) == 3
    assert out["script"]["loss_type"] == "Tensor"
    # the step's methods took the reference's forms: its two ``x.matmul``
    # ran as the op, through ``run_op``
    assert out["step_ops"].count("matmul") == 2


def test_readme_step_matches_the_reference():
    """The README's model, one AdamW step on the same numpy weights and
    batch through both packages: the loss and every updated weight."""
    r = R("readme_step")
    x, label = r.u(32, 784), r.i(32, hi=10)
    out = {}
    for P in (pt, pp):
        P.seed(0)
        net = P.nn.Sequential(P.nn.Linear(784, 256), P.nn.ReLU(),
                              P.nn.Linear(256, 10))
        if P is pt:
            state = {k: v.numpy() for k, v in net.state_dict().items()}
        else:
            from paddle_tpu_torch.models.convert import layer_state_from_numpy

            layer_state_from_numpy(net, state, device="cpu")
        opt = P.optimizer.AdamW(learning_rate=1e-3,
                                parameters=net.parameters())
        loss = P.nn.functional.cross_entropy(net(P.to_tensor(x)),
                                             P.to_tensor(label))
        loss.backward()
        opt.step()
        opt.clear_grad()
        out[P.__name__] = [loss] + [p for p in net.parameters()]
    # op_test's fp32 TOL: Adam's first step is lr * sign(g) where |g| is
    # tiny, so a few-ulp gradient difference moves a weight by ~1e-6
    for g, w in zip(out["paddle_tpu_torch"], out["paddle_tpu"]):
        assert_close(g, w)
