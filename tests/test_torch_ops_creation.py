"""``ops/creation.py`` of the port against the JAX package's: the
deterministic creation ops value for value (``tests/test_ops_basic.py``'s
creation cases among them), the random ops by distribution (shape, dtype,
range, moments; the port's bits are not ``jax.random``'s) and by
repetition under ``seed``, and the device rule: creation ops and
``to_tensor`` run on the card and raise without one unless the caller
names the CPU."""

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as pp
from torch_ops_common import R, ids, on_cpu, run_case  # noqa: F401

I64 = np.int64

CASES = [
    ("zeros", "zeros", lambda r: ([[2, 3]], {}), False),
    ("zeros_int", "zeros", lambda r: ([[2]], dict(dtype="int32")), False),
    ("ones", "ones", lambda r: ([3], dict(dtype="float32")), False),
    ("full", "full", lambda r: ([[2, 2], 1.5], {}), False),
    ("full_int", "full", lambda r: ([[3], 7], {}), False),
    ("full_bool", "full", lambda r: ([[3], True], {}), False),
    ("empty", "empty", lambda r: ([[2, 3]], {}), False),
    ("zeros_like", "zeros_like", lambda r: ([r.n(2, 3)], {}), False),
    ("ones_like", "ones_like", lambda r: ([r.n(2, 3)], dict(dtype="int32")),
     False),
    ("full_like", "full_like", lambda r: ([r.n(2, 3), 2.0], {}), False),
    ("empty_like", "empty_like", lambda r: ([r.n(2, 3)], {}), False),
    ("arange", "arange", lambda r: ([5], {}), False),
    ("arange_start_step", "arange", lambda r: ([2, 11, 3], {}), False),
    ("arange_float", "arange", lambda r: ([0.0, 1.0, 0.25], {}), False),
    ("linspace", "linspace", lambda r: ([0.0, 1.0, 7], {}), False),
    ("logspace", "logspace", lambda r: ([0.0, 2.0, 5], {}), False),
    ("logspace_base2", "logspace", lambda r: ([0.0, 3.0, 4], dict(base=2.0)),
     False),
    ("eye", "eye", lambda r: ([3], {}), False),
    ("eye_rect", "eye", lambda r: ([2, 4], {}), False),
    ("diag_vector", "diag", lambda r: ([r.n(3)], {}), True),
    ("diag_matrix_offset", "diag", lambda r: ([r.n(3, 4)], dict(offset=1)),
     True),
    ("diag_padding", "diag", lambda r: ([r.n(3)], dict(
        offset=-1, padding_value=9.0)), True),
    ("diagflat", "diagflat", lambda r: ([r.n(2, 2)], dict(offset=1)), True),
    ("tril", "tril", lambda r: ([r.n(3, 4)], {}), True),
    ("tril_diag", "tril", lambda r: ([r.n(2, 3, 4)], dict(diagonal=-1)),
     True),
    ("triu", "triu", lambda r: ([r.n(3, 4)], dict(diagonal=1)), True),
    ("meshgrid", "meshgrid", lambda r: ([r.n(2), r.n(3)], {}), False),
    ("meshgrid_list", "meshgrid", lambda r: ([[r.n(2), r.n(3), r.n(4)]], {}),
     False),
    ("one_hot", "one_hot", lambda r: ([np.array([0, 3, 1], I64), 4], {}),
     False),
    ("one_hot_out_of_range", "one_hot", lambda r: (
        [np.array([[0, 5], [2, -1]], I64), 4], {}), False),
    ("assign", "assign", lambda r: ([r.n(2, 3)], {}), False),
    ("assign_array", "assign", lambda r: ([[1.0, 2.0]], {}), False),
    ("clone", "clone", lambda r: ([r.n(2, 3)], {}), True),
]


@pytest.mark.parametrize("case", CASES, ids=ids(CASES))
def test_op_against_reference(case):
    run_case(case)


_RANDOM = {"rand", "randn", "standard_normal", "randint", "randperm",
           "uniform", "normal", "bernoulli", "multinomial"}


def test_every_creation_op_is_covered():
    from paddle_tpu.ops import creation as ref

    done = {c[1] for c in CASES} | _RANDOM | {"clone_"}
    assert set(ref.__all__) - done == set()


def test_assign_into_output():
    a = R("assign_out").n(2, 3)
    out_r, out_p = pt.zeros([2, 3]), pp.zeros([2, 3])
    pt.assign(pt.to_tensor(a), out_r)
    got = pp.assign(pp.to_tensor(a), out_p)
    assert got is out_p
    np.testing.assert_array_equal(out_p.numpy(), out_r.numpy())


def _stats(t):
    v = t.numpy().astype(np.float64)
    return v.mean(), v.std(), v.min(), v.max()


@pytest.mark.parametrize("pkg", [pt, pp], ids=["jax", "port"])
def test_random_ops_by_distribution(pkg):
    """The random ops of both packages hold the same distributions."""
    pkg.seed(11)
    n = 20000
    m, s, lo, hi = _stats(pkg.rand([n]))
    assert abs(m - 0.5) < 0.02 and abs(s - 0.2887) < 0.02
    assert lo >= 0.0 and hi < 1.0
    m, s, _, _ = _stats(pkg.randn([n]))
    assert abs(m) < 0.03 and abs(s - 1.0) < 0.03
    m, s, _, _ = _stats(pkg.standard_normal([n]))
    assert abs(m) < 0.03 and abs(s - 1.0) < 0.03
    r = pkg.randint(2, 9, [n])
    m, _, lo, hi = _stats(r)
    assert lo == 2 and hi == 8 and abs(m - 5.0) < 0.1
    assert r.numpy().dtype.kind == "i"
    p = pkg.randperm(50).numpy()
    assert sorted(p.tolist()) == list(range(50))
    m, _, lo, hi = _stats(pkg.uniform([n], min=-2.0, max=3.0))
    assert lo >= -2.0 and hi < 3.0 and abs(m - 0.5) < 0.05
    m, s, _, _ = _stats(pkg.normal(1.5, 0.5, [n]))
    assert abs(m - 1.5) < 0.02 and abs(s - 0.5) < 0.02
    mean = pkg.to_tensor(np.full((n,), 3.0, np.float32))
    m, s, _, _ = _stats(pkg.normal(mean, 2.0))
    assert abs(m - 3.0) < 0.06 and abs(s - 2.0) < 0.06
    b = pkg.bernoulli(pkg.to_tensor(np.full((n,), 0.3, np.float32)))
    m, _, lo, hi = _stats(b)
    assert {lo, hi} == {0.0, 1.0} and abs(m - 0.3) < 0.02
    probs = pkg.to_tensor(np.array([[0.1, 0.0, 0.9]] * 2000, np.float32))
    draws = pkg.multinomial(probs, 1).numpy().reshape(-1)
    assert 1 not in draws.tolist()
    assert abs((draws == 2).mean() - 0.9) < 0.03
    w = pkg.multinomial(pkg.to_tensor(np.array([0.2, 0.3, 0.5], np.float32)),
                        3).numpy()
    assert sorted(w.tolist()) == [0, 1, 2]  # without replacement


def test_random_ops_repeat_under_seed():
    def draw():
        return [pp.rand([4]), pp.randn([4]), pp.randint(0, 9, [4]),
                pp.randperm(6), pp.uniform([4]), pp.normal(shape=[3]),
                pp.bernoulli(pp.to_tensor(np.full(4, 0.5, np.float32))),
                pp.multinomial(pp.to_tensor(np.ones(5, np.float32)), 2)]

    pp.seed(5)
    a = draw()
    pp.seed(5)
    b = draw()
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    u1 = pp.uniform([6], seed=3).numpy()
    pp.seed(99)
    np.testing.assert_array_equal(pp.uniform([6], seed=3).numpy(), u1)


def test_seed_keeps_the_initializers_draws():
    """``seed`` reseeds the generator layers draw from, as
    ``nn.initializer.seed`` does: the same seed, the same weights."""
    from paddle_tpu_torch.nn import initializer

    pp.seed(123)
    w1 = pp.nn.Linear(4, 3).weight.detach().clone()
    initializer.seed(123)
    w2 = pp.nn.Linear(4, 3).weight.detach().clone()
    assert torch.equal(w1, w2)


def test_creation_defaults_to_the_card(monkeypatch):
    """Without ``set_device("cpu")`` or ``place=``, creation ops and
    ``to_tensor`` run on the card and raise without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    prev = pp.set_device("gpu")
    try:
        for make in (lambda: pp.to_tensor([1.0]), lambda: pp.zeros([2]),
                     lambda: pp.arange(3), lambda: pp.rand([2]),
                     lambda: pp.full([2], 1.0), lambda: pp.eye(2)):
            with pytest.raises(RuntimeError, match="CUDA"):
                make()
        t = pp.to_tensor([1.0], place="cpu")
        assert t.place == pp.CPUPlace()
        t = pp.to_tensor([1.0], place=pp.CPUPlace())
        assert t.device.type == "cpu"
    finally:
        pp.set_device(prev)


def test_meshgrid_is_differentiable():
    """The reference's ``meshgrid`` returns tensors cut from its tape (a
    reference caveat); the port's carries gradients: each input's is the
    sum of its grid's weights over the other axes."""
    r = R("meshgrid_grad")
    a, b = r.n(2), r.n(3)
    w0, w1 = r.n(2, 3), r.n(2, 3)
    x = pp.to_tensor(a, stop_gradient=False)
    y = pp.to_tensor(b, stop_gradient=False)
    gx, gy = pp.meshgrid(x, y)
    (gx * torch.from_numpy(w0) + gy * torch.from_numpy(w1)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), w0.sum(1), rtol=1e-6)
    np.testing.assert_allclose(y.grad.numpy(), w1.sum(0), rtol=1e-6)
