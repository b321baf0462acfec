"""``ops/math.py`` of the port against the JAX package's: every op's
outputs and input gradients on the same seeded inputs (the numeric cases
of ``tests/test_ops_basic.py``'s elementwise and matmul classes among
them), at ``tests/op_test.py``'s float32 tolerance."""

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as pp
from torch_ops_common import R, ids, on_cpu, run_case  # noqa: F401

S = (3, 4)

_UNARY = {
    # name: (low, high) of the uniform input, or None for a normal one
    "neg": None, "abs": None, "sign": None, "exp": None, "expm1": None,
    "log": (0.2, 3.0), "log2": (0.2, 3.0), "log10": (0.2, 3.0),
    "log1p": (-0.5, 2.0), "sqrt": (0.2, 3.0), "rsqrt": (0.2, 3.0),
    "square": None, "reciprocal": (0.5, 2.0), "sin": None, "cos": None,
    "tan": (-1.0, 1.0), "asin": (-0.9, 0.9), "acos": (-0.9, 0.9),
    "atan": None, "sinh": None, "cosh": None, "tanh": None, "asinh": None,
    "acosh": (1.2, 3.0), "atanh": (-0.9, 0.9), "floor": None, "ceil": None,
    "round": None, "trunc": None, "frac": None, "erf": None,
    "erfinv": (-0.9, 0.9), "lgamma": (0.5, 3.0), "digamma": (0.5, 3.0),
    "gammaln": (0.5, 3.0), "exp2": None, "deg2rad": None, "rad2deg": None,
    "stanh": None,
}

_BINARY = {
    "add": None, "subtract": None, "multiply": None, "divide": (0.5, 2.0),
    "maximum": None, "minimum": None, "fmax": None, "fmin": None,
    "atan2": (0.5, 2.0), "logaddexp": None, "logaddexp2": None,
    "hypot": (0.5, 2.0), "pow": (0.5, 2.0), "float_power": (0.5, 2.0),
}


def _u(name, rng):
    def build(r):
        x = r.n(*S) if rng is None else r.u(*S, lo=rng[0], hi=rng[1])
        return [x], {}
    return (name, name, build, True)


def _b(name, rng):
    def build(r):
        if rng is None:
            return [r.n(*S), r.n(*S)], {}
        return [r.u(*S, lo=rng[0], hi=rng[1]),
                r.u(*S, lo=rng[0], hi=rng[1])], {}
    return (name, name, build, True)


CASES = [_u(n, v) for n, v in _UNARY.items()]
CASES += [_b(n, v) for n, v in _BINARY.items()]
CASES += [
    ("add_broadcast", "add", lambda r: ([r.n(3, 4), r.n(4)], {}), True),
    ("add_scalar", "add", lambda r: ([r.n(3, 4), 2.5], {}), True),
    ("rsub_scalar", "subtract", lambda r: ([1.5, r.n(3, 4)], {}), True),
    ("divide_int", "divide", lambda r: ([r.i(3, 4, lo=1, hi=9),
                                         r.i(3, 4, lo=1, hi=4)], {}), False),
    ("floor_divide", "floor_divide", lambda r: (
        [r.i(3, 4, lo=-9, hi=9), r.i(3, 4, lo=1, hi=4)], {}), False),
    ("floor_divide_float", "floor_divide", lambda r: (
        [r.n(3, 4) * 4, r.u(3, 4, lo=0.5, hi=2)], {}), False),
    ("mod", "mod", lambda r: ([r.n(3, 4) * 4, r.u(3, 4, lo=0.5, hi=2)], {}),
     True),
    ("mod_int_negative", "mod", lambda r: (
        [r.i(3, 4, lo=-9, hi=9), r.i(3, 4, lo=1, hi=4) * np.array(
            [1, -1, 1, -1])], {}), False),
    ("remainder", "remainder", lambda r: (
        [r.n(3, 4) * 4, r.u(3, 4, lo=0.5, hi=2)], {}), False),
    ("pow_scalar", "pow", lambda r: ([r.u(3, 3, lo=0.5, hi=1.5), 2.0], {}),
     True),
    ("pow_int", "pow", lambda r: ([r.i(3, 4, lo=0, hi=5), 2], {}), False),
    ("gcd", "gcd", lambda r: ([r.i(3, 4, lo=1, hi=30),
                               r.i(3, 4, lo=1, hi=30)], {}), False),
    ("lcm", "lcm", lambda r: ([r.i(3, 4, lo=1, hi=12),
                               r.i(3, 4, lo=1, hi=12)], {}), False),
    ("gammainc", "gammainc", lambda r: ([r.u(3, 4, lo=0.5, hi=3),
                                         r.u(3, 4, lo=0.2, hi=3)], {}), False),
    ("gammaincc", "gammaincc", lambda r: ([r.u(3, 4, lo=0.5, hi=3),
                                           r.u(3, 4, lo=0.2, hi=3)], {}),
     False),
    ("isnan", "isnan", lambda r: ([np.array([1.0, np.nan, np.inf, -np.inf],
                                            np.float32)], {}), False),
    ("isinf", "isinf", lambda r: ([np.array([1.0, np.nan, np.inf, -np.inf],
                                            np.float32)], {}), False),
    ("isposinf", "isposinf", lambda r: ([np.array(
        [1.0, np.nan, np.inf, -np.inf], np.float32)], {}), False),
    ("isneginf", "isneginf", lambda r: ([np.array(
        [1.0, np.nan, np.inf, -np.inf], np.float32)], {}), False),
    ("isfinite", "isfinite", lambda r: ([np.array(
        [1.0, np.nan, np.inf, -np.inf], np.float32)], {}), False),
    ("nan_to_num", "nan_to_num", lambda r: ([np.array(
        [1.0, np.nan, np.inf, -np.inf], np.float32)], {}), False),
    ("nan_to_num_values", "nan_to_num", lambda r: ([np.array(
        [1.0, np.nan, np.inf, -np.inf], np.float32)],
        dict(nan=2.0, posinf=9.0, neginf=-9.0)), False),
    ("nan_to_num_grad", "nan_to_num", lambda r: ([r.n(3, 4)], {}), True),
    ("logit", "logit", lambda r: ([r.u(3, 4, lo=0.05, hi=0.95)], {}), True),
    ("logit_eps", "logit", lambda r: ([r.u(3, 4, lo=0.0, hi=1.0)],
                                      dict(eps=0.1)), True),
    ("clip", "clip", lambda r: ([r.n(4, 4)], dict(min=-0.5, max=0.5)), True),
    ("clip_min_only", "clip", lambda r: ([r.n(4, 4)], dict(min=0.0)), True),
    ("scale", "scale", lambda r: ([r.n(3, 4)], dict(scale=2.0, bias=1.0)),
     True),
    ("scale_bias_first", "scale", lambda r: (
        [r.n(3, 4)], dict(scale=2.0, bias=1.0, bias_after_scale=False)),
     True),
    ("lerp", "lerp", lambda r: ([r.n(3, 4), r.n(3, 4), 0.3], {}), True),
    ("lerp_tensor_weight", "lerp", lambda r: (
        [r.n(3, 4), r.n(3, 4), r.u(3, 4)], {}), True),
    ("matmul", "matmul", lambda r: ([r.n(3, 4), r.n(4, 5)], {}), True),
    ("matmul_transpose_x", "matmul", lambda r: (
        [r.n(4, 3), r.n(4, 5)], dict(transpose_x=True)), True),
    ("matmul_transpose_y", "matmul", lambda r: (
        [r.n(3, 4), r.n(5, 4)], dict(transpose_y=True)), True),
    ("matmul_batched", "matmul", lambda r: ([r.n(2, 3, 4), r.n(2, 4, 5)],
                                            {}), True),
    ("matmul_vector", "matmul", lambda r: ([r.n(3, 4), r.n(4)], {}), True),
    ("mm", "mm", lambda r: ([r.n(3, 4), r.n(4, 2)], {}), True),
    ("bmm", "bmm", lambda r: ([r.n(2, 3, 4), r.n(2, 4, 5)], {}), True),
    ("dot", "dot", lambda r: ([r.n(4), r.n(4)], {}), True),
    ("dot_batched", "dot", lambda r: ([r.n(3, 4), r.n(3, 4)], {}), True),
    ("inner", "inner", lambda r: ([r.n(3, 4), r.n(2, 4)], {}), True),
    ("outer", "outer", lambda r: ([r.n(3), r.n(4)], {}), True),
    ("addmm", "addmm", lambda r: ([r.n(3, 5), r.n(3, 4), r.n(4, 5)],
                                  dict(beta=0.5, alpha=2.0)), True),
    ("trace", "trace", lambda r: ([r.n(4, 4)], {}), True),
    ("trace_offset", "trace", lambda r: ([r.n(2, 4, 4)], dict(
        offset=1, axis1=1, axis2=2)), True),
    ("kron", "kron", lambda r: ([r.n(2, 3), r.n(3, 2)], {}), True),
    ("cumsum", "cumsum", lambda r: ([r.n(3, 4)], {}), True),
    ("cumsum_axis", "cumsum", lambda r: ([r.n(3, 4)], dict(axis=1)), True),
    ("cumprod", "cumprod", lambda r: ([r.u(3, 4, lo=0.5, hi=1.5)],
                                      dict(dim=1)), True),
    ("cumprod_flat", "cumprod", lambda r: ([r.u(3, 4, lo=0.5, hi=1.5)], {}),
     True),
    ("cummax", "cummax", lambda r: ([r.n(3, 4)], {}), True),
    ("cummax_axis0", "cummax", lambda r: ([r.n(3, 4)], dict(axis=0)), True),
    ("cummin", "cummin", lambda r: ([r.n(3, 4)], dict(axis=1)), True),
    ("diff", "diff", lambda r: ([r.n(3, 5)], {}), True),
    ("diff_n2_axis0", "diff", lambda r: ([r.n(4, 3)], dict(n=2, axis=0)),
     True),
    ("multiplex", "multiplex", lambda r: (
        [[r.n(4, 3), r.n(4, 3), r.n(4, 3)],
         np.array([[2], [0], [1], [2]], np.int64)], {}), False),
]


@pytest.mark.parametrize("case", CASES, ids=ids(CASES))
def test_op_against_reference(case):
    run_case(case)


def test_every_math_op_has_a_case():
    names = {c[1] for c in CASES if isinstance(c[1], str)}
    from paddle_tpu.ops import math as ref_math

    missing = set(ref_math.__all__) - names - {"increment", "rsqrt_"}
    assert missing == set()


def test_increment_and_rsqrt_inplace():
    a = np.array([1.0, 4.0], np.float32)
    x, y = pt.to_tensor(a), pp.to_tensor(a)
    pt.increment(x, 2.0)
    pp.increment(y, 2.0)
    np.testing.assert_allclose(y.numpy(), x.numpy())
    pt.ops.math.rsqrt_(x)
    pp.ops.math.rsqrt_(y)
    np.testing.assert_allclose(y.numpy(), x.numpy(), rtol=1e-6)
    z = pp.to_tensor(a, stop_gradient=False) * 2
    with pytest.raises(ValueError, match="non-leaf"):
        pp.increment(z)


def test_gammainc_gradient_in_y():
    """The port differentiates ``gammainc`` in ``y`` (torch has no
    derivative in ``x``); ``y``'s gradient matches the reference's."""
    r = R("gammainc_grad")
    a, xv = r.u(5, lo=0.5, hi=3), r.u(5, lo=0.2, hi=3)
    xr = pt.to_tensor(xv, stop_gradient=False)
    pt.sum(pt.gammainc(pt.to_tensor(a), xr)).backward()
    xp = pp.to_tensor(xv, stop_gradient=False)
    pp.gammainc(pp.to_tensor(a), xp).sum().backward()
    np.testing.assert_allclose(xp.grad.numpy(), xr.grad.numpy(), rtol=2e-4,
                               atol=1e-5)


def test_int_results_keep_int64():
    """Divergence: integer results are int64 in the port, int32 in the
    reference (no 64-bit types there); the values agree."""
    a = np.array([1, 2, 3], np.int64)
    assert pp.add(pp.to_tensor(a), 1).dtype == torch.int64
    assert str(pt.add(pt.to_tensor(a), 1).dtype) == "int32"
