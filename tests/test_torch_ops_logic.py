"""``ops/logic.py`` of the port against the JAX package's: comparisons,
logical and bitwise ops (``tests/test_ops_basic.py``'s compare cases among
them), closeness and the tensor predicates."""

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as pp
from torch_ops_common import R, ids, on_cpu, run_case  # noqa: F401

_CMP = ("equal", "not_equal", "greater_than", "greater_equal", "less_than",
        "less_equal")


def _pair(r):
    a = r.i(3, 4, lo=0, hi=3).astype(np.float32)
    return [a, r.i(3, 4, lo=0, hi=3).astype(np.float32)]


CASES = [(n, n, lambda r: (_pair(r), {}), False) for n in _CMP]
CASES += [(n + "_scalar", n, lambda r: ([_pair(r)[0], 1.0], {}), False)
          for n in _CMP]
CASES += [
    (n, n, lambda r: ([r.b(3, 4), r.b(3, 4)], {}), False)
    for n in ("logical_and", "logical_or", "logical_xor")
]
CASES += [
    (n, n, lambda r: ([r.i(3, 4, hi=16), r.i(3, 4, hi=16)], {}), False)
    for n in ("bitwise_and", "bitwise_or", "bitwise_xor")
]
CASES += [
    ("logical_and_float", "logical_and", lambda r: (
        [r.i(3, 4, hi=2).astype(np.float32), r.b(3, 4)], {}), False),
    ("logical_not", "logical_not", lambda r: ([r.b(3, 4)], {}), False),
    ("bitwise_not", "bitwise_not", lambda r: ([r.i(3, 4, lo=-8, hi=8)], {}),
     False),
    ("bitwise_not_bool", "bitwise_not", lambda r: ([r.b(3, 4)], {}), False),
    ("isclose", "isclose", lambda r: (
        [np.array([1.0, 1.0 + 1e-6, 2.0, np.nan], np.float32),
         np.array([1.0, 1.0, 2.1, np.nan], np.float32)], {}), False),
    ("isclose_equal_nan", "isclose", lambda r: (
        [np.array([1.0, np.nan], np.float32),
         np.array([1.1, np.nan], np.float32)],
        dict(rtol=0.2, equal_nan=True)), False),
    ("allclose", "allclose", lambda r: (
        [np.array([1.0, 2.0], np.float32),
         np.array([1.0, 2.0 + 1e-6], np.float32)], {}), False),
    ("allclose_false", "allclose", lambda r: (
        [np.array([1.0, 2.0], np.float32),
         np.array([1.0, 2.1], np.float32)], {}), False),
    ("equal_all", "equal_all", lambda r: (
        [np.array([1, 2], np.int64), np.array([1, 2], np.int64)], {}), False),
    ("equal_all_false", "equal_all", lambda r: (
        [np.array([1, 2], np.int64), np.array([1, 3], np.int64)], {}), False),
    ("is_empty", "is_empty", lambda r: ([np.zeros((0, 3), np.float32)], {}),
     False),
    ("is_empty_false", "is_empty", lambda r: ([r.n(2)], {}), False),
]


@pytest.mark.parametrize("case", CASES, ids=ids(CASES))
def test_op_against_reference(case):
    run_case(case)


def test_every_logic_op_has_a_case():
    from paddle_tpu.ops import logic as ref

    assert set(ref.__all__) - {c[1] for c in CASES} == {"is_tensor"}


def test_is_tensor():
    assert pp.is_tensor(pp.to_tensor([1.0]))
    assert pp.is_tensor(torch.ones(2))  # a plain torch tensor is one too
    assert not pp.is_tensor(np.ones(2))
    assert pt.is_tensor(pt.to_tensor([1.0])) and not pt.is_tensor([1.0])


def test_comparison_dunders():
    a = R("dunders").i(3, 4, hi=3)
    x, y = pp.to_tensor(a), pt.to_tensor(a)
    for op in ("__eq__", "__ne__", "__lt__", "__le__", "__gt__", "__ge__"):
        np.testing.assert_array_equal(getattr(x, op)(1).numpy(),
                                      getattr(y, op)(1).numpy())
    np.testing.assert_array_equal((~(x > 0)).numpy(), (~(y > 0)).numpy())
