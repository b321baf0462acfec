"""``ops/reduction.py`` of the port against the JAX package's: every op's
outputs and input gradients on the same seeded inputs (the reduction
cases of ``tests/test_ops_basic.py`` among them), and the semantics where
torch's defaults differ: ``median`` averages the two middle values, and
``mode`` takes the first-occurring value among the most frequent ones."""

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as pp
from torch_ops_common import R, assert_close, ids, on_cpu, run_case  # noqa: F401

X = (3, 4, 5)


def _c(cid, op, kw, grad=True, make=None):
    def build(r):
        return [make(r) if make else r.n(*X)], dict(kw)
    return (cid, op, build, grad)


CASES = [
    _c("sum", "sum", {}),
    _c("sum_axis", "sum", dict(axis=1)),
    _c("sum_axes_keepdim", "sum", dict(axis=[0, 2], keepdim=True)),
    _c("sum_bool", "sum", {}, False, lambda r: r.b(3, 4)),
    _c("mean", "mean", {}),
    _c("mean_axis_keepdim", "mean", dict(axis=-1, keepdim=True)),
    _c("mean_int", "mean", dict(axis=0), False, lambda r: r.i(3, 4)),
    _c("max", "max", {}),
    _c("max_axis", "max", dict(axis=1)),
    _c("min_axes", "min", dict(axis=[1, 2], keepdim=True)),
    _c("amax", "amax", dict(axis=0)),
    _c("amin", "amin", dict(axis=2)),
    _c("prod", "prod", {}, True, lambda r: r.u(2, 3, lo=0.5, hi=1.5)),
    _c("prod_axes", "prod", dict(axis=[0, 2], keepdim=True)),
    _c("prod_keepdim_all", "prod", dict(keepdim=True), True,
       lambda r: r.u(2, 3, lo=0.5, hi=1.5)),
    _c("std", "std", {}),
    _c("std_axis_biased", "std", dict(axis=1, unbiased=False)),
    _c("var", "var", dict(axis=[0, 1])),
    _c("var_keepdim", "var", dict(axis=2, keepdim=True)),
    _c("argmax", "argmax", {}, False),
    _c("argmax_axis_keepdim", "argmax", dict(axis=1, keepdim=True), False),
    _c("argmin_axis", "argmin", dict(axis=-1), False),
    _c("all", "all", {}, False, lambda r: r.b(3, 4)),
    _c("all_axis", "all", dict(axis=1), False, lambda r: r.b(3, 4)),
    _c("any_axis_keepdim", "any", dict(axis=0, keepdim=True), False,
       lambda r: r.b(3, 4)),
    _c("all_float", "all", {}, False, lambda r: r.i(3, 4, lo=0, hi=2)
       .astype(np.float32)),
    _c("count_nonzero", "count_nonzero", {}, False,
       lambda r: r.i(3, 4, lo=0, hi=2)),
    _c("count_nonzero_axis", "count_nonzero", dict(axis=1, keepdim=True),
       False, lambda r: r.i(3, 4, lo=0, hi=2)),
    _c("logsumexp", "logsumexp", {}),
    _c("logsumexp_axis", "logsumexp", dict(axis=1, keepdim=True)),
    _c("median", "median", {}),
    _c("median_axis_even", "median", dict(axis=1)),
    _c("median_axis_odd_keepdim", "median", dict(axis=2, keepdim=True)),
    _c("median_int", "median", dict(axis=1), False, lambda r: r.i(3, 4)),
    _c("nanmedian", "nanmedian", dict(axis=1), True,
       lambda r: np.where(r.b(3, 4), np.nan, r.n(3, 4)).astype(np.float32)),
    _c("nanmedian_all", "nanmedian", {}, True,
       lambda r: np.where(r.b(3, 4), np.nan, r.n(3, 4)).astype(np.float32)),
    _c("nansum", "nansum", dict(axis=0), True,
       lambda r: np.where(r.b(3, 4), np.nan, r.n(3, 4)).astype(np.float32)),
    _c("nanmean", "nanmean", {}, True,
       lambda r: np.where(r.b(3, 4), np.nan, r.n(3, 4)).astype(np.float32)),
    _c("norm", "norm", {}),
    _c("norm_axis", "norm", dict(axis=1)),
    _c("norm_p1", "norm", dict(p=1, axis=-1, keepdim=True)),
    _c("norm_p3", "norm", dict(p=3, axis=[0, 1])),
    _c("norm_inf", "norm", dict(p=float("inf"), axis=1)),
    _c("norm_neg_inf", "norm", dict(p=float("-inf"), axis=0)),
    _c("norm_fro", "norm", dict(p="fro", axis=[1, 2])),
    _c("quantile", "quantile", dict(q=0.3)),
    _c("quantile_array_axis", "quantile",
       dict(q=np.array([0.1, 0.5, 0.9], np.float32), axis=1)),
    _c("quantile_keepdim", "quantile", dict(q=0.75, axis=2, keepdim=True)),
    _c("mode", "mode", {}, False, lambda r: r.i(3, 7, lo=0, hi=3)),
    _c("mode_axis0_keepdim", "mode", dict(axis=0, keepdim=True), False,
       lambda r: r.i(6, 4, lo=0, hi=3)),
    _c("kthvalue", "kthvalue", dict(k=2), True),
    _c("kthvalue_axis_keepdim", "kthvalue", dict(k=3, axis=1, keepdim=True),
       True),
    _c("kthvalue_ties", "kthvalue", dict(k=2), False,
       lambda r: r.i(3, 6, lo=0, hi=3)),
]


@pytest.mark.parametrize("case", CASES, ids=ids(CASES))
def test_op_against_reference(case):
    run_case(case)


def test_every_reduction_op_has_a_case():
    from paddle_tpu.ops import reduction as ref_red

    assert set(ref_red.__all__) - {c[1] for c in CASES} == set()


def _both(name, a, **kw):
    return (getattr(pp, name)(pp.to_tensor(a), **kw),
            getattr(pt, name)(pt.to_tensor(a), **kw))


def test_median_averages_the_two_middle_values():
    """``torch.median`` returns the lower middle value; the reference (and
    the port) average the two."""
    a = np.array([[4.0, 1.0, 3.0, 2.0], [5.0, 5.0, 1.0, 9.0]], np.float32)
    got, want = _both("median", a, axis=1)
    assert_close(got, want)
    np.testing.assert_array_equal(got.numpy(), [2.5, 5.0])
    assert torch.median(torch.from_numpy(a), 1).values.tolist() == [2.0, 5.0]
    got, want = _both("median", np.array([1.0, np.nan, 3.0], np.float32))
    assert np.isnan(got.numpy()) and np.isnan(want.numpy())
    got, want = _both("nanmedian", np.array([1.0, np.nan, 3.0, 8.0],
                                            np.float32))
    assert float(got) == float(want) == 3.0


def test_mode_takes_the_first_of_the_most_frequent():
    """Among values as frequent as each other, the first to occur wins,
    with the index of its first occurrence."""
    a = np.array([[3, 1, 1, 3, 2], [2, 2, 0, 0, 1], [4, 0, 4, 0, 0]],
                 np.int64)
    (vp, ip), (vr, ir) = _both("mode", a)
    assert_close(vp, vr)
    assert_close(ip, ir)
    np.testing.assert_array_equal(vp.numpy(), [3, 2, 0])
    np.testing.assert_array_equal(ip.numpy(), [0, 0, 1])


def test_reduction_methods_take_both_forms():
    """``x.sum(axis=...)`` is the reference's method; ``x.sum(dim=...)``
    (a keyword of torch's) is torch's."""
    a = R("methods").n(3, 4)
    x = pp.to_tensor(a)
    np.testing.assert_allclose(x.sum(axis=1).numpy(), a.sum(1), rtol=1e-6)
    np.testing.assert_allclose(x.sum(dim=1, keepdim=True).numpy(),
                               a.sum(1, keepdims=True), rtol=1e-6)
    assert isinstance(x.max(1), torch.Tensor)  # paddle: the values
    vals, idx = x.max(dim=1)  # torch: (values, indices)
    np.testing.assert_array_equal(idx.numpy(), a.argmax(1))
    np.testing.assert_allclose(x.mean(axis=[0, 1]).numpy(), a.mean(),
                               rtol=1e-6)
