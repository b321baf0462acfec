"""``ops/special.py`` of the port against the JAX package's: the
statistics and special functions on the same seeded inputs, with the
semantics torch's own functions would change: ``cdist`` with p = 2 in the
matmul form clamped at 0, ``histogram`` with ``min == max`` widened by
±0.5 and its last bin closed."""

import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as pp
from torch_ops_common import ids, on_cpu, run_case  # noqa: F401

I64 = np.int64

CASES = [
    ("bincount", "bincount", lambda r: ([r.i(12, hi=5)], {}), False),
    ("bincount_minlength", "bincount", lambda r: ([r.i(12, hi=5)], dict(
        minlength=8)), False),
    ("bincount_weights", "bincount", lambda r: ([r.i(12, hi=5), r.u(12)],
                                                {}), False),
    ("histogram", "histogram", lambda r: ([r.n(50)], dict(bins=7)), False),
    ("histogram_range", "histogram", lambda r: ([r.n(50)], dict(
        bins=5, min=-1.0, max=1.0)), False),
    ("histogram_edges_inclusive", "histogram", lambda r: (
        [np.array([0.0, 1.0, 2.0, 3.0, 4.0, 4.0, 5.0], np.float32)],
        dict(bins=4, min=0, max=4)), False),
    ("histogram_weight_density", "histogram", lambda r: (
        [r.n(40), ], dict(bins=6, density=True)), False),
    ("histogram_weighted", lambda pkg: lambda x, w: pkg.histogram(
        x, bins=4, weight=w), lambda r: ([r.n(30), r.u(30)], {}), False),
    ("histogram_constant", "histogram", lambda r: (
        [np.full((5,), 2.0, np.float32)], dict(bins=3)), False),
    ("histogramdd", "histogramdd", lambda r: ([r.n(40, 2)], dict(bins=3)),
     False),
    ("histogramdd_ranges", "histogramdd", lambda r: ([r.n(40, 3)], dict(
        bins=[2, 3, 4], ranges=[(-1, 1), (-2, 2), (0, 1)])), False),
    ("histogramdd_density", "histogramdd", lambda r: ([r.n(40, 2)], dict(
        bins=4, density=True)), False),
    ("cross", "cross", lambda r: ([r.n(4, 3), r.n(4, 3)], {}), True),
    ("cross_axis0", "cross", lambda r: ([r.n(3, 5), r.n(3, 5)], dict(
        axis=0)), True),
    ("cdist", "cdist", lambda r: ([r.n(4, 3), r.n(5, 3)], {}), True),
    ("cdist_batched", "cdist", lambda r: ([r.n(2, 4, 3), r.n(2, 5, 3)], {}),
     True),
    ("cdist_no_mm", "cdist", lambda r: ([r.n(4, 3), r.n(5, 3)], dict(
        compute_mode="donot_use_mm_for_euclid_dist")), True),
    ("cdist_p1", "cdist", lambda r: ([r.n(4, 3), r.n(5, 3)], dict(p=1.0)),
     True),
    ("cdist_p0", "cdist", lambda r: ([r.i(4, 3, hi=2).astype(np.float32),
                                      r.i(5, 3, hi=2).astype(np.float32)],
                                     dict(p=0.0)), False),
    ("cdist_inf", "cdist", lambda r: ([r.n(4, 3), r.n(5, 3)], dict(
        p=float("inf"))), True),
    ("pdist", "pdist", lambda r: ([r.n(5, 3)], {}), True),
    ("pdist_p1", "pdist", lambda r: ([r.n(5, 3)], dict(p=1.0)), True),
    ("pdist_inf", "pdist", lambda r: ([r.n(5, 3)], dict(p=float("inf"))),
     True),
    ("dist", "dist", lambda r: ([r.n(3, 4), r.n(3, 4)], {}), True),
    ("dist_p3", "dist", lambda r: ([r.n(3, 4), r.n(3, 4)], dict(p=3)), True),
    ("dist_inf", "dist", lambda r: ([r.n(3, 4), r.n(3, 4)], dict(
        p=float("inf"))), True),
    ("dist_p0", "dist", lambda r: ([r.n(3, 4), r.n(3, 4)], dict(p=0)),
     False),
    ("renorm", "renorm", lambda r: ([r.n(3, 4) * 3], dict(
        p=2, axis=0, max_norm=1.0)), True),
    ("renorm_axis1_p1", "renorm", lambda r: ([r.n(3, 4) * 3], dict(
        p=1, axis=1, max_norm=2.0)), True),
    ("i0", "i0", lambda r: ([r.n(3, 4)], {}), True),
    ("i0e", "i0e", lambda r: ([r.n(3, 4)], {}), True),
    ("i1", "i1", lambda r: ([r.n(3, 4)], {}), True),
    ("i1e", "i1e", lambda r: ([r.n(3, 4)], {}), True),
    ("polygamma0", "polygamma", lambda r: ([r.u(3, 4, lo=0.5, hi=3)], dict(
        n=0)), True),
    ("polygamma2", "polygamma", lambda r: ([r.u(3, 4, lo=0.5, hi=3)], dict(
        n=2)), True),
]


@pytest.mark.parametrize("case", CASES, ids=ids(CASES))
def test_op_against_reference(case):
    run_case(case)


def test_every_special_op_is_covered():
    from paddle_tpu.ops import special as ref

    done = {c[1] for c in CASES if isinstance(c[1], str)} | {"poisson"}
    assert set(ref.__all__) - done == set()


def test_cdist_uses_the_clamped_matmul_form():
    """Equal rows: ``a² + b² − 2ab`` may round below 0; clamped, the
    distance is 0 (sqrt of a negative would be NaN)."""
    a = np.array([[1e3, 1e-3, 7.0]], np.float32)
    got = pp.cdist(pp.to_tensor(a), pp.to_tensor(a)).numpy()
    want = pt.cdist(pt.to_tensor(a), pt.to_tensor(a)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0, 0] >= 0.0 and not np.isnan(got).any()


def test_histogram_widens_a_constant_range():
    a = np.full((4,), 3.0, np.float32)
    got = pp.histogram(pp.to_tensor(a), bins=2).numpy()
    want = pt.histogram(pt.to_tensor(a), bins=2).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [0.0, 4.0])  # [2.5, 3) [3, 3.5]


@pytest.mark.parametrize("pkg", [pt, pp], ids=["jax", "port"])
def test_poisson_by_distribution(pkg):
    pkg.seed(3)
    rates = np.full((20000,), 4.0, np.float32)
    v = pkg.poisson(pkg.to_tensor(rates)).numpy()
    assert v.min() >= 0 and np.all(v == np.round(v))
    assert abs(v.mean() - 4.0) < 0.1 and abs(v.var() - 4.0) < 0.25
