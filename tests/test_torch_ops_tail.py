"""``ops/tail.py`` of the port against the JAX package's: the long-tail
ops on the same seeded inputs (``tests/test_tail_ops.py``'s numeric cases
among them), outputs and input gradients."""

import numpy as np
import pytest
import torch

import paddle_tpu_torch as pp
from torch_ops_common import ids, on_cpu, run_case  # noqa: F401

I64 = np.int64


def _cplx(r, *s):
    return (r.n(*s) + 1j * r.n(*s)).astype(np.complex64)


CASES = [
    ("vander", "vander", lambda r: ([r.n(4)], {}), False),
    ("vander_n_increasing", "vander", lambda r: ([r.n(3)], dict(
        n=5, increasing=True)), False),
    ("frexp", "frexp", lambda r: ([r.n(3, 4) * 10], {}), False),
    ("ldexp", "ldexp", lambda r: ([r.n(3, 4), r.i(3, 4, lo=-4, hi=4)], {}),
     True),
    ("ldexp_large_exponent", "ldexp", lambda r: (
        [np.array([1e-30, 2.0], np.float32), np.array([130, -3], I64)], {}),
     False),
    ("copysign", "copysign", lambda r: ([r.n(3, 4), r.n(3, 4)], {}), True),
    ("nextafter", "nextafter", lambda r: ([r.n(3, 4), r.n(3, 4)], {}), False),
    ("heaviside", "heaviside", lambda r: (
        [np.array([-1.0, 0.0, 2.0, np.nan], np.float32),
         np.array([0.5, 0.5, 0.5, 0.5], np.float32)], {}), False),
    ("trapezoid", "trapezoid", lambda r: ([r.n(3, 5)], {}), True),
    ("trapezoid_x", "trapezoid", lambda r: ([r.n(3, 5), np.sort(r.n(5))],
                                            {}), True),
    ("trapezoid_dx_axis0", "trapezoid", lambda r: ([r.n(4, 3)], dict(
        dx=0.5, axis=0)), True),
    ("cumulative_trapezoid", "cumulative_trapezoid", lambda r: (
        [r.n(3, 5)], {}), True),
    ("cumulative_trapezoid_x", "cumulative_trapezoid", lambda r: (
        [r.n(3, 5), np.sort(r.n(5))], {}), True),
    ("logcumsumexp", "logcumsumexp", lambda r: ([r.n(3, 4)], {}), True),
    ("logcumsumexp_axis", "logcumsumexp", lambda r: ([r.n(3, 4)], dict(
        axis=0)), True),
    ("index_fill", "index_fill", lambda r: ([r.n(4, 3), np.array([0, 2], I64),
                                             0, 9.0], {}), True),
    ("index_fill_negative", "index_fill", lambda r: (
        [r.n(4, 3), np.array([-1], I64), 1, -2.0], {}), True),
    ("masked_scatter", "masked_scatter", lambda r: (
        [r.n(3, 4), r.b(3, 4), r.n(12)], {}), True),
    ("diag_embed", "diag_embed", lambda r: ([r.n(2, 3)], {}), True),
    ("diag_embed_offset", "diag_embed", lambda r: ([r.n(2, 3)], dict(
        offset=1)), True),
    ("diag_embed_dims", "diag_embed", lambda r: ([r.n(2, 3)], dict(
        offset=-1, dim1=0, dim2=2)), True),
    ("take", "take", lambda r: ([r.n(3, 4), np.array([0, 5, -1, 11], I64)],
                                {}), True),
    ("take_wrap", "take", lambda r: ([r.n(3, 4), np.array([13, -14], I64)],
                                     dict(mode="wrap")), True),
    ("take_clip", "take", lambda r: ([r.n(3, 4), np.array([20, -1], I64)],
                                     dict(mode="clip")), True),
    ("select_scatter", "select_scatter", lambda r: ([r.n(3, 4), r.n(4)],
                                                    dict(axis=0, index=1)),
     True),
    ("diagonal_scatter", "diagonal_scatter", lambda r: ([r.n(3, 4), r.n(3)],
                                                        {}), True),
    ("diagonal_scatter_offset", "diagonal_scatter", lambda r: (
        [r.n(3, 4), r.n(2)], dict(offset=2)), True),
    ("diagonal_scatter_batched", "diagonal_scatter", lambda r: (
        [r.n(2, 3, 3), r.n(2, 3)], dict(axis1=1, axis2=2)), True),
    ("unfold", "unfold", lambda r: ([r.n(3, 7)], dict(axis=1, size=3,
                                                      step=2)), True),
    ("unfold_axis0", "unfold", lambda r: ([r.n(5, 2)], dict(axis=0, size=2,
                                                            step=1)), True),
    ("slice_scatter", "slice_scatter", lambda r: (
        [r.n(4, 6), r.n(2, 2)], dict(axes=[0, 1], starts=[1, 0],
                                     ends=[3, 6], strides=[1, 3])), True),
    ("column_stack", "column_stack", lambda r: ([[r.n(3), r.n(3, 2)]], {}),
     True),
    ("row_stack", "row_stack", lambda r: ([[r.n(2, 3), r.n(3)]], {}), True),
    ("dstack", "dstack", lambda r: ([[r.n(2, 3), r.n(2, 3)]], {}), True),
    ("hstack", "hstack", lambda r: ([[r.n(2, 3), r.n(2, 1)]], {}), True),
    ("vstack", "vstack", lambda r: ([[r.n(2, 3), r.n(1, 3)]], {}), True),
    ("tensor_split", "tensor_split", lambda r: ([r.n(7, 2)], dict(
        num_or_indices=3)), True),
    ("tensor_split_indices", "tensor_split", lambda r: ([r.n(2, 7)], dict(
        num_or_indices=[2, 5], axis=1)), True),
    ("as_strided", "as_strided", lambda r: ([r.n(3, 4)], dict(
        shape=[3, 3], stride=[2, 1], offset=1)), True),
    ("nanquantile", "nanquantile", lambda r: (
        [np.where(r.b(3, 6), np.nan, r.n(3, 6)).astype(np.float32)],
        dict(q=0.4, axis=1)), True),
    ("msort", "msort", lambda r: ([r.n(4, 3)], {}), True),
    ("aminmax", "aminmax", lambda r: ([r.n(3, 4)], {}), True),
    ("aminmax_axis", "aminmax", lambda r: ([r.n(3, 4)], dict(axis=1,
                                                             keepdim=True)),
     True),
    ("positive", "positive", lambda r: ([r.n(3)], {}), True),
    ("negative", "negative", lambda r: ([r.n(3)], {}), True),
    ("signbit", "signbit", lambda r: ([r.n(5)], {}), False),
    ("sinc", "sinc", lambda r: ([r.n(3, 4)], {}), True),
    ("fix", "fix", lambda r: ([r.n(3, 4) * 3], {}), True),
    ("sgn", "sgn", lambda r: ([r.n(3, 4)], {}), True),
    ("sgn_complex", "sgn", lambda r: ([_cplx(r, 3)], {}), False),
    ("conj", "conj", lambda r: ([_cplx(r, 3)], {}), False),
    ("conj_real", "conj", lambda r: ([r.n(3)], {}), True),
    ("real", "real", lambda r: ([_cplx(r, 3)], {}), False),
    ("imag", "imag", lambda r: ([_cplx(r, 3)], {}), False),
    ("angle", "angle", lambda r: ([_cplx(r, 3)], {}), False),
    ("angle_real", "angle", lambda r: ([r.n(5)], {}), True),
    ("polar_grad", lambda pkg: lambda a, t: pkg.real(pkg.polar(a, t)),
     lambda r: ([r.u(3), r.n(3)], {}), True),
    ("complex_grad", lambda pkg: lambda a, b: pkg.imag(pkg.complex(a, b))
     + pkg.real(pkg.complex(a, b)) * 2.0, lambda r: ([r.n(3), r.n(3)], {}),
     True),
    ("real_imag_grad", lambda pkg: lambda a, b: pkg.real(
        pkg.complex(a, b) * pkg.complex(b, a)), lambda r: ([r.n(4), r.n(4)],
                                                          {}), True),
    ("polar", "polar", lambda r: ([r.u(3), r.n(3)], {}), False),
    ("complex", "complex", lambda r: ([r.n(3), r.n(3)], {}), False),
    ("complex_broadcast", "complex", lambda r: ([r.n(2, 3), r.n(3)], {}),
     False),
    ("is_complex", "is_complex", lambda r: ([_cplx(r, 2)], {}), False),
    ("is_integer", "is_integer", lambda r: ([r.i(2)], {}), False),
    ("is_floating_point", "is_floating_point", lambda r: ([r.n(2)], {}),
     False),
    ("isreal", "isreal", lambda r: ([np.array([1 + 0j, 1 + 1j],
                                              np.complex64)], {}), False),
    ("bitwise_left_shift", "bitwise_left_shift", lambda r: (
        [r.i(5, hi=16), r.i(5, hi=4)], {}), False),
    ("bitwise_right_shift", "bitwise_right_shift", lambda r: (
        [r.i(5, hi=64), r.i(5, hi=4)], {}), False),
    ("bitwise_invert", "bitwise_invert", lambda r: ([r.i(5, lo=-4, hi=4)],
                                                    {}), False),
    ("shard_index", "shard_index", lambda r: ([r.i(6, 1, hi=20)], dict(
        index_num=20, nshards=2, shard_id=1)), False),
    ("triu_indices", "triu_indices", lambda r: ([4, 5, 1], {}), False),
    ("tril_indices", "tril_indices", lambda r: ([4], dict(offset=-1)),
     False),
]


@pytest.mark.parametrize("case", CASES, ids=ids(CASES))
def test_op_against_reference(case):
    run_case(case)


def test_every_tail_op_has_a_case():
    from paddle_tpu.ops import tail as ref

    assert set(ref.__all__) - {c[1] for c in CASES} == set()


def test_masked_scatter_refuses_a_short_value():
    x = pp.to_tensor(np.zeros(4, np.float32))
    mask = pp.to_tensor(np.array([True, True, True, False]))
    with pytest.raises(ValueError, match="masked_scatter"):
        pp.masked_scatter(x, mask, pp.to_tensor(np.ones(2, np.float32)))


def test_take_raise_mode_refuses_out_of_range():
    x = pp.to_tensor(np.zeros((2, 2), np.float32))
    with pytest.raises(ValueError, match="take"):
        pp.take(x, pp.to_tensor(np.array([4], np.int64)))


def test_complex_tensors_stay_on_their_device():
    """Divergence: the reference keeps complex tensors on the host (its TPU
    transport moves none); the port's stay where they are made."""
    t = pp.to_tensor(np.array([1 + 2j], np.complex128))
    assert t.place == pp.device.expected_place()  # the CPU, set here
    assert t.dtype == torch.complex64  # complex128 data: complex64
    assert pp.real(t * 2).numpy().tolist() == [2.0]
