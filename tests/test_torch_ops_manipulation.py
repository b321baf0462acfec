"""``ops/manipulation.py`` of the port against the JAX package's: every
op's outputs and input gradients on the same seeded inputs (the shape,
gather/scatter, sort and search cases of ``tests/test_ops_basic.py``
among them), and the orders torch's defaults would change: ``argsort``
descending flips a stable ascending sort (the later index first among
ties), ``topk`` keeps the lower index first among ties (also for
``largest=False``), ``scatter`` adds repeated indices with
``overwrite=False`` and sets distinct ones with ``overwrite=True``."""

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as pp
from torch_ops_common import R, assert_close, ids, on_cpu, run_case, to_np  # noqa: F401

I64 = np.int64


def _c(cid, op, build, grad=True):
    return (cid, op, build, grad)


CASES = [
    _c("reshape", "reshape", lambda r: ([r.n(2, 3, 4)], dict(shape=[4, -1]))),
    _c("flatten", "flatten", lambda r: ([r.n(2, 3, 4)], {})),
    _c("flatten_range", "flatten", lambda r: ([r.n(2, 3, 4, 5)], dict(
        start_axis=1, stop_axis=2))),
    _c("unflatten", "unflatten", lambda r: ([r.n(2, 12)], dict(
        axis=1, shape=[3, -1]))),
    _c("transpose", "transpose", lambda r: ([r.n(2, 3, 4)], dict(
        perm=[2, 0, 1]))),
    _c("transpose_default", "transpose", lambda r: ([r.n(2, 3, 4)], {})),
    _c("moveaxis", "moveaxis", lambda r: ([r.n(2, 3, 4)], dict(
        source=0, destination=2))),
    _c("swapaxes", "swapaxes", lambda r: ([r.n(2, 3, 4)], dict(
        axis0=0, axis1=2))),
    _c("squeeze", "squeeze", lambda r: ([r.n(2, 1, 3, 1)], {})),
    _c("squeeze_axis_not_one", "squeeze", lambda r: ([r.n(2, 1, 3)], dict(
        axis=[0, 1]))),
    _c("unsqueeze", "unsqueeze", lambda r: ([r.n(2, 3)], dict(axis=1))),
    _c("unsqueeze_list", "unsqueeze", lambda r: ([r.n(2, 3)], dict(
        axis=[0, 3]))),
    _c("concat", "concat", lambda r: ([[r.n(2, 3), r.n(4, 3)]], {})),
    _c("concat_axis", "concat", lambda r: ([[r.n(2, 3), r.n(2, 1)]], dict(
        axis=1))),
    _c("stack", "stack", lambda r: ([[r.n(2, 3), r.n(2, 3)]], dict(axis=1))),
    _c("split", "split", lambda r: ([r.n(6, 4)], dict(num_or_sections=3))),
    _c("split_sections", "split", lambda r: ([r.n(6, 4)], dict(
        num_or_sections=[1, -1, 2], axis=0))),
    _c("split_axis", "split", lambda r: ([r.n(2, 6)], dict(
        num_or_sections=2, axis=1))),
    _c("chunk", "chunk", lambda r: ([r.n(6, 4)], dict(chunks=2, axis=1))),
    _c("dsplit", "dsplit", lambda r: ([r.n(2, 2, 4)], dict(
        num_or_sections=2))),
    _c("hsplit", "hsplit", lambda r: ([r.n(2, 4)], dict(num_or_sections=2))),
    _c("vsplit", "vsplit", lambda r: ([r.n(4, 2)], dict(num_or_sections=2))),
    _c("unbind", "unbind", lambda r: ([r.n(3, 4)], dict(axis=1))),
    _c("unstack", "unstack", lambda r: ([r.n(3, 4)], {})),
    _c("tile", "tile", lambda r: ([r.n(2, 3)], dict(repeat_times=[2, 1, 2]))),
    _c("expand", "expand", lambda r: ([r.n(1, 3)], dict(shape=[2, 4, 3]))),
    _c("expand_minus_one", "expand", lambda r: ([r.n(2, 1)], dict(
        shape=[-1, 3]))),
    _c("expand_as", "expand_as", lambda r: ([r.n(1, 3), r.n(4, 3)], {})),
    _c("broadcast_to", "broadcast_to", lambda r: ([r.n(3)], dict(
        shape=[2, 3]))),
    _c("broadcast_tensors", "broadcast_tensors", lambda r: (
        [[r.n(2, 1), r.n(1, 3)]], {})),
    _c("flip", "flip", lambda r: ([r.n(2, 3)], dict(axis=[0, 1]))),
    _c("flip_int", "flip", lambda r: ([r.n(2, 3)], dict(axis=1))),
    _c("rot90", "rot90", lambda r: ([r.n(2, 3)], dict(k=1))),
    _c("rot90_k3_axes", "rot90", lambda r: ([r.n(2, 3, 4)], dict(
        k=3, axes=[1, 2]))),
    _c("roll", "roll", lambda r: ([r.n(3, 4)], dict(shifts=1))),
    _c("roll_axis", "roll", lambda r: ([r.n(3, 4)], dict(shifts=-2, axis=1))),
    _c("gather", "gather", lambda r: ([r.n(5, 3), np.array([4, 0, 2, 0], I64)],
                                      {})),
    _c("gather_axis", "gather", lambda r: ([r.n(3, 5), np.array([4, 1], I64)],
                                           dict(axis=1))),
    _c("gather_nd", "gather_nd", lambda r: ([r.n(3, 4, 2), np.array(
        [[0, 1], [2, 3], [2, 3]], I64)], {})),
    _c("scatter_distinct", "scatter", lambda r: (
        [r.n(5, 3), np.array([1, 3], I64), r.n(2, 3)], {})),
    _c("scatter_add_repeated", "scatter", lambda r: (
        [r.n(5, 3), np.array([1, 3, 1, 1], I64), r.n(4, 3)],
        dict(overwrite=False))),
    _c("scatter_nd_add", "scatter_nd_add", lambda r: (
        [r.n(4, 3), np.array([[1], [2], [1]], I64), r.n(3, 3)], {})),
    _c("index_select", "index_select", lambda r: (
        [r.n(4, 3), np.array([3, 0, 0], I64)], dict(axis=0))),
    _c("index_select_axis1", "index_select", lambda r: (
        [r.n(4, 3), np.array([2, 1], I64)], dict(axis=1))),
    _c("index_sample", "index_sample", lambda r: (
        [r.n(3, 5), np.array([[0, 4], [1, 1], [3, 2]], I64)], {})),
    _c("index_add", "index_add", lambda r: (
        [r.n(4, 3), np.array([0, 2, 0], I64), 0, r.n(3, 3)], {})),
    _c("index_put", "index_put", lambda r: (
        [r.n(4, 3), (np.array([0, 2], I64), np.array([1, 1], I64)),
         r.n(2)], {})),
    _c("index_put_accumulate", "index_put", lambda r: (
        [r.n(4, 3), (np.array([0, 0, 2], I64), np.array([1, 1, 0], I64)),
         r.n(3)], dict(accumulate=True))),
    _c("masked_select", "masked_select", lambda r: ([r.n(3, 4), r.b(3, 4)],
                                                    {})),
    _c("masked_fill", "masked_fill", lambda r: ([r.n(3, 4), r.b(3, 4)],
                                                dict(value=2.5))),
    _c("where", "where", lambda r: ([r.b(3, 4), r.n(3, 4), r.n(3, 4)], {})),
    _c("where_scalar", "where", lambda r: ([r.b(3, 4), r.n(3, 4), 0.0], {})),
    _c("where_nonzero", "where", lambda r: ([r.b(3, 4)], {}), False),
    _c("nonzero", "nonzero", lambda r: ([r.b(3, 4)], {}), False),
    _c("nonzero_tuple", "nonzero", lambda r: ([r.b(3, 4)], dict(
        as_tuple=True)), False),
    _c("take_along_axis", "take_along_axis", lambda r: (
        [r.n(3, 4), np.array([[0, 3], [1, 1], [2, 0]], I64)], dict(axis=1))),
    _c("put_along_axis", "put_along_axis", lambda r: (
        [r.n(3, 4), np.array([[0], [3], [1]], I64), r.n(3, 1)], dict(
            axis=1))),
    _c("put_along_axis_add", "put_along_axis", lambda r: (
        [r.n(3, 4), np.array([[0, 2], [3, 1], [1, 0]], I64), r.n(3, 2)],
        dict(axis=1, reduce="add"))),
    _c("sort", "sort", lambda r: ([r.n(3, 5)], {})),
    _c("sort_descending_axis0", "sort", lambda r: ([r.n(4, 3)], dict(
        axis=0, descending=True))),
    _c("argsort", "argsort", lambda r: ([r.n(3, 5)], {}), False),
    _c("argsort_ties", "argsort", lambda r: ([r.i(3, 8, hi=3)], {}), False),
    _c("argsort_descending_ties", "argsort", lambda r: (
        [r.i(3, 8, hi=3)], dict(descending=True)), False),
    _c("topk", "topk", lambda r: ([r.n(3, 6)], dict(k=3))),
    _c("topk_ties", "topk", lambda r: ([r.i(3, 8, hi=3).astype(np.float32)],
                                       dict(k=4))),
    _c("topk_smallest_ties", "topk", lambda r: (
        [r.i(3, 8, hi=3).astype(np.float32)], dict(k=4, largest=False))),
    _c("topk_axis0", "topk", lambda r: ([r.n(5, 3)], dict(k=2, axis=0))),
    _c("unique", "unique", lambda r: ([r.i(10, hi=4)], {}), False),
    _c("unique_all", "unique", lambda r: ([r.i(10, hi=4)], dict(
        return_index=True, return_inverse=True, return_counts=True)), False),
    _c("unique_consecutive", "unique_consecutive", lambda r: (
        [np.array([1, 1, 2, 2, 3, 1, 1, 2], I64)], dict(
            return_inverse=True, return_counts=True)), False),
    _c("searchsorted", "searchsorted", lambda r: (
        [np.array([1.0, 2.0, 3.0, 5.0], np.float32), r.u(6, lo=0, hi=6)],
        {}), False),
    _c("searchsorted_right", "searchsorted", lambda r: (
        [np.array([1.0, 2.0, 3.0, 5.0], np.float32),
         np.array([2.0, 3.0, 0.5], np.float32)], dict(right=True)), False),
    _c("bucketize", "bucketize", lambda r: (
        [r.u(6, lo=0, hi=6), np.array([1.0, 2.0, 3.0, 5.0], np.float32)],
        {}), False),
    _c("pad", "pad", lambda r: ([r.n(1, 2, 3, 3)], dict(pad=[1, 1, 2, 0]))),
    _c("pad_reflect", "pad", lambda r: ([r.n(1, 2, 4, 4)], dict(
        pad=[1, 2, 1, 0], mode="reflect"))),
    _c("pad_full", "pad", lambda r: ([r.n(2, 3)], dict(pad=[1, 0, 0, 2],
                                                       value=1.5))),
    _c("repeat_interleave", "repeat_interleave", lambda r: ([r.n(2, 3)],
                                                            dict(repeats=2))),
    _c("repeat_interleave_axis", "repeat_interleave", lambda r: (
        [r.n(2, 3)], dict(repeats=3, axis=1))),
    _c("diagonal", "diagonal", lambda r: ([r.n(3, 4)], {})),
    _c("diagonal_offset", "diagonal", lambda r: ([r.n(2, 3, 4)], dict(
        offset=-1, axis1=1, axis2=2))),
    _c("tensordot", "tensordot", lambda r: ([r.n(2, 3, 4), r.n(3, 4, 5)],
                                            {})),
    _c("tensordot_axes", "tensordot", lambda r: (
        [r.n(2, 3, 4), r.n(4, 3)], dict(axes=[[1, 2], [1, 0]]))),
    _c("einsum", "einsum", lambda r: (["ij,jk->ik", r.n(2, 3), r.n(3, 4)],
                                      {})),
    _c("einsum_batch", "einsum", lambda r: (
        ["bij,bjk->bik", r.n(2, 2, 3), r.n(2, 3, 4)], {})),
    _c("strided_slice", "strided_slice", lambda r: ([r.n(5, 6)], dict(
        axes=[0, 1], starts=[1, 0], ends=[5, 6], strides=[2, 3]))),
    _c("strided_slice_negative", "strided_slice", lambda r: ([r.n(5, 6)],
        dict(axes=[1], starts=[5], ends=[0], strides=[-2]))),
    _c("crop", "crop", lambda r: ([r.n(4, 5)], dict(shape=[2, 3],
                                                    offsets=[1, 2]))),
    _c("crop_minus_one", "crop", lambda r: ([r.n(4, 5)], dict(
        shape=[-1, 2], offsets=[1, 0]))),
    _c("as_real", "as_real", lambda r: ([(r.n(2, 3) + 1j * r.n(2, 3))
                                          .astype(np.complex64)], {}), False),
    _c("as_complex", "as_complex", lambda r: ([r.n(2, 3, 2)], {}), False),
    _c("view", "view", lambda r: ([r.n(2, 6)], dict(shape_or_dtype=[3, 4]))),
    _c("view_dtype", "view", lambda r: ([r.n(2, 3)], dict(
        shape_or_dtype="int32")), False),
    _c("view_as", "view_as", lambda r: ([r.n(2, 6), r.n(4, 3)], {})),
    _c("atleast_1d", "atleast_1d", lambda r: ([np.array(3.0, np.float32)],
                                                {})),
    _c("atleast_2d", "atleast_2d", lambda r: ([r.n(3)], {})),
    _c("atleast_3d", "atleast_3d", lambda r: ([r.n(2, 3)], {})),
    _c("numel", "numel", lambda r: ([r.n(2, 3)], {}), False),
    _c("rank", "rank", lambda r: ([r.n(2, 3)], {}), False),
    _c("block_diag", "block_diag", lambda r: ([[r.n(2, 2), r.n(1, 3)]], {})),
    _c("combinations", "combinations", lambda r: ([r.n(4)], {})),
    _c("combinations_replace", "combinations", lambda r: ([r.n(3)], dict(
        r=2, with_replacement=True))),
    _c("cartesian_prod", "cartesian_prod", lambda r: ([[r.n(2), r.n(3)]],
                                                      {})),
    _c("tolist", "tolist", lambda r: ([r.n(2, 3)], {}), False),
]


@pytest.mark.parametrize("case", CASES, ids=ids(CASES))
def test_op_against_reference(case):
    run_case(case)


def test_every_manipulation_op_has_a_case():
    from paddle_tpu.ops import manipulation as ref

    done = {c[1] for c in CASES}
    assert set(ref.__all__) - done - {"reshape_", "squeeze_",
                                      "unsqueeze_"} == set()


def test_inplace_shape_ops():
    a = R("inplace").n(2, 1, 3)
    for name, args in (("reshape_", ([3, 2],)), ("squeeze_", (1,)),
                       ("unsqueeze_", (0,))):
        x, y = pt.to_tensor(a), pp.to_tensor(a)
        getattr(pt, name)(x, *args)
        getattr(pp, name)(y, *args)
        assert list(y.shape) == x.shape
        np.testing.assert_array_equal(y.numpy(), x.numpy())


def test_argsort_descending_puts_later_ties_first():
    a = np.array([2, 1, 2, 3, 1, 2], np.int64)
    got = pp.argsort(pp.to_tensor(a), descending=True).numpy()
    want = pt.argsort(pt.to_tensor(a), descending=True).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [3, 5, 2, 0, 4, 1])


def test_topk_ties_keep_the_lower_index():
    a = np.array([[1.0, 3.0, 3.0, 0.0, 3.0, 0.0]], np.float32)
    for largest, want_idx in ((True, [1, 2, 4]), (False, [3, 5, 0])):
        vp, ip = pp.topk(pp.to_tensor(a), 3, largest=largest)
        vr, ir = pt.topk(pt.to_tensor(a), 3, largest=largest)
        assert_close(vp, vr)
        assert_close(ip, ir)
        np.testing.assert_array_equal(ip.numpy()[0], want_idx)


def test_scatter_repeated_indices():
    """``overwrite=False`` adds every update of a repeated row; with
    ``overwrite=True`` the rows are distinct (a repeated row has no defined
    winner in either package)."""
    x = np.zeros((4, 2), np.float32)
    idx = np.array([1, 1, 3, 1], np.int64)
    upd = np.arange(8, dtype=np.float32).reshape(4, 2)
    got = pp.scatter(pp.to_tensor(x), pp.to_tensor(idx), pp.to_tensor(upd),
                     overwrite=False)
    want = pt.scatter(pt.to_tensor(x), pt.to_tensor(idx), pt.to_tensor(upd),
                      overwrite=False)
    assert_close(got, want)
    np.testing.assert_array_equal(got.numpy()[1], [0 + 2 + 6, 1 + 3 + 7])


def test_split_and_transpose_methods_take_both_forms():
    """A script's ``x.split(3)`` cuts 3 pieces (Paddle); torch's code,
    and a call with ``dim=``, cuts pieces of 3 (torch). ``transpose``
    takes a permutation or torch's two dims."""
    x = pp.to_tensor(np.arange(12, dtype=np.float32).reshape(2, 6))
    assert [p.shape[1] for p in x.split(3, axis=1)] == [2, 2, 2]
    assert [p.shape[1] for p in x.split(3, dim=1)] == [3, 3]
    assert [p.shape[1] for p in torch.split(x, 3, 1)] == [3, 3]
    assert list(x.transpose([1, 0]).shape) == [6, 2]
    assert list(x.transpose(0, 1).shape) == [6, 2]
    idx = pp.to_tensor(np.array([[1], [0]], np.int64))
    assert x.gather(1, idx).numpy().tolist() == [[1.0], [6.0]]  # torch
    assert list(x.gather(idx.reshape([-1])).shape) == [2, 6]  # paddle rows


@pytest.mark.parametrize("op", ["gather", "index_select"])
def test_negative_index_wraps(op):
    """A negative index counts from the end of the axis, as ``jnp.take``
    reads it, in the output and in the gradient."""
    a = np.arange(10, dtype=np.float32).reshape(2, 5)
    idx = np.array([-1, 2], np.int64)
    xr = pt.to_tensor(a, stop_gradient=False)
    xp = pp.to_tensor(a, place="cpu", stop_gradient=False)
    want = getattr(pt, op)(xr, pt.to_tensor(idx), axis=1)
    got = getattr(pp, op)(xp, pp.to_tensor(idx, place="cpu"), axis=1)
    np.testing.assert_array_equal(to_np(want), [[4, 2], [9, 7]])
    np.testing.assert_array_equal(to_np(got), to_np(want))
    w = np.array([[1.0, 2.0], [3.0, 4.0]], np.float32)
    pt.sum(pt.multiply(want, pt.to_tensor(w))).backward()
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_array_equal(to_np(xp.grad), to_np(xr.grad))
    assert to_np(xp.grad)[0, 4] == 1.0 and to_np(xp.grad)[1, 4] == 3.0
