"""The port's op registry, dispatch and ``_C_ops`` against the JAX
package's: the two ``all_ops()`` lists are equal, every registered op runs
at default arguments on a seeded 2 x 3 x 4 input through both packages
(values equal; the random ops and the decompositions by shape and dtype,
their values are held in ``test_torch_ops_creation.py`` and
``test_torch_ops_linalg.py``), and ``run_op``'s duties: the AMP cast by
op name, ``FLAGS_check_nan_inf`` and the profiler span."""

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as pp
from paddle_tpu_torch.experiments.op_corpus import FFT, default_call
from torch_ops_common import R, assert_close, on_cpu, to_np  # noqa: F401

ALL = sorted(pt.all_ops())

# drawn or decomposed: compared by shape and dtype here
_SHAPE_ONLY = {"rand", "randn", "randint", "randperm", "uniform", "normal",
               "bernoulli", "multinomial", "poisson", "svd_lowrank",
               "pca_lowrank", "svd", "qr", "eigh", "eig", "eigvals"}


def _special(name, P, X, XI, M):
    """The call of ``name`` in package ``P`` at default arguments beyond
    what it requires: X a float [2, 3, 4] tensor, XI an int one, M a
    [2, 3, 3] batch of symmetric positive-definite matrices."""
    t = P.to_tensor
    i64 = lambda *v: t(np.asarray(v, np.int64))
    mt = P.transpose(X, [0, 2, 1])
    table = {
        "addmm": lambda: P.addmm(X[0, :, :3], X[0], mt[0]),
        "crop": lambda: P.crop(X, [1, 2, 2], [1, 0, 1]),
        "arange": lambda: P.arange(5),
        "as_strided": lambda: P.as_strided(X, [2, 2], [3, 1]),
        "bmm": lambda: P.bmm(X, mt),
        "broadcast_to": lambda: P.broadcast_to(X, [2, 2, 3, 4]),
        "bucketize": lambda: P.bucketize(X, t(np.array([0.2, 0.5, 0.8],
                                                       np.float32))),
        "cdist": lambda: P.cdist(X, X * 2),
        "cholesky_solve": lambda: P.cholesky_solve(X[:, :, :3],
                                                   P.linalg.cholesky(M)),
        "chunk": lambda: P.chunk(X, 2, axis=2),
        "cumulative_trapezoid": lambda: P.cumulative_trapezoid(X),
        "diagonal_scatter": lambda: P.diagonal_scatter(X[0], X[0, 0, :3]),
        "dot": lambda: P.dot(X, X),
        "einsum": lambda: P.einsum("bij,bkj->bik", X, X),
        "empty": lambda: P.empty([2, 3]),
        "expand": lambda: P.expand(X, [2, 2, 3, 4]),
        "eye": lambda: P.eye(3),
        "fftfreq": lambda: P.fft.fftfreq(6),
        "flip": lambda: P.flip(X, 1),
        "full": lambda: P.full([2, 2], 1.5),
        "full_like": lambda: P.full_like(X, 2.0),
        "gather": lambda: P.gather(X, i64(1, 0)),
        "gather_nd": lambda: P.gather_nd(X, i64([0, 1], [1, 2])),
        "histogram": lambda: P.histogram(X),
        "histogramdd": lambda: P.histogramdd(X[0]),
        "householder_product": lambda: P.linalg.householder_product(
            mt[0], X[0, 0, :3]),
        "index_add": lambda: P.index_add(X, i64(0, 1), 2, X[:, :, :2]),
        "index_fill": lambda: P.index_fill(X, i64(1), 1, 0.5),
        "index_put": lambda: P.index_put(X, (i64(0, 1), i64(2, 0)), X[0, 0,
                                                                     :4]),
        "index_sample": lambda: P.index_sample(X[0], i64([0, 3], [1, 1],
                                                         [2, 0])),
        "index_select": lambda: P.index_select(X, i64(2, 0), axis=1),
        "kthvalue": lambda: P.kthvalue(X, 2),
        "lerp": lambda: P.lerp(X, X * 2, 0.25),
        "linspace": lambda: P.linspace(0.0, 1.0, 5),
        "logspace": lambda: P.logspace(0.0, 1.0, 4),
        "lstsq": lambda: P.linalg.lstsq(X[0], X[1]),
        "lu_unpack": lambda: P.linalg.lu_unpack(*P.linalg.lu(M)),
        "masked_fill": lambda: P.masked_fill(X, X > 0.5, 0.0),
        "masked_scatter": lambda: P.masked_scatter(X, X > 0.5, X * 10),
        "masked_select": lambda: P.masked_select(X, X > 0.5),
        "matmul": lambda: P.matmul(X, mt),
        "matrix_power": lambda: P.linalg.matrix_power(M, 2),
        "meshgrid": lambda: P.meshgrid(X[0, 0], X[0, :, 0]),
        "mm": lambda: P.mm(X[0], mt[0]),
        "moveaxis": lambda: P.moveaxis(X, 0, 2),
        "multiplex": lambda: P.multiplex([X[0], X[1]], i64([1], [0], [1])),
        "nanquantile": lambda: P.nanquantile(X, 0.5),
        "one_hot": lambda: P.one_hot(XI, 5),
        "ones": lambda: P.ones([2, 3]),
        "pad": lambda: P.pad(X, [1, 0]),
        "polygamma": lambda: P.polygamma(X, 1),
        "put_along_axis": lambda: P.put_along_axis(X, i64([[0]]), X[:1, :1,
                                                                    :1], 0),
        "quantile": lambda: P.quantile(X, 0.5),
        "rand": lambda: P.rand([2, 3]),
        "randint": lambda: P.randint(0, 5, [2, 3]),
        "randn": lambda: P.randn([2, 3]),
        "randperm": lambda: P.randperm(6),
        "renorm": lambda: P.renorm(X, 2, 0, 1.0),
        "repeat_interleave": lambda: P.repeat_interleave(X, 2),
        "reshape": lambda: P.reshape(X, [6, 4]),
        "rfftfreq": lambda: P.fft.rfftfreq(6),
        "roll": lambda: P.roll(X, 1),
        "scatter": lambda: P.scatter(X, i64(1, 0), X[:2] * 3),
        "scatter_nd_add": lambda: P.scatter_nd_add(X, i64([0], [0]), X[:2]),
        "searchsorted": lambda: P.searchsorted(t(np.array(
            [0.2, 0.5, 0.8], np.float32)), X),
        "select_scatter": lambda: P.select_scatter(X, X[:, 0], 1, 2),
        "shard_index": lambda: P.shard_index(XI, 5, 2, 0),
        "slice_scatter": lambda: P.slice_scatter(X, X[:, :1], [1], [0], [1],
                                                 [1]),
        "solve": lambda: P.linalg.solve(M, X[:, :, :3]),
        "split": lambda: P.split(X, 2, axis=2),
        "strided_slice": lambda: P.strided_slice(X, [2], [0], [4], [2]),
        "swapaxes": lambda: P.swapaxes(X, 0, 1),
        "take": lambda: P.take(X, i64(0, 23, -1)),
        "take_along_axis": lambda: P.take_along_axis(X, t(np.array(
            [[[0, 1]]], np.int64)), 2),
        "tensor_split": lambda: P.tensor_split(X, 3, axis=2),
        "tensordot": lambda: P.tensordot(X, X, axes=[[1, 2], [1, 2]]),
        "tile": lambda: P.tile(X, [1, 2]),
        "topk": lambda: P.topk(X, 2),
        "trapezoid": lambda: P.trapezoid(X),
        "triangular_solve": lambda: P.linalg.triangular_solve(
            M, X[:, :, :3]),
        "tril_indices": lambda: P.tril_indices(3),
        "triu_indices": lambda: P.triu_indices(3),
        "unflatten": lambda: P.unflatten(X, 2, [2, 2]),
        "unfold": lambda: P.unfold(X, 2, 2, 1),
        "uniform": lambda: P.uniform([2, 3]),
        "unsqueeze": lambda: P.unsqueeze(X, 0),
        "vander": lambda: P.vander(X[0, 0]),
        "where": lambda: P.where(X > 0.5, X, X * 0),
        "zeros": lambda: P.zeros([2, 3]),
        "normal": lambda: P.normal(shape=[2, 3]),
        "bernoulli": lambda: P.bernoulli(X),
        "multinomial": lambda: P.multinomial(X[0, 0]),
        "poisson": lambda: P.poisson(X),
        "concat": lambda: P.concat([X, X]),
        "stack": lambda: P.stack([X, X]),
        "column_stack": lambda: P.column_stack([X[0, 0], X[0, 1]]),
        "row_stack": lambda: P.row_stack([X[0], X[1]]),
        "dstack": lambda: P.dstack([X[0], X[1]]),
        "hstack": lambda: P.hstack([X[0], X[1]]),
        "vstack": lambda: P.vstack([X[0], X[1]]),
        "diag": lambda: P.diag(X[0]),
        "diagflat": lambda: P.diagflat(X[0]),
        "pdist": lambda: P.pdist(X[0]),
        "cov": lambda: P.linalg.cov(X[0]),
        "corrcoef": lambda: P.linalg.corrcoef(X[0]),
        "trace": lambda: P.trace(X[0]),
        "frexp": lambda: P.frexp(X),
        "svd_lowrank": lambda: P.linalg.svd_lowrank(X[0], q=2),
        "pca_lowrank": lambda: P.linalg.pca_lowrank(X[0], q=2),
        "ldexp": lambda: P.ldexp(X, XI),
        "bincount": lambda: P.bincount(XI.reshape([-1])),
        "hfft": lambda: P.fft.hfft(X),
        "irfft": lambda: P.fft.irfft(X),
        "irfft2": lambda: P.fft.irfft2(X),
        "irfftn": lambda: P.fft.irfftn(X),
    }
    for lin in ("cholesky", "inv", "det", "slogdet", "svd", "qr", "eigh",
                "eigvalsh", "eig", "eigvals", "pinv", "matrix_rank",
                "cond"):
        table.setdefault(lin, lambda lin=lin: getattr(P.linalg, lin)(M))
    return table.get(name)


def _call(name, P):
    r = R("sweep")
    x = r.u(2, 3, 4)
    y = r.u(2, 3, 4, lo=0.2, hi=1.2)
    xi, yi = r.i(2, 3, 4, hi=5), r.i(2, 3, 4, lo=1, hi=4)
    m = r.spd(3, (2,))
    t = P.to_tensor
    X, Y, XI, YI, M = t(x), t(y), t(xi), t(yi), t(m)
    special = _special(name, P, X, XI, M)
    if special is not None:
        return special()
    op = getattr(P.fft, name) if name in FFT else getattr(P, name)
    return default_call(op, name, X, Y, XI, YI)


def test_all_ops_lists_are_equal():
    # a custom C++ op registers as custom_<fn>; the reference's own
    # tests/test_cpp_extension.py leaves its ops in the registry of a
    # worker that runs several files, so those names are set aside
    def own(names):
        return [n for n in names if not n.startswith("custom_")]

    assert own(pp.all_ops()) == own(pt.all_ops())
    assert len(own(pp.all_ops())) == 303
    assert set(own(pp.ops.OPS)) == set(own(pt.ops.registry.OPS))
    for name in pp.all_ops():
        assert (pp.ops.get_op(name).differentiable
                == pt.ops.registry.get_op(name).differentiable), name


def _flat(v):
    if isinstance(v, (list, tuple)):
        for e in v:
            yield from _flat(e)
    else:
        yield v


@pytest.mark.parametrize("name", ALL)
def test_every_op_at_default_arguments(name):
    ref = list(_flat(_call(name, pt)))
    port = list(_flat(_call(name, pp)))
    assert len(ref) == len(port)
    for p, r in zip(port, ref):
        if name in _SHAPE_ONLY:
            assert to_np(p).shape == to_np(r).shape
            # numpy (the reference's eig) returns real eigenvalues when
            # every imaginary part is 0; torch keeps the complex type
            if name not in ("eig", "eigvals"):
                assert to_np(p).dtype.kind == to_np(r).dtype.kind
        else:
            assert_close(p, r, dict(rtol=1e-3, atol=1e-5), name)


def test_card_sweep_on_the_cpu():
    """Phase 6g (a)'s sweep (``experiments.op_corpus.op_sweep``) at a
    small size, the CPU standing in for the card: every registered op
    runs, forward and backward, and the random ops pass their checks."""
    from paddle_tpu_torch.experiments import op_corpus

    out = op_corpus.op_sweep("cpu", n=16, k=8, batch=2)
    assert out["held"] == 303
    assert set(out["ops"]) | set(out["random"]) == set(pp.all_ops())
    # the randomized decompositions draw anew on each device: by invariants
    assert out["max_err"] <= op_corpus.TOL
    assert all(out["ops"][n]["err"] == 0.0 for n in out["ops"]
               if n not in ("svd_lowrank", "pca_lowrank"))
    assert all(r["ok"] for r in out["random"].values())


def test_run_op_casts_by_op_name_under_auto_cast():
    """O1: a white-listed op (``matmul``) runs in bf16, a black-listed one
    (``exp``) in fp32, as in the reference's ``run_op``."""
    a = pp.to_tensor(R("amp").n(4, 4))
    with pp.amp.auto_cast(dtype="bfloat16"):
        assert pp.matmul(a, a).dtype == torch.bfloat16
        assert pp.exp(a.astype("bfloat16")).dtype == torch.float32
        assert pp.sin(a).dtype == torch.float32  # on neither list
    with pp.amp.auto_cast(dtype="bfloat16", level="O2"):
        assert pp.sin(a).dtype == torch.bfloat16
    ra = pt.to_tensor(R("amp").n(4, 4))
    with pt.amp.auto_cast(dtype="bfloat16"):
        assert str(pt.matmul(ra, ra).dtype) == "bfloat16"


def test_check_nan_inf_flag_names_the_op():
    a = pp.to_tensor(np.array([-1.0, 1.0], np.float32))
    assert np.isnan(pp.log(a).numpy()[0])
    pp.set_flags({"check_nan_inf": True})
    try:
        with pytest.raises(FloatingPointError, match="'log'"):
            pp.log(a)
        pp.exp(a)  # finite: no error
    finally:
        pp.set_flags({"check_nan_inf": False})
    assert pp.get_flags("check_nan_inf") == {"check_nan_inf": False}
    assert set(pp.get_flags()) == set(pt.get_flags())


def test_profiler_span_per_op():
    from paddle_tpu_torch.profiler import _hooks

    class Collector:
        def __init__(self):
            self.spans = []

        def _host_event(self, name, t0, t1, kind):
            self.spans.append((name, kind, t1 >= t0))

    c = Collector()
    _hooks.COLLECTORS.append(c)
    try:
        a = pp.to_tensor(np.ones((2, 2), np.float32))
        pp.matmul(pp.exp(a), a).sum()
    finally:
        _hooks.COLLECTORS.remove(c)
    assert [s[0] for s in c.spans] == ["exp", "matmul", "sum"]
    assert all(s[1] == "op" and s[2] for s in c.spans)


def test_static_and_distributed_wait_for_their_items():
    with pytest.raises(NotImplementedError, match="item 8"):
        pp.enable_static()
    with pytest.raises(NotImplementedError, match="item 8"):
        pp.jit.to_static(lambda x: x)
    with pytest.raises(NotImplementedError, match="item 8"):
        pp.static
    # the mesh and eager data-parallel halves of item 5 are ported; the
    # pipeline and the launcher still wait
    with pytest.raises(NotImplementedError, match="item 5"):
        pp.distributed.fleet.meta_parallel.PipelineLayer
    with pytest.raises(NotImplementedError, match="item 5"):
        pp.distributed.launch
    assert pp.in_dynamic_mode()


def test_c_ops_projection():
    """``_C_ops`` projects the registry: ``final_state_`` aliases and
    in-place ``_`` forms, as the reference's."""
    from paddle_tpu_torch import _C_ops

    a = R("cops").n(3, 4)
    b = R("cops2").n(4, 2)
    got = _C_ops.matmul(pp.to_tensor(a), pp.to_tensor(b), False, False)
    want = pt._C_ops.matmul(pt.to_tensor(a), pt.to_tensor(b), False, False)
    assert_close(got, want)
    assert_close(_C_ops.final_state_exp(pp.to_tensor(a)),
                 pt._C_ops.final_state_exp(pt.to_tensor(a)))
    x, y = pp.to_tensor(a), pt.to_tensor(a)
    out = _C_ops.reshape_(x, [4, 3])
    pt._C_ops.reshape_(y, [4, 3])
    assert out is x and list(x.shape) == y.shape
    assert_close(x, y)
    assert "matmul" in dir(_C_ops) and len(dir(_C_ops)) == 303
    with pytest.raises(AttributeError, match="no op"):
        _C_ops.not_an_op
    z = pp.to_tensor(a, stop_gradient=False) * 2
    with pytest.raises(ValueError, match="non-leaf"):
        _C_ops.exp_(z)
