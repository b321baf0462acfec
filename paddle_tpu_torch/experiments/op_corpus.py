"""The tensor core and the op corpus on a device (``chip_smoke.py`` phase
6g).

- ``op_sweep(device)``: every name of ``all_ops()`` on ``device`` and on
  the CPU, on the same seeded inputs at working sizes (``N x N`` fp32 for
  the elementwise, reduction and manipulation ops, ``BATCH x K x K`` for
  the decompositions), outputs and the gradients of every differentiable
  op compared. The products and the reductions take zero-mean inputs, so
  that a rounding random in sign (TF32's) is not hidden under the size of
  a sum of positive terms. The decompositions are held by their invariants (the
  reconstruction, the singular values or eigenvalues; two solvers choose
  other signs), ``sort`` / ``argsort`` / ``topk`` / ``mode`` / ``unique``
  by integer-valued inputs that tie, the random ops by shape, dtype,
  range, moments and repetition under ``seed``. An op beyond ``TOL``
  (``SPECTRA_TOL`` for the spectra; its largest difference over the larger
  of 1 and its largest value) fails the sweep with its name.
- ``readme_phase(device)``: ``README.md``'s quickstart (lines 10-29, the
  two import lines naming this package; ``to_static`` waits for ROADMAP
  Queue A item 8) run unchanged on ``device``, then ``STEPS`` AdamW steps
  of its model written with Tensor methods (``x.matmul``, ``.astype``,
  ``.numpy()``, ``paddle.grad``; ``METHOD_STEP``, run as a script's code,
  so that the methods take the reference's forms) on ``device`` and on
  the CPU from the same weights (carried by
  ``models.convert.layer_state_from_numpy``), each step's loss compared,
  with the ops the first step ran through ``run_op`` and the kernel
  launches on ``device`` (none: the README's AdamW updates 4 tensors, and
  the flat update, in the reference as here, takes more than 8).

Both take the caller's launch counters (``counts``: a pair of functions
that zero and read them) or None (a CPU rehearsal, as the tests run it).
"""

from __future__ import annotations

import time
import zlib
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
README_LINES = (10, 29)
# working sizes on the card; the tests pass small ones
N, K, BATCH = 1024, 256, 8
# an op's largest difference, card against CPU, over max(1, its largest
# value): outputs and gradients. Set from the H100's readings: 6.6e-6
# (lstsq) and 7.4e-6 (pinv's gradient) at most outside the spectra; with
# TF32 products, 18 ops read 3.0e-5 to 2.7e-3 (matmul 2.6e-4)
TOL = 3e-5
# the spectra's: a backward-stable fp32 solver of a 256^2 matrix finds its
# singular values and eigenvalues to about n * eps (3e-5) of its norm, and
# their vectors' gradients carry 1 / (the gap between neighbouring values);
# the inputs keep their spectra 1/8 apart. The H100 read 2.07e-4 at most
# (svd's gradient); ``cond`` is a ratio of two singular values
SPECTRA_TOL = 1e-3
SPECTRA = {"svd", "eigh", "eigvalsh", "eig", "eigvals", "cond"}
STEPS = 20
# each step's loss, card against CPU, relative: the H100 read 1.83e-7
LOSS_RTOL = 1e-5

# how an op without an entry in ``_calls`` is called at default arguments
# (the CPU tests use these tables too)
_BINARY = {
    "add", "atan2", "copysign", "divide", "equal", "equal_all",
    "float_power", "floor_divide", "fmax", "fmin", "gammainc", "gammaincc",
    "greater_equal", "greater_than", "heaviside", "hypot", "isclose",
    "allclose", "less_equal", "less_than", "logaddexp", "logaddexp2",
    "logical_and", "logical_or", "logical_xor", "maximum", "minimum", "mod",
    "multiply", "nextafter", "not_equal", "polar", "pow", "subtract",
    "complex", "dist", "inner", "mm", "matmul", "kron", "outer",
    "expand_as", "cross",
}
_INT_BINARY = {"bitwise_and", "bitwise_or", "bitwise_xor", "gcd", "lcm",
               "bitwise_left_shift", "bitwise_right_shift"}
_INT_UNARY = {"bitwise_not", "bincount", "one_hot"}
_BOOL_UNARY = {"logical_not", "nonzero"}
FFT = ("fft", "ifft", "rfft", "irfft", "hfft", "ihfft", "fft2", "ifft2",
       "rfft2", "irfft2", "fftn", "ifftn", "rfftn", "irfftn", "fftshift",
       "ifftshift")
# zero-mean inputs (``XZ``, ``YZ``): the products and the reductions
_ZERO_MEAN = {
    "matmul", "mm", "dot", "inner", "einsum", "tensordot", "addmm", "cdist",
    "cov", "corrcoef", "trace", "sum", "mean", "prod", "std", "var",
    "aminmax", "max", "min", "argmax", "argmin", "all", "any",
    "count_nonzero", "logsumexp", "median", "nanmedian", "nansum", "nanmean",
    "norm", "quantile", "nanquantile", "kthvalue",
}
# integer-valued float inputs: ties decide the order
_TIES = {"sort", "argsort", "msort", "unique", "unique_consecutive"}
RANDOM = ("rand", "randn", "randint", "randperm", "uniform", "normal",
          "bernoulli", "multinomial", "poisson")


class _Ctx:
    """One device's inputs: ``c.X`` is a new leaf of the array ``X`` on
    ``dev`` (requiring grad when ``grad`` and it is floating; recorded in
    ``leaves``), ``c.t(a)`` a constant."""

    def __init__(self, P, dev, arrays, grad):
        self.P, self.dev, self.arrays, self.grad = P, dev, arrays, grad
        self.leaves = []

    def __getattr__(self, key):
        if not key.isupper():
            raise AttributeError(key)
        arr = self.arrays[key]
        t = self.P.to_tensor(arr, place=self.dev, stop_gradient=not (
            self.grad and arr.dtype.kind == "f"))
        if not t.stop_gradient:
            self.leaves.append(t)
        return t

    def t(self, arr):
        return self.P.to_tensor(np.asarray(arr), place=self.dev)


def _arrays(n, k, b, seed=0):
    g = np.random.default_rng(seed)
    f = lambda *s: g.uniform(0.1, 0.9, s).astype(np.float32)
    zm = lambda *s: g.uniform(-1.0, 1.0, s).astype(np.float32)
    z = g.standard_normal((b, k, k)).astype(np.float32)
    m = z @ np.swapaxes(z, -1, -2) / k + np.eye(k, dtype=np.float32)
    # spectra 1/8 apart: the factors (and so the gradients of the values)
    # are well conditioned
    spec = 1.0 + np.arange(k) / 8.0
    o1 = np.linalg.qr(g.standard_normal((b, k, k)))[0]
    o2 = np.linalg.qr(g.standard_normal((b, k, k)))[0]
    e = (o1 * spec) @ np.swapaxes(o1, -1, -2)
    w = (o1 * spec) @ np.swapaxes(o2, -1, -2)
    hh, tau = torch.geqrf(torch.from_numpy(z[..., : max(2, k // 4)]))
    r = max(2, k // 8)
    low = (g.standard_normal((k, r)) @ g.standard_normal((r, k))
           ).astype(np.float32)
    return {
        "X": f(n, n), "Y": f(n, n) + 0.1, "XI": g.integers(0, 5, (n, n)),
        "YI": g.integers(1, 4, (n, n)),
        "XT": g.integers(0, 4, (n, n)).astype(np.float32),
        "M": m.astype(np.float32), "Z": z / np.float32(np.sqrt(k)),
        "E": e.astype(np.float32), "W": w.astype(np.float32),
        "H": hh.numpy(), "TAU": tau.numpy(),
        "LOW": low, "S": (g.standard_normal((b, 16, 16)) / 4
                          + np.eye(16)).astype(np.float32),
        "IDX": g.permutation(n).astype(np.int64),
        "SMALL": f(32, 32), "SMALL2": f(32, 32),
        "XZ": zm(n, n), "YZ": zm(n, n),
    }


def _spectrum(w):
    """The eigenvalues' real parts and imaginary parts, each sorted (an
    order-free invariant: two solvers may order a conjugate pair or two
    close values differently)."""
    w = w.to(torch.complex64)
    return (torch.sort(w.real, dim=-1).values,
            torch.sort(w.imag, dim=-1).values)


def _calls(n, k):
    """name -> call(c) at working size ``n`` (decompositions at ``k``),
    for the names whose default ``op(c.X)`` does not do."""
    h = n // 2
    edges = np.linspace(0.0, 1.0, 17, dtype=np.float32)
    L = lambda c: c.P.linalg

    # the spectra carry gradients; a reconstruction's gradient through the
    # factors has 1 / (s_i^2 - s_j^2) terms, unstable at close values, so
    # it is compared as a value only
    def svd(c):
        u, s, vh = L(c).svd(c.W)
        return s, ((u * s.unsqueeze(-2)) @ vh).detach()

    def qr(c):
        qq, rr = L(c).qr(c.Z)
        return qq @ rr, rr.diagonal(dim1=-2, dim2=-1).abs().detach()

    def eigh(c):
        w, v = L(c).eigh(c.E)
        return w, ((v * w.unsqueeze(-2)) @ v.transpose(-1, -2)).detach()

    def eig(c):
        a = c.Z
        w, v = L(c).eig(a)
        resid = (a.to(v.dtype) @ v - v * w.unsqueeze(-2)).abs()
        return _spectrum(w), resid

    def eigvals(c):
        return _spectrum(L(c).eigvals(c.Z))

    def lowrank(name):
        def f(c):
            a = c.LOW
            kw = dict(q=max(2, k // 8))
            if name == "pca_lowrank":
                a = a - a.mean(0, keepdim=True)
                kw["center"] = False
            u, s, v = getattr(L(c), name)(a, **kw)
            return s, (u * s.unsqueeze(-2)) @ v.transpose(-1, -2)
        return f

    def lu(c):
        lu_, piv = L(c).lu(c.Z)
        p, lo, up = L(c).lu_unpack(lu_, piv)
        return p @ lo @ up

    return {
        "addmm": lambda c: c.P.addmm(c.XZ, c.XZ, c.YZ),
        "arange": lambda c: c.P.arange(n * n),
        "as_strided": lambda c: c.P.as_strided(c.X, [h, h], [n, 2]),
        "bmm": lambda c: c.P.bmm(c.Z, c.M),
        "broadcast_to": lambda c: c.P.broadcast_to(c.X[0], [n, n]),
        "bucketize": lambda c: c.P.bucketize(c.X, c.t(edges)),
        "searchsorted": lambda c: c.P.searchsorted(c.t(edges), c.X),
        "cdist": lambda c: c.P.cdist(c.XZ[:, :64], c.YZ[:, :64]),
        "cholesky_solve": lambda c: L(c).cholesky_solve(
            c.Z[..., :8], L(c).cholesky(c.M)),
        "chunk": lambda c: c.P.chunk(c.X, 4, axis=1),
        "crop": lambda c: c.P.crop(c.X, [h, h], [1, 2]),
        "diagonal_scatter": lambda c: c.P.diagonal_scatter(c.X, c.Y[0]),
        "dot": lambda c: c.P.dot(c.XZ, c.YZ),
        "einsum": lambda c: c.P.einsum("ij,kj->ik", c.XZ, c.YZ),
        "empty": lambda c: c.P.empty([n, n]),
        "expand": lambda c: c.P.expand(c.X[:1], [n, n]),
        "expand_as": lambda c: c.P.expand_as(c.X[:1], c.Y),
        "eye": lambda c: c.P.eye(n),
        "fftfreq": lambda c: c.P.fft.fftfreq(n),
        "rfftfreq": lambda c: c.P.fft.rfftfreq(n),
        "flip": lambda c: c.P.flip(c.X, 1),
        "full": lambda c: c.P.full([n, n], 1.5),
        "full_like": lambda c: c.P.full_like(c.X, 2.0),
        "gather": lambda c: c.P.gather(c.X, c.t(np.arange(n)[::-3].copy())),
        "gather_nd": lambda c: c.P.gather_nd(c.X, c.t(
            np.stack([np.arange(n), np.arange(n)[::-1]], 1).copy())),
        "histogramdd": lambda c: c.P.histogramdd(c.X[:, :3]),
        "householder_product": lambda c: L(c).householder_product(c.H,
                                                                  c.TAU),
        "index_add": lambda c: c.P.index_add(
            c.X, c.t(np.arange(0, n, 4)), 1, c.Y[:, : n // 4]),
        "index_fill": lambda c: c.P.index_fill(c.X, c.t(np.arange(0, n, 3)),
                                               1, 0.5),
        "index_put": lambda c: c.P.index_put(
            c.X, (c.t(np.arange(h)), c.IDX[:h]), c.Y[0, :h]),
        "index_sample": lambda c: c.P.index_sample(c.X, c.XI),
        "index_select": lambda c: c.P.index_select(c.X, c.IDX[:h], axis=1),
        "kthvalue": lambda c: c.P.kthvalue(c.XZ, 3),
        "kron": lambda c: c.P.kron(c.SMALL, c.SMALL2),
        "outer": lambda c: c.P.outer(c.X[0], c.Y[0]),
        "lerp": lambda c: c.P.lerp(c.X, c.Y, 0.25),
        "linspace": lambda c: c.P.linspace(0.0, 1.0, n * n),
        "logspace": lambda c: c.P.logspace(0.0, 2.0, n),
        "lstsq": lambda c: L(c).lstsq(c.M[0][:, : max(2, k // 4)],
                                      c.Z[1][:, :4]),
        "lu": lu, "lu_unpack": lu,
        "masked_fill": lambda c: c.P.masked_fill(c.X, c.X > 0.5, 0.0),
        "masked_scatter": lambda c: c.P.masked_scatter(c.X, c.X > 0.5, c.Y),
        "masked_select": lambda c: c.P.masked_select(c.X, c.X > 0.5),
        "matrix_power": lambda c: L(c).matrix_power(c.M, 3),
        "meshgrid": lambda c: c.P.meshgrid(c.X[0], c.Y[0]),
        "moveaxis": lambda c: c.P.moveaxis(c.X, 0, 1),
        "multiplex": lambda c: c.P.multiplex([c.X, c.Y], c.XI[:, :1] % 2),
        "nanquantile": lambda c: c.P.nanquantile(c.XZ, 0.5, axis=1),
        "quantile": lambda c: c.P.quantile(c.XZ, 0.25, axis=1),
        "ones": lambda c: c.P.ones([n, n]),
        "pad": lambda c: c.P.pad(c.X, [1, 2]),
        "polygamma": lambda c: c.P.polygamma(c.X, 1),
        "put_along_axis": lambda c: c.P.put_along_axis(
            c.X, c.IDX[:, None], c.Y[:, :1], 1),
        "renorm": lambda c: c.P.renorm(c.X, 2, 0, 1.0),
        "repeat_interleave": lambda c: c.P.repeat_interleave(c.X, 2, axis=1),
        "reshape": lambda c: c.P.reshape(c.X, [n * n // 4, 4]),
        "roll": lambda c: c.P.roll(c.X, 1),
        "scatter": lambda c: c.P.scatter(c.X, c.IDX[:h], c.Y[:h]),
        "scatter_nd_add": lambda c: c.P.scatter_nd_add(
            c.X, c.t(np.arange(h)[:, None] % 7), c.Y[:h]),
        "select_scatter": lambda c: c.P.select_scatter(c.X, c.Y[:, 0], 1, 2),
        "shard_index": lambda c: c.P.shard_index(c.XI, 5, 2, 0),
        "slice_scatter": lambda c: c.P.slice_scatter(
            c.X, c.Y[:, :h], [1], [0], [n], [2]),
        "solve": lambda c: L(c).solve(c.M, c.Z[..., :8]),
        "triangular_solve": lambda c: L(c).triangular_solve(
            L(c).cholesky(c.M, upper=True), c.Z[..., :8]),
        "split": lambda c: c.P.split(c.X, 4, axis=1),
        "strided_slice": lambda c: c.P.strided_slice(c.X, [1], [0], [n], [2]),
        "swapaxes": lambda c: c.P.swapaxes(c.X, 0, 1),
        "take": lambda c: c.P.take(c.X, c.IDX),
        "take_along_axis": lambda c: c.P.take_along_axis(c.X, c.XI, 1),
        "tensor_split": lambda c: c.P.tensor_split(c.X, 3, axis=1),
        "tensordot": lambda c: c.P.tensordot(c.XZ, c.YZ, axes=1),
        "tile": lambda c: c.P.tile(c.SMALL, [4, 4]),
        "topk": lambda c: c.P.topk(c.XT, 16),
        "mode": lambda c: c.P.mode(c.XT[:, : k]),
        "unflatten": lambda c: c.P.unflatten(c.X, 1, [n // 4, 4]),
        "unfold": lambda c: c.P.unfold(c.X, 1, 4, 4),
        "unsqueeze": lambda c: c.P.unsqueeze(c.X, 0),
        "vander": lambda c: c.P.vander(c.X[0, :64]),
        "where": lambda c: c.P.where(c.X > 0.5, c.X, c.Y),
        "zeros": lambda c: c.P.zeros([n, n]),
        "concat": lambda c: c.P.concat([c.X, c.Y]),
        "stack": lambda c: c.P.stack([c.X, c.Y]),
        "column_stack": lambda c: c.P.column_stack([c.X[0], c.Y[0]]),
        "row_stack": lambda c: c.P.row_stack([c.X, c.Y]),
        "dstack": lambda c: c.P.dstack([c.X, c.Y]),
        "hstack": lambda c: c.P.hstack([c.X, c.Y]),
        "vstack": lambda c: c.P.vstack([c.X, c.Y]),
        "diag": lambda c: c.P.diag(c.X),
        "diagflat": lambda c: c.P.diagflat(c.SMALL),
        "diag_embed": lambda c: c.P.diag_embed(c.SMALL),
        "pdist": lambda c: c.P.pdist(c.X[:256, :64]),
        "cov": lambda c: L(c).cov(c.XZ[:64]),
        "corrcoef": lambda c: L(c).corrcoef(c.XZ[:64]),
        "cross": lambda c: c.P.cross(c.X[:, :3], c.Y[:, :3]),
        "trace": lambda c: c.P.trace(c.XZ),
        "ldexp": lambda c: c.P.ldexp(c.X, c.XI),
        "bincount": lambda c: c.P.bincount(c.XI.reshape([-1])),
        "acosh": lambda c: c.P.acosh(c.X + 1.0),
        "logit": lambda c: c.P.logit(c.X, 1e-6),
        "clip": lambda c: c.P.clip(c.X, 0.3, 0.7),
        "frexp": lambda c: c.P.frexp(c.X),
        "svd": svd, "qr": qr, "eigh": eigh, "eig": eig, "eigvals": eigvals,
        "svd_lowrank": lowrank("svd_lowrank"),
        "pca_lowrank": lowrank("pca_lowrank"),
        "cholesky": lambda c: L(c).cholesky(c.M),
        "inv": lambda c: L(c).inv(c.M),
        "det": lambda c: L(c).det(c.S),
        "slogdet": lambda c: L(c).slogdet(c.M),
        "pinv": lambda c: L(c).pinv(c.M),
        "matrix_rank": lambda c: L(c).matrix_rank(c.M),
        "cond": lambda c: L(c).cond(c.M),
        "eigvalsh": lambda c: L(c).eigvalsh(c.E),
        "tril_indices": lambda c: c.P.tril_indices(n),
        "triu_indices": lambda c: c.P.triu_indices(n),
    }


def default_call(op, name, x, y, xi, yi):
    """``op`` (the op ``name`` of either package) at default arguments on
    float ``x`` / ``y`` and integer ``xi`` / ``yi``."""
    if name in _BINARY:
        return op(x, y)
    if name in _INT_BINARY:
        return op(xi, yi)
    if name == "one_hot":
        return op(xi, 5)
    if name in _INT_UNARY:
        return op(xi)
    if name in _BOOL_UNARY:
        return op(x > 0.5)
    return op(x)


def _call(name, c, calls):
    P = c.P
    fn = calls.get(name)
    if fn is not None:
        return fn(c)
    op = getattr(P.fft, name) if name in FFT else getattr(P, name)
    if name in _TIES:
        return op(c.XT)
    if name in _ZERO_MEAN:
        return default_call(op, name, c.XZ, c.YZ, c.XI, c.YI)
    return default_call(op, name, c.X, c.Y, c.XI, c.YI)


def _flat(v):
    if isinstance(v, (list, tuple)):
        for e in v:
            yield from _flat(e)
    elif v is not None:
        yield v


def to_numpy(v):
    """A tensor, an object with ``numpy()`` or a Python value as a numpy
    array (bfloat16 as float32)."""
    if isinstance(v, torch.Tensor):
        t = v.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.as_subclass(torch.Tensor).numpy(force=True)
    if hasattr(v, "numpy"):
        return np.asarray(v.numpy())
    return np.asarray(v)


def _scaled_err(got, want):
    """max |got - want| over max(1, max |want|), NaN/inf positions equal."""
    g, w = to_numpy(got), to_numpy(want)
    if g.shape != w.shape:
        return float("inf")
    if g.size == 0:
        return 0.0
    if w.dtype.kind not in "fc" and g.dtype.kind not in "fc":
        return 0.0 if np.array_equal(g.astype(np.int64),
                                     w.astype(np.int64)) else float("inf")
    wide = np.complex128 if "c" in (g.dtype.kind, w.dtype.kind) \
        else np.float64
    g, w = g.astype(wide, copy=False), w.astype(wide, copy=False)
    bad_w = ~np.isfinite(w)
    if not np.array_equal(~np.isfinite(g), bad_w):
        return float("inf")
    if bad_w.any():
        g, w = g[~bad_w], w[~bad_w]
    if w.size == 0:
        return 0.0
    scale = max(1.0, float(np.abs(w).max()))
    return float(np.abs(g - w).max()) / scale


_WEIGHTS = {}


def _weight(shape):
    """The seeded weights of an output of ``shape`` in the gradient's
    weighted sum (the same on both devices; made once a shape)."""
    w = _WEIGHTS.get(shape)
    if w is None:
        rng = np.random.default_rng(zlib.crc32(repr(shape).encode()))
        w = _WEIGHTS[shape] = torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32))
    return w


def _run(name, P, dev, arrays, calls, grad):
    c = _Ctx(P, dev, arrays, grad)
    prev = P.set_device(dev)  # the creation ops make tensors there
    try:
        outs = list(_flat(_call(name, c, calls)))
    finally:
        P.set_device(prev)
    grads = []
    if grad and c.leaves:
        total = None
        for o in outs:
            if isinstance(o, torch.Tensor) and o.is_floating_point() \
                    and o.requires_grad:
                w = _weight(tuple(o.shape)).to(o.device)
                s = (o * w).sum()
                total = s if total is None else total + s
        if total is not None:
            total.backward()
            grads = [t.grad if t.grad is not None else torch.zeros_like(t)
                     for t in c.leaves]
    return outs, grads


def op_sweep(device, n=N, k=K, batch=BATCH):
    """Every op of ``all_ops()`` on ``device`` against the CPU (see the
    module docstring). Returns ``{"ops": {name: {"err": ...,
    "grad_err": ..., "ms": ...}}, "max_err": ..., "worst": name,
    "random": {...}, "seconds": ...}``; raises ``AssertionError`` naming
    every op beyond its tolerance."""
    import paddle_tpu_torch as P
    from paddle_tpu_torch.ops.registry import OPS

    t0 = time.perf_counter()
    dev = torch.device(device)
    arrays = _arrays(n, k, batch)
    calls = _calls(n, k)
    res, bad = {}, []
    for name in sorted(OPS):
        if name in RANDOM or name == "increment":
            continue
        grad = OPS[name].differentiable
        ts = time.perf_counter()
        outs_d, grads_d = _run(name, P, dev, arrays, calls, grad)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        ms = (time.perf_counter() - ts) * 1e3
        outs_c, grads_c = _run(name, P, "cpu", arrays, calls, grad)
        err = (max((_scaled_err(a, b) for a, b in zip(outs_d, outs_c)),
                   default=0.0) if len(outs_d) == len(outs_c)
               else float("inf"))
        gerr = (max((_scaled_err(a, b) for a, b in zip(grads_d, grads_c)),
                    default=0.0) if len(grads_d) == len(grads_c)
                else float("inf"))
        res[name] = {"err": err, "grad_err": gerr if grads_d else None,
                     "ms": round(ms, 3)}
        tol = SPECTRA_TOL if name in SPECTRA else TOL
        if not (err <= tol and gerr <= tol):
            bad.append(f"{name} (err {err:.3e}, grad {gerr:.3e})")
    res["increment"] = _increment(P, dev)
    if res["increment"]["err"] > 0:
        bad.append("increment")
    rnd = random_checks(P, dev, n)
    worst = max((k2 for k2 in res), key=lambda k2: max(
        res[k2]["err"], res[k2]["grad_err"] or 0.0))
    out = {"ops": res, "random": rnd, "worst": worst,
           "max_err": max(res[worst]["err"], res[worst]["grad_err"] or 0.0),
           "held": len(res) + len(rnd),
           "seconds": round(time.perf_counter() - t0, 2)}
    if bad or not all(r["ok"] for r in rnd.values()):
        raise AssertionError(
            f"ops beyond {TOL} ({SPECTRA_TOL} for {sorted(SPECTRA)}) on "
            f"{device}: {bad}; random: "
            f"{[k2 for k2, r in rnd.items() if not r['ok']]}")
    return out


def _increment(P, dev):
    a = np.arange(6, dtype=np.float32)
    x = P.to_tensor(a, place=dev)
    P.increment(x, 2.0)
    return {"err": float(np.abs(to_numpy(x) - (a + 2.0)).max()),
            "grad_err": None, "ms": None}


def random_checks(P, dev, n):
    """The random ops on ``dev``: shape, dtype, range and moments of
    ``n * n`` draws (at least 256 * 256), and the same draws again after
    the same ``seed``. A mean within six standard errors passes, a variance
    within 2 % (over 9 of its standard errors at 256 * 256 draws)."""
    n = max(n, 256)
    cnt = n * n
    tol = 6.0 / np.sqrt(cnt)  # six standard errors of a unit-scale mean
    rates = P.to_tensor(np.full(cnt, 4.0, np.float32), place=dev)
    halves = P.to_tensor(np.full(cnt, 0.3, np.float32), place=dev)
    probs = P.to_tensor(np.tile(np.array([[0.1, 0.0, 0.9]], np.float32),
                                (cnt, 1)), place=dev)
    prev = P.set_device(dev)
    try:
        draws = {
            "rand": (lambda: P.rand([n, n]), (0.0, 1.0), 0.5, 1 / 12),
            "randn": (lambda: P.randn([n, n]), None, 0.0, 1.0),
            "randint": (lambda: P.randint(2, 9, [n, n]), (2, 8), 5.0, 4.0),
            "randperm": (lambda: P.randperm(cnt), (0, cnt - 1),
                         (cnt - 1) / 2, (cnt * cnt - 1) / 12),
            "uniform": (lambda: P.uniform([n, n], min=-2.0, max=3.0),
                        (-2.0, 3.0), 0.5, 25 / 12),
            "normal": (lambda: P.normal(1.5, 0.5, [n, n]), None, 1.5, 0.25),
            "bernoulli": (lambda: P.bernoulli(halves), (0.0, 1.0), 0.3,
                          0.21),
            "multinomial": (lambda: P.multinomial(probs, 1), (0, 2), 1.8,
                            0.36),
            "poisson": (lambda: P.poisson(rates), (0.0, None), 4.0, 4.0),
        }
        out = {}
        for name, (draw, rng, mean, var) in draws.items():
            P.seed(7)
            a = draw()
            P.seed(7)
            b = draw()
            v = to_numpy(a).astype(np.float64)
            sd = np.sqrt(var)
            ok = (a.device.type == torch.device(dev).type
                  and torch.equal(a, b)
                  and (rng is None or (v.min() >= rng[0] and (
                      rng[1] is None or v.max() <= rng[1]))))
            if name == "randperm":  # a permutation: its moments are fixed
                ok = ok and np.array_equal(np.sort(v), np.arange(cnt))
            else:
                ok = ok and (abs(v.mean() - mean) <= tol * max(sd, 1.0)
                             and abs(v.var() - var) <= 0.02 * var)
            out[name] = {"ok": bool(ok), "shape": list(a.shape),
                         "dtype": str(a.dtype).replace("torch.", ""),
                         "mean": float(v.mean()), "var": float(v.var())}
    finally:
        P.set_device(prev)
    return out


def readme_script() -> str:
    """``README.md``'s quickstart (lines 10-29) with its two import lines
    naming ``paddle_tpu_torch``; the rest unchanged."""
    lines = (ROOT / "README.md").read_text().splitlines()[
        README_LINES[0] - 1:README_LINES[1]]
    swaps = {"import paddle_tpu as paddle": "import paddle_tpu_torch as paddle",
             "from paddle_tpu import nn": "from paddle_tpu_torch import nn"}
    out = [swaps.get(line.strip(), line) for line in lines]
    if sum(a != b for a, b in zip(out, lines)) != 2:
        raise ValueError("README.md lines 10-29 are not the quickstart")
    return "\n".join(out)


# one step of the README's model written with Tensor methods, as a
# script's code: ``x.matmul``, ``.astype``, ``paddle.grad`` and ``.numpy()``
# take the reference's forms here (``ops._tensor_methods``)
METHOD_STEP = """
import paddle_tpu_torch as paddle

def loss_and_grads(net, x, label):
    w1, b1, w2, b2 = params = list(net.parameters())
    h = paddle.nn.functional.relu(x.matmul(w1) + b1)
    logits = h.matmul(w2).astype("float32") + b2
    loss = paddle.nn.functional.cross_entropy(logits, label)
    return float(loss.numpy()), paddle.grad(loss, params)
"""


class _OpNames:
    """A profiler collector that records the ops ``run_op`` ran."""

    def __init__(self):
        self.names = []

    def _host_event(self, name, t0, t1, kind):
        self.names.append(name)


def readme_phase(device, steps=STEPS, counts=None):
    """The README quickstart on ``device`` (see the module docstring).
    Returns the script's loss and launches, each step's loss on ``device``
    and on the CPU, their largest relative difference, the ops the first
    step on ``device`` ran through ``run_op``, the launches and the
    seconds."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models.convert import layer_state_from_numpy
    from paddle_tpu_torch.profiler import _hooks

    t0 = time.perf_counter()
    src = readme_script()
    step = {"__name__": "__main__"}
    exec(compile(METHOD_STEP, "METHOD_STEP", "exec"), step)
    loss_and_grads = step["loss_and_grads"]
    ops = _OpNames()
    prev = paddle.set_device(device)
    try:
        np.random.seed(0)
        paddle.seed(0)
        g = {"__name__": "__main__"}
        if counts:
            counts[0]()
        exec(compile(src, "README.md", "exec"), g)
        if str(device).startswith("cuda"):
            torch.cuda.synchronize()
        script = {"loss": float(g["loss"].numpy()),
                  "loss_type": type(g["loss"]).__name__,
                  "launches": counts[1]() if counts else None}
        Net = g["Net"]
        paddle.seed(1)
        net_d = Net()
        state = {k: v.detach().cpu().numpy()
                 for k, v in net_d.state_dict().items()}
        paddle.set_device("cpu")
        net_c = layer_state_from_numpy(Net(), state, device="cpu")
        paddle.set_device(device)
        rng = np.random.default_rng(2)
        batches = [(rng.random((32, 784), dtype=np.float32),
                    rng.integers(0, 10, (32,))) for _ in range(steps)]
        losses = []
        launches = None
        for j, (dev, net) in enumerate(((device, net_d), ("cpu", net_c))):
            opt = paddle.optimizer.AdamW(learning_rate=1e-3,
                                         parameters=net.parameters())
            ls = []
            if counts and j == 0:
                counts[0]()
            for i, (xb, yb) in enumerate(batches):
                x = paddle.to_tensor(xb, place=dev)
                label = paddle.to_tensor(yb, place=dev)
                watch = j == 0 and i == 0
                if watch:
                    _hooks.COLLECTORS.append(ops)
                try:
                    loss, grads = loss_and_grads(net, x, label)
                finally:
                    if watch:
                        _hooks.COLLECTORS.remove(ops)
                for p, grad in zip(net.parameters(), grads):
                    p.grad = grad.as_subclass(torch.Tensor)
                opt.step()
                opt.clear_grad()
                ls.append(loss)
            if counts and j == 0:
                launches = counts[1]()
            losses.append(ls)
    finally:
        paddle.set_device(prev)
    ld, lc = np.asarray(losses[0]), np.asarray(losses[1])
    rel = float(np.max(np.abs(ld - lc) / np.abs(lc)))
    return {"script": script, "losses": losses[0],
            "losses_cpu": losses[1], "loss_max_rel_err": rel,
            "steps": steps, "step_ops": ops.names, "launches": launches,
            "seconds": round(time.perf_counter() - t0, 2)}
