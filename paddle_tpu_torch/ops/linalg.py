"""Linear algebra ops, the ``paddle.linalg`` surface (port of
``paddle_tpu/ops/linalg.py``), on ``torch.linalg`` (cuSOLVER and cuBLAS on
the card, LAPACK on the CPU).

The reference's conventions kept: ``svd`` returns ``(U, S, VH)``;
``slogdet`` stacks ``[sign, logabsdet]``; ``lu`` returns 1-based LAPACK
pivots (int32), which ``lu_unpack`` and ``lu_solve`` read; ``lstsq``
returns ``(solution, residuals, rank, singular_values)`` by the SVD, with
``jnp.linalg.lstsq``'s cut-off and full residuals, on every device
(torch's own CUDA solver gives no rank); ``cholesky_solve`` and
``cholesky_inverse`` read only the factor's triangle, so its other
triangle gets no gradient; ``matrix_rank``'s ``tol`` is an absolute
cut-off on the singular values; ``eig`` / ``eigvals`` run on the tensor's device (the reference
computes them with numpy on the host). The decompositions' signs and
phases are the solver's: compare invariants (reconstructions, singular
values, eigenvalues), not factors.
"""

from __future__ import annotations

import torch

from .dispatch import run_op
from .registry import register_op

__all__ = [
    "cholesky", "inv", "det", "slogdet", "svd", "qr", "eigh", "eigvalsh",
    "eig", "eigvals", "matrix_exp", "matrix_power", "matrix_rank", "pinv",
    "solve",
    "triangular_solve", "cholesky_solve", "lstsq", "lu", "lu_unpack",
    "cond", "cov",
    "corrcoef", "householder_product", "multi_dot", "norm",
    "svd_lowrank", "pca_lowrank", "ormqr", "vector_norm", "matrix_norm",
    "cholesky_inverse", "lu_solve",
]


def _lowrank_svd(a, q, niter, gen):
    """Randomized range-finder SVD (Halko et al., the reference's
    svd_lowrank algorithm): project onto a q-dim random range, power-
    iterate with QR re-orthonormalisation, SVD the small projection."""
    n = a.shape[-1]
    g = torch.randn(a.shape[:-2] + (n, q), dtype=a.dtype, device=a.device,
                    generator=gen)
    qm, _ = torch.linalg.qr(a @ g)
    for _ in range(niter):
        qz, _ = torch.linalg.qr(a.transpose(-1, -2) @ qm)
        qm, _ = torch.linalg.qr(a @ qz)
    b = qm.transpose(-1, -2) @ a
    ub, s, vh = torch.linalg.svd(b, full_matrices=False)
    return qm @ ub, s, vh.transpose(-1, -2)


def _gen(dev):
    from ..framework.random import generator

    return generator(dev)


@register_op()
def svd_lowrank(x, q=6, niter=2, M=None, name=None):
    """(U, S, V) with U diag(S) V^T close to ``x`` for inputs of rank <=
    q; randomized, drawn from the device's generator."""
    gen = _gen(x.device)

    def f(a, *rest):
        am = a - rest[0] if rest else a
        return _lowrank_svd(am.detach(), int(q), int(niter), gen)

    args = (x,) if M is None else (x, M)
    return run_op("svd_lowrank", f, *args)


@register_op()
def pca_lowrank(x, q=None, center=True, niter=2, name=None):
    """Randomized PCA: centers the columns, then the randomized SVD."""
    m, n = x.shape[-2], x.shape[-1]
    qq = min(6, m, n) if q is None else int(q)
    gen = _gen(x.device)

    def f(a):
        a = a.detach()
        am = a - a.mean(dim=-2, keepdim=True) if center else a
        return _lowrank_svd(am, qq, int(niter), gen)

    return run_op("pca_lowrank", f, x)


@register_op()
def cholesky(x, upper=False, name=None):
    def f(a):
        low = torch.linalg.cholesky(a)
        return low.transpose(-1, -2) if upper else low

    return run_op("cholesky", f, x)


@register_op()
def inv(x, name=None):
    return run_op("inv", torch.linalg.inv, x)


@register_op()
def det(x, name=None):
    return run_op("det", torch.linalg.det, x)


@register_op()
def slogdet(x, name=None):
    def f(a):
        sign, logdet = torch.linalg.slogdet(a)
        return torch.stack([sign, logdet], dim=0)

    return run_op("slogdet", f, x)


@register_op()
def svd(x, full_matrices=False, name=None):
    return run_op("svd", lambda a: tuple(torch.linalg.svd(
        a, full_matrices=full_matrices)), x)


@register_op()
def qr(x, mode="reduced", name=None):
    def f(a):
        if mode == "r":
            return torch.linalg.qr(a, mode="r")[1]
        return tuple(torch.linalg.qr(a, mode=mode))

    return run_op("qr", f, x)


@register_op()
def eigh(x, UPLO="L", name=None):
    return run_op("eigh", lambda a: tuple(torch.linalg.eigh(a, UPLO=UPLO)),
                  x)


@register_op()
def eigvalsh(x, UPLO="L", name=None):
    return run_op("eigvalsh", lambda a: torch.linalg.eigvalsh(a, UPLO=UPLO),
                  x)


@register_op(differentiable=False)
def eig(x, name=None):
    w, v = torch.linalg.eig(x.detach())
    return w, v


@register_op(differentiable=False)
def eigvals(x, name=None):
    return torch.linalg.eigvals(x.detach())


@register_op()
def matrix_power(x, n, name=None):
    return run_op("matrix_power", lambda a: torch.linalg.matrix_power(a, n),
                  x)


@register_op(differentiable=False)
def matrix_rank(x, tol=None, hermitian=False, name=None):
    if tol is None:
        return run_op("matrix_rank", lambda a: torch.linalg.matrix_rank(
            a.detach()), x)
    return run_op("matrix_rank", lambda a: torch.linalg.matrix_rank(
        a.detach(), atol=tol, rtol=0.0), x)


@register_op()
def pinv(x, rcond=1e-15, hermitian=False, name=None):
    return run_op("pinv", lambda a: torch.linalg.pinv(
        a, rtol=rcond, hermitian=hermitian), x)


@register_op()
def solve(x, y, name=None):
    return run_op("solve", torch.linalg.solve, x, y)


@register_op()
def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False,
                     name=None):
    def f(a, b):
        if transpose:
            a, up = a.transpose(-1, -2), not upper
        else:
            up = upper
        return torch.linalg.solve_triangular(a, b, upper=up,
                                             unitriangular=unitriangular)

    return run_op("triangular_solve", f, x, y)


@register_op()
def cholesky_solve(x, y, upper=False, name=None):
    return run_op("cholesky_solve", lambda b, c: torch.cholesky_solve(
        b, _triangle(c, upper), upper=upper), x, y)


def _triangle(c, upper):
    """The factor's stored triangle (the solves read no other entry)."""
    return torch.triu(c) if upper else torch.tril(c)


@register_op(differentiable=False)
def lstsq(x, y, rcond=None, driver=None, name=None):
    a, b = x.detach(), y.detach()
    m, n = a.shape
    vector = b.ndim == 1
    if vector:
        b = b[:, None]
    u, s, vh = torch.linalg.svd(a, full_matrices=False)
    cut = (torch.finfo(a.dtype).eps * max(m, n) if rcond is None
           else rcond) * s[0]
    mask = (s > 0) & (s >= cut)
    rank = mask.sum().to(torch.int32)
    inv_s = torch.where(mask, 1.0 / torch.where(mask, s, 1.0), 0.0)
    sol = vh.T @ (inv_s[:, None] * (u.T @ b))
    res = torch.linalg.vector_norm(b - a @ sol, dim=0) ** 2
    return (sol.reshape(-1) if vector else sol), res, rank, s


@register_op(differentiable=False)
def lu(x, pivot=True, get_infos=False, name=None):
    lu_, piv = torch.linalg.lu_factor(x.detach())
    piv = piv.to(torch.int32)
    if get_infos:
        return lu_, piv, torch.zeros((), dtype=torch.int32, device=x.device)
    return lu_, piv


@register_op(differentiable=False)
def lu_unpack(x, y, unpack_ludata=True, unpack_pivots=True, name=None):
    """(P, L, U) with A = P @ L @ U from ``lu``'s packed factors and
    1-based pivots."""
    p_mat, l_mat, u_mat = torch.lu_unpack(x.detach(), y.detach())
    return (p_mat if unpack_pivots else None,
            l_mat if unpack_ludata else None,
            u_mat if unpack_ludata else None)


@register_op(differentiable=False)
def cond(x, p=None, name=None):
    return run_op("cond", lambda a: torch.linalg.cond(a.detach(), p=p), x)


@register_op()
def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None, name=None):
    def f(a):
        a = a if rowvar or a.ndim < 2 else a.transpose(0, 1)
        return torch.cov(a, correction=1 if ddof else 0)

    return run_op("cov", f, x)


@register_op()
def corrcoef(x, rowvar=True, name=None):
    return run_op("corrcoef", lambda a: torch.corrcoef(
        a if rowvar or a.ndim < 2 else a.transpose(0, 1)), x)


@register_op()
def householder_product(x, tau, name=None):
    return run_op("householder_product", torch.linalg.householder_product,
                  x, tau)


def cholesky_inverse(x, upper=False, name=None):
    """Inverse of A from its Cholesky factor."""
    return run_op("cholesky_inverse", lambda a: torch.cholesky_inverse(
        _triangle(a, upper), upper=upper), x)


def lu_solve(b, lu, pivots, trans="N", name=None):
    """Solve A x = b from ``lu``'s output (1-based pivots)."""
    adjoint = {"N": False, "T": True, "H": True, 0: False, 1: True,
               2: True}[trans]
    return run_op("lu_solve", lambda bv, luv, piv: torch.linalg.lu_solve(
        luv, piv.to(torch.int32), bv, adjoint=adjoint), b, lu, pivots)


def ormqr(x, tau, y, left=True, transpose=False, name=None):
    """``y`` multiplied by the orthogonal Q of the Householder reflectors
    ``(x, tau)`` of a QR factorisation."""
    return run_op("ormqr", lambda a, t, o: torch.ormqr(
        a, t, o, left=left, transpose=transpose), x, tau, y)


def vector_norm(x, p=2.0, axis=None, keepdim=False, name=None):
    """Vector p-norm over ``axis`` (every element for ``None``)."""
    dims = None if axis is None else (
        tuple(axis) if isinstance(axis, (list, tuple)) else (axis,))
    return run_op("vector_norm", lambda a: torch.linalg.vector_norm(
        a, ord=p, dim=dims, keepdim=keepdim), x)


def matrix_norm(x, p="fro", axis=(-2, -1), keepdim=False, name=None):
    """Matrix norm over the two ``axis`` dims: 'fro', 'nuc', +-1, +-2,
    +-inf."""
    if p not in ("fro", "nuc", 1, -1, 2, -2, float("inf"), float("-inf")):
        raise ValueError(f"matrix_norm: unsupported p={p!r}")
    return run_op("matrix_norm", lambda a: torch.linalg.matrix_norm(
        a, ord=p, dim=tuple(axis), keepdim=keepdim), x)


def multi_dot(tensors, name=None):
    return run_op("multi_dot", lambda *arrs: torch.linalg.multi_dot(arrs),
                  *tensors)


from .reduction import norm  # noqa: E402  (re-exported as linalg.norm)


def matrix_exp(x, name=None):
    """Matrix exponential (scaling and squaring)."""
    return run_op("matrix_exp", torch.linalg.matrix_exp, x)
