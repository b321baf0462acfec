"""``ops/linalg.py`` of the port against the JAX package's: every op on
the same seeded inputs (``tests/test_ops_basic.py``'s linalg cases among
them), outputs and gradients; for the decompositions (``svd``, ``qr``,
``eigh``, ``eig``, the randomized ones) their invariants, the
reconstruction and the singular values or eigenvalues, since two solvers
may choose other signs."""

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as pp
from torch_ops_common import R, assert_close, ids, on_cpu, run_case  # noqa: F401

L = "linalg."
TOL3 = dict(rtol=1e-3, atol=1e-4)


def _geqrf(r, m, n):
    a, tau = torch.geqrf(torch.from_numpy(r.n(m, n)))
    return a.numpy(), tau.numpy()


def _svd_inv(pkg):
    def f(x):
        u, s, vh = pkg.linalg.svd(x)
        return s, pkg.matmul(u * pkg.unsqueeze(s, -2), vh)
    return f


def _qr_inv(pkg):
    def f(x):
        q, r_ = pkg.linalg.qr(x)
        return pkg.matmul(q, r_), pkg.abs(pkg.diagonal(r_, axis1=-2,
                                                       axis2=-1))
    return f


def _eigh_inv(pkg):
    def f(x):
        w, v = pkg.linalg.eigh(x)
        return w, pkg.matmul(v * pkg.unsqueeze(w, -2), pkg.transpose(
            v, [0, 2, 1] if len(v.shape) == 3 else [1, 0]))
    return f


CASES = [
    ("cholesky", L + "cholesky", lambda r: ([r.spd(3)], {}), True),
    ("cholesky_upper", L + "cholesky", lambda r: ([r.spd(3)], dict(
        upper=True)), True),
    ("inv", L + "inv", lambda r: ([r.spd(3)], {}), True),
    ("det", L + "det", lambda r: ([r.n(3, 3)], {}), True),
    ("det_batched", L + "det", lambda r: ([r.n(2, 3, 3)], {}), True),
    ("slogdet", L + "slogdet", lambda r: ([r.n(3, 3)], {}), True),
    # gradients of these three: test_decomposition_gradients (the
    # reference's tape raises on them)
    ("svd", _svd_inv, lambda r: ([r.n(4, 3)], {}), False),
    ("svd_batched", _svd_inv, lambda r: ([r.n(2, 3, 5)], {}), False),
    ("qr", _qr_inv, lambda r: ([r.n(4, 3)], {}), False),
    ("eigh", _eigh_inv, lambda r: ([r.spd(3)], {}), False),
    ("eigh_batched", _eigh_inv, lambda r: ([r.spd(3, (2,))], {}), False),
    ("eigvalsh", L + "eigvalsh", lambda r: ([r.spd(4)], {}), True),
    ("eigvalsh_upper", L + "eigvalsh", lambda r: ([r.spd(3)], dict(
        UPLO="U")), True),
    ("matrix_exp", L + "matrix_exp", lambda r: ([r.n(3, 3) * 0.5], {}),
     True),
    ("matrix_power", L + "matrix_power", lambda r: ([r.n(3, 3)], dict(n=3)),
     True),
    ("matrix_power_negative", L + "matrix_power", lambda r: (
        [r.spd(3)], dict(n=-2)), True),
    ("matrix_rank", L + "matrix_rank", lambda r: (
        [(r.n(4, 2) @ r.n(2, 4)).astype(np.float32)], {}), False),
    ("matrix_rank_tol", L + "matrix_rank", lambda r: ([r.n(4, 4)], dict(
        tol=0.5)), False),
    ("pinv", L + "pinv", lambda r: ([r.n(4, 3)], {}), True),
    ("solve", L + "solve", lambda r: ([r.spd(3), r.n(3, 2)], {}), True),
    ("triangular_solve", L + "triangular_solve", lambda r: (
        [np.triu(r.n(3, 3)) + 3 * np.eye(3, dtype=np.float32), r.n(3, 2)],
        {}), True),
    ("triangular_solve_lower_t", L + "triangular_solve", lambda r: (
        [np.tril(r.n(3, 3)) + 3 * np.eye(3, dtype=np.float32), r.n(3, 2)],
        dict(upper=False, transpose=True)), True),
    ("triangular_solve_unit", L + "triangular_solve", lambda r: (
        [np.triu(r.n(3, 3)), r.n(3, 2)], dict(unitriangular=True)), True),
    ("cholesky_solve", L + "cholesky_solve", lambda r: (
        [r.n(3, 2), np.linalg.cholesky(r.spd(3)).astype(np.float32)], {}),
     True),
    ("lstsq", L + "lstsq", lambda r: ([r.n(5, 3), r.n(5, 2)], {}), False),
    ("lstsq_vector", L + "lstsq", lambda r: ([r.n(5, 3), r.n(5)], {}), False),
    ("lstsq_rank_deficient", L + "lstsq", lambda r: (
        [np.repeat(r.n(5, 1), 3, 1), r.n(5, 2)], {}), False),
    ("lu", L + "lu", lambda r: ([r.n(4, 4)], {}), False),
    ("lu_infos", L + "lu", lambda r: ([r.n(3, 3)], dict(get_infos=True)),
     False),
    ("lu_unpack", lambda pkg: lambda x: pkg.linalg.lu_unpack(
        *pkg.linalg.lu(x)), lambda r: ([r.n(4, 4)], {}), False),
    ("lu_unpack_batched", lambda pkg: lambda x: pkg.linalg.lu_unpack(
        *pkg.linalg.lu(x)), lambda r: ([r.n(2, 3, 3)], {}), False),
    ("lu_solve", lambda pkg: lambda a, b: pkg.linalg.lu_solve(
        b, *pkg.linalg.lu(a)), lambda r: ([r.n(3, 3), r.n(3, 2)], {}), False),
    ("lu_solve_trans", lambda pkg: lambda a, b: pkg.linalg.lu_solve(
        b, *pkg.linalg.lu(a), trans="T"), lambda r: ([r.n(3, 3), r.n(3, 2)],
                                                     {}), False),
    ("cond", L + "cond", lambda r: ([r.n(3, 3)], {}), False),
    ("cond_fro", L + "cond", lambda r: ([r.n(3, 3)], dict(p="fro")), False),
    ("cov", L + "cov", lambda r: ([r.n(3, 5)], {}), True),
    ("cov_cols_biased", L + "cov", lambda r: ([r.n(5, 3)], dict(
        rowvar=False, ddof=False)), True),
    ("corrcoef", L + "corrcoef", lambda r: ([r.n(3, 6)], {}), True),
    ("householder_product", L + "householder_product", lambda r: (
        list(_geqrf(r, 4, 3)), {}), True),
    ("multi_dot", L + "multi_dot", lambda r: ([[r.n(2, 3), r.n(3, 4),
                                                r.n(4, 2)]], {}), True),
    ("norm", L + "norm", lambda r: ([r.n(3, 4)], {}), True),
    ("ormqr", L + "ormqr", lambda r: (list(_geqrf(r, 4, 3)) + [r.n(4, 2)],
                                      {}), True),
    ("ormqr_right_t", L + "ormqr", lambda r: (
        list(_geqrf(r, 4, 3)) + [r.n(2, 4)], dict(left=False,
                                                  transpose=True)), True),
    ("vector_norm", L + "vector_norm", lambda r: ([r.n(3, 4)], {}), True),
    ("vector_norm_p1_axis", L + "vector_norm", lambda r: ([r.n(3, 4)], dict(
        p=1.0, axis=1, keepdim=True)), True),
    ("vector_norm_inf", L + "vector_norm", lambda r: ([r.n(3, 4)], dict(
        p=float("inf"), axis=[0, 1])), True),
    ("vector_norm_p0", L + "vector_norm", lambda r: (
        [r.n(3, 4) * r.b(3, 4)], dict(p=0)), False),
    ("matrix_norm", L + "matrix_norm", lambda r: ([r.n(3, 4)], {}), True),
    ("matrix_norm_nuc", L + "matrix_norm", lambda r: ([r.n(2, 3, 4)], dict(
        p="nuc")), True),
    ("matrix_norm_1", L + "matrix_norm", lambda r: ([r.n(3, 4)], dict(
        p=1)), True),
    ("matrix_norm_neg_inf_keepdim", L + "matrix_norm", lambda r: (
        [r.n(2, 3, 4)], dict(p=float("-inf"), keepdim=True)), True),
    ("matrix_norm_2", L + "matrix_norm", lambda r: ([r.n(3, 4)], dict(p=2)),
     True),
    ("cholesky_inverse", L + "cholesky_inverse", lambda r: (
        [np.linalg.cholesky(r.spd(3)).astype(np.float32)], {}), True),
    ("cholesky_inverse_upper", L + "cholesky_inverse", lambda r: (
        [np.linalg.cholesky(r.spd(3)).T.copy().astype(np.float32)], dict(
            upper=True)), True),
]


@pytest.mark.parametrize("case", CASES, ids=ids(CASES))
def test_op_against_reference(case):
    run_case(case, tol=TOL3 if case[0].startswith(("matrix_power_neg",
                                                    "cond")) else None)


def test_every_linalg_op_is_covered():
    from paddle_tpu.ops import linalg as ref

    done = {c[1][len(L):] for c in CASES if isinstance(c[1], str)}
    done |= {"svd", "qr", "eigh", "lu_unpack", "lu_solve", "eig", "eigvals",
             "svd_lowrank", "pca_lowrank"}
    assert set(ref.__all__) - done == set()


def test_eig_and_eigvals_by_invariants():
    a = R("eig").n(4, 4)
    wr, vr = pt.linalg.eig(pt.to_tensor(a))
    wp, vp = pp.linalg.eig(pp.to_tensor(a))
    key = lambda w: np.lexsort((np.round(w.imag, 4), np.round(w.real, 4)))
    w_r, w_p = wr.numpy(), wp.numpy()
    np.testing.assert_allclose(w_p[key(w_p)], w_r[key(w_r)], rtol=1e-4,
                               atol=1e-5)
    v = vp.numpy()
    np.testing.assert_allclose(a @ v, v * w_p, rtol=1e-4, atol=1e-4)
    ev = pp.linalg.eigvals(pp.to_tensor(a)).numpy()
    np.testing.assert_allclose(ev[key(ev)], w_r[key(w_r)], rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("name", ["svd_lowrank", "pca_lowrank"])
def test_randomized_svd_by_invariants(name):
    """Randomized: U diag(S) V^T reconstructs a rank-2 input, and S equals
    the reference's (and the exact) singular values."""
    r = R(name)
    a = (r.n(6, 2) @ r.n(2, 5)).astype(np.float32)
    if name == "pca_lowrank":
        a = a - a.mean(0, keepdims=True)
    kw = dict(q=2) if name == "svd_lowrank" else dict(q=2, center=False)
    up, sp, vp = getattr(pp.linalg, name)(pp.to_tensor(a), **kw)
    ur, sr, vr = getattr(pt.linalg, name)(pt.to_tensor(a), **kw)
    assert_close(sp, sr, TOL3)
    np.testing.assert_allclose(np.linalg.svd(a, compute_uv=False)[:2],
                               sp.numpy(), rtol=1e-4)
    rec = up.numpy() @ np.diag(sp.numpy()) @ vp.numpy().T
    np.testing.assert_allclose(rec, a, atol=1e-4)


@pytest.mark.parametrize("name", ["svd", "qr", "eigh"])
def test_decomposition_gradients(name):
    """The reference's tape raises on ``svd`` / ``qr`` / ``eigh`` backward
    (its ``run_op`` hands the vjp a tuple where ``jnp`` returned a named
    one: a reference caveat), so the port's gradients of a sign-free
    function of the factors are held to ``jax.grad`` of the reference's
    own lowering (``jnp.linalg``)."""
    import jax
    import jax.numpy as jnp

    r = R("grad_" + name)
    a = r.spd(3) if name == "eigh" else r.n(4, 3)
    w1 = r.n(*((3,) if name != "qr" else (4, 3)))
    w2 = r.n(*a.shape)

    def jax_loss(m):
        if name == "svd":
            u, s, vh = jnp.linalg.svd(m, full_matrices=False)
            rec = (u * s) @ vh
        elif name == "qr":
            q, rr = jnp.linalg.qr(m)
            s, rec = q @ rr, q @ rr
        else:
            s, v = jnp.linalg.eigh(m)
            rec = (v * s) @ v.T
        return jnp.sum(s * w1) + jnp.sum(rec * w2)

    want = np.asarray(jax.grad(jax_loss)(jnp.asarray(a)))
    x = pp.to_tensor(a, stop_gradient=False)
    if name == "svd":
        u, s, vh = pp.linalg.svd(x)
        rec = (u * s.unsqueeze(-2)) @ vh
    elif name == "qr":
        q, rr = pp.linalg.qr(x)
        s = rec = q @ rr
    else:
        s, v = pp.linalg.eigh(x)
        rec = (v * s.unsqueeze(-2)) @ v.T
    ((s * torch.from_numpy(w1)).sum() + (rec * torch.from_numpy(w2)).sum()
     ).backward()
    np.testing.assert_allclose(x.grad.numpy(), want, rtol=1e-3, atol=1e-4)


def test_lu_pivots_are_one_based_int32():
    a = R("lu_piv").n(3, 3)
    _, piv = pp.linalg.lu(pp.to_tensor(a))
    assert piv.dtype == torch.int32 and int(piv.min()) >= 1
