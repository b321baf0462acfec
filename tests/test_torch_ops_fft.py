"""``fft.py`` of the port against the JAX package's: every registered
transform, outputs and input gradients, on the same seeded inputs."""

import numpy as np
import pytest

import paddle_tpu_torch as pp
from torch_ops_common import ids, on_cpu, run_case  # noqa: F401

F = "fft."


def _c(r, *s):
    return (r.n(*s) + 1j * r.n(*s)).astype(np.complex64)


CASES = [
    ("fft", F + "fft", lambda r: ([_c(r, 3, 8)], {}), False),
    ("fft_real_n_norm", F + "fft", lambda r: ([r.n(3, 8)], dict(
        n=6, axis=0, norm="ortho")), False),
    ("ifft", F + "ifft", lambda r: ([_c(r, 8)], dict(norm="forward")), False),
    ("rfft", F + "rfft", lambda r: ([r.n(4, 8)], {}), False),
    ("irfft", F + "irfft", lambda r: ([_c(r, 2, 5)], {}), False),
    ("irfft_n", F + "irfft", lambda r: ([_c(r, 5)], dict(n=9)), False),
    ("hfft", F + "hfft", lambda r: ([_c(r, 5)], {}), False),
    ("ihfft", F + "ihfft", lambda r: ([r.n(8)], {}), False),
    ("fft2", F + "fft2", lambda r: ([_c(r, 2, 4, 4)], {}), False),
    ("ifft2", F + "ifft2", lambda r: ([_c(r, 4, 6)], {}), False),
    ("rfft2", F + "rfft2", lambda r: ([r.n(4, 6)], {}), False),
    ("irfft2", F + "irfft2", lambda r: ([_c(r, 4, 4)], {}), False),
    ("fftn", F + "fftn", lambda r: ([_c(r, 2, 3, 4)], {}), False),
    ("fftn_s_axes", F + "fftn", lambda r: ([r.n(3, 4, 5)], dict(
        s=[4, 4], axes=[1, 2])), False),
    ("ifftn", F + "ifftn", lambda r: ([_c(r, 2, 3, 4)], {}), False),
    ("rfftn", F + "rfftn", lambda r: ([r.n(2, 3, 4)], {}), False),
    ("irfftn", F + "irfftn", lambda r: ([_c(r, 2, 3, 3)], {}), False),
    ("fftshift", F + "fftshift", lambda r: ([r.n(4, 5)], {}), True),
    ("fftshift_axes", F + "fftshift", lambda r: ([r.n(4, 5)], dict(
        axes=[1])), True),
    ("ifftshift", F + "ifftshift", lambda r: ([r.n(5, 4)], {}), True),
    ("fftfreq", F + "fftfreq", lambda r: ([8], dict(d=0.5)), False),
    ("rfftfreq", F + "rfftfreq", lambda r: ([9], {}), False),
    # gradients through a transform: a real input, a real output
    ("rfft_irfft_grad", lambda pkg: lambda x: pkg.fft.irfft(
        pkg.fft.rfft(x) * 2.0, n=8), lambda r: ([r.n(3, 8)], {}), True),
    ("fft_abs_grad", lambda pkg: lambda x: pkg.abs(pkg.fft.fft(x)),
     lambda r: ([r.n(3, 8)], {}), True),
    ("hfft_ihfft_grad", lambda pkg: lambda x: pkg.fft.hfft(
        pkg.fft.ihfft(x) * 2.0, n=8), lambda r: ([r.n(3, 8)], {}), True),
    ("irfft2_rfft2_grad", lambda pkg: lambda x: pkg.fft.irfft2(
        pkg.fft.rfft2(x) * 2.0, s=[4, 6]), lambda r: ([r.n(2, 4, 6)], {}),
     True),
    ("irfftn_rfftn_grad", lambda pkg: lambda x: pkg.fft.irfftn(
        pkg.fft.rfftn(x) * 2.0, s=[3, 4, 6]), lambda r: ([r.n(3, 4, 6)], {}),
     True),
]
# every complex-valued transform differentiated through |.| of its output
CASES += [
    (f"{name}_grad", lambda pkg, name=name: lambda x: pkg.abs(
        getattr(pkg.fft, name)(x)), lambda r: ([r.n(2, 4, 6)], {}), True)
    for name in ("ifft", "rfft", "ihfft", "fft2", "ifft2", "rfft2", "fftn",
                 "ifftn", "rfftn")
]


@pytest.mark.parametrize("case", CASES, ids=ids(CASES))
def test_op_against_reference(case):
    run_case(case, tol=dict(rtol=2e-4, atol=2e-5))


def test_every_transform_has_a_case():
    from paddle_tpu import fft as ref

    done = {c[1][len(F):] for c in CASES if isinstance(c[1], str)}
    assert set(ref.__all__) - done == set()
    assert set(ref.__all__) <= set(pp.all_ops())
