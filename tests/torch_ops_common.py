"""Shared harness of the op-corpus tests (``tests/test_torch_ops_*.py``):
the same seeded numpy inputs through an op of the JAX package and its
counterpart in the port, outputs and input gradients compared at
``tests/op_test.py``'s float32 tolerance.

A case is ``(id, op, build, grad)``: ``op`` names the op in both packages
(or is a ``(pkg) -> callable`` for a call that is not ``pkg.<op>``),
``build(R)`` returns ``(args, kwargs)`` from a seeded ``R``, where numpy
arrays (also inside lists) become tensors of each package, and ``grad``
asks for the gradients of every floating input against a seeded weighted
sum of the floating outputs. Integer outputs are compared by value: the
port keeps int64 where the reference, without 64-bit types, has int32.
The reference runs eagerly: each op here is a handful of primitives,
0.05-0.5 s a case (a whole program a case costs as much to compile).
"""

from __future__ import annotations

import zlib

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as pp
from paddle_tpu_torch.experiments.op_corpus import to_numpy as to_np

TOL = dict(rtol=2e-4, atol=1e-5)  # tests/op_test.py TOL["float32"]


class R:
    """Seeded numpy inputs (one generator per case, seeded by its id)."""

    def __init__(self, key: str):
        self.g = np.random.default_rng(zlib.crc32(key.encode()))

    def n(self, *s):
        return self.g.standard_normal(s).astype(np.float32)

    def u(self, *s, lo=0.1, hi=0.9):
        return self.g.uniform(lo, hi, s).astype(np.float32)

    def i(self, *s, lo=0, hi=5):
        return self.g.integers(lo, hi, s).astype(np.int64)

    def b(self, *s):
        return self.g.random(s) < 0.5

    def spd(self, n, batch=()):
        a = self.g.standard_normal(batch + (n, n)).astype(np.float32)
        return (a @ np.swapaxes(a, -1, -2) + n * np.eye(n, dtype=np.float32)
                ).astype(np.float32)


@pytest.fixture(autouse=True, scope="module")
def on_cpu():
    prev = pp.set_device("cpu")
    yield
    pp.set_device(prev)


def _tensors(pkg, v, grad):
    if isinstance(v, np.ndarray):
        if pkg is pt:
            return pt.to_tensor(v, stop_gradient=not (
                grad and v.dtype.kind == "f"))
        return pp.to_tensor(v, place="cpu", stop_gradient=not (
            grad and v.dtype.kind == "f"))
    if isinstance(v, list):
        return [_tensors(pkg, e, grad) for e in v]
    if isinstance(v, tuple):
        return tuple(_tensors(pkg, e, grad) for e in v)
    return v


def _leaves(v):
    if isinstance(v, (list, tuple)):
        for e in v:
            yield from _leaves(e)
    elif v is not None:
        yield v


def assert_close(got, want, tol=None, what="output"):
    tol = tol or TOL
    got, want = to_np(got), to_np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if want.dtype.kind in "fc" or got.dtype.kind in "fc":
        np.testing.assert_allclose(got.astype(np.complex128 if (
            got.dtype.kind == "c" or want.dtype.kind == "c") else np.float64),
            want, err_msg=what, **tol)
    else:
        np.testing.assert_array_equal(got.astype(np.int64),
                                      want.astype(np.int64), err_msg=what)


def call(pkg, op, args, kwargs):
    fn = op(pkg) if callable(op) else _attr(pkg, op)
    return fn(*args, **kwargs)


def _attr(pkg, path):
    obj = pkg
    for part in path.split("."):
        obj = getattr(obj, part)
    return obj


def _weighted(pkg, outs, rng):
    total = None
    for o in outs:
        if pkg is pt:
            if not isinstance(o, pt.Tensor) or not o.is_floating_point():
                continue
            w = pt.to_tensor(rng.standard_normal(o.shape).astype(np.float32))
            s = pt.sum(pt.multiply(o, w))
        else:
            if not isinstance(o, torch.Tensor) or not o.is_floating_point():
                continue
            w = torch.from_numpy(rng.standard_normal(tuple(o.shape)).astype(
                np.float32))
            s = (o * w).sum()
        total = s if total is None else total + s
    return total


def run_case(case, tol=None, grad_tol=None):
    """Run ``case`` through both packages and compare outputs and, when it
    asks, the gradients of its floating inputs."""
    cid, op, build, grad = case
    args, kwargs = build(R(cid))
    ref_args = _tensors(pt, args, grad)
    port_args = _tensors(pp, args, grad)
    ref = call(pt, op, ref_args, kwargs)
    port = call(pp, op, port_args, kwargs)
    ref_out, port_out = list(_leaves(ref)), list(_leaves(port))
    assert len(ref_out) == len(port_out), (cid, len(ref_out), len(port_out))
    for k, (p, r) in enumerate(zip(port_out, ref_out)):
        assert_close(p, r, tol, f"{cid} output {k}")
    if not grad:
        return
    ref_in = [t for t in _leaves(ref_args) if isinstance(t, pt.Tensor)
              and not t.stop_gradient]
    port_in = [t for t in _leaves(port_args) if isinstance(t, torch.Tensor)
               and t.requires_grad]
    assert len(ref_in) == len(port_in) and ref_in, cid
    lr = _weighted(pt, ref_out, np.random.default_rng(7))
    lp = _weighted(pp, port_out, np.random.default_rng(7))
    assert (lr is None) == (lp is None), cid
    lr.backward()
    lp.backward()
    for k, (p, r) in enumerate(zip(port_in, ref_in)):
        gr = np.zeros(r.shape, np.float32) if r.grad is None else r.grad
        gp = torch.zeros(p.shape) if p.grad is None else p.grad
        assert_close(gp, gr, grad_tol or tol, f"{cid} gradient {k}")


def ids(cases):
    return [c[0] for c in cases]
