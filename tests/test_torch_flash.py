"""The port's flash-attention and head-dx kernels' plain versions against
the JAX package's Pallas kernels, on the CPU.

A CPU tensor takes the plain version (the kernel's arithmetic written out
in PyTorch); the Pallas kernels run in interpret mode, reached by patching
``jax.experimental.pallas.pallas_call`` (the JAX functions look it up when
they are called). Inputs are numpy float32 from a seed. JAX's lse layouts
are converted to the port's natural-log ``[B, H, S]``: the packed kernels'
base-2 ``[B, G, hp, S]`` (head g * hp + i) and the blocked kernels'
``[B * H, S, 1]``.

Tolerance 2e-5 (rtol and atol) in float32: the two sides sum in other
orders and scale q before (JAX) or after (the port) the product.
"""

import functools

import jax.experimental.pallas as pallas
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.ops.pallas.flash_attention as jfa
from paddle_tpu.ops.pallas.head_dx import head_dx_softmax as jax_head_dx
from paddle_tpu_torch.ops.kernels import flash_attention as fa
from paddle_tpu_torch.ops.kernels import head_dx as hd

TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture
def interpret(monkeypatch):
    """Every ``pallas_call`` in interpret mode, on the CPU."""
    monkeypatch.setattr(pallas, "pallas_call", functools.partial(
        pallas.pallas_call, interpret=True))


def _inputs(seed, B, S, H, D):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, S, H, D).astype(np.float32) for _ in range(4)]


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or TOL))


CASES = [  # B, S, H, D, causal
    (2, 128, 4, 32, True), (2, 256, 4, 32, False), (1, 256, 4, 64, True),
    (2, 128, 2, 64, False)]


@pytest.mark.parametrize("B,S,H,D,causal", CASES)
def test_plain_matches_packed_pallas(interpret, B, S, H, D, causal):
    """S <= 512 with 128 // D heads per cell: the packed kernels (fused
    backward, base-2 lse)."""
    q, k, v, do = _inputs(S + D, B, S, H, D)
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    assert jfa._packed_eligible(jq, jk)
    jout, jlse = jfa._pallas_flash_fwd_packed(jq, jk, jv, causal)
    jdq, jdk, jdv = jfa._pallas_flash_bwd_packed(jq, jk, jv, jdo, jout, jlse,
                                                 causal)
    tq, tk, tv, tdo = _t(q, k, v, do)
    out, lse = fa.flash_attention_fwd(tq, tk, tv, causal)
    _close(out, jout)
    _close(lse, np.asarray(jlse).reshape(B, H, S) / np.log2(np.e))
    # the backward from JAX's own forward, so only the backward differs
    grads = fa.flash_attention_bwd_plain(
        tq, tk, tv, *_t(jout, np.asarray(jlse).reshape(B, H, S)
                        / np.log2(np.e)), tdo, causal)
    for g, w in zip(grads, (jdq, jdk, jdv)):
        _close(g, w)


@pytest.mark.parametrize("B,S,H,D,causal", CASES)
def test_plain_matches_blocked_pallas(interpret, B, S, H, D, causal):
    """Blocks of 128: at S 256 the online-softmax loop, the causal block
    skip and the dk/dv kernel's start at the diagonal run over two
    blocks."""
    q, k, v, do = _inputs(S + D + 1, B, S, H, D)
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    jout, jlse = jfa._pallas_flash_fwd_lse(jq, jk, jv, causal, block_q=128,
                                           block_k=128)
    jdq, jdk, jdv = jfa._pallas_flash_bwd(jq, jk, jv, jdo, jout, jlse,
                                          causal, block_q=128, block_k=128)
    tq, tk, tv, tdo = _t(q, k, v, do)
    out, lse = fa.flash_attention_fwd(tq, tk, tv, causal)
    _close(out, jout)
    jl = np.asarray(jlse).reshape(B, H, S)
    _close(lse, jl)
    lse_t, out_t = _t(jl, jout)
    delta = fa.attention_delta(out_t, tdo)
    _close(fa.flash_attention_bwd_dq(tq, tk, tv, tdo, lse_t, delta, causal),
           jdq)
    dk, dv = fa.flash_attention_bwd_dkv(tq, tk, tv, tdo, lse_t, delta,
                                        causal)
    _close(dk, jdk)
    _close(dv, jdv)


@pytest.mark.parametrize("kernel", ["packed", "blocked"])
@pytest.mark.parametrize("B,S,H,D,causal", CASES)
def test_one_launch_backward_matches_pallas(interpret, kernel, B, S, H, D,
                                            causal):
    """``flash_attention_bwd`` (dq, dk and dv from one call) on CPU tensors
    against the fused packed backward and the blocked one (blocks of 128),
    both fed JAX's own forward."""
    q, k, v, do = _inputs(S + D + 2, B, S, H, D)
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    if kernel == "packed":
        jout, jlse = jfa._pallas_flash_fwd_packed(jq, jk, jv, causal)
        want = jfa._pallas_flash_bwd_packed(jq, jk, jv, jdo, jout, jlse,
                                            causal)
        lse = (np.asarray(jlse).reshape(B, H, S)
               / np.log2(np.e)).astype(np.float32)
    else:
        jout, jlse = jfa._pallas_flash_fwd_lse(jq, jk, jv, causal,
                                               block_q=128, block_k=128)
        want = jfa._pallas_flash_bwd(jq, jk, jv, jdo, jout, jlse, causal,
                                     block_q=128, block_k=128)
        lse = np.asarray(jlse).reshape(B, H, S)
    tq, tk, tv, tdo, lse_t, out_t = _t(q, k, v, do, lse, jout)
    got = fa.flash_attention_bwd(tq, tk, tv, tdo, lse_t,
                                 fa.attention_delta(out_t, tdo), causal)
    assert len(got) == 3
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,sk", [(64, 64), (48, 80)])
def test_plain_backward_matches_autograd(causal, sq, sk):
    """The flash backward written out equals autograd through
    ``xla_attention``, here also with Sq < Sk (causal offset Sk - Sq)."""
    rng = np.random.RandomState(sq + sk)
    q = torch.from_numpy(rng.randn(2, sq, 3, 16).astype(np.float32))
    k, v = (torch.from_numpy(rng.randn(2, sk, 3, 16).astype(np.float32))
            for _ in range(2))
    do = torch.from_numpy(rng.randn(2, sq, 3, 16).astype(np.float32))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ref = fa.xla_attention(*leaves, is_causal=causal)
    ref.backward(do)
    out, lse = fa.flash_attention_fwd_plain(q, k, v, causal)
    torch.testing.assert_close(out, ref.detach(), **TOL)
    got = fa.flash_attention_bwd_plain(q, k, v, out, lse, do, causal)
    for g, leaf in zip(got, leaves):
        torch.testing.assert_close(g, leaf.grad, **TOL)


def test_dot_product_attention_gradient():
    """The autograd Function on the CPU: its forward and gradients equal
    autograd through ``xla_attention``; a mask takes ``xla_attention``."""
    rng = np.random.RandomState(7)
    q, k, v, do = (torch.from_numpy(rng.randn(2, 40, 4, 8).astype(np.float32))
                   for _ in range(4))
    got = [t.clone().requires_grad_() for t in (q, k, v)]
    want = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fa.dot_product_attention(*got, is_causal=True)
    ref = fa.xla_attention(*want, is_causal=True)
    torch.testing.assert_close(out, ref, **TOL)
    out.backward(do)
    ref.backward(do)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.grad, w.grad, **TOL)
    mask = torch.from_numpy(rng.rand(2, 4, 40, 40) > 0.3)
    mask[..., 0] = True
    torch.testing.assert_close(
        fa.dot_product_attention(q, k, v, mask=mask),
        fa.xla_attention(q, k, v, mask=mask))
    assert not fa.flash_path_active(q)


def test_cpu_tensors_never_reach_the_kernels(monkeypatch):
    def no_kernel(*a):
        raise AssertionError("a CUDA kernel was reached on the CPU")

    monkeypatch.setattr(fa, "_kernel", no_kernel)
    monkeypatch.setattr(hd, "_kernel", no_kernel)
    rng = np.random.RandomState(2)
    q, k, v, do = (torch.from_numpy(rng.randn(1, 64, 2, 64).astype(np.float32))
                   for _ in range(4))
    counters = (fa.flash_attention_fwd, fa.flash_attention_bwd,
                fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv,
                hd.head_dx_softmax)
    counts = [f.launches for f in counters]
    out, lse = fa.flash_attention_fwd(q, k, v, True)
    delta = fa.attention_delta(out, do)
    fa.flash_attention_bwd(q, k, v, do, lse, delta, True)
    fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, True)
    fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, True)
    logits = torch.from_numpy(rng.randn(8, 32).astype(np.float32))
    hd.head_dx_softmax(logits, logits.max(-1).values, torch.ones(8),
                       torch.ones(16, 32))
    assert [f.launches for f in counters] == counts


def test_rejects_bad_inputs():
    q = torch.zeros(1, 8, 2, 64)
    with pytest.raises(ValueError, match="Sq <= Sk"):
        fa.flash_attention_fwd(q, q[:, :4], q[:, :4], causal=True)
    with pytest.raises(ValueError, match="repeat kv heads"):
        fa.flash_attention_fwd(q, q[:, :, :1], q[:, :, :1])
    with pytest.raises(TypeError, match="dtype"):
        fa.flash_attention_fwd(q.double(), q.double(), q.double())
    lse = torch.zeros(1, 2, 8)
    with pytest.raises(ValueError, match="lse"):
        fa.flash_attention_bwd_dq(q, q, q, q, lse[:, :1], lse)
    with pytest.raises(ValueError, match="delta"):
        fa.flash_attention_bwd_dkv(q, q, q, q, lse, lse.double())
    with pytest.raises(ValueError, match="devices"):
        fa.flash_attention_fwd(q, q, q.to("meta"))
    with pytest.raises(ValueError, match=r"\[M, V\]"):
        hd.head_dx_softmax(torch.zeros(4, 8), torch.zeros(4), torch.zeros(4),
                           torch.zeros(2, 6))
    with pytest.raises(ValueError, match="scale"):
        hd.head_dx_softmax(torch.zeros(4, 8), torch.zeros(4),
                           torch.zeros(4).double(), torch.zeros(2, 8))


@pytest.mark.parametrize("entry", ["flash_attention_bwd",
                                   "flash_attention_bwd_dq",
                                   "flash_attention_bwd_dkv"])
def test_backward_entries_reject_the_same(entry):
    """The one-launch backward and the two role launches check their
    operands alike: Sq <= Sk when causal, kv heads, dtypes, lse and delta
    shapes and dtypes, one device."""
    fn = getattr(fa, entry)
    q = torch.zeros(1, 8, 2, 64)
    lse = torch.zeros(1, 2, 8)
    with pytest.raises(ValueError, match="Sq <= Sk"):
        fn(q, q[:, :4], q[:, :4], q, lse, lse, causal=True)
    with pytest.raises(ValueError, match="repeat kv heads"):
        fn(q, q[:, :, :1], q[:, :, :1], q, lse, lse)
    with pytest.raises(TypeError, match="dtype"):
        fn(q.double(), q.double(), q.double(), q.double(), lse, lse)
    with pytest.raises(ValueError, match="do must be"):
        fn(q, q, q, q[:, :4], lse, lse)
    with pytest.raises(ValueError, match="lse"):
        fn(q, q, q, q, lse[:, :1], lse)
    with pytest.raises(ValueError, match="delta"):
        fn(q, q, q, q, lse, lse.double())
    with pytest.raises(ValueError, match="devices"):
        fn(q, q, q, q, lse, lse.to("meta"))


def test_dot_product_attention_backward_is_one_call(monkeypatch):
    """``dot_product_attention``'s backward goes through
    ``flash_attention_bwd`` once, with the forward's lse and delta =
    rowsum(do * out), and never through the role-only entries."""
    calls = []
    real = fa.flash_attention_bwd

    def spy(*args):
        calls.append(args)
        return real(*args)

    def role_only(*a, **kw):
        raise AssertionError("a role-only backward entry was called")

    monkeypatch.setattr(fa, "flash_attention_bwd", spy)
    monkeypatch.setattr(fa, "flash_attention_bwd_dq", role_only)
    monkeypatch.setattr(fa, "flash_attention_bwd_dkv", role_only)
    rng = np.random.RandomState(9)
    q, k, v, do = (torch.from_numpy(rng.randn(2, 24, 3, 16)
                                    .astype(np.float32)) for _ in range(4))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fa.dot_product_attention(*leaves, is_causal=True)
    out.backward(do)
    assert len(calls) == 1
    _, lse = fa.flash_attention_fwd_plain(q, k, v, True)
    cq, ck, cv, cdo, clse, cdelta, causal, scale = calls[0]
    assert causal is True and scale is None
    torch.testing.assert_close(clse, lse, **TOL)
    torch.testing.assert_close(cdelta, fa.attention_delta(out.detach(), do),
                               **TOL)
    want = fa.flash_attention_bwd_plain(q, k, v, out.detach(), lse, do, True)
    for g, leaf in zip(want, leaves):
        torch.testing.assert_close(leaf.grad, g, **TOL)


def _head_dx_inputs(seed, M, V, H):
    rng = np.random.RandomState(seed)
    logits = rng.randn(M, V).astype(np.float32)
    m = logits.max(-1)
    se = np.exp(logits - m[:, None]).sum(-1)
    scale = (rng.rand(M).astype(np.float32) / se).astype(np.float32)
    w = rng.randn(H, V).astype(np.float32)
    return logits, m, scale, w


def test_head_dx_plain_matches_pallas(interpret):
    """The blocked Pallas kernel (bm 128: two row blocks, two V blocks),
    which takes W^T where the port takes W."""
    logits, m, scale, w = _head_dx_inputs(3, 256, 1024, 64)
    ref = jax_head_dx(jnp.asarray(logits), jnp.asarray(m),
                      jnp.asarray(scale), jnp.asarray(w.T), bm=128)
    got = hd.head_dx_softmax(*_t(logits, m, scale, w))
    _close(got, ref, rtol=1e-5, atol=1e-5)


def test_head_dx_plain_matches_fallback_shape():
    """A shape the Pallas kernel cannot tile (V 96 < a lane tile) takes its
    XLA formulation there, as in tests/test_ce_tail.py."""
    logits, m, scale, w = _head_dx_inputs(4, 48, 96, 16)
    ref = jax_head_dx(jnp.asarray(logits), jnp.asarray(m),
                      jnp.asarray(scale), jnp.asarray(w.T))
    got = hd.head_dx_softmax(*_t(logits, m, scale, w))
    _close(got, ref, rtol=1e-4, atol=1e-5)
    _close(got, (np.exp(logits - m[:, None]) * scale[:, None]) @ w.T,
           rtol=1e-4, atol=1e-5)
