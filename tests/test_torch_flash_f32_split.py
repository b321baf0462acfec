"""The fp32 flash kernels' 3xTF32 arithmetic, emulated on the CPU, against
the JAX package's flash attention in interpret mode.

``csrc/flash_attention_f32.cu`` computes every product on the tensor cores
as three TF32 products. Each fp32 operand x is split into hi, x rounded to
TF32 (10 mantissa bits) to nearest with ties away from zero as
``cvt.rna.tf32.f32`` rounds, and lo = x - hi (exact), which the tensor core
reads rounded toward zero to TF32; a product is hi lo + lo hi + hi hi,
summed in fp32. Here that arithmetic is emulated in torch (the roundings on
the int32 view of the fp32 bits), and the emulated forward (out, lse) and
backward (dq, dk, dv) are held to the JAX package's blocked Pallas kernels
(``_pallas_flash_fwd_lse``, ``_pallas_flash_bwd``, one block a sequence)
within ``FLASH_F32_ATOL``, chip_smoke.py's bar for the kernels: at D 64 and
128, S off the kernels' 32- and 64-row tiles, and causal with Sq < Sk. On
the same inputs one TF32 pass misses that bar, which is why the kernels
take three.

The emulation takes the softmax over a whole row at once, where the kernels
run it online over key tiles (the same values up to fp32 rounding), and
sums in IEEE fp32, where the tensor core rounds its sums toward zero. The
backward is fed JAX's own forward, so that only the backward differs. Each
case's JAX side is one jitted call, run once.
"""

import functools
import math

import jax
import jax.experimental.pallas as pallas
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.ops.pallas.flash_attention as jfa

FLASH_F32_ATOL = 1e-4
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453

CASES = [  # B, Sq, Sk, H, D, causal
    (1, 100, 100, 2, 64, False),   # ragged at 64 rows
    (2, 72, 136, 2, 64, True),     # causal, Sq < Sk: offset 64
    (1, 40, 100, 2, 128, True),    # D 128, offset 60, ragged at 32 keys
    (1, 96, 80, 2, 128, False),    # D 128, Sq > Sk
]


# ---------------------------------------------------------------------------
# the kernels' arithmetic
# ---------------------------------------------------------------------------

def tf32_rna(x):
    """x rounded to TF32 to nearest, ties away from zero: add half a TF32
    ulp to the magnitude's bits, clear the 13 bits below."""
    u = x.contiguous().view(torch.int32)
    return ((u + 0x1000) & -0x2000).view(torch.float32)


def tf32_rz(x):
    """x rounded to TF32 toward zero: the tensor core's reading of an
    fp32 register."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def split(x):
    hi = tf32_rna(x)
    return hi, tf32_rz(x - hi)


def mm3(a, b):
    """a @ b as the kernels compute it: three TF32 products."""
    ah, al = split(a)
    bh, bl = split(b)
    return (ah @ bl + al @ bh) + ah @ bh


def mm1(a, b):
    """a @ b in one TF32 pass."""
    return tf32_rna(a) @ tf32_rna(b)


def _heads(*ts):
    return [t.transpose(1, 2) for t in ts]  # [B, S, H, D] -> [B, H, S, D]


def _visible(Sq, Sk, causal):
    return torch.ones(Sq, Sk, dtype=torch.bool).tril(Sk - Sq) if causal \
        else torch.ones(Sq, Sk, dtype=torch.bool)


def emulated_forward(q, k, v, causal, mm):
    """(out [B, Sq, H, D], lse [B, H, Sq] natural log)."""
    Sq, Sk, D = q.shape[1], k.shape[1], q.shape[-1]
    qh, kh, vh = _heads(q, k, v)
    s = mm(qh, kh.transpose(-1, -2)) * (LOG2E / math.sqrt(D))
    s = s.masked_fill(~_visible(Sq, Sk, causal), -math.inf)
    m = s.amax(-1, keepdim=True)
    p = torch.exp2(s - m)
    l = p.sum(-1, keepdim=True)
    out = mm(p, vh) / l
    return out.transpose(1, 2), ((m + torch.log2(l)) * LN2)[..., 0]


def emulated_backward(q, k, v, do, out, lse, causal, mm):
    """(dq, dk, dv) from the forward's out and lse, as the kernels' two
    roles compute them."""
    Sq, Sk, D = q.shape[1], k.shape[1], q.shape[-1]
    scale = 1.0 / math.sqrt(D)
    qh, kh, vh, doh = _heads(q, k, v, do)
    delta = (do * out).sum(-1).transpose(1, 2)[..., None]
    s = mm(qh, kh.transpose(-1, -2))
    p = torch.exp2(s * (scale * LOG2E) - lse[..., None] * LOG2E)
    p = p.masked_fill(~_visible(Sq, Sk, causal), 0.0)
    ds = p * (mm(doh, vh.transpose(-1, -2)) - delta)
    dq = mm(ds, kh) * scale
    dk = mm(ds.transpose(-1, -2), qh) * scale
    dv = mm(p.transpose(-1, -2), doh)
    return [g.transpose(1, 2) for g in (dq, dk, dv)]


# ---------------------------------------------------------------------------
# the reference
# ---------------------------------------------------------------------------

def _inputs(case):
    B, Sq, Sk, H, D, _ = case
    rng = np.random.RandomState(Sq * 7 + Sk + D)
    return [rng.randn(B, S, H, D).astype(np.float32)
            for S in (Sq, Sk, Sk, Sq)]


@functools.partial(jax.jit, static_argnames=("causal",))
def _jax_fwd_bwd(q, k, v, do, causal):
    Sq, Sk = q.shape[1], k.shape[1]
    out, lse = jfa._pallas_flash_fwd_lse(q, k, v, causal, block_q=Sq,
                                         block_k=Sk)
    grads = jfa._pallas_flash_bwd(q, k, v, do, out, lse, causal,
                                  block_q=Sq, block_k=Sk)
    return out, lse, grads


@functools.lru_cache(maxsize=None)
def _reference(case):
    """JAX's out, lse [B, H, Sq] and (dq, dk, dv), every pallas_call in
    interpret mode."""
    B, Sq, _, H, _, causal = case
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pallas, "pallas_call", functools.partial(
            pallas.pallas_call, interpret=True))
        out, lse, grads = _jax_fwd_bwd(*map(jnp.asarray, _inputs(case)),
                                       causal=causal)
    return (np.asarray(out), np.asarray(lse).reshape(B, H, Sq),
            [np.asarray(g) for g in grads])


def _worst(got, want):
    return max(float(np.abs(np.asarray(g) - w).max())
               for g, w in zip(got, want))


def _emulated(case, mm):
    """The emulated forward and, from JAX's forward, backward."""
    q, k, v, do = map(torch.from_numpy, _inputs(case))
    out, lse = emulated_forward(q, k, v, case[-1], mm)
    jout, jlse, _ = _reference(case)
    grads = emulated_backward(q, k, v, do, torch.tensor(jout),
                              torch.tensor(jlse), case[-1], mm)
    return out, lse, grads


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

def test_tf32_roundings():
    """To nearest, a tie goes away from zero (1 + 2^-11 lies halfway
    between 1, whose last TF32 bit is even, and 1 + 2^-10), whatever the
    sign; toward zero the low bits drop; hi + lo is x exactly."""
    tie = 1.0 + 2.0 ** -11
    x = torch.tensor([tie, -tie, tie - 2.0 ** -23, 3.0, 1.0 + 2.0 ** -12])
    assert tf32_rna(x).tolist() == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10),
                                    1.0, 3.0, 1.0]
    assert tf32_rz(x).tolist() == [1.0, -1.0, 1.0, 3.0, 1.0]
    r = torch.randn(1000)
    hi, lo = split(r)
    assert torch.equal(hi + (r - hi), r)
    assert torch.equal(tf32_rna(hi), hi) and torch.equal(tf32_rz(lo), lo)
    assert ((r - hi).abs() <= hi.abs() * 2.0 ** -11).all()


@pytest.mark.parametrize("case", CASES, ids=str)
def test_three_pass_forward_matches_reference(case):
    out, lse, _ = _emulated(case, mm3)
    jout, jlse, _ = _reference(case)
    np.testing.assert_allclose(out.numpy(), jout, rtol=0,
                               atol=FLASH_F32_ATOL)
    np.testing.assert_allclose(lse.numpy(), jlse, rtol=0,
                               atol=FLASH_F32_ATOL)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_three_pass_backward_matches_reference(case):
    _, _, grads = _emulated(case, mm3)
    for g, w in zip(grads, _reference(case)[2]):
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=FLASH_F32_ATOL)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_one_pass_misses_the_bar(case):
    """One TF32 pass keeps about three decimal digits: on the same inputs
    its out or gradients leave the bar that three passes keep, by ten
    times the three passes' own worst error at least."""
    jout, jlse, jgrads = _reference(case)
    worst = {}
    for name, mm in (("three", mm3), ("one", mm1)):
        out, lse, grads = _emulated(case, mm)
        worst[name] = _worst([out, lse, *grads], [jout, jlse, *jgrads])
    assert worst["three"] <= FLASH_F32_ATOL
    assert worst["one"] > FLASH_F32_ATOL
    assert worst["one"] > 10 * worst["three"]
