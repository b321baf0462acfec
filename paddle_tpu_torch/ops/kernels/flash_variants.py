"""The packed flash-attention experiments: forward and backward variants
with their schedule knobs, and the stage-drop ablations.

Replaces the TPU kernels of ``benchmarks/flash_variants.py``:
``make_fwd`` (``run_fwd``), ``make_fwd2`` (``run_fwd2``) and
``make_fwd_diag`` (the forward ablations of ``run_diag``) become one
forward kernel; ``make_bwd`` (``run_bwd``) and ``make_bwd_diag`` (the
backward ablations) one backward kernel. The CUDA sources are
``paddle_tpu_torch/csrc/flash_variants_fwd.cu`` and
``flash_variants_bwd.cu``, each built into its own library; their shared
header ``flash_variants.cuh`` says what bounds the kernels on the H100 and
how their design follows. Each kernel is a
template instance per variant (``FLAGS``); ``nsplit`` is a run-time
argument, since it sets only loop bounds.

Functions, as the experiments define them (each a well-defined function,
the ablations' numerics wrong by design):

- ``run_fwd``: q prescaled outside the kernel to ``bf16(q * c)``, ``c =
  scale * log2(e)`` held in fp32; s = q k^T in fp32; row block r of height
  ``R = S / nsplit`` computes columns ``[0, (r + 1) R)`` only (so
  ``nsplit=1`` computes and masks the whole square); causal masks s to
  -inf before the exact row max m; ``p = exp2(s - m)`` (with ``exp_bf16``
  the argument is rounded to bf16 and exp2 is bf16's: XLA computes it as
  ``exp(x * ln 2)`` in the argument's type, ``bf16(exp(bf16(x *
  bf16(ln 2))))``, so p is bf16 and about 0.25 % of its exponent low);
  ``l = sum(p)``; ``out = (bf16(p) @ v) / l``; ``lse = m + log2(l)``
  (base 2).
- ``run_bwd``: from q, k, v, do, out and that lse; ``delta =
  rowsum(do * o)``; p as above, masked to 0 after exp2; ``ds = bf16(p *
  (dp - delta))``; ``dq = (ds k) * scale``; ``dk = (ds^T q_prescaled) /
  log2(e)``; ``dv = bf16(p)^T do``.
- ``run_fwd2``: ``run_fwd`` over the whole row (no nsplit, no exp_bf16)
  with the prescale inside the kernel (``in_kernel_scale``) and ``l``
  summed over bf16-rounded p (``p_bf16``). ``qblocks`` splits the TPU
  grid's q rows; the CUDA kernel always splits q rows across blocks, so
  ``qblocks`` does not change the CUDA schedule and every value gives the
  same result.
- ``fwd_diag`` / ``bwd_diag``: q not prescaled, no scale factors, causal
  unless "mask" is dropped. Forward drops: "mask" (no masking; with "exp"
  dropped the mask writes 0.0, not -inf), "max" (m = 0), "sum" (l = 1),
  "exp" (p = the argument); its lse is ``m + l``. Backward drops: "mask",
  "exp", "delta" (delta = 0), "ds" (ds = bf16(dp), masked or not).

Layouts (the reference's): q, k, v, do, out and the gradients ``[B, S, H,
D]``; lse fp32 ``[B, G, hp, S]`` with ``hp = 128 // D`` heads per packed
block and ``G = H / hp`` (head ``g * hp + i``; the same memory as ``[B, H,
S]``). It raises unless ``H % hp == 0``.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises (bf16, D in {64, 128}, S a multiple of 64, contiguous).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

__all__ = ["LOG2_E", "FWD_DROPS", "BWD_DROPS", "run_fwd", "run_bwd",
           "run_fwd2", "fwd_diag", "bwd_diag", "run_fwd_plain",
           "run_bwd_plain", "run_fwd2_plain", "fwd_diag_plain",
           "bwd_diag_plain", "variant_fwd", "variant_bwd",
           "variant_fwd_plain", "variant_bwd_plain", "fwd_flags",
           "bwd_flags", "FWD_INSTANCES", "BWD_INSTANCES", "smem_bytes"]

LOG2_E = math.log2(math.e)

# the ablations of run_diag, in the reference's order
FWD_DROPS = ((), ("mask",), ("max",), ("sum",), ("exp",),
             ("mask", "max", "sum", "exp"))
BWD_DROPS = ((), ("mask",), ("exp",), ("delta",), ("ds",),
             ("mask", "exp", "delta", "ds"))

# variant bits, as csrc/flash_variants.cuh names them
CAUSAL, EXP_BF16, P_BF16, SCALE_IN, DIAG = 1, 2, 4, 8, 16
_DROP_BIT = {"mask": 32, "max": 64, "sum": 128, "exp": 256, "delta": 512,
             "ds": 1024}
_HEAD_DIMS = (64, 128)
_TILE = 64


def _drop_bits(drop, allowed):
    bits = 0
    for d in drop:
        if d not in allowed:
            raise ValueError(f"unknown stage {d!r} to drop; the stages are "
                             f"{allowed}")
        bits |= _DROP_BIT[d]
    return bits


def fwd_flags(is_causal=True, exp_bf16=False, p_bf16=False,
              in_kernel_scale=False, drop=None):
    """The forward kernel's variant bits. ``drop`` (a tuple of stages)
    selects a diagnostic instance: causal unless "mask" is dropped."""
    if drop is not None:
        bits = _drop_bits(drop, ("mask", "max", "sum", "exp"))
        return DIAG | bits | (0 if "mask" in drop else CAUSAL)
    return ((CAUSAL if is_causal else 0) | (EXP_BF16 if exp_bf16 else 0)
            | (P_BF16 if p_bf16 else 0)
            | (SCALE_IN if in_kernel_scale else 0))


def bwd_flags(is_causal=True, exp_bf16=False, drop=None):
    """The backward kernel's variant bits (see ``fwd_flags``)."""
    if drop is not None:
        bits = _drop_bits(drop, ("mask", "exp", "delta", "ds"))
        return DIAG | bits | (0 if "mask" in drop else CAUSAL)
    return (CAUSAL if is_causal else 0) | (EXP_BF16 if exp_bf16 else 0)


# the instances the kernels are built for (one template instance each)
FWD_INSTANCES = frozenset(
    [fwd_flags(c, e, p, s) for c in (False, True)
     for e, p, s in ((False, False, False), (True, False, False),
                     (False, True, False), (False, False, True),
                     (False, True, True))]
    + [fwd_flags(drop=d) for d in FWD_DROPS])
BWD_INSTANCES = frozenset(
    [bwd_flags(c, e) for c in (False, True) for e in (False, True)]
    + [bwd_flags(drop=d) for d in BWD_DROPS])


def _scale(d):
    return 1.0 / math.sqrt(d)


def _prescale(q, c):
    """``bf16(q * c)`` (q's dtype) with the product in fp32, one pass:
    torch multiplies a bf16 tensor by a Python scalar in fp32 and rounds
    once, as JAX does with the reference's float64 constant."""
    return q * c


# ln 2 in bf16: XLA's exp2 of a bf16 argument is exp(x * LN2_BF16) with
# the product rounded to bf16
LN2_BF16 = 0.69140625


def _round(x, on):
    """x rounded to bf16 (kept fp32) where ``on``."""
    return x.to(torch.bfloat16).float() if on else x


def _exp2(arg, exp_bf16):
    """exp2 in fp32, or with ``exp_bf16`` bf16's exp2 of the argument
    rounded to bf16, as XLA computes it."""
    if not exp_bf16:
        return torch.exp2(arg)
    return _round(torch.exp(_round(_round(arg, True) * LN2_BF16, True)),
                  True)


def _extent(S, nsplit, device):
    """[S, S] bool: row i computes column j (j < R * (i // R + 1))."""
    R = S // nsplit
    i = torch.arange(S, device=device)
    return (torch.arange(S, device=device)[None, :]
            < (R * (i // R + 1))[:, None])


def _causal(S, device):
    return torch.ones(S, S, dtype=torch.bool, device=device).tril()


# ---------------------------------------------------------------------------
# plain versions: the kernels' functions over dense [B, H, S, S] scores
# ---------------------------------------------------------------------------

def variant_fwd_plain(q, k, v, flags, nsplit=1, cst=1.0):
    """The forward kernel's function: (out [B, S, H, D] in q's dtype, lse
    [B, H, S] fp32). q is used as given, or scaled by ``cst`` first where
    ``flags`` has SCALE_IN."""
    if flags & SCALE_IN:
        q = _prescale(q, cst)
    S, dev = q.shape[1], q.device
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    drop_exp = bool(flags & _DROP_BIT["exp"])
    if flags & CAUSAL:
        s = s.masked_fill(~_causal(S, dev),
                          0.0 if drop_exp else float("-inf"))
    inside = _extent(S, nsplit, dev)
    if flags & _DROP_BIT["max"]:
        m = torch.zeros(s.shape[:-1], device=dev)
        arg = s
    else:
        m = s.masked_fill(~inside, float("-inf")).amax(-1)
        arg = s - m[..., None]
    p = arg if drop_exp else _exp2(arg, bool(flags & EXP_BF16))
    p = p.masked_fill(~inside, 0.0)
    pv = p.to(v.dtype).float()
    if flags & _DROP_BIT["sum"]:
        l = torch.ones_like(m)
    else:
        l = (pv if flags & P_BF16 else p).sum(-1)
    o = torch.einsum("bhqk,bkhd->bqhd", pv, v.float())
    out = (o / l.transpose(1, 2)[..., None]).to(q.dtype).contiguous()
    lse = m + l if flags & DIAG else m + torch.log2(l)
    return out, lse


def variant_bwd_plain(q, k, v, do, o, lse, flags, nsplit=1, dq_scale=1.0,
                      dk_scale=1.0):
    """The backward kernel's function: (dq, dk, dv) [B, S, H, D] from q as
    the forward used it, do, o and lse [B, H, S] (base 2)."""
    S, dev = q.shape[1], q.device
    if flags & _DROP_BIT["delta"]:
        delta = torch.zeros(lse.shape, device=dev)
    else:
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    arg = s - lse[..., None]
    p = arg if flags & _DROP_BIT["exp"] else _exp2(arg,
                                                   bool(flags & EXP_BF16))
    if flags & CAUSAL:
        p = p.masked_fill(~_causal(S, dev), 0.0)
    inside = _extent(S, nsplit, dev)
    p = p.masked_fill(~inside, 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    ds = dp if flags & _DROP_BIT["ds"] else p * (dp - delta[..., None])
    ds = ds.masked_fill(~inside, 0.0).to(q.dtype).float()
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), do.float())
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * dq_scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * dk_scale
    return tuple(t.to(q.dtype).contiguous() for t in (dq, dk, dv))


# ---------------------------------------------------------------------------
# the kernel wrappers
# ---------------------------------------------------------------------------

def _check(q, k, v, nsplit, *more):
    """q, k, v [B, S, H, D] of one dtype and device, hp = 128 // D heads
    per packed block dividing H, S divisible by ``nsplit``; ``more``
    holds (name, tensor, shape, dtype) of the other operands."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"expected q, k, v [B, S, H, D] of one shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, S, H, D = q.shape
    hp = 128 // D
    if hp < 1 or H % hp:
        raise ValueError(f"{H} heads of D {D} do not fill packed blocks of "
                         f"128 // D = {hp} heads")
    if nsplit < 1 or S % nsplit:
        raise ValueError(f"S {S} is not divisible by nsplit {nsplit}")
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share a dtype in float32/bfloat16, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    for name, t, shape, dtype in more:
        if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype} {tuple(shape)}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    devs = {t.device for t in (q, k, v)} | {m[1].device for m in more}
    if len(devs) != 1:
        raise ValueError(f"inputs lie on different devices: {devs}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {q.device}")


def _check_kernel(*ts):
    B, S, H, D = ts[0].shape
    if ts[0].dtype != torch.bfloat16 or D not in _HEAD_DIMS or S % _TILE:
        raise ValueError(f"the kernels take bfloat16 with D in {_HEAD_DIMS} "
                         f"and S a multiple of {_TILE}, got {ts[0].dtype}, "
                         f"D={D}, S={S}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("the kernels take contiguous tensors")
    if any(t.data_ptr() % 16 for t in ts):
        raise ValueError("the kernels take tensors on a 16-byte boundary "
                         "(the TMA maps need an aligned base)")


def variant_fwd(q, k, v, flags, nsplit=1, cst=1.0):
    """The forward kernel, one launch: (out [B, S, H, D], lse [B, H, S]
    fp32); ``flags`` one of ``FWD_INSTANCES``."""
    _check(q, k, v, nsplit)
    if flags not in FWD_INSTANCES:
        raise ValueError(f"no forward instance for flags {flags}")
    if q.device.type == "cpu":
        return variant_fwd_plain(q, k, v, flags, nsplit, cst)
    _check_kernel(q, k, v)
    B, S, H, D = q.shape
    out = torch.empty_like(q)
    lse = torch.empty(B, H, S, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = _kernel("flash_variants_fwd", 5, 1)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), B, H, S, D, flags, nsplit, cst,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_variants_fwd launch failed: CUDA error "
                           f"{err}")
    variant_fwd.launches += 1
    return out, lse


def variant_bwd(q, k, v, do, o, lse, flags, nsplit=1, dq_scale=1.0,
                dk_scale=1.0):
    """The backward kernel, one launch computing dq, dk and dv; lse
    [B, H, S] fp32 (base 2); ``flags`` one of ``BWD_INSTANCES``."""
    B, S, H, D = q.shape
    _check(q, k, v, nsplit, ("do", do, q.shape, q.dtype),
           ("out", o, q.shape, q.dtype),
           ("lse", lse, (B, H, S), torch.float32))
    if flags not in BWD_INSTANCES:
        raise ValueError(f"no backward instance for flags {flags}")
    if q.device.type == "cpu":
        return variant_bwd_plain(q, k, v, do, o, lse, flags, nsplit,
                                 dq_scale, dk_scale)
    _check_kernel(q, k, v, do, o, lse)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    with torch.cuda.device(q.device):
        err = _kernel("flash_variants_bwd", 9, 2)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            o.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), B, H, S, D, flags, nsplit, dq_scale, dk_scale,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_variants_bwd launch failed: CUDA error "
                           f"{err}")
    variant_bwd.launches += 1
    return dq, dk, dv


variant_fwd.launches = 0
variant_bwd.launches = 0


@functools.lru_cache(maxsize=None)
def _kernel(name: str, n_ptrs: int, n_floats: int):
    """The C entry point ``name`` of ``csrc/<name>.cu``, built and loaded
    at first use: ``n_ptrs`` tensor pointers, then B, H, S, D,
    flags, nsplit, ``n_floats`` fp32 scalars and the stream (every pointer
    and the stream ``c_void_p``, so none is cut to 32 bits)."""
    from ._build import load_library

    fn = getattr(load_library(name), name)
    fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 6
                   + [ctypes.c_float] * n_floats + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def smem_bytes(kernel: str, D: int) -> int:
    """The dynamic shared memory a block of the ``kernel`` ("fwd" or
    "bwd") instances at head dim ``D`` asks for (builds the library)."""
    from ._build import load_library

    name = f"flash_variants_{kernel}"
    fn = getattr(load_library(name), f"{name}_smem")
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn(D)


# ---------------------------------------------------------------------------
# the experiments' entry points, each with its plain twin
# ---------------------------------------------------------------------------

def _packed_lse(lse, q):
    B, S, H, D = q.shape
    hp = 128 // D
    return lse.view(B, H // hp, hp, S)


def _flat_lse(lse, q):
    B, S, H, D = q.shape
    hp = 128 // D
    if tuple(lse.shape) != (B, H // hp, hp, S):
        raise ValueError(f"lse must be [B, G, hp, S] = "
                         f"{(B, H // hp, hp, S)}, got {tuple(lse.shape)}")
    return lse.reshape(B, H, S)


def _fwd(fwd, q, k, v, is_causal, nsplit, exp_bf16):
    c = _scale(q.shape[-1]) * LOG2_E
    _check(q, k, v, nsplit)
    out, lse = fwd(_prescale(q, c), k, v, fwd_flags(is_causal, exp_bf16),
                   nsplit)
    return out, _packed_lse(lse, q)


def _bwd(bwd, q, k, v, do, out, lse, is_causal, nsplit, exp_bf16):
    d = q.shape[-1]
    _check(q, k, v, nsplit)
    qs = _prescale(q, _scale(d) * LOG2_E)
    return bwd(qs, k, v, do, out, _flat_lse(lse, q),
               bwd_flags(is_causal, exp_bf16), nsplit, _scale(d),
               1.0 / LOG2_E)


def _fwd2(fwd, q, k, v, is_causal, qblocks, p_bf16, in_kernel_scale):
    S = q.shape[1]
    _check(q, k, v, 1)
    if qblocks < 1 or S % qblocks:
        raise ValueError(f"S {S} is not divisible by qblocks {qblocks}")
    c = _scale(q.shape[-1]) * LOG2_E
    if not in_kernel_scale:
        q = _prescale(q, c)
    out, lse = fwd(q, k, v, fwd_flags(is_causal, p_bf16=p_bf16,
                                      in_kernel_scale=in_kernel_scale),
                   1, c)
    return out, _packed_lse(lse, q)


def _fwd_diag(fwd, q, k, v, drop):
    _check(q, k, v, 1)
    out, lse = fwd(q, k, v, fwd_flags(drop=tuple(drop)))
    return out, _packed_lse(lse, q)


def _bwd_diag(bwd, q, k, v, do, out, lse, drop):
    _check(q, k, v, 1)
    return bwd(q, k, v, do, out, _flat_lse(lse, q),
               bwd_flags(drop=tuple(drop)))


def run_fwd(q, k, v, is_causal=True, nsplit=1, exp_bf16=False):
    """(out [B, S, H, D], lse [B, G, hp, S] base 2): the prescale (a torch
    operation, as the reference's is XLA's) and one forward launch."""
    return _fwd(variant_fwd, q, k, v, is_causal, nsplit, exp_bf16)


def run_fwd_plain(q, k, v, is_causal=True, nsplit=1, exp_bf16=False):
    return _fwd(variant_fwd_plain, q, k, v, is_causal, nsplit, exp_bf16)


def run_bwd(q, k, v, do, out, lse, is_causal=True, nsplit=1,
            exp_bf16=False):
    """(dq, dk, dv) [B, S, H, D] from ``run_fwd``'s out and lse: the
    prescale and one backward launch."""
    return _bwd(variant_bwd, q, k, v, do, out, lse, is_causal, nsplit,
                exp_bf16)


def run_bwd_plain(q, k, v, do, out, lse, is_causal=True, nsplit=1,
                  exp_bf16=False):
    return _bwd(variant_bwd_plain, q, k, v, do, out, lse, is_causal, nsplit,
                exp_bf16)


def run_fwd2(q, k, v, is_causal=True, qblocks=1, p_bf16=False,
             in_kernel_scale=True):
    """``run_fwd`` with the scale folded into the kernel
    (``in_kernel_scale``) and l over bf16 p (``p_bf16``); ``qblocks``
    (dividing S) leaves the CUDA schedule and the result unchanged."""
    return _fwd2(variant_fwd, q, k, v, is_causal, qblocks, p_bf16,
                 in_kernel_scale)


def run_fwd2_plain(q, k, v, is_causal=True, qblocks=1, p_bf16=False,
                   in_kernel_scale=True):
    return _fwd2(variant_fwd_plain, q, k, v, is_causal, qblocks, p_bf16,
                 in_kernel_scale)


def fwd_diag(q, k, v, drop):
    """A forward ablation of ``run_diag`` (``drop`` one of ``FWD_DROPS``):
    (out [B, S, H, D], lse [B, G, hp, S] = m + l)."""
    return _fwd_diag(variant_fwd, q, k, v, drop)


def fwd_diag_plain(q, k, v, drop):
    return _fwd_diag(variant_fwd_plain, q, k, v, drop)


def bwd_diag(q, k, v, do, out, lse, drop):
    """A backward ablation of ``run_diag`` (``drop`` one of
    ``BWD_DROPS``): (dq, dk, dv) [B, S, H, D]."""
    return _bwd_diag(variant_bwd, q, k, v, do, out, lse, drop)


def bwd_diag_plain(q, k, v, do, out, lse, drop):
    return _bwd_diag(variant_bwd_plain, q, k, v, do, out, lse, drop)
