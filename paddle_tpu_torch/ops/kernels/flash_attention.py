"""Flash attention for training: forward with logsumexp, and the backward
(dq, dk and dv) in one launch.

Replaces the TPU kernels of ``paddle_tpu/ops/pallas/flash_attention.py``:
the blocked ``_pallas_flash_attention`` / ``_pallas_flash_fwd_lse`` and the
packed ``_pallas_flash_fwd_packed`` become one forward kernel; the blocked
``_pallas_flash_bwd`` (its dq and dk/dv calls) and the fused packed
``_pallas_flash_bwd_packed`` become one backward kernel whose grid holds a
dq role and a dk/dv role. The CUDA source is
``paddle_tpu_torch/csrc/flash_attention.cu``; its header says what bounds
the kernels on the H100 and how they are built. Their fp32 instance (fp32
q, k and v: 3xTF32 on the tensor cores, each operand split into a TF32
high and low part and each product the sum of three TF32 products, fp32
accumulation) is ``paddle_tpu_torch/csrc/flash_attention_f32.cu``, with
the same entry points; it counts its launches in each wrapper's
``f32_launches``, the bf16 kernels in ``launches``. It does not read
``torch.backends.cuda.matmul.allow_tf32``: three TF32 passes are its fp32
arithmetic.

Three backward entry points launch that kernel: ``flash_attention_bwd``
(both roles in one launch: dq, dk and dv; the training path's),
``flash_attention_bwd_dq`` (the dq role alone) and
``flash_attention_bwd_dkv`` (the dk/dv role alone). A role computes the
same bits whichever entry launches it. Each counts its own launches.

Layouts: q, k, v, out and their gradients are ``[B, S, H, D]`` (the JAX
package's); ``lse`` (natural log) and ``delta = rowsum(do * o)`` are
``[B, H, Sq]`` fp32. Causal masking is ``tril(k=Sk-Sq)``.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel of its dtype or raises (bf16 or fp32, D in {64, 128}, contiguous,
16-byte aligned). An fp32 CUDA tensor never takes the plain version.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

__all__ = ["attention_probs", "attention_apply", "xla_attention",
           "attention_delta", "flash_attention_fwd_plain",
           "flash_attention_bwd_dq_plain", "flash_attention_bwd_dkv_plain",
           "flash_attention_bwd_grads_plain", "flash_attention_bwd_plain", "flash_attention_fwd",
           "flash_attention_bwd", "flash_attention_bwd_dq",
           "flash_attention_bwd_dkv", "dot_product_attention",
           "flash_path_active", "smem_bytes"]

_DTYPES = (torch.float32, torch.bfloat16)
_HEAD_DIMS = (64, 128)


def _scale(q, scale):
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)


# ---------------------------------------------------------------------------
# plain versions (dense [B, H, Sq, Sk] scores)
# ---------------------------------------------------------------------------

def _scores(q, k, is_causal, scale):
    """fp32 scores [B, H, Sq, Sk] of q [B, Sq, H, D] against k, keys past
    the causal diagonal at -inf."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if is_causal:
        sq, sk = s.shape[-2], s.shape[-1]
        causal = torch.ones(sq, sk, dtype=torch.bool,
                            device=s.device).tril(sk - sq)
        s = s.masked_fill(~causal, float("-inf"))
    return s


def attention_probs(q, k, mask=None, is_causal=False, scale=None):
    """Masked softmax probabilities [B, H, Sq, Sk] in fp32: scores from
    fp32 products, the causal mask, then a boolean mask (False hides a key)
    or an additive one."""
    s = _scores(q, k, is_causal, _scale(q, scale))
    if mask is not None:
        if mask.dtype == torch.bool:
            s = s.masked_fill(~mask, float("-inf"))
        else:
            s = s + mask.float()
    return torch.softmax(s, dim=-1)


def attention_apply(probs, v, dtype=None):
    """probs [B, H, Sq, Sk] @ v [B, Sk, H, D] -> [B, Sq, H, D]: the probs
    rounded to ``dtype`` (default v's), the product accumulated in fp32."""
    dtype = dtype or v.dtype
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(dtype).float(), v.float())
    return out.to(dtype)


def xla_attention(q, k, v, mask=None, is_causal=False, scale=None):
    """Dense attention, the JAX package's ``_xla_attention``."""
    probs = attention_probs(q, k, mask=mask, is_causal=is_causal,
                            scale=scale)
    return attention_apply(probs, v, dtype=q.dtype)


def attention_delta(out, do):
    """delta = rowsum(do * o) in fp32, [B, Sq, H, D] -> [B, H, Sq]: the
    softmax-jacobian term of the backward, one reduction outside the
    kernels (as the JAX package computes it outside its blocked ones)."""
    return (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def flash_attention_fwd_plain(q, k, v, causal=False, scale=None):
    """(out [B, Sq, H, D] in q's dtype, lse [B, H, Sq] fp32)."""
    s = _scores(q, k, causal, _scale(q, scale))
    lse = torch.logsumexp(s, dim=-1)
    return attention_apply(torch.exp(s - lse[..., None]), v,
                           dtype=q.dtype), lse


def _probs_and_ds(q, k, v, do, lse, delta, causal, scale):
    """p = exp(s - lse) (0 where masked) and ds = p * (dp - delta) rounded
    to q's dtype, both [B, H, Sq, Sk]."""
    p = torch.exp(_scores(q, k, causal, scale) - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    return p, (p * (dp - delta[..., None])).to(q.dtype)


def flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, causal=False,
                                 scale=None):
    """dq = (ds @ k) * scale, rounded to q's dtype."""
    scale = _scale(q, scale)
    _, ds = _probs_and_ds(q, k, v, do, lse, delta, causal, scale)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.float(), k.float()) * scale
    return dq.to(q.dtype)


def flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta, causal=False,
                                  scale=None):
    """(dk = (ds^T @ q) * scale, dv = p^T @ do), p rounded to the dtype
    before its product."""
    scale = _scale(q, scale)
    p, ds = _probs_and_ds(q, k, v, do, lse, delta, causal, scale)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(q.dtype).float(), do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.float(), q.float()) * scale
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_grads_plain(q, k, v, do, lse, delta, causal=False,
                                    scale=None):
    """(dq, dk, dv) from the forward's ``lse`` and ``delta``: the plain
    version of the one-launch backward."""
    dq = flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, causal, scale)
    dk, dv = flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta, causal,
                                           scale)
    return dq, dk, dv


def flash_attention_bwd_plain(q, k, v, o, lse, do, causal=False, scale=None):
    """(dq, dk, dv) of the attention whose forward gave ``o`` and ``lse``:
    the flash backward written out, p = exp(s - lse), delta = rowsum(do *
    o) in fp32, ds = p * (dp - delta)."""
    return flash_attention_bwd_grads_plain(q, k, v, do, lse,
                                           attention_delta(o, do), causal,
                                           scale)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _check(q, k, v, causal, *more):
    """q [B, Sq, H, D], k/v [B, Sk, H, D], one dtype and device; ``more``
    holds (name, tensor, shape, dtype) of the other operands."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"expected q [B,Sq,H,D] and k/v [B,Sk,H,D], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Sq, H, D = q.shape
    if (k.shape[0], k.shape[2], k.shape[3]) != (B, H, D):
        raise ValueError(f"k {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)} (repeat kv heads first)")
    if causal and Sq > k.shape[1]:
        raise ValueError(f"causal attention needs Sq <= Sk, got {Sq} > "
                         f"{k.shape[1]}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must share a dtype in float32/bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
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
    D = ts[0].shape[-1]
    if ts[0].dtype not in _DTYPES or D not in _HEAD_DIMS:
        raise ValueError(f"the kernels take bfloat16 or float32 with "
                         f"head_dim in {_HEAD_DIMS}, got {ts[0].dtype}, "
                         f"D={D}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("the kernels take contiguous tensors")
    if any(t.data_ptr() % 16 for t in ts):
        raise ValueError("the kernels take tensors on a 16-byte boundary "
                         "(they read 16-byte pieces: the bf16 kernels' TMA "
                         "tiles, the fp32 instance's cp.async copies)")


def _lse_shape(q):
    return (q.shape[0], q.shape[2], q.shape[1])


def flash_attention_fwd(q, k, v, causal=False, scale=None):
    """(out [B, Sq, H, D], lse [B, H, Sq] fp32 natural log)."""
    _check(q, k, v, causal)
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, causal, scale)
    _check_kernel(q, k, v)
    B, Sq, H, D = q.shape
    out = torch.empty_like(q)
    lse = torch.empty(_lse_shape(q), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = _kernel("flash_attention_fwd", q.dtype)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), B, H, Sq, k.shape[1], D, int(causal),
            _scale(q, scale), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: CUDA error "
                           f"{err}")
    _count(flash_attention_fwd, q)
    return out, lse


def _count(wrapper, q):
    """One launch of ``wrapper``'s kernel: the bf16 kernel's count or the
    fp32 instance's."""
    if q.dtype == torch.float32:
        wrapper.f32_launches += 1
    else:
        wrapper.launches += 1


def _check_bwd(q, k, v, do, lse, delta, causal):
    st = _lse_shape(q)
    _check(q, k, v, causal, ("do", do, q.shape, q.dtype),
           ("lse", lse, st, torch.float32), ("delta", delta, st,
                                             torch.float32))


def _launch_bwd(name, q, k, v, do, lse, delta, outs, causal, scale):
    """Launch the entry ``name`` of the backward kernel, writing ``outs``
    (dq and/or dk, dv, allocated here)."""
    _check_kernel(q, k, v, do, lse, delta)
    B, Sq, H, D = q.shape
    ptrs = [t.data_ptr() for t in (q, k, v, do, lse, delta, *outs)]
    with torch.cuda.device(q.device):
        err = _kernel(name, q.dtype)(
            *ptrs, B, H, Sq, k.shape[1], D, int(causal), _scale(q, scale),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def flash_attention_bwd(q, k, v, do, lse, delta, causal=False, scale=None):
    """(dq [B, Sq, H, D], dk, dv [B, Sk, H, D]) in one launch, from the
    forward's ``lse`` and ``delta`` (``attention_delta(out, do)``)."""
    _check_bwd(q, k, v, do, lse, delta, causal)
    if q.device.type == "cpu":
        return flash_attention_bwd_grads_plain(q, k, v, do, lse, delta,
                                               causal, scale)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    _launch_bwd("flash_attention_bwd", q, k, v, do, lse, delta,
                (dq, dk, dv), causal, scale)
    _count(flash_attention_bwd, q)
    return dq, dk, dv


def flash_attention_bwd_dq(q, k, v, do, lse, delta, causal=False,
                           scale=None):
    """dq [B, Sq, H, D] alone (the backward kernel's dq role)."""
    _check_bwd(q, k, v, do, lse, delta, causal)
    if q.device.type == "cpu":
        return flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, causal,
                                            scale)
    dq = torch.empty_like(q)
    _launch_bwd("flash_attention_bwd_dq", q, k, v, do, lse, delta, (dq,),
                causal, scale)
    _count(flash_attention_bwd_dq, q)
    return dq


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal=False,
                            scale=None):
    """(dk, dv) [B, Sk, H, D] alone (the backward kernel's dk/dv role)."""
    _check_bwd(q, k, v, do, lse, delta, causal)
    if q.device.type == "cpu":
        return flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta,
                                             causal, scale)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch_bwd("flash_attention_bwd_dkv", q, k, v, do, lse, delta,
                (dk, dv), causal, scale)
    _count(flash_attention_bwd_dkv, q)
    return dk, dv


for _wrapper in (flash_attention_fwd, flash_attention_bwd,
                 flash_attention_bwd_dq, flash_attention_bwd_dkv):
    _wrapper.launches = 0       # the bf16 kernels'
    _wrapper.f32_launches = 0   # the fp32 instance's
del _wrapper


def smem_bytes(kind: str, D: int, dtype=torch.bfloat16) -> int:
    """The dynamic shared memory one block of the ``kind`` ("fwd" or
    "bwd") kernel at head dim ``D`` asks for, for ``dtype``'s kernels
    (builds the library)."""
    lib = _LIBRARIES[dtype]
    fn = getattr(_library(lib), lib + "_smem")
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn(D, int(kind == "bwd"))


# dtype -> the library of its kernels: ``csrc/<library>.cu``, whose entry
# points are ``<library>_fwd``, ``<library>_bwd``, ...
_LIBRARIES = {torch.bfloat16: "flash_attention",
              torch.float32: "flash_attention_f32"}


def _library(name: str):
    from ._build import load_library

    return load_library(name)


def entry_argtypes(name: str):
    """The ctypes argument types of the entry ``name`` (the bf16 name,
    e.g. ``flash_attention_bwd``): its tensor pointers, then B, H, Sq, Sk,
    D, causal, scale and the stream; every pointer and the stream are
    ``c_void_p`` so none is cut to 32 bits."""
    n_ptrs = {"fwd": 5, "bwd": 9, "bwd_dq": 7, "bwd_dkv": 8}[
        name[len("flash_attention_"):]]
    return ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 6
            + [ctypes.c_float, ctypes.c_void_p])


@functools.lru_cache(maxsize=None)
def _kernel(name: str, dtype):
    """The C entry point of ``name`` for ``dtype``'s kernels (``name``
    in ``csrc/flash_attention.cu``, ``flash_attention_f32<suffix>`` in
    ``csrc/flash_attention_f32.cu``), built and loaded at first use."""
    lib = _LIBRARIES[dtype]
    fn = getattr(_library(lib), lib + name[len("flash_attention"):])
    fn.argtypes = entry_argtypes(name)
    fn.restype = ctypes.c_int
    return fn


# ---------------------------------------------------------------------------
# the differentiable entry
# ---------------------------------------------------------------------------

class _FlashAttention(torch.autograd.Function):
    """The forward kernel, saving (q, k, v, out, lse): O(S) residuals,
    never the [S, S] scores; the backward is one launch of the backward
    kernel (dq, dk and dv)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = flash_attention_fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        do = do.contiguous()
        dq, dk, dv = flash_attention_bwd(q, k, v, do, lse,
                                         attention_delta(out, do),
                                         ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


def flash_path_active(t) -> bool:
    """True where ``dot_product_attention`` launches the flash kernels: a
    CUDA tensor. Models pick their remat structure on it."""
    return t.device.type == "cuda"


def dot_product_attention(q, k, v, mask=None, is_causal=False, scale=None):
    """Attention over [B, S, H, D] with Hkv == H, differentiable. Without a
    mask: the flash forward and backward (the kernels of q's dtype, bf16
    or fp32, on a CUDA tensor; their plain versions on a CPU one). With a
    mask: ``xla_attention`` and autograd, as the JAX entry does (its
    ``flash_path_active`` is False for a mask): that dense path is the
    reference's dispatch, not a fallback. ``scale`` defaults to
    1 / sqrt(D)."""
    if mask is not None:
        return xla_attention(q, k, v, mask=mask, is_causal=is_causal,
                             scale=scale)
    return _FlashAttention.apply(q, k, v, bool(is_causal), scale)
