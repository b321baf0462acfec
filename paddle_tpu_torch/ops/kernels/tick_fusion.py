"""Fused decode-tick epilogue: rmsnorm, residual add + rmsnorm, q/k rope.

Replaces the TPU kernels of ``paddle_tpu/ops/pallas/tick_fusion.py``:
``fused_rms_norm`` (``_rms_kernel``), ``fused_add_rms_norm``
(``_add_rms_kernel``) and ``fused_rope_qk`` (``_rope_qk_kernel``). Each
collapses one between-matmul chain of the single-token decode tick into
one launch.

What bounds them on the H100: bytes, and below that the launch itself.
The tick's tensors are tiny ([slots, hidden] = [8, 768] at the serving
shape), so each kernel reads its inputs once and writes its outputs once.
The two norms are Triton kernels (``tick_fusion_triton``), one program
per row (the block is the next power of two of the row width, masked):
the row reduction never leaves registers. The rope is CUDA C++
(``paddle_tpu_torch/csrc/rope.cu``, loaded with ctypes): a block a row
and a group of heads, the row's D / 2 angles computed once, each value
read once; its header says why.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches
the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

__all__ = ["fused_rms_norm", "fused_add_rms_norm", "fused_rope_qk",
           "rms_norm_plain", "add_rms_norm_plain", "rope_qk_plain"]

_DTYPES = (torch.float32, torch.bfloat16)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ROPE_MAX_D = 8192  # MAX_D in csrc/rope.cu


# ---------------------------------------------------------------------------
# plain versions (the reference's inline chains, same rounding points)
# ---------------------------------------------------------------------------

def rms_norm_plain(x, w, eps: float):
    """rmsnorm(x) * w: fp32 mean square, round to x.dtype, gain in dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w.to(x.dtype)


def add_rms_norm_plain(x, y, w, eps: float):
    """(x + y, rmsnorm(x + y) * w)."""
    s = x + y
    return s, rms_norm_plain(s, w, eps)


def _rope_rows(z, cos, sin, head_dim: int):
    B, N = z.shape
    zz = z.reshape(B, N // head_dim, head_dim)
    half = head_dim // 2
    x1, x2 = zz[..., :half], zz[..., half:]
    cos = cos[:, None, :]
    sin = sin[:, None, :]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).reshape(B, N)


def rope_qk_plain(zq, zk, pos, head_dim: int, theta: float):
    """Rotate-half rope on the flat rows zq [B, nH*D] and zk [B, Hkv*D],
    row b at position pos[b]; angles pos * theta^(-2i/D) in fp32, cos/sin
    rounded to the dtype."""
    i2 = torch.arange(0, head_dim, 2, dtype=torch.float32, device=zq.device)
    freqs = theta ** (-i2 / head_dim)
    ang = pos.float()[:, None] * freqs                  # [B, D/2]
    cos = torch.cos(ang).to(zq.dtype)
    sin = torch.sin(ang).to(zq.dtype)
    return (_rope_rows(zq, cos, sin, head_dim),
            _rope_rows(zk, cos, sin, head_dim))


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _check_rows(name, *ts):
    x = ts[0]
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype must be float32 or bfloat16, got "
                        f"{x.dtype}")
    for t in ts:
        if t.dtype != x.dtype:
            raise TypeError(f"{name}: mixed dtypes {x.dtype} and {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name}: tensors on {x.device} and {t.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {x.device}")


def _check_norm(name, x, w, *more):
    if x.dim() != 2 or w.shape != (x.shape[1],):
        raise ValueError(f"{name}: expected x [B, H] and w [H], got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    for t in more:
        if t.shape != x.shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)} != "
                             f"{tuple(x.shape)}")
    _check_rows(name, x, w, *more)
    if x.device.type == "cuda" and not all(
            t.is_contiguous() for t in (x, w) + more):
        raise ValueError(f"{name}: inputs must be contiguous")


def _row_warps(block: int) -> int:
    return 4 if block <= 1024 else 8


def fused_rms_norm(x, w, eps: float):
    """rmsnorm(x) * w as one launch. x: [B, H]; w: [H] in x's dtype."""
    _check_norm("fused_rms_norm", x, w)
    if x.device.type == "cpu":
        return rms_norm_plain(x, w, eps)
    import triton

    from . import tick_fusion_triton as k

    B, H = x.shape
    out = torch.empty_like(x)
    block = triton.next_power_of_2(H)
    with torch.cuda.device(x.device):
        k.rms_kernel[(B,)](x, w, out, H, float(eps), BLOCK=block,
                           num_warps=_row_warps(block))
    fused_rms_norm.launches += 1
    return out


def fused_add_rms_norm(x, y, w, eps: float):
    """(x + y, rmsnorm(x + y) * w) as one launch: the residual sum feeding
    the next pre-norm is written once and normed from registers."""
    _check_norm("fused_add_rms_norm", x, w, y)
    if x.device.type == "cpu":
        return add_rms_norm_plain(x, y, w, eps)
    import triton

    from . import tick_fusion_triton as k

    B, H = x.shape
    s = torch.empty_like(x)
    out = torch.empty_like(x)
    block = triton.next_power_of_2(H)
    with torch.cuda.device(x.device):
        k.add_rms_kernel[(B,)](x, y, w, s, out, H, float(eps), BLOCK=block,
                               num_warps=_row_warps(block))
    fused_add_rms_norm.launches += 1
    return s, out


def fused_rope_qk(zq, zk, pos, head_dim: int, theta: float):
    """Rope both projections in one launch. zq: [B, nH*D]; zk: [B, Hkv*D];
    pos: [B] int32, each row at its own position. cos/sin are computed in
    the kernel from ``pos`` (in fp32, rounded to the dtype, as
    ``rope_qk_plain``)."""
    if (zq.dim() != 2 or zk.dim() != 2 or zk.shape[0] != zq.shape[0]
            or head_dim % 2 or zq.shape[1] % head_dim
            or zk.shape[1] % head_dim):
        raise ValueError(f"fused_rope_qk: expected zq [B, nH*D], zk "
                         f"[B, Hkv*D] with even D={head_dim}, got "
                         f"{tuple(zq.shape)}, {tuple(zk.shape)}")
    B = zq.shape[0]
    if pos.shape != (B,) or pos.dtype != torch.int32:
        raise ValueError(f"fused_rope_qk: pos must be int32 [{B}], got "
                         f"{pos.dtype} {tuple(pos.shape)}")
    _check_rows("fused_rope_qk", zq, zk)
    if pos.device != zq.device:
        raise ValueError(f"fused_rope_qk: pos on {pos.device}, zq on "
                         f"{zq.device}")
    if zq.device.type == "cpu":
        return rope_qk_plain(zq, zk, pos, head_dim, theta)
    if not all(t.is_contiguous() for t in (zq, zk, pos)):
        raise ValueError("fused_rope_qk: inputs must be contiguous")
    if head_dim > _ROPE_MAX_D:
        raise ValueError(f"fused_rope_qk: the kernel takes head_dim at most "
                         f"{_ROPE_MAX_D}, got {head_dim}")
    oq = torch.empty_like(zq)
    ok = torch.empty_like(zk)
    with torch.cuda.device(zq.device):
        err = _rope_kernel()(
            zq.data_ptr(), zk.data_ptr(), oq.data_ptr(), ok.data_ptr(),
            pos.data_ptr(), B, zq.shape[1] // head_dim,
            zk.shape[1] // head_dim, head_dim, _DTYPE_CODES[zq.dtype],
            theta, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_rope_qk launch failed: CUDA error {err}")
    fused_rope_qk.launches += 1
    return oq, ok


@functools.lru_cache(maxsize=None)
def _rope_kernel():
    """The C entry point of ``csrc/rope.cu``, built and loaded at first
    use; every pointer and the stream are ``c_void_p`` so none is cut to
    32 bits."""
    from ._build import load_library

    fn = load_library("rope").fused_rope_qk
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


fused_rms_norm.launches = 0
fused_add_rms_norm.launches = 0
fused_rope_qk.launches = 0
