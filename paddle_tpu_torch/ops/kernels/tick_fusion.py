"""Fused decode-tick epilogue: rmsnorm, residual add + rmsnorm, q/k rope.

Replaces the TPU kernels of ``paddle_tpu/ops/pallas/tick_fusion.py``:
``fused_rms_norm`` (``_rms_kernel``), ``fused_add_rms_norm``
(``_add_rms_kernel``) and ``fused_rope_qk`` (``_rope_qk_kernel``). Each
collapses one between-matmul chain of the single-token decode tick into
one launch.

What bounds them on the H100: bytes, and below that the launch itself.
The tick's tensors are tiny ([slots, hidden] = [8, 768] at the serving
shape), so each kernel reads its inputs once and writes its outputs once.
All three are CUDA C++ behind plain C entry points loaded with ctypes, so
a call's host path is its checks, its outputs' allocation and one ctypes
call. The norms (``paddle_tpu_torch/csrc/rms_norm.cu``) give each thread
a 16-byte piece of the row, every load issued before the reduction, the
row's sum by warp shuffles, launched with programmatic dependent launch;
the rope (``csrc/rope.cu``) a block a row
and a group of heads, the row's D / 2 angles computed once, each value
read once. Each source's header says why.

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


def _launched(name, err):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def fused_rms_norm(x, w, eps: float):
    """rmsnorm(x) * w as one launch. x: [B, H]; w: [H] in x's dtype."""
    _check_norm("fused_rms_norm", x, w)
    if x.device.type == "cpu":
        return rms_norm_plain(x, w, eps)
    B, H = x.shape
    out = torch.empty_like(x)
    dev = x.device.index
    _launched("fused_rms_norm", _entry("rms_norm", "fused_rms_norm")(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), B, H,
        _DTYPE_CODES[x.dtype], eps, dev, _stream(dev)))
    fused_rms_norm.launches += 1
    return out


def fused_add_rms_norm(x, y, w, eps: float):
    """(x + y, rmsnorm(x + y) * w) as one launch: the residual sum feeding
    the next pre-norm is written once and normed from registers."""
    _check_norm("fused_add_rms_norm", x, w, y)
    if x.device.type == "cpu":
        return add_rms_norm_plain(x, y, w, eps)
    B, H = x.shape
    s = torch.empty_like(x)
    out = torch.empty_like(x)
    dev = x.device.index
    _launched("fused_add_rms_norm", _entry("rms_norm", "fused_add_rms_norm")(
        x.data_ptr(), y.data_ptr(), w.data_ptr(), s.data_ptr(),
        out.data_ptr(), B, H, _DTYPE_CODES[x.dtype], eps, dev, _stream(dev)))
    fused_add_rms_norm.launches += 1
    return s, out


def empty_launch(device_index: int):
    """An empty kernel on CUDA device ``device_index``, launched through
    the norms' host path (the stream, one ctypes call, the error check):
    the launch floor the tick's small kernels are measured against. On no
    path, and counted nowhere."""
    _launched("empty_launch", _entry("rms_norm", "empty_launch")(
        device_index, _stream(device_index)))


def set_pdl(on: bool) -> bool:
    """Launch the norms (and ``empty_launch``) with programmatic dependent
    launch (Hopper: a norm's blocks start while the kernel ahead of it
    drains and wait for it in the kernel), which is on unless set off here;
    ``experiments.turns`` times the decode tick both ways. Returns the
    previous setting."""
    return bool(_entry("rms_norm", "set_pdl")(int(on)))


def fused_rope_qk(zq, zk, pos, head_dim: int, theta: float):
    """Rope both projections in one launch. zq: [B, nH*D]; zk: [B, Hkv*D];
    pos: [B] int32, each row at its own position. cos/sin are computed in
    the kernel from ``pos`` (in fp32, rounded to the dtype, as
    ``rope_qk_plain``). zq and zk may be column slices of a wider product
    (a fused qkv projection): the kernel reads each row at its stride and
    writes contiguous outputs."""
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
    if not (zq.stride(1) == 1 and zk.stride(1) == 1
            and pos.is_contiguous()):
        raise ValueError("fused_rope_qk: the rows of zq and zk, and pos, "
                         "must be contiguous")
    if head_dim > _ROPE_MAX_D:
        raise ValueError(f"fused_rope_qk: the kernel takes head_dim at most "
                         f"{_ROPE_MAX_D}, got {head_dim}")
    oq = torch.empty_like(zq)
    ok = torch.empty_like(zk)
    with torch.cuda.device(zq.device):
        _launched("fused_rope_qk", _entry("rope", "fused_rope_qk")(
            zq.data_ptr(), zk.data_ptr(), oq.data_ptr(), ok.data_ptr(),
            pos.data_ptr(), B, zq.shape[1] // head_dim,
            zk.shape[1] // head_dim, head_dim, zq.stride(0), zk.stride(0),
            _DTYPE_CODES[zq.dtype], theta,
            torch.cuda.current_stream().cuda_stream))
    fused_rope_qk.launches += 1
    return oq, ok


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the C entry points of csrc/<library>.cu this module calls, with their
# argument types (every pointer and the stream ``c_void_p``, so none is
# cut to 32 bits); the tests hold them to the sources' signatures
ENTRIES = {
    "rms_norm": {
        # x, w, out, B, H, dtype code, eps, device, stream
        "fused_rms_norm": [_P] * 3 + [_I] * 3 + [_F, _I, _P],
        # x, y, w, s, out, B, H, dtype code, eps, device, stream
        "fused_add_rms_norm": [_P] * 5 + [_I] * 3 + [_F, _I, _P],
        "empty_launch": [_I, _P],
        "set_pdl": [_I],
    },
    "rope": {
        # zq, zk, oq, ok, pos, B, nH, Hkv, D, ldq, ldk, dtype code, theta,
        # stream
        "fused_rope_qk": [_P] * 5 + [_I] * 7 + [_F, _P],
    },
}


@functools.lru_cache(maxsize=None)
def _entry(library, name):
    """The C entry point ``name`` of ``csrc/<library>.cu``, built and
    loaded at first use."""
    from ._build import load_library

    fn = getattr(load_library(library), name)
    fn.argtypes = ENTRIES[library][name]
    fn.restype = ctypes.c_int
    return fn


def _stream(device_index):
    """The current stream of a CUDA device, as an int: the raw handle,
    without the ``torch.cuda.Stream`` object ``current_stream()`` builds."""
    return torch._C._cuda_getCurrentRawStream(device_index)


fused_rms_norm.launches = 0
fused_add_rms_norm.launches = 0
fused_rope_qk.launches = 0
