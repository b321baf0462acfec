"""A blocked bf16 matmul with an fp32 accumulator: ``a[M, K] @ b[K, N] ->
bf16``.

Replaces the TPU kernel ``benchmarks/dot_variants.py`` ``pallas_matmul``:
a (M / bm, N / bn, K / bk) grid whose fp32 VMEM accumulator lives across
the inner K axis and is rounded to bf16 once. The TPU's blocks (512 x 768
x 3200) do not map onto a CTA (a 512 x 768 fp32 accumulator alone is
1.5 MB), so the CUDA kernel (``paddle_tpu_torch/csrc/blocked_matmul.cu``,
whose header says what bounds it and how it is built) has CTA tiles of its
own, one template instance per tile in ``TILES``. It keeps the reference's
contract on divisibility strictly: M, N and K must be multiples of the
tile asked for (the reference's grid drops the rest rows silently).

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises (bf16, contiguous).
"""

from __future__ import annotations

import ctypes
import functools

import torch

__all__ = ["TILES", "blocked_matmul", "blocked_matmul_plain"]

# (bm, bn, bk): the kernel's CTA tiles, each a template instance
TILES = ((128, 128, 32), (128, 256, 32), (256, 128, 32), (128, 128, 64))


def blocked_matmul_plain(a, b, bk):
    """fp32 products summed chunk by chunk over K (``bk`` at a time, in
    the reference's order), rounded once to bf16."""
    acc = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32,
                      device=a.device)
    for k0 in range(0, a.shape[1], bk):
        acc += a[:, k0:k0 + bk].float() @ b[k0:k0 + bk].float()
    return acc.to(torch.bfloat16)


def _check(a, b, bm, bn, bk):
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"expected a [M, K] and b [K, N], got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if (bm, bn, bk) not in TILES:
        raise ValueError(f"no kernel instance for tile {(bm, bn, bk)}; the "
                         f"instances are {TILES}")
    (M, K), N = a.shape, b.shape[1]
    if M % bm or N % bn or K % bk:
        raise ValueError(f"[{M}, {K}] x [{K}, {N}] is not divisible by the "
                         f"tile {(bm, bn, bk)}")
    if a.dtype not in (torch.float32, torch.bfloat16) or b.dtype != a.dtype:
        raise TypeError(f"a and b must share a dtype in float32/bfloat16, "
                        f"got {a.dtype}, {b.dtype}")
    if a.device != b.device:
        raise ValueError(f"inputs lie on different devices: {a.device}, "
                         f"{b.device}")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {a.device}")


def blocked_matmul(a, b, bm=128, bn=128, bk=32):
    """``a @ b`` in bf16 with an fp32 accumulator, one launch of the
    ``(bm, bn, bk)`` instance (one of ``TILES``)."""
    _check(a, b, bm, bn, bk)
    if a.device.type == "cpu":
        return blocked_matmul_plain(a, b, bk)
    if a.dtype != torch.bfloat16:
        raise ValueError(f"the kernel takes bfloat16, got {a.dtype}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("the kernel takes contiguous tensors")
    if a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError("the kernel takes tensors on a 16-byte boundary "
                         "(rows are read in 16-byte copies)")
    (M, K), N = a.shape, b.shape[1]
    out = torch.empty(M, N, dtype=torch.bfloat16, device=a.device)
    with torch.cuda.device(a.device):
        err = _kernel()(a.data_ptr(), b.data_ptr(), out.data_ptr(), M, N, K,
                        bm, bn, bk, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"blocked_matmul launch failed: CUDA error {err}")
    blocked_matmul.launches += 1
    return out


blocked_matmul.launches = 0


@functools.lru_cache(maxsize=None)
def _kernel():
    """The C entry point, built and loaded at first use; every pointer
    and the stream are ``c_void_p`` so none is cut to 32 bits."""
    from ._build import load_library

    fn = load_library("blocked_matmul").blocked_matmul
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn
