"""Weight-only quantized matmul: ``x @ (w * scale)`` with the weights
dequantized inside the kernel.

Replaces the TPU kernel ``paddle_tpu/ops/pallas/tick_fusion.py``
(``quant_matmul``, body ``_quant_matmul_kernel``). The CUDA kernel is
``paddle_tpu_torch/csrc/quant_matmul.cu``; its header says what bounds it
on the H100 (bytes: the narrow weight stream) and how its design streams
the weights through a shared-memory ring into tensor cores, split over K
across the blocks of a thread-block cluster. The launch's tiling (output
columns a block, blocks along K) is chosen here from (K, N) alone
(``tiling``).

Dispatch: a CPU tensor takes the plain version below; a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

__all__ = ["quant_matmul", "quant_matmul_plain", "tiling", "blocks",
           "smem_bytes"]

_X_CODES = {torch.float32: 0, torch.bfloat16: 1}
_W_CODES = {torch.int8: 1, torch.float8_e4m3fn: 2}
_SROWS = 64      # SROWS in csrc/quant_matmul.cu: rows of K a ring stage
_MAX_SPLITS = 8  # MAX_SPLITS: blocks of a cluster along K
_BT = 8          # BT: batch rows a block
_SMS = 132       # the H100's SMs: the blocks a projection should reach
_STAGES_A_SPLIT = 6  # the stages a 32-column block should walk, at most


def tiling(K: int, N: int):
    """The launch's (output columns a block, blocks along K) at K x N.
    Weights wide enough to put 128-column strips on the card's 132 SMs
    (lm_head) take them whole, one block a strip over all of K, its warps
    splitting the columns. The others take 32-column tiles, their warps
    splitting K, and as many splits of K (at most 8, and at most the
    64-row stages of K) as reach 132 blocks or hold a split to 6 stages,
    whichever is more: a block walks its stages one after another."""
    stages = -(-K // _SROWS)
    if -(-N // 128) >= _SMS:
        return 128, 1
    splits = max(-(-_SMS // -(-N // 32)), -(-stages // _STAGES_A_SPLIT))
    return 32, max(1, min(_MAX_SPLITS, stages, splits))


def blocks(B: int, K: int, N: int) -> int:
    """The blocks of the launch at B x K x N."""
    nt, splits = tiling(K, N)
    return splits * -(-N // nt) * -(-B // _BT)


def quant_matmul_plain(x, w, scale):
    """The plain PyTorch version, with the TPU kernel's arithmetic: each
    weight times its column's scale in fp32, then an fp32 product.
    Returns [B, N] fp32."""
    return x.float() @ (w.float() * scale.float())


def _check(x, w, scale):
    if x.dim() != 2 or w.dim() != 2 or scale.dim() != 1:
        raise ValueError(f"expected x [B, K], w [K, N] and scale [N], got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}, "
                         f"{tuple(scale.shape)}")
    if x.shape[1] != w.shape[0] or scale.shape[0] != w.shape[1]:
        raise ValueError(f"shapes do not chain: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, scale {tuple(scale.shape)}")
    if x.dtype not in _X_CODES or w.dtype not in _W_CODES \
            or scale.dtype != torch.float32:
        raise TypeError(f"x must be float32/bfloat16, w int8/float8_e4m3fn "
                        f"and scale float32, got {x.dtype}, {w.dtype}, "
                        f"{scale.dtype}")
    devs = {t.device for t in (x, w, scale)}
    if len(devs) != 1:
        raise ValueError(f"x, w, scale lie on different devices: {devs}")
    if 0 in x.shape or 0 in w.shape:
        raise ValueError(f"empty operand: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}")


def quant_matmul(x, w, scale):
    """``x @ (w * scale)``: x [B, K] fp32/bf16, w [K, N] int8 or
    float8_e4m3fn, scale [N] fp32 per output channel. Returns [B, N] fp32
    (callers cast to the compute dtype)."""
    _check(x, w, scale)
    if x.device.type == "cpu":
        return quant_matmul_plain(x, w, scale)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if not all(t.is_contiguous() for t in (x, w, scale)):
        raise ValueError("x, w and scale must be contiguous")
    B, K = x.shape
    N = w.shape[1]
    nt, splits = tiling(K, N)
    out = torch.empty((B, N), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _kernel()(x.data_ptr(), w.data_ptr(), scale.data_ptr(),
                        out.data_ptr(), B, K, N, _X_CODES[x.dtype],
                        _W_CODES[w.dtype], nt, splits,
                        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"quant_matmul launch failed: CUDA error {err}")
    quant_matmul.launches += 1
    return out


quant_matmul.launches = 0


def smem_bytes(x_dtype, K: int, N: int) -> int:
    """The dynamic shared memory of the launch at K x N for x of
    ``x_dtype`` (builds the library)."""
    nt, splits = tiling(K, N)
    fn = _library().quant_matmul_smem
    fn.argtypes = [ctypes.c_int] * 4
    fn.restype = ctypes.c_int
    return fn(_X_CODES[x_dtype], K, nt, splits)


def _library():
    from ._build import load_library

    return load_library("quant_matmul")


@functools.lru_cache(maxsize=None)
def _kernel():
    """The C entry point, built and loaded at first use; every pointer and
    the stream are declared ``c_void_p`` so none is cut to 32 bits."""
    fn = _library().quant_matmul
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn
