"""The softmax term of the lm-head activation gradient (the CE-tail dx).

Replaces the TPU kernel ``paddle_tpu/ops/pallas/head_dx.py``
(``head_dx_softmax``): ``dh_soft = (exp(logits - m) * scale) @ W^T``,
the softmax recomputed from the natural-layout logits inside the product,
so no [M, V] probability tensor is written. The CUDA source is
``paddle_tpu_torch/csrc/head_dx.cu``: a warp-specialised ``wgmma`` GEMM
fed by a TMA ring, whose A operand (the probabilities) its consumer
warpgroups make in registers from the logits box while the step before's
products run; its header says what bounds it on the H100 and how its
design follows.

Unlike the TPU kernel, which takes a pre-transposed ``wt = W^T [V, H]``,
this one takes the lm head ``w [H, V]`` as the model stores it and reads
its rows: no transposed copy is made.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises (bf16, V and H multiples of 8, contiguous).
"""

from __future__ import annotations

import ctypes
import functools

import torch

__all__ = ["head_dx_softmax", "head_dx_softmax_plain", "smem_bytes"]


def head_dx_softmax_plain(logits, m, scale, w):
    """``(exp(min(logits - m, 0)) * scale).to(dtype) @ w^T``: logits
    [M, V], m and scale [M] fp32, w [H, V]; returns [M, H] in logits'
    dtype. The clamp at 0 is exact for real rows (m is the row max)."""
    p = torch.exp(torch.clamp(logits.float() - m[:, None], max=0.0))
    p = (p * scale[:, None]).to(logits.dtype)
    return p @ w.to(logits.dtype).t()


def _check(logits, m, scale, w):
    if logits.dim() != 2 or w.dim() != 2 or w.shape[1] != logits.shape[1]:
        raise ValueError(f"expected logits [M, V] and w [H, V], got "
                         f"{tuple(logits.shape)} and {tuple(w.shape)}")
    M = logits.shape[0]
    for name, t in (("m", m), ("scale", scale)):
        if t.shape != (M,) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 [{M}], got {t.dtype} "
                             f"{tuple(t.shape)}")
    if logits.dtype not in (torch.float32, torch.bfloat16) \
            or w.dtype != logits.dtype:
        raise TypeError(f"logits and w must share a dtype in "
                        f"float32/bfloat16, got {logits.dtype}, {w.dtype}")
    devs = {t.device for t in (logits, m, scale, w)}
    if len(devs) != 1:
        raise ValueError(f"inputs lie on different devices: {devs}")
    if logits.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {logits.device}")


def head_dx_softmax(logits, m, scale, w):
    """``(exp(min(logits - m, 0)) * scale) @ w^T`` as one launch, fp32
    accumulation over V. logits [M, V]; m, scale [M] fp32 (scale folds the
    cotangent, the row weight and 1 / sumexp); w [H, V]. Returns [M, H] in
    logits' dtype."""
    _check(logits, m, scale, w)
    if logits.device.type == "cpu":
        return head_dx_softmax_plain(logits, m, scale, w)
    M, V = logits.shape
    H = w.shape[0]
    if logits.dtype != torch.bfloat16 or V % 8 or H % 8:
        raise ValueError(f"the kernel takes bfloat16 with V and H multiples "
                         f"of 8, got {logits.dtype}, V={V}, H={H}")
    ts = (logits, m, scale, w)
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("the kernel takes contiguous tensors")
    if any(t.data_ptr() % 16 for t in ts):
        raise ValueError("the kernel takes tensors on a 16-byte boundary "
                         "(rows are read in 16-byte loads)")
    out = torch.empty(M, H, dtype=logits.dtype, device=logits.device)
    with torch.cuda.device(logits.device):
        err = _kernel()(logits.data_ptr(), m.data_ptr(), scale.data_ptr(),
                        w.data_ptr(), out.data_ptr(), M, V, H,
                        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"head_dx_softmax launch failed: CUDA error {err}")
    head_dx_softmax.launches += 1
    return out


head_dx_softmax.launches = 0


def smem_bytes() -> int:
    """The dynamic shared memory one block of the kernel asks for (its
    ring of logits and W boxes; builds the library)."""
    from ._build import load_library

    fn = load_library("head_dx").head_dx_smem
    fn.argtypes = []
    fn.restype = ctypes.c_int
    return fn()


@functools.lru_cache(maxsize=None)
def _kernel():
    """The C entry point, built and loaded at first use; every pointer
    and the stream are ``c_void_p`` so none is cut to 32 bits."""
    from ._build import load_library

    fn = load_library("head_dx").head_dx_softmax
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn
