"""Ragged decode attention: per-slot KV reads bounded by position.

Replaces the TPU kernel ``paddle_tpu/ops/pallas/decode_attention.py``
(``ragged_decode_attention``, body ``_make_kernel``). The CUDA kernel is
``paddle_tpu_torch/csrc/decode_attention.cu``; its header says what bounds
it on the H100 (latency: it reads each visible key and value once, fewer
bytes than one trip to memory costs) and how its design splits each slot
over key chunks across blocks, merges them in the same launch and keeps
the bytes read proportional to ``pos`` rather than to ``max_len``.

The launch needs two buffers beside its output: a float32 workspace for
the chunks' partial states (``torch.empty`` per call) and an int32 ticket
per (slot, kv head), zero before the launch and left zero by it, kept
here per device and size (``_tickets``). One ticket buffer serves one
stream at a time, as the port runs.

Quant mode (the TPU kernel's ``k_scale``/``v_scale``): an int8 or
float8_e4m3fn cache with one fp32 scale per cache row, dequantized in the
kernel; its launches are also counted in
``ragged_decode_attention.quant_launches``.

Head dims: every ``D % 8 == 0`` from 8 to 128 (``check_heads``): 64 and
128 by instances compiled for them, the others by instances at the padded
widths 32, 64 and 128 with the true D at run time.

Dispatch: a CPU tensor takes the plain version below; a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

__all__ = ["ragged_decode_attention", "ragged_decode_attention_plain",
           "check_heads", "padded_dim", "smem_bytes"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_KV_CODES = {torch.int8: 1, torch.float8_e4m3fn: 2}  # quant mode's caches
_MAX_HEAD_DIM = 128  # MAX_D in csrc/split_kv.cuh
_MAX_REP = 8  # MAX_ROWS in csrc/split_kv.cuh
_CHUNK = 64   # CHUNK in csrc/split_kv.cuh: keys per block


def padded_dim(D: int) -> int:
    """The width whose kernel instances serve head dim ``D`` (32, 64 or
    128; ``padded_dim`` in csrc/split_kv.cuh), 0 for a head dim no
    instance takes."""
    if D < 8 or D > _MAX_HEAD_DIM or D % 8:
        return 0
    return 32 if D <= 32 else 64 if D <= 64 else 128


def check_heads(nH: int, Hkv: int, D: int) -> None:
    """Raise ``ValueError`` unless the split-KV decode and the paged
    kernels take ``nH`` query heads over ``Hkv`` kv heads of dim ``D``:
    ``D % 8 == 0`` with ``8 <= D <= 128``, and at most 8 query heads a kv
    head. A ``ServingEngine`` built on the card checks its model with it,
    so a shape the kernels refuse fails at build, not at the first
    tick."""
    if not padded_dim(D):
        raise ValueError(f"the attention kernels take head_dim a multiple "
                         f"of 8 from 8 to {_MAX_HEAD_DIM}, got D={D}")
    if nH % Hkv or nH // Hkv > _MAX_REP:
        raise ValueError(f"the attention kernels take at most {_MAX_REP} "
                         f"query heads per kv head (num_heads a multiple of "
                         f"num_kv_heads), got {nH}/{Hkv}")


def ragged_decode_attention_plain(q, kc, vc, pos, k_scale=None,
                                  v_scale=None):
    """The plain PyTorch version: the same function as the kernel, with
    the same conventions (q pre-scaled in its own dtype, fp32 scores and
    softmax, probabilities rounded to the dtype before P @ V, fp32
    accumulation). In quant mode each cache row is dequantized in fp32
    with its scale and the probabilities stay fp32, as in the TPU
    kernel. Softmax here is over the whole visible window at once where
    the kernel takes it chunk by chunk and merges the chunks."""
    B, nH, D = q.shape
    Smax, Hkv = kc.shape[1], kc.shape[2]
    rep = nH // Hkv
    dt = q.dtype
    quant = k_scale is not None
    kf, vf = kc.float(), vc.float()
    if quant:
        kf = kf * k_scale.float()[..., None, None]
        vf = vf * v_scale.float()[..., None, None]
    qs = (q * (1.0 / math.sqrt(D))).to(dt).reshape(B, Hkv, rep, D)
    s = torch.einsum("bhrd,bshd->bhrs", qs.float(), kf)
    visible = (torch.arange(Smax, device=q.device)[None, :]
               <= pos.to(torch.int64)[:, None])                # [B, Smax]
    s = s.masked_fill(~visible[:, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    if not quant:
        p = p.to(dt)
    o = torch.einsum("bhrs,bshd->bhrd", p.float(), vf)
    return o.to(dt).reshape(B, nH, D)


def _check(q, kc, vc, pos, k_scale, v_scale):
    if q.dim() != 3 or kc.dim() != 4 or vc.shape != kc.shape:
        raise ValueError(f"expected q [B,nH,D] and kc/vc [B,max_len,Hkv,D], "
                         f"got {tuple(q.shape)}, {tuple(kc.shape)}, "
                         f"{tuple(vc.shape)}")
    B, nH, D = q.shape
    if kc.shape[0] != B or kc.shape[3] != D:
        raise ValueError(f"cache {tuple(kc.shape)} does not match q "
                         f"{tuple(q.shape)}")
    Hkv = kc.shape[2]
    if nH % Hkv:
        raise ValueError(f"num_heads {nH} is not a multiple of "
                         f"num_kv_heads {Hkv}")
    if pos.shape != (B,) or pos.dtype != torch.int32:
        raise ValueError(f"pos must be int32 [{B}], got {pos.dtype} "
                         f"{tuple(pos.shape)}")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale come together")
    quant = k_scale is not None
    kv_ok = (kc.dtype in _KV_CODES if quant else kc.dtype == q.dtype)
    if q.dtype not in _DTYPE_CODES or not kv_ok or vc.dtype != kc.dtype:
        raise TypeError(
            f"q must be float32/bfloat16 and kc/vc share "
            f"{'int8/float8_e4m3fn' if quant else 'its dtype'}, got "
            f"{q.dtype}, {kc.dtype}, {vc.dtype}")
    tensors = [q, kc, vc, pos]
    if quant:
        for name, sc in (("k_scale", k_scale), ("v_scale", v_scale)):
            if sc.shape != kc.shape[:2] or sc.dtype != torch.float32:
                raise ValueError(f"{name} must be float32 "
                                 f"{tuple(kc.shape[:2])}, got {sc.dtype} "
                                 f"{tuple(sc.shape)}")
        tensors += [k_scale, v_scale]
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"q, kc, vc, pos (and the scales) lie on different "
                         f"devices: {devs}")
    return tensors


def ragged_decode_attention(q, kc, vc, pos, k_scale=None, v_scale=None):
    """Single-token decode attention with per-slot ragged KV reads.

    q: [B, nH, D]; kc/vc: [B, max_len, Hkv, D] (the slot-contiguous cache,
    or one layer's view of the stacked cache); pos: [B] int32 — keys
    [0, pos[b]] are visible to slot b (row ``pos`` holds the token being
    decoded, already scattered by the caller on the same stream). Returns
    [B, nH, D] in q.dtype.

    ``k_scale``/``v_scale`` ([B, max_len] fp32, optional): a quantized
    cache's per-row scales (kc/vc int8 or float8_e4m3fn)."""
    tensors = _check(q, kc, vc, pos, k_scale, v_scale)
    quant = k_scale is not None
    if q.device.type == "cpu":
        return ragged_decode_attention_plain(q, kc, vc, pos, k_scale,
                                             v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    B, nH, D = q.shape
    Smax, Hkv = kc.shape[1], kc.shape[2]
    check_heads(nH, Hkv, D)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("q, kc, vc, pos and the scales must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, kc, vc)):
        raise ValueError("q, kc and vc must start on a 16-byte boundary "
                         "(the kernel reads rows in 16-byte loads)")
    out = torch.empty_like(q)
    n_chunks = -(-Smax // _CHUNK)
    part = torch.empty(B * Hkv * n_chunks * (nH // Hkv) * (D + 2),
                       dtype=torch.float32, device=q.device)
    tickets = _tickets(q.device, B * Hkv)
    with torch.cuda.device(q.device):
        err = _kernel()(
            q.data_ptr(), kc.data_ptr(), vc.data_ptr(),
            k_scale.data_ptr() if quant else None,
            v_scale.data_ptr() if quant else None, pos.data_ptr(),
            out.data_ptr(), part.data_ptr(), tickets.data_ptr(), B, nH, Hkv,
            D, Smax, _DTYPE_CODES[q.dtype],
            _KV_CODES[kc.dtype] if quant else 0, 1.0 / math.sqrt(D),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"ragged_decode_attention launch failed: CUDA "
                           f"error {err}")
    ragged_decode_attention.launches += 1
    if quant:
        ragged_decode_attention.quant_launches += 1
    return out


ragged_decode_attention.launches = 0
ragged_decode_attention.quant_launches = 0

# (device, slots x kv heads) -> the zeroed int32 tickets of the merge; and
# how many this process made (``analysis.recompile`` counts them)
_TICKETS = {}
TICKET_BUFFERS = [0]


def _tickets(device, n):
    """The ticket buffer of ``n`` (slot, kv head) pairs on ``device``:
    made zero at its first use, outside any CUDA-graph capture (a buffer
    made inside one would belong to the graph's pool and be zeroed only
    when the graph replays), and left zero by every launch."""
    key = (device.index, n)
    if key not in _TICKETS:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("split-KV attention (ragged_decode_attention"
                               ", ragged_paged_attention's decode): call it "
                               "once at this shape before capturing it into "
                               "a CUDA graph (its ticket buffer is made "
                               "then)")
        _TICKETS[key] = torch.zeros(n, dtype=torch.int32, device=device)
        TICKET_BUFFERS[0] += 1
    return _TICKETS[key]


def smem_bytes(dtype, kv_dtype, D, rep=1):
    """The dynamic shared memory one block of the kernel instance for q
    of ``dtype``, a cache of ``kv_dtype`` and head dim ``D`` asks for at
    ``rep`` query heads per kv head (builds the library)."""
    fn = _library().ragged_decode_smem
    fn.argtypes = [ctypes.c_int] * 4
    fn.restype = ctypes.c_int
    return fn(_DTYPE_CODES[dtype],
              0 if kv_dtype == dtype else _KV_CODES[kv_dtype], D, rep)


def _library():
    from ._build import load_library

    return load_library("decode_attention")


@functools.lru_cache(maxsize=None)
def _kernel():
    """The C entry point, built and loaded at first use; every pointer
    and the stream are declared ``c_void_p`` so none is cut to 32 bits."""
    fn = _library().ragged_decode_attention
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn
