"""Ragged paged attention: decode ticks and prefill chunks over a page pool.

Replaces the TPU kernel ``paddle_tpu/ops/pallas/paged_attention.py``
(``ragged_paged_attention``, body ``_make_kernel``). The CUDA kernel is
``paddle_tpu_torch/csrc/paged_attention.cu``; its header says what bounds
it on the H100 and how its design keeps the pages read proportional to
each slot's position rather than to the table width. Two families, chosen
from the shape alone (``family``): a decode tick (at most 8 query rows a
kv head) runs the split-KV kernel of ``csrc/split_kv.cuh``, 64-key chunks
across blocks merged in the same launch by tickets, which needs a float32
workspace (``torch.empty`` per call) and an int32 ticket per (slot, kv
head), zero before the launch and left zero by it (the decode wrapper's
``_tickets``, made outside any CUDA-graph capture); a prefill chunk runs
on tensor cores in bf16 (on CUDA cores in fp32).

Dispatch: a CPU tensor takes the plain version below (the JAX package's
CPU path: gather the slot's pages into a window, then dense attention);
a CUDA tensor launches the kernel or raises. The quantized pool of the
TPU engine takes a dequantizing gather there, not this kernel, and is not
ported yet.

Shapes: every head dim ``D % 8 == 0`` from 8 to 128 (``check_heads`` of
the decode module) and any ``Tq >= 1`` up to ``max_rows`` query rows a kv
head, as the JAX kernel (no bound on Tq but the grid's).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from .decode_attention import _tickets, check_heads

__all__ = ["ragged_paged_attention", "ragged_paged_attention_plain",
           "pages_read", "family", "max_rows", "smem_bytes"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_REP = 8    # MAX_ROWS in csrc/split_kv.cuh: query heads a kv head
_CHUNK = 64     # CHUNK in csrc/split_kv.cuh: keys a decode block
_MAX_BLOCKS_Z = 65535  # a grid's z extent: the prefill's row blocks
_ROWS_A_BLOCK = {torch.bfloat16: 64, torch.float32: 8}  # PF_ROWS, CC_ROWS


def family(Tq: int, rep: int) -> str:
    """The kernel family that serves Tq query positions of rep heads a kv
    head: "decode" (split-KV) for at most 8 rows, else "prefill"."""
    return "decode" if Tq * rep <= _MAX_REP else "prefill"


def max_rows(dtype) -> int:
    """The most query rows a kv head (Tq x rep) one launch takes in
    ``dtype``: the prefill's row blocks fill at most a grid's z extent
    (4194240 rows in bf16, 524280 in fp32; an engine's chunk is at most
    its max_len)."""
    return _MAX_BLOCKS_Z * _ROWS_A_BLOCK[dtype]


def pages_read(ctx_len, q_len, page_size: int):
    """Pages the kernel reads for a slot whose chunk ends at position
    ``ctx_len + q_len - 1`` (keys [0, end] visible: end // page + 1),
    before the clamp at the table width."""
    return (ctx_len + q_len - 1) // page_size + 1


def ragged_paged_attention_plain(q, kp, vp, page_table, ctx_len, q_len=None,
                                 scale=None):
    """The plain PyTorch version: gather each slot's pages into a
    ``[B, max_pages * page_size]`` window and run the model's dense cache
    attention on it with row t of slot b at position ``ctx_len[b] + t``.
    Every row is computed; rows at or past ``q_len`` are padding the
    caller discards."""
    # imported here: models.llama imports this module
    from ...models.llama import _dense_cache_attention

    B, Tq, nH, D = q.shape
    psz, Hkv = kp.shape[1], kp.shape[2]
    W = page_table.shape[1] * psz
    idx = page_table.long()
    gk = kp[idx].reshape(B, W, Hkv, D)
    gv = vp[idx].reshape(B, W, Hkv, D)
    positions = (ctx_len.long()[:, None]
                 + torch.arange(Tq, device=q.device))
    return _dense_cache_attention(None, q, gk, gv, positions,
                                  1.0 / math.sqrt(D) if scale is None
                                  else scale)


def _check(q, kp, vp, page_table, ctx_len, q_len):
    if q.dim() != 4 or kp.dim() != 4 or vp.shape != kp.shape:
        raise ValueError(f"expected q [B,Tq,nH,D] and kp/vp "
                         f"[P,page_size,Hkv,D], got {tuple(q.shape)}, "
                         f"{tuple(kp.shape)}, {tuple(vp.shape)}")
    B, Tq, nH, D = q.shape
    if kp.shape[3] != D:
        raise ValueError(f"pool {tuple(kp.shape)} does not match q "
                         f"{tuple(q.shape)}")
    Hkv = kp.shape[2]
    if nH % Hkv:
        raise ValueError(f"num_heads {nH} is not a multiple of "
                         f"num_kv_heads {Hkv}")
    if (page_table.dim() != 2 or page_table.shape[0] != B
            or page_table.dtype != torch.int32):
        raise ValueError(f"page_table must be int32 [{B}, max_pages], got "
                         f"{page_table.dtype} {tuple(page_table.shape)}")
    for name, t in (("ctx_len", ctx_len), ("q_len", q_len)):
        if t is not None and (t.shape != (B,) or t.dtype != torch.int32):
            raise ValueError(f"{name} must be int32 [{B}], got {t.dtype} "
                             f"{tuple(t.shape)}")
    if q.dtype not in _DTYPE_CODES or kp.dtype != q.dtype \
            or vp.dtype != q.dtype:
        raise TypeError(f"q/kp/vp must share a dtype in float32/bfloat16, "
                        f"got {q.dtype}, {kp.dtype}, {vp.dtype}")
    ts = [t for t in (q, kp, vp, page_table, ctx_len, q_len) if t is not None]
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"inputs lie on different devices: {devs}")


def ragged_paged_attention(q, kp, vp, page_table, ctx_len, q_len=None,
                           scale=None):
    """Attention over a paged KV pool, decode ticks and prefill chunks in
    one call.

    q: [B, Tq, nH, D], row t of slot b at position ``ctx_len[b] + t``;
    kp/vp: [P, page_size, Hkv, D], the flat pool (one layer's view of the
    stacked pool), already holding the chunk's own K/V rows (the caller
    scatters first, on the same stream); page_table: [B, max_pages] int32
    physical page per virtual page slot; ctx_len: [B] int32 rows already
    in the cache; q_len: [B] int32 live rows per chunk (None: all Tq).
    Returns [B, Tq, nH, D] in q.dtype; rows at or past q_len are finite
    garbage."""
    _check(q, kp, vp, page_table, ctx_len, q_len)
    if q.device.type == "cpu":
        return ragged_paged_attention_plain(q, kp, vp, page_table, ctx_len,
                                            q_len, scale)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    B, Tq, nH, D = q.shape
    P, psz, Hkv = kp.shape[0], kp.shape[1], kp.shape[2]
    check_heads(nH, Hkv, D)
    if psz % 8:
        raise ValueError(f"the kernel takes page_size a multiple of 8, got "
                         f"page_size={psz}")
    if not 1 <= Tq * (nH // Hkv) <= max_rows(q.dtype):
        raise ValueError(f"the kernel takes Tq >= 1 with at most "
                         f"{max_rows(q.dtype)} query rows a kv head (Tq x "
                         f"{nH // Hkv}), got Tq={Tq}")
    ts = [t for t in (q, kp, vp, page_table, ctx_len, q_len) if t is not None]
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("q, kp, vp, page_table, ctx_len and q_len must be "
                         "contiguous")
    if any(t.data_ptr() % 16 for t in (q, kp, vp)):
        raise ValueError("q, kp and vp must start on a 16-byte boundary "
                         "(the kernel reads rows in 16-byte loads)")
    out = torch.empty_like(q)
    max_pages = page_table.shape[1]
    part = tickets = None
    if family(Tq, nH // Hkv) == "decode":
        n_chunks = -(-max_pages * psz // _CHUNK)
        part = torch.empty(B * Hkv * n_chunks * Tq * (nH // Hkv) * (D + 2),
                           dtype=torch.float32, device=q.device)
        tickets = _tickets(q.device, B * Hkv)
    with torch.cuda.device(q.device):
        err = _kernel()(
            q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
            page_table.data_ptr(), ctx_len.data_ptr(),
            None if q_len is None else q_len.data_ptr(), out.data_ptr(),
            None if part is None else part.data_ptr(),
            None if tickets is None else tickets.data_ptr(),
            B, Tq, nH, Hkv, D, psz, P, max_pages, _DTYPE_CODES[q.dtype],
            1.0 / math.sqrt(D) if scale is None else scale,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"ragged_paged_attention launch failed: CUDA "
                           f"error {err}")
    ragged_paged_attention.launches += 1
    return out


ragged_paged_attention.launches = 0


def smem_bytes(dtype, D: int, rows: int) -> int:
    """The dynamic shared memory one block of the instance that serves
    ``rows`` = Tq x rep query rows a kv head at head dim ``D`` asks for (0
    for the fp32 prefill, whose shared memory is static; builds the
    library)."""
    fn = _library().ragged_paged_smem
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_int
    return fn(_DTYPE_CODES[dtype], D, rows)


def _library():
    from ._build import load_library

    return load_library("paged_attention")


@functools.lru_cache(maxsize=None)
def _kernel():
    """The C entry point, built and loaded at first use; every pointer
    and the stream are declared ``c_void_p`` so none is cut to 32 bits."""
    fn = _library().ragged_paged_attention
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 9
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn
