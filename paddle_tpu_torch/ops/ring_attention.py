"""Ring and Ulysses attention: context parallelism over a mesh axis.

Port of ``paddle_tpu/ops/pallas/ring_attention.py``, which calls no
``pallas_call``: its per-chunk attention and merge are plain XLA, and so
they are plain torch here (``_chunk_attention``, ``_merge``). Layout is
[batch, seq, heads, dim] with the sequence split over the axis, each rank
holding its contiguous rows (rank i's start at ``i * S_local``).

- ``ring_attention``: each rank attends its queries to every rank's K/V
  chunk, passed around the ring by ``batch_isend_irecv`` (an autograd
  Function whose backward passes the cotangent the other way, as
  ``ppermute``'s transpose does), partial results merged by the online
  softmax. Under ``is_causal`` the chunks after this rank's rows are
  skipped, and the last pass is not made (it fed nothing).
- ``ulysses_attention``: two all-to-alls (autograd Functions, each its own
  transpose) reshard sequence-parallel q/k/v into head-parallel ones, each
  rank attends the whole sequence on H / n heads through
  ``dot_product_attention`` (the flash kernels on the card), and a third
  and inverse all-to-all brings the rows back.

The entries ``context_parallel_attention`` and
``ulysses_parallel_attention`` take whole arrays, as the reference's
GSPMD entries do, and run the local function on each rank's shard through
``shard_map_compat``. Where the axis is absent or of size 1, or a sharded
dimension does not divide, they take the reference's dense branch
(``fallback()`` if given, else ``xla_attention``): an explicit test of the
shapes, never a caught error. ``sp_slab_ring_attention`` and
``sp_slab_prefill_attention`` (the serving ``sp`` axis) wait for ROADMAP
Queue A item 6.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist

from ..distributed import _comm
from ..parallel.mesh import (P, axis_group, axis_size, get_mesh,
                             shard_map_compat)
from .kernels import flash_attention as _fa

__all__ = ["ring_attention", "RingFlashAttention",
           "context_parallel_attention", "ulysses_attention",
           "ulysses_parallel_attention", "sp_slab_ring_attention",
           "sp_slab_prefill_attention"]


def _chunk_attention(q, k, v, scale, q_offset, k_offset, is_causal):
    """Unnormalised attention of q against one K/V chunk: (acc, m, l), the
    fp32 weighted values [B, H, Sq, D], running max and running sum [B, H,
    Sq]. Products of the inputs' values accumulate in fp32 (the
    reference's ``preferred_element_type``); p is rounded to v's type
    before its product, as there. Offsets are global positions of q's and
    k's row 0, for the causal mask across chunks."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if is_causal:
        sq, sk = q.shape[1], k.shape[1]
        qp = q_offset + torch.arange(sq, device=q.device)[:, None]
        kp = k_offset + torch.arange(sk, device=q.device)[None, :]
        s = s.masked_fill(~(qp >= kp), float("-inf"))
    m = s.amax(-1)
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.exp(s - m_safe[..., None])
    p = torch.where(torch.isfinite(s), p, 0.0)
    l = p.sum(-1)
    acc = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(), v.float())
    return acc, m, l


def _merge(acc, m, l, acc2, m2, l2):
    """Online-softmax merge of two partial attention states."""
    m_new = torch.maximum(m, m2)
    m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
    a1 = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
    a2 = torch.where(torch.isfinite(m2), torch.exp(m2 - m_safe), 0.0)
    return (acc * a1[..., None] + acc2 * a2[..., None], m_new,
            l * a1 + l2 * a2)


class _RingShift(torch.autograd.Function):
    """x to the next rank of the ring, the previous rank's x back; the
    backward passes the cotangent to the previous rank."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _comm.ring_shift(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return _comm.ring_shift(g, ctx.group, -1), None


class _AllToAll(torch.autograd.Function):
    """Piece j (dim 0) to rank j; the backward is the same exchange of the
    cotangent's pieces."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _comm.all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _comm.all_to_all(g.contiguous(), ctx.group), None


def _group(axis_name, mesh):
    mesh = mesh or get_mesh()
    return axis_group(mesh, axis_name), axis_size(mesh, axis_name)


def ring_attention(q, k, v, axis_name: str = "sep", is_causal: bool = False,
                   scale: Optional[float] = None, mesh=None):
    """Ring attention over ``axis_name`` of ``mesh`` (default the global
    mesh) on this rank's rows of q/k/v [B, S / n, H, D]. Exact: equal to
    full attention over the gathered sequence."""
    group, n = _group(axis_name, mesh)
    idx = 0 if group is None else dist.get_rank(group)
    b, s_local, h, d = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    q_offset = idx * s_local
    acc = q.new_zeros((b, h, s_local, d), dtype=torch.float32)
    m = torch.full((b, h, s_local), float("-inf"), dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, h, s_local), dtype=torch.float32, device=q.device)
    kv = torch.stack([k, v])   # one pass of the ring for both
    for i in range(n):
        src = (idx - i) % n  # the rank whose chunk this rank now holds
        if not is_causal or src <= idx:
            acc, m, l = _merge(acc, m, l, *_chunk_attention(
                q, kv[0], kv[1], scale, q_offset, src * s_local, is_causal))
        if i < n - 1:
            kv = _RingShift.apply(kv, group)
    if n > 1:
        # every rank's backward must run every pass's transpose, also a
        # rank whose last chunks were skipped (nothing of them reached its
        # output): the held chunk joins the output with weight 0
        l = l + 0.0 * kv.float().sum()
    l = torch.where(l == 0.0, 1.0, l)
    out = acc / l[..., None]
    return out.transpose(1, 2).to(q.dtype)


RingFlashAttention = ring_attention


def _seq_to_heads(x, group, n):
    """[T, B, S / n, H, D] -> [T, B, S, H / n, D] for T stacked tensors (q,
    k, v in one exchange): head group r to rank r, the sequence chunks
    received in rank order."""
    t, b, sl, h, d = x.shape
    y = x.reshape(t, b, sl, n, h // n, d).permute(3, 0, 1, 2, 4, 5)
    y = _AllToAll.apply(y.contiguous(), group)  # [n (source), T, B, S/n, ..]
    return y.permute(1, 2, 0, 3, 4, 5).reshape(t, b, n * sl, h // n, d)


def _heads_to_seq(x, group, n):
    """The inverse: [B, S, H / n, D] -> [B, S / n, H, D]."""
    b, s, hl, d = x.shape
    y = x.reshape(b, n, s // n, hl, d).permute(1, 0, 2, 3, 4).contiguous()
    y = _AllToAll.apply(y, group)          # [n (head group), B, S/n, H/n, D]
    return y.permute(1, 2, 0, 3, 4).reshape(b, s // n, n * hl, d)


def ulysses_attention(q, k, v, axis_name: str = "sep",
                      is_causal: bool = False, scale: Optional[float] = None,
                      mesh=None):
    """Ulysses sequence parallelism on this rank's rows of q/k/v [B, S / n,
    H, D]; H must divide by the axis size n."""
    group, n = _group(axis_name, mesh)
    h = q.shape[2]
    if h % n:
        raise ValueError(f"ulysses_attention: head count {h} must be "
                         f"divisible by the '{axis_name}' axis size {n}")
    if group is None:
        return _fa.dot_product_attention(q, k, v, is_causal=is_causal,
                                         scale=scale)
    qh, kh, vh = _seq_to_heads(torch.stack([q, k, v]), group, n)
    out = _fa.dot_product_attention(qh, kh, vh, is_causal=is_causal,
                                    scale=scale)
    return _heads_to_seq(out, group, n)


def _present(axes, mesh):
    if axes is None:
        return None
    axes = tuple(a for a in (axes if isinstance(axes, (tuple, list))
                             else (axes,)) if a in mesh.mesh_dim_names)
    return axes or None


def sp_divides(shape, mesh, axis_name, batch_axes=None, head_axes=None,
               needs_head_divisible=False) -> bool:
    """True where the sequence-parallel entries shard [B, S, H, D] of
    ``shape`` over ``axis_name`` (with the batch over ``batch_axes`` and
    the heads over ``head_axes``), False where they take the dense
    branch: the axis absent or of size 1, or a sharded dimension (or,
    for Ulysses, the per-shard head count) not dividing."""
    if mesh is None or axis_name not in mesh.mesh_dim_names:
        return False
    n = axis_size(mesh, axis_name)
    if n <= 1:
        return False
    b_size = axis_size(mesh, _present(batch_axes, mesh) or ())
    h_size = axis_size(mesh, _present(head_axes, mesh) or ())
    b, s, h = shape[:3]
    if s % n or b % b_size or h % h_size:
        return False
    return not (needs_head_divisible and (h // h_size) % n)


def _sp_entry(local_fn, q, k, v, mesh, axis_name, is_causal, batch_axes,
              head_axes, fallback, needs_head_divisible=False):
    mesh = mesh or get_mesh()
    if not all(sp_divides(x.shape, mesh, axis_name, batch_axes, head_axes,
                          needs_head_divisible) for x in (q, k, v)):
        if fallback is not None:
            return fallback()
        return _fa.xla_attention(q, k, v, is_causal=is_causal)
    spec = P(_present(batch_axes, mesh), axis_name,
             _present(head_axes, mesh), None)

    def local(qs, ks, vs):
        return local_fn(qs, ks, vs, axis_name=axis_name, is_causal=is_causal,
                        mesh=mesh)

    return shard_map_compat(local, mesh, (spec, spec, spec), spec)(q, k, v)


def context_parallel_attention(q, k, v, mesh=None, axis_name: str = "sep",
                               is_causal: bool = False, batch_axes=None,
                               head_axes=None, fallback=None):
    """Ring attention on whole q/k/v: the sequence split over
    ``axis_name`` (the batch over ``batch_axes``, heads over
    ``head_axes``), the output gathered whole; the dense branch where
    ``sp_divides`` is False."""
    return _sp_entry(ring_attention, q, k, v, mesh, axis_name, is_causal,
                     batch_axes, head_axes, fallback)


def ulysses_parallel_attention(q, k, v, mesh=None, axis_name: str = "sep",
                               is_causal: bool = False, batch_axes=None,
                               head_axes=None, fallback=None):
    """Ulysses on whole q/k/v, as ``context_parallel_attention``; also
    dense where the per-shard head count does not divide by the axis."""
    return _sp_entry(ulysses_attention, q, k, v, mesh, axis_name, is_causal,
                     batch_axes, head_axes, fallback,
                     needs_head_divisible=True)


def sp_slab_ring_attention(*args, **kwargs):
    raise NotImplementedError("sp_slab_ring_attention (serving's sp axis) "
                              "is not ported yet (ROADMAP Queue A item 6)")


def sp_slab_prefill_attention(*args, **kwargs):
    raise NotImplementedError("sp_slab_prefill_attention (serving's sp axis)"
                              " is not ported yet (ROADMAP Queue A item 6)")
