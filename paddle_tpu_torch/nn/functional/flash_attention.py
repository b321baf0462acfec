"""``flash_attention`` and ``flash_attn_unpadded``: the reference's
flash-attn functional module.

Counterpart of ``paddle_tpu/nn/functional/flash_attention.py``. Both
dispatch through ``scaled_dot_product_attention`` (the flash kernels
without dropout, the probability-level dropout path with it). The varlen
form runs each packed sequence as its own batch of 1; its boundaries
(``cu_seqlens``) are read on the host, since they define shapes.

Layout: ``[batch, seq, num_heads, head_dim]``; the varlen form's
``[total_tokens, num_heads, head_dim]``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ...amp import cast_inputs
from ...ops.kernels import flash_attention as _fa

__all__ = ["flash_attention", "flash_attn_unpadded"]


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, *, fixed_seed_offset=None,
                    rng_name="", training=True, name=None):
    """``(out, softmax)``; ``softmax`` is None unless ``return_softmax``,
    then the pre-dropout probabilities ``[B, H, Sq, Sk]`` (fp32), computed
    apart from ``out`` (the reference returns them for debugging)."""
    from . import scaled_dot_product_attention

    out = scaled_dot_product_attention(query, key, value, dropout_p=dropout,
                                       is_causal=causal, training=training)
    softmax = None
    if return_softmax:
        q, k = cast_inputs("flash_attention_softmax", query, key)
        softmax = _fa.attention_probs(q, k, is_causal=causal)
    return out, softmax


def _host_ints(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().numpy()
    return np.asarray(t).astype(np.int64)


def flash_attn_unpadded(query, key, value, cu_seqlens_q, cu_seqlens_k,
                        max_seqlen_q, max_seqlen_k, scale, dropout=0.0,
                        causal=False, return_softmax=False, *,
                        fixed_seed_offset=None, rng_name="", training=True,
                        name=None):
    """Varlen (packed) attention: ``query`` / ``key`` / ``value``
    ``[total_tokens, num_heads, head_dim]``, ``cu_seqlens_*`` the
    ``[batch + 1]`` cumulative boundaries, ``scale`` the softmax scale.
    Each segment runs as its own batch of 1 through
    ``scaled_dot_product_attention``, q pre-scaled by ``scale *
    sqrt(head_dim)`` so that its default ``1 / sqrt(head_dim)`` gives
    ``scale``. Returns ``(out [total_q, heads, head_dim], None)``."""
    if return_softmax:
        raise NotImplementedError(
            "flash_attn_unpadded(return_softmax=True): the per-segment "
            "softmax matrices are ragged; use the dense flash_attention "
            "on one sequence at a time if you need them")
    cq, ck = _host_ints(cu_seqlens_q), _host_ints(cu_seqlens_k)
    if len(cq) != len(ck):
        raise ValueError("cu_seqlens_q and cu_seqlens_k disagree on batch")
    if int(cq[-1]) != int(query.shape[0]) or int(ck[-1]) != int(key.shape[0]):
        raise ValueError(
            f"cu_seqlens must cover the packed tokens: cu_seqlens_q ends at "
            f"{int(cq[-1])} but query has {int(query.shape[0])} tokens "
            f"(key: {int(ck[-1])} vs {int(key.shape[0])})")
    for name_, arr in (("cu_seqlens_q", cq), ("cu_seqlens_k", ck)):
        if int(arr[0]) != 0 or np.any(np.diff(arr) < 0):
            raise ValueError(
                f"{name_} must start at 0 and be non-decreasing, got "
                f"{arr.tolist()}")
    from . import scaled_dot_product_attention

    q_factor = float(scale) * math.sqrt(int(query.shape[-1]))
    outs = []
    for i in range(len(cq) - 1):
        qs, qe, ks, ke = int(cq[i]), int(cq[i + 1]), int(ck[i]), int(ck[i + 1])
        outs.append(scaled_dot_product_attention(
            (query[qs:qe] * q_factor).unsqueeze(0), key[ks:ke].unsqueeze(0),
            value[ks:ke].unsqueeze(0), dropout_p=dropout, is_causal=causal,
            training=training).squeeze(0))
    return torch.cat(outs, dim=0), None
