"""``incubate.nn.functional``: the fused-op entry points.

Counterpart of ``paddle_tpu/incubate/nn/functional.py``, which writes each
fused CUDA kernel of the reference (``fused_gemm_epilogue``,
``fused_feedforward``, ``fused_attention``, ``fused_rope``, ...) as a
composition of ``nn.functional`` ops and leaves the fusion to XLA; the port
composes the same ops, so the names exist and reference model code runs
unchanged. None of them is a TPU kernel; their attention reaches the flash
kernels (``fused_multi_head_attention`` through
``scaled_dot_product_attention``, ``flash_attention`` through
``dot_product_attention`` directly, as the JAX package's does).
"""

from __future__ import annotations

import torch

from ...amp import cast_inputs
from ...nn import functional as F
from ...ops.kernels import flash_attention as _fa

__all__ = ["fused_linear", "fused_rms_norm", "fused_layer_norm",
           "fused_rotary_position_embedding", "fused_feedforward",
           "flash_attention", "fused_multi_head_attention", "swiglu"]


def fused_linear(x, weight, bias=None, transpose_weight=False, name=None):
    """``x @ weight + bias`` (``weight`` ``[out, in]`` when
    ``transpose_weight``)."""
    if transpose_weight:
        weight = weight.t()
    return F.linear(x, weight, bias)


def fused_rms_norm(x, norm_weight, norm_bias=None, epsilon: float = 1e-6,
                   begin_norm_axis: int = -1, name=None):
    out = F.rms_norm(x, norm_weight, epsilon=epsilon)
    return out if norm_bias is None else out + norm_bias


def fused_layer_norm(x, norm_weight, norm_bias, epsilon: float = 1e-5,
                     begin_norm_axis: int = -1, name=None):
    return F.layer_norm(x, list(x.shape[begin_norm_axis:]),
                        weight=norm_weight, bias=norm_bias, epsilon=epsilon)


def _table(t, device):
    return t.to(device=device, dtype=torch.float32) \
        if isinstance(t, torch.Tensor) else torch.as_tensor(
            t, dtype=torch.float32, device=device)


def fused_rotary_position_embedding(q, k=None, v=None, sin=None, cos=None,
                                    position_ids=None,
                                    use_neox_rotary_style=True, name=None):
    """Rope on each of q, k, v given (``[B, S, H, D]``), in fp32 and back
    to the input's type: the halves rotated (neox style) or interleaved
    pairs. ``sin`` / ``cos`` (``[..., S_max, D/2]``) default to the
    ``10000^(-2i/D)`` frequencies at positions 0.. or ``position_ids``
    (``[S]`` or ``[B, S]``), whose rows of a given table are gathered."""
    outs = []
    for t in (q, k, v):
        if t is None:
            outs.append(None)
            continue
        B, S, H, D = t.shape
        dev = t.device
        pos = None if position_ids is None else torch.as_tensor(
            position_ids, device=dev).long()
        if sin is None or cos is None:
            inv = 1.0 / (10000.0 ** (torch.arange(
                0, D, 2, dtype=torch.float32, device=dev) / D))
            p = (torch.arange(S, dtype=torch.float32, device=dev)
                 if pos is None else pos.float())
            ang = p[..., None] * inv                     # [(B,) S, D/2]
            s_, c_ = torch.sin(ang), torch.cos(ang)
        else:
            s_ = _table(sin, dev).reshape(-1, sin.shape[-1])
            c_ = _table(cos, dev).reshape(-1, cos.shape[-1])
            if pos is not None:
                s_, c_ = s_[pos], c_[pos]
        if s_.dim() == 2:
            s_, c_ = s_[None], c_[None]
        s_, c_ = s_[:, :, None, :], c_[:, :, None, :]
        tf = t.float()
        if use_neox_rotary_style:
            x1, x2 = tf[..., : D // 2], tf[..., D // 2:]
            out = torch.cat([x1 * c_ - x2 * s_, x2 * c_ + x1 * s_], dim=-1)
        else:
            x1, x2 = tf[..., 0::2], tf[..., 1::2]
            out = torch.stack([x1 * c_ - x2 * s_, x2 * c_ + x1 * s_],
                              dim=-1).reshape(B, S, H, D)
        outs.append(out.to(t.dtype))
    return tuple(outs)


def fused_feedforward(x, linear1_weight, linear2_weight, linear1_bias=None,
                      linear2_bias=None, ln1_scale=None, ln1_bias=None,
                      ln2_scale=None, ln2_bias=None, dropout1_rate=0.5,
                      dropout2_rate=0.5, activation="relu",
                      ln1_epsilon=1e-5, ln2_epsilon=1e-5,
                      pre_layer_norm=False, training=True,
                      mode="upscale_in_train", name=None):
    """The transformer FFN block: (pre-LN) linear, activation, dropout,
    linear, dropout, residual, (post-LN)."""
    residual = x
    if pre_layer_norm and ln1_scale is not None:
        x = F.layer_norm(x, list(x.shape[-1:]), weight=ln1_scale,
                         bias=ln1_bias, epsilon=ln1_epsilon)
    y = getattr(F, activation)(F.linear(x, linear1_weight, linear1_bias))
    y = F.dropout(y, p=dropout1_rate, training=training, mode=mode)
    y = F.linear(y, linear2_weight, linear2_bias)
    y = F.dropout(y, p=dropout2_rate, training=training, mode=mode)
    out = residual + y
    if not pre_layer_norm and ln2_scale is not None:
        out = F.layer_norm(out, list(out.shape[-1:]), weight=ln2_scale,
                           bias=ln2_bias, epsilon=ln2_epsilon)
    return out


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, fixed_seed_offset=None, rng_name="",
                    training=True, name=None):
    """``(out, None)``: ``[B, S, H, D]`` attention straight through
    ``dot_product_attention`` (the flash kernels on a card), as the JAX
    package's entry does; ``dropout`` and ``return_softmax`` are not
    applied there either."""
    q, k, v = cast_inputs("flash_attention", query, key, value)
    return _fa.dot_product_attention(q, k, v, is_causal=causal), None


def fused_multi_head_attention(x, qkv_weight, linear_weight,
                               pre_layer_norm=False, pre_ln_scale=None,
                               pre_ln_bias=None, ln_scale=None, ln_bias=None,
                               pre_ln_epsilon=1e-5, qkv_bias=None,
                               linear_bias=None, cache_kv=None,
                               attn_mask=None, dropout_rate=0.0,
                               attn_dropout_rate=0.0, ln_epsilon=1e-5,
                               training=True, mode="upscale_in_train",
                               ring_id=-1, add_residual=True, num_heads=None,
                               name=None):
    """The reference's ``fused_attention``: (pre-LN), the qkv projection
    with ``qkv_weight`` in its ``[3, num_heads, head_dim, H]`` layout,
    attention through ``scaled_dot_product_attention`` (a mask is
    broadcast to 4 axes), the output projection, dropout, the residual,
    (post-LN)."""
    residual = x
    if pre_layer_norm and pre_ln_scale is not None:
        x = F.layer_norm(x, list(x.shape[-1:]), weight=pre_ln_scale,
                         bias=pre_ln_bias, epsilon=pre_ln_epsilon)
    B, S, H = x.shape
    n_heads, head_dim = qkv_weight.shape[1], qkv_weight.shape[2]
    mask = attn_mask
    if mask is not None:
        while mask.dim() < 4:
            mask = mask[None]
    xa, wa, ba = cast_inputs("fused_attention_qkv", x, qkv_weight, qkv_bias)
    qkv = xa @ wa.reshape(3 * n_heads * head_dim, H).t()
    if ba is not None:
        qkv = qkv + ba.reshape(-1)
    qkv = qkv.reshape(B, S, 3, n_heads, head_dim)
    o = F.scaled_dot_product_attention(
        qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], attn_mask=mask,
        dropout_p=attn_dropout_rate, training=training)
    o = F.linear(o.reshape(B, S, n_heads * head_dim), linear_weight,
                 linear_bias)
    o = F.dropout(o, p=dropout_rate, training=training, mode=mode)
    out = o + residual if add_residual else o
    if not pre_layer_norm and ln_scale is not None:
        out = F.layer_norm(out, list(out.shape[-1:]), weight=ln_scale,
                           bias=ln_bias, epsilon=ln_epsilon)
    return out


def swiglu(x, y=None, name=None):
    """``silu(x) * y``; with ``y=None`` x splits into halves on its last
    axis."""
    if y is None:
        if x.shape[-1] % 2:
            raise ValueError(
                f"swiglu with y=None needs an even last dim to split, got "
                f"{x.shape[-1]}")
        d = x.shape[-1] // 2
        x, y = x[..., :d], x[..., d:]
    return F.silu(x) * y
