"""``incubate.nn``: the fused functional entry points and the layers that
own their parameters (counterpart of ``paddle_tpu/incubate/nn``)."""

from . import functional
from .layers import (FusedFeedForward, FusedLinear, FusedMultiHeadAttention,
                     FusedTransformerEncoderLayer)


def memory_efficient_attention(query, key, value, attn_bias=None, p=0.0,
                               scale=None, training=True):
    """``[B, S, H, D]`` attention through
    ``nn.functional.scaled_dot_product_attention`` (the flash kernels
    without a bias or dropout); ``scale`` pre-scales q by ``scale *
    sqrt(D)`` so the default ``1 / sqrt(D)`` gives it."""
    from ...nn.functional import scaled_dot_product_attention

    q = query if scale is None else query * (
        float(scale) * float(query.shape[-1]) ** 0.5)
    return scaled_dot_product_attention(q, key, value, attn_mask=attn_bias,
                                        dropout_p=p, training=training)


__all__ = ["functional", "FusedLinear", "FusedFeedForward",
           "FusedMultiHeadAttention", "FusedTransformerEncoderLayer",
           "memory_efficient_attention"]
