"""``incubate.nn``'s fused layers: parameter-owning wrappers over the
fused functional entry points, with the reference's packed layouts (the
qkv weight ``[3, num_heads, head_dim, embed_dim]``). Counterpart of
``paddle_tpu/incubate/nn/layers.py``, with its parameter names and
state-dict keys."""

from __future__ import annotations

from ...nn import initializer as I
from ...nn.layer.layers import Layer
from . import functional as F

__all__ = ["FusedLinear", "FusedFeedForward", "FusedMultiHeadAttention",
           "FusedTransformerEncoderLayer"]


class FusedLinear(Layer):
    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, transpose_weight=False, name=None):
        super().__init__()
        self._transpose_weight = transpose_weight
        shape = ([out_features, in_features] if transpose_weight
                 else [in_features, out_features])
        self.weight = self.create_parameter(
            shape, attr=weight_attr, default_initializer=I.XavierUniform())
        self.bias = self.create_parameter([out_features], attr=bias_attr,
                                          is_bias=True)

    def forward(self, x):
        return F.fused_linear(x, self.weight, self.bias,
                              transpose_weight=self._transpose_weight)


class FusedFeedForward(Layer):
    def __init__(self, d_model, dim_feedforward, dropout_rate=0.1,
                 epsilon=1e-5, activation="relu", act_dropout_rate=None,
                 normalize_before=False, linear1_weight_attr=None,
                 linear1_bias_attr=None, linear2_weight_attr=None,
                 linear2_bias_attr=None, ln1_scale_attr=None,
                 ln1_bias_attr=None, ln2_scale_attr=None, ln2_bias_attr=None,
                 name=None):
        super().__init__()
        self._dropout_rate = dropout_rate
        self._act_dropout_rate = (dropout_rate if act_dropout_rate is None
                                  else act_dropout_rate)
        self._activation = activation
        self._epsilon = epsilon
        self._normalize_before = normalize_before
        self.linear1_weight = self.create_parameter(
            [d_model, dim_feedforward], attr=linear1_weight_attr,
            default_initializer=I.XavierUniform())
        self.linear1_bias = self.create_parameter(
            [dim_feedforward], attr=linear1_bias_attr, is_bias=True)
        self.linear2_weight = self.create_parameter(
            [dim_feedforward, d_model], attr=linear2_weight_attr,
            default_initializer=I.XavierUniform())
        self.linear2_bias = self.create_parameter(
            [d_model], attr=linear2_bias_attr, is_bias=True)
        one = I.Constant(1.0)
        self.ln1_scale = self.create_parameter(
            [d_model], attr=ln1_scale_attr, default_initializer=one)
        self.ln1_bias = self.create_parameter([d_model], attr=ln1_bias_attr,
                                              is_bias=True)
        self.ln2_scale = self.create_parameter(
            [d_model], attr=ln2_scale_attr, default_initializer=one)
        self.ln2_bias = self.create_parameter([d_model], attr=ln2_bias_attr,
                                              is_bias=True)

    def forward(self, src):
        return F.fused_feedforward(
            src, self.linear1_weight, self.linear2_weight,
            self.linear1_bias, self.linear2_bias,
            ln1_scale=self.ln1_scale, ln1_bias=self.ln1_bias,
            ln2_scale=self.ln2_scale, ln2_bias=self.ln2_bias,
            dropout1_rate=self._act_dropout_rate,
            dropout2_rate=self._dropout_rate,
            activation=self._activation, ln1_epsilon=self._epsilon,
            ln2_epsilon=self._epsilon,
            pre_layer_norm=self._normalize_before, training=self.training)


class FusedMultiHeadAttention(Layer):
    """Self-attention block with the packed qkv layout
    ``[3, num_heads, head_dim, embed_dim]``."""

    def __init__(self, embed_dim, num_heads, dropout_rate=0.5,
                 attn_dropout_rate=0.5, kdim=None, vdim=None,
                 normalize_before=False, need_weights=False,
                 qkv_weight_attr=None, qkv_bias_attr=None,
                 linear_weight_attr=None, linear_bias_attr=None,
                 pre_ln_scale_attr=None, pre_ln_bias_attr=None,
                 ln_scale_attr=None, ln_bias_attr=None, epsilon=1e-5,
                 nranks=1, ring_id=-1, name=None):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(
                f"num_heads ({num_heads}) must divide embed_dim "
                f"({embed_dim})")
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self._dropout_rate = dropout_rate
        self._attn_dropout_rate = attn_dropout_rate
        self._normalize_before = normalize_before
        self._epsilon = epsilon
        self.qkv_weight = self.create_parameter(
            [3, num_heads, self.head_dim, embed_dim], attr=qkv_weight_attr,
            default_initializer=I.XavierUniform())
        self.qkv_bias = self.create_parameter(
            [3, num_heads, self.head_dim], attr=qkv_bias_attr, is_bias=True)
        self.linear_weight = self.create_parameter(
            [embed_dim, embed_dim], attr=linear_weight_attr,
            default_initializer=I.XavierUniform())
        self.linear_bias = self.create_parameter(
            [embed_dim], attr=linear_bias_attr, is_bias=True)
        one = I.Constant(1.0)
        self.pre_ln_scale = self.create_parameter(
            [embed_dim], attr=pre_ln_scale_attr, default_initializer=one)
        self.pre_ln_bias = self.create_parameter(
            [embed_dim], attr=pre_ln_bias_attr, is_bias=True)
        self.ln_scale = self.create_parameter(
            [embed_dim], attr=ln_scale_attr, default_initializer=one)
        self.ln_bias = self.create_parameter([embed_dim], attr=ln_bias_attr,
                                             is_bias=True)

    def forward(self, x, attn_mask=None, cache=None):
        return F.fused_multi_head_attention(
            x, self.qkv_weight, self.linear_weight,
            pre_layer_norm=self._normalize_before,
            pre_ln_scale=self.pre_ln_scale, pre_ln_bias=self.pre_ln_bias,
            ln_scale=self.ln_scale, ln_bias=self.ln_bias,
            pre_ln_epsilon=self._epsilon, qkv_bias=self.qkv_bias,
            linear_bias=self.linear_bias, attn_mask=attn_mask,
            dropout_rate=self._dropout_rate,
            attn_dropout_rate=self._attn_dropout_rate,
            ln_epsilon=self._epsilon, training=self.training,
            num_heads=self.num_heads)


class FusedTransformerEncoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout_rate=0.1,
                 activation="relu", attn_dropout_rate=None,
                 act_dropout_rate=None, normalize_before=False,
                 weight_attr=None, bias_attr=None, name=None):
        super().__init__()
        self.fused_attn = FusedMultiHeadAttention(
            d_model, nhead, dropout_rate=dropout_rate,
            attn_dropout_rate=(dropout_rate if attn_dropout_rate is None
                               else attn_dropout_rate),
            normalize_before=normalize_before)
        self.ffn = FusedFeedForward(
            d_model, dim_feedforward, dropout_rate=dropout_rate,
            activation=activation, act_dropout_rate=act_dropout_rate,
            normalize_before=normalize_before)

    def forward(self, src, src_mask=None, cache=None):
        return self.ffn(self.fused_attn(src, attn_mask=src_mask))
