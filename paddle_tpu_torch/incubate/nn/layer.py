"""incubate.nn fused layers: port of `paddle_tpu/incubate/nn/layer.py`
and of the fused Layer classes of `paddle_tpu/incubate/nn/__init__.py`.

Each layer holds its weights in the reference's layout and calls its
fused function (`incubate.nn.functional`) in forward.
"""
from __future__ import annotations

import numpy as np

from ...core.tensor import Parameter, Tensor
from ...nn.initializer import Constant
from ...nn.layer.layers import Layer
from . import functional as F

__all__ = ["FusedLinear", "FusedMultiHeadAttention", "FusedFeedForward",
           "FusedDropoutAdd", "FusedBiasDropoutResidualLayerNorm",
           "FusedMultiTransformer", "FusedTransformerEncoderLayer"]


def _ones(n):
    return Parameter.from_tensor(Tensor(np.ones(n, np.float32)))


def _zeros(n):
    return Parameter.from_tensor(Tensor(np.zeros(n, np.float32)))


class FusedLinear(Layer):
    def __init__(self, in_features: int, out_features: int, weight_attr=None,
                 bias_attr=None, transpose_weight: bool = False, name=None):
        super().__init__()
        self.transpose_weight = transpose_weight
        shape = ([out_features, in_features] if transpose_weight
                 else [in_features, out_features])
        self.weight = self.create_parameter(shape)
        self.bias = (self.create_parameter([out_features], is_bias=True)
                     if bias_attr is not False else None)

    def forward(self, x):
        return F.fused_linear(x, self.weight, self.bias,
                              self.transpose_weight)


class FusedMultiHeadAttention(Layer):
    """Packed QKV, attention, the out projection, the residual and LN in
    one `fused_attention` call."""

    def __init__(self, embed_dim: int, num_heads: int, dropout_rate=0.5,
                 attn_dropout_rate=0.5, kdim=None, vdim=None,
                 normalize_before=False, need_weights=False,
                 qkv_weight_attr=None, qkv_bias_attr=None,
                 linear_weight_attr=None, linear_bias_attr=None,
                 pre_ln_scale_attr=None, pre_ln_bias_attr=None,
                 ln_scale_attr=None, ln_bias_attr=None, epsilon=1e-5,
                 nranks=1, ring_id=-1, name=None):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError("embed_dim must be divisible by num_heads")
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.normalize_before = normalize_before
        self.dropout_rate = dropout_rate
        self.attn_dropout_rate = attn_dropout_rate
        self.epsilon = epsilon
        self.qkv_weight = self.create_parameter(
            [3, num_heads, self.head_dim, embed_dim])
        self.qkv_bias = self.create_parameter(
            [3, num_heads, self.head_dim], is_bias=True)
        self.linear_weight = self.create_parameter([embed_dim, embed_dim])
        self.linear_bias = self.create_parameter([embed_dim], is_bias=True)
        self.pre_ln_scale = _ones(embed_dim)
        self.pre_ln_bias = _zeros(embed_dim)
        self.ln_scale = _ones(embed_dim)
        self.ln_bias = _zeros(embed_dim)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        return F.fused_attention(
            query, self.qkv_weight, self.linear_weight,
            qkv_bias=self.qkv_bias, linear_bias=self.linear_bias,
            pre_ln_scale=self.pre_ln_scale, pre_ln_bias=self.pre_ln_bias,
            ln_scale=self.ln_scale, ln_bias=self.ln_bias,
            num_heads=self.num_heads, pre_layer_norm=self.normalize_before,
            epsilon=self.epsilon, attn_dropout_rate=self.attn_dropout_rate,
            dropout_rate=self.dropout_rate, attn_mask=attn_mask,
            training=self.training)


class FusedFeedForward(Layer):
    def __init__(self, d_model: int, dim_feedforward: int, dropout_rate=0.1,
                 epsilon=1e-5, activation="relu", act_dropout_rate=None,
                 normalize_before=False, linear1_weight_attr=None,
                 linear1_bias_attr=None, linear2_weight_attr=None,
                 linear2_bias_attr=None, ln1_scale_attr=None,
                 ln1_bias_attr=None, ln2_scale_attr=None, ln2_bias_attr=None,
                 nranks=1, ring_id=-1, name=None):
        super().__init__()
        self.normalize_before = normalize_before
        self.activation = activation
        self.dropout_rate = dropout_rate
        self.act_dropout_rate = (act_dropout_rate if act_dropout_rate
                                 is not None else dropout_rate)
        self.epsilon = epsilon
        self.linear1_weight = self.create_parameter([d_model,
                                                     dim_feedforward])
        self.linear1_bias = self.create_parameter([dim_feedforward],
                                                  is_bias=True)
        self.linear2_weight = self.create_parameter([dim_feedforward,
                                                     d_model])
        self.linear2_bias = self.create_parameter([d_model], is_bias=True)
        self.ln1_scale = _ones(d_model)
        self.ln1_bias = _zeros(d_model)
        self.ln2_scale = _ones(d_model)
        self.ln2_bias = _zeros(d_model)

    def forward(self, x):
        return F.fused_feedforward(
            x, self.linear1_weight, self.linear2_weight,
            linear1_bias=self.linear1_bias, linear2_bias=self.linear2_bias,
            ln1_scale=self.ln1_scale, ln1_bias=self.ln1_bias,
            ln2_scale=self.ln2_scale, ln2_bias=self.ln2_bias,
            dropout1_rate=self.act_dropout_rate,
            dropout2_rate=self.dropout_rate, activation=self.activation,
            ln1_epsilon=self.epsilon, ln2_epsilon=self.epsilon,
            pre_layer_norm=self.normalize_before, training=self.training)


class FusedDropoutAdd(Layer):
    """dropout(x) + y."""

    def __init__(self, p=0.5, mode="upscale_in_train", name=None):
        super().__init__()
        self.p = p
        self.mode = mode

    def forward(self, x, y):
        return F.fused_dropout_add(x, y, p=self.p, mode=self.mode,
                                   is_test=not self.training)


class FusedBiasDropoutResidualLayerNorm(Layer):
    """LN(dropout(x + bias) + residual)."""

    def __init__(self, embed_dim, dropout_rate=0.5, epsilon=1e-5,
                 name=None):
        super().__init__()
        self.ln_scale = self.create_parameter(
            [embed_dim], default_initializer=Constant(1.0))
        self.ln_bias = self.create_parameter([embed_dim], is_bias=True)
        self.linear_bias = self.create_parameter([embed_dim], is_bias=True)
        self.dropout_rate = dropout_rate
        self.epsilon = epsilon

    def forward(self, x, residual):
        return F.fused_bias_dropout_residual_layer_norm(
            x, residual, self.linear_bias, self.ln_scale, self.ln_bias,
            dropout_rate=self.dropout_rate, ln_epsilon=self.epsilon,
            training=self.training)


class FusedMultiTransformer(Layer):
    """Layer form of `fused_multi_transformer`; the weights are given per
    call, as the serving stack passes them."""

    def __init__(self, embed_dim, num_heads, dim_feedforward,
                 dropout_rate=0.0, num_layers=1, name=None, **kw):
        super().__init__()
        self.cfg = dict(embed_dim=embed_dim, num_heads=num_heads,
                        dim_feedforward=dim_feedforward,
                        num_layers=num_layers)

    def forward(self, x, *args, **kwargs):
        return F.fused_multi_transformer(x, *args, **kwargs)


class FusedTransformerEncoderLayer(Layer):
    """The encoder layer (`nn.TransformerEncoderLayer` inside)."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout_rate=0.1,
                 activation="relu", attn_dropout_rate=None,
                 act_dropout_rate=None, normalize_before=False, name=None):
        super().__init__()
        from ...nn import TransformerEncoderLayer

        self._inner = TransformerEncoderLayer(
            d_model, nhead, dim_feedforward, dropout=dropout_rate,
            activation=activation, attn_dropout=attn_dropout_rate,
            act_dropout=act_dropout_rate, normalize_before=normalize_before)

    def forward(self, src, src_mask=None):
        return self._inner(src, src_mask)
