"""Common layers (reference: python/paddle/nn/layer/common.py): port of
`paddle_tpu/nn/layer/common.py`. `Linear` keeps paddle's weight layout,
[in, out], and its `state_dict` names (`weight`, `bias`).
"""
from __future__ import annotations

import torch

from ...ops.dispatch import OPS as _C_ops
from .. import functional as F
from ..param_attr import ParamAttr
from .layers import Layer


class Linear(Layer):
    """Reference: python/paddle/nn/layer/common.py Linear — weight [in, out]."""

    def __init__(self, in_features, out_features, weight_attr=None, bias_attr=None, name=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        from .. import initializer as I

        self.weight = self.create_parameter(
            [in_features, out_features], ParamAttr._to_attr(weight_attr), self._dtype
        )
        if bias_attr is not False:
            self.bias = self.create_parameter(
                [out_features], ParamAttr._to_attr(bias_attr), self._dtype, is_bias=True
            )
        else:
            self.bias = None

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return f"in_features={self.in_features}, out_features={self.out_features}"


class Embedding(Layer):
    """Reference: python/paddle/nn/layer/common.py Embedding."""

    def __init__(
        self, num_embeddings, embedding_dim, padding_idx=None, sparse=False, weight_attr=None, name=None
    ):
        super().__init__()
        self._num_embeddings = num_embeddings
        self._embedding_dim = embedding_dim
        self._padding_idx = (
            None if padding_idx is None else (padding_idx if padding_idx >= 0 else num_embeddings + padding_idx)
        )
        from .. import initializer as I

        attr = ParamAttr._to_attr(weight_attr)
        self.weight = self.create_parameter(
            [num_embeddings, embedding_dim], attr, self._dtype, default_initializer=I.Normal(0.0, 1.0) if attr is None else None
        )
        if self._padding_idx is not None:
            with torch.no_grad():
                self.weight._data[self._padding_idx] = 0.0

    def forward(self, x):
        return F.embedding(x, self.weight, self._padding_idx, False)

    def extra_repr(self):
        return f"{self._num_embeddings}, {self._embedding_dim}"


class Dropout(Layer):
    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None):
        super().__init__()
        self.p = p
        self.axis = axis
        self.mode = mode

    def forward(self, x):
        return F.dropout(x, self.p, self.axis, self.training, self.mode)

    def extra_repr(self):
        return f"p={self.p}"


class Dropout2D(Layer):
    def __init__(self, p=0.5, data_format="NCHW", name=None):
        super().__init__()
        self.p = p
        self.data_format = data_format

    def forward(self, x):
        return F.dropout2d(x, self.p, self.training, self.data_format)


class Flatten(Layer):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis = start_axis
        self.stop_axis = stop_axis

    def forward(self, x):
        return _C_ops["flatten"](x, self.start_axis, self.stop_axis)


class Identity(Layer):
    def __init__(self, *args, **kwargs):
        super().__init__()

    def forward(self, x):
        return x


class Upsample(Layer):
    def __init__(
        self, size=None, scale_factor=None, mode="nearest", align_corners=False, data_format="NCHW", name=None
    ):
        super().__init__()
        self.size = size
        self.scale_factor = scale_factor
        self.mode = mode
        self.align_corners = align_corners
        self.data_format = data_format

    def forward(self, x):
        return F.interpolate(x, self.size, self.scale_factor, self.mode, self.align_corners, self.data_format)


class Pad2D(Layer):
    def __init__(self, padding, mode="constant", value=0.0, data_format="NCHW", name=None):
        super().__init__()
        self.padding = padding if isinstance(padding, (list, tuple)) else [padding] * 4
        self.mode = mode
        self.value = value
        self.data_format = data_format

    def forward(self, x):
        return _C_ops["pad"](x, list(self.padding), self.mode, self.value, self.data_format)


class ZeroPad2D(Pad2D):
    def __init__(self, padding, data_format="NCHW", name=None):
        super().__init__(padding, "constant", 0.0, data_format, name)


class CosineSimilarity(Layer):
    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self.axis = axis
        self.eps = eps

    def forward(self, x1, x2):
        return F.cosine_similarity(x1, x2, self.axis, self.eps)
