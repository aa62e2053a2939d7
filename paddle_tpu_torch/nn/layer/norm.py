"""Normalization layers: port of `paddle_tpu/nn/layer/norm.py`.

BatchNorm keeps its running statistics as non-trainable buffers and, in
training, updates them from the batch statistics that
`_C_ops.batch_norm_train` returns, `running * momentum + batch * (1 -
momentum)` under no_grad, as the reference does; eval reads them through
`batch_norm_infer`. `SyncBatchNorm` runs at world size 1, where the batch
is the whole batch and the local statistics are the global ones.
"""
from __future__ import annotations

import numpy as np
import torch

from ...core.tensor import Tensor
from ...ops.dispatch import OPS as _C_ops
from .. import functional as F
from .. import initializer as I
from ..param_attr import ParamAttr
from .layers import Layer

__all__ = ["BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D",
           "SyncBatchNorm", "LayerNorm", "RMSNorm", "GroupNorm",
           "InstanceNorm1D", "InstanceNorm2D", "InstanceNorm3D",
           "LocalResponseNorm"]


def _affine_params(layer, shape, weight_attr, bias_attr):
    w = (layer.create_parameter(shape, ParamAttr._to_attr(weight_attr),
                                layer._dtype,
                                default_initializer=I.Constant(1.0))
         if weight_attr is not False else None)
    b = (layer.create_parameter(shape, ParamAttr._to_attr(bias_attr),
                                layer._dtype, is_bias=True)
         if bias_attr is not False else None)
    return w, b


class _BatchNormBase(Layer):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None):
        super().__init__()
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        self.weight, self.bias = _affine_params(
            self, [num_features], weight_attr, bias_attr)
        self.register_buffer("_mean",
                             Tensor(np.zeros([num_features], np.float32)))
        self.register_buffer("_variance",
                             Tensor(np.ones([num_features], np.float32)))

    def forward(self, x):
        if self.training and not self._use_global_stats:
            out, batch_mean, batch_var = _C_ops["batch_norm_train"](
                x, self.weight, self.bias, self._epsilon, self._data_format)
            m = self._momentum
            with torch.no_grad():
                self._mean._data = (self._mean._data * m
                                    + batch_mean._data * (1 - m))
                self._variance._data = (self._variance._data * m
                                        + batch_var._data * (1 - m))
            return out
        return _C_ops["batch_norm_infer"](
            x, self._mean, self._variance, self.weight, self.bias,
            self._epsilon, self._data_format)

    def extra_repr(self):
        return (f"num_features={self._num_features}, "
                f"momentum={self._momentum}, epsilon={self._epsilon}")


class BatchNorm(_BatchNormBase):
    pass


class BatchNorm1D(_BatchNormBase):
    pass


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    pass


class SyncBatchNorm(_BatchNormBase):
    """Cross-replica BatchNorm, at world size 1: the local statistics."""

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        for name, sub in list(layer._sub_layers.items()):
            if isinstance(sub, _BatchNormBase) and not isinstance(
                    sub, SyncBatchNorm):
                new = SyncBatchNorm(sub._num_features, sub._momentum,
                                    sub._epsilon,
                                    data_format=sub._data_format)
                if sub.weight is not None:
                    new.weight.set_value(sub.weight)
                if sub.bias is not None:
                    new.bias.set_value(sub.bias)
                new._mean.set_value(sub._mean)
                new._variance.set_value(sub._variance)
                layer._sub_layers[name] = new
            else:
                cls.convert_sync_batchnorm(sub)
        return layer


class LayerNorm(Layer):
    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        self.weight, self.bias = _affine_params(
            self, self._normalized_shape, weight_attr, bias_attr)

    def forward(self, x):
        begin = x.ndim - len(self._normalized_shape)
        return F.layer_norm(x, self.weight, self.bias, self._epsilon, begin)

    def extra_repr(self):
        return (f"normalized_shape={self._normalized_shape}, "
                f"epsilon={self._epsilon}")


class RMSNorm(Layer):
    def __init__(self, normalized_shape, epsilon=1e-6, weight_attr=None,
                 name=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._epsilon = epsilon
        self.weight = self.create_parameter(
            list(normalized_shape), ParamAttr._to_attr(weight_attr),
            self._dtype, default_initializer=I.Constant(1.0))

    def forward(self, x):
        return F.rms_norm(x, self.weight, None, self._epsilon)


class GroupNorm(Layer):
    def __init__(self, num_groups, num_channels, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self._num_groups = num_groups
        self._epsilon = epsilon
        self._data_format = data_format
        self.weight, self.bias = _affine_params(
            self, [num_channels], weight_attr, bias_attr)

    def forward(self, x):
        return F.group_norm(x, self.weight, self.bias, self._epsilon,
                            self._num_groups, self._data_format)


class InstanceNorm2D(Layer):
    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self._epsilon = epsilon
        self.scale, self.bias = _affine_params(
            self, [num_features], weight_attr, bias_attr)

    def forward(self, x):
        return F.instance_norm(x, self.scale, self.bias, self._epsilon)


InstanceNorm1D = InstanceNorm2D
InstanceNorm3D = InstanceNorm2D


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.size, self.alpha, self.beta, self.k = size, alpha, beta, k
        self.data_format = data_format

    def forward(self, x):
        return F.local_response_norm(x, self.size, self.alpha, self.beta,
                                     self.k, self.data_format)
