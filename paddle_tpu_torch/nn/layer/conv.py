"""Convolution layers (reference: python/paddle/nn/layer/conv.py).

A copy of `paddle_tpu/nn/layer/conv.py` (jax-free).
"""
from __future__ import annotations

import numpy as np

from .. import functional as F
from .. import initializer as I
from ..param_attr import ParamAttr
from .layers import Layer


def _ntuple(v, n):
    return list(v) if isinstance(v, (list, tuple)) else [v] * n


class _ConvNd(Layer):
    def __init__(
        self,
        in_channels,
        out_channels,
        kernel_size,
        nd,
        stride=1,
        padding=0,
        dilation=1,
        groups=1,
        padding_mode="zeros",
        weight_attr=None,
        bias_attr=None,
        data_format="NCHW",
    ):
        super().__init__()
        self._in_channels = in_channels
        self._out_channels = out_channels
        self._kernel_size = _ntuple(kernel_size, nd)
        self._stride = _ntuple(stride, nd)
        self._padding = padding
        self._dilation = _ntuple(dilation, nd)
        self._groups = groups
        self._data_format = data_format
        self._nd = nd
        filter_shape = [out_channels, in_channels // groups] + self._kernel_size
        fan_in = (in_channels // groups) * int(np.prod(self._kernel_size))
        bound = 1.0 / np.sqrt(fan_in)
        self.weight = self.create_parameter(
            filter_shape,
            ParamAttr._to_attr(weight_attr),
            self._dtype,
            default_initializer=I.KaimingUniform(nonlinearity="leaky_relu", negative_slope=np.sqrt(5.0)),
        )
        if bias_attr is not False:
            self.bias = self.create_parameter(
                [out_channels],
                ParamAttr._to_attr(bias_attr),
                self._dtype,
                is_bias=True,
                default_initializer=I.Uniform(-bound, bound) if bias_attr is None else None,
            )
        else:
            self.bias = None

    def extra_repr(self):
        return (
            f"{self._in_channels}, {self._out_channels}, kernel_size={self._kernel_size}, "
            f"stride={self._stride}, padding={self._padding}"
        )


class Conv1D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0, dilation=1,
                 groups=1, padding_mode="zeros", weight_attr=None, bias_attr=None, data_format="NCL"):
        super().__init__(in_channels, out_channels, kernel_size, 1, stride, padding, dilation,
                         groups, padding_mode, weight_attr, bias_attr, data_format)

    def forward(self, x):
        return F.conv1d(x, self.weight, self.bias, self._stride, self._padding, self._dilation,
                        self._groups, self._data_format)


class Conv2D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0, dilation=1,
                 groups=1, padding_mode="zeros", weight_attr=None, bias_attr=None, data_format="NCHW"):
        super().__init__(in_channels, out_channels, kernel_size, 2, stride, padding, dilation,
                         groups, padding_mode, weight_attr, bias_attr, data_format)

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self._stride, self._padding, self._dilation,
                        self._groups, self._data_format)


class Conv3D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0, dilation=1,
                 groups=1, padding_mode="zeros", weight_attr=None, bias_attr=None, data_format="NCDHW"):
        super().__init__(in_channels, out_channels, kernel_size, 3, stride, padding, dilation,
                         groups, padding_mode, weight_attr, bias_attr, data_format)

    def forward(self, x):
        return F.conv3d(x, self.weight, self.bias, self._stride, self._padding, self._dilation,
                        self._groups, self._data_format)


class Conv2DTranspose(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0, output_padding=0,
                 dilation=1, groups=1, weight_attr=None, bias_attr=None, data_format="NCHW"):
        super().__init__()
        self._stride = _ntuple(stride, 2)
        self._padding = padding
        self._output_padding = output_padding
        self._dilation = _ntuple(dilation, 2)
        self._groups = groups
        self._data_format = data_format
        kernel_size = _ntuple(kernel_size, 2)
        filter_shape = [in_channels, out_channels // groups] + kernel_size
        self.weight = self.create_parameter(filter_shape, ParamAttr._to_attr(weight_attr), self._dtype)
        if bias_attr is not False:
            self.bias = self.create_parameter([out_channels], ParamAttr._to_attr(bias_attr), self._dtype, is_bias=True)
        else:
            self.bias = None

    def forward(self, x, output_size=None):
        output_padding = self._output_padding
        if output_size is not None:
            # derive output_padding so the result matches the requested size
            if isinstance(output_size, int):
                output_size = [output_size, output_size]
            spatial = x.shape[2:4] if self._data_format == "NCHW" else x.shape[1:3]
            k = self.weight.shape[2:4]
            p = _ntuple(self._padding, 2)
            output_padding = [
                output_size[i]
                - ((spatial[i] - 1) * self._stride[i] - 2 * p[i] + self._dilation[i] * (k[i] - 1) + 1)
                for i in range(2)
            ]
        return F.conv2d_transpose(x, self.weight, self.bias, self._stride, self._padding,
                                  output_padding, self._dilation, self._groups, self._data_format)
