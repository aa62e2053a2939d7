"""Activation layers (reference: python/paddle/nn/layer/activation.py).

A copy of `paddle_tpu/nn/layer/activation.py` (jax-free).
"""
from __future__ import annotations

from .. import functional as F
from ..param_attr import ParamAttr
from .layers import Layer


def _simple(fn_name, cls_name, **fixed):
    fn = getattr(F, fn_name)

    class _Act(Layer):
        def __init__(self, name=None, **kw):
            super().__init__()
            self._kw = {**fixed, **{k: v for k, v in kw.items() if k != "name"}}

        def forward(self, x):
            return fn(x, **self._kw)

    _Act.__name__ = cls_name
    _Act.__qualname__ = cls_name
    return _Act


ReLU = _simple("relu", "ReLU")
ReLU6 = _simple("relu6", "ReLU6")
Sigmoid = _simple("sigmoid", "Sigmoid")
Tanh = _simple("tanh", "Tanh")
GELU = _simple("gelu", "GELU")
Silu = _simple("silu", "Silu")
SiLU = Silu
Mish = _simple("mish", "Mish")
Swish = _simple("swish", "Swish")
Hardswish = _simple("hardswish", "Hardswish")
Hardsigmoid = _simple("hardsigmoid", "Hardsigmoid")
Softsign = _simple("softsign", "Softsign")
Tanhshrink = _simple("tanhshrink", "Tanhshrink")
LogSigmoid = _simple("log_sigmoid", "LogSigmoid")


class LeakyReLU(Layer):
    def __init__(self, negative_slope=0.01, name=None):
        super().__init__()
        self.negative_slope = negative_slope

    def forward(self, x):
        return F.leaky_relu(x, self.negative_slope)


class ELU(Layer):
    def __init__(self, alpha=1.0, name=None):
        super().__init__()
        self.alpha = alpha

    def forward(self, x):
        return F.elu(x, self.alpha)


class CELU(Layer):
    def __init__(self, alpha=1.0, name=None):
        super().__init__()
        self.alpha = alpha

    def forward(self, x):
        return F.celu(x, self.alpha)


class SELU(Layer):
    def __init__(self, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
        super().__init__()
        self.scale, self.alpha = scale, alpha

    def forward(self, x):
        return F.selu(x, self.scale, self.alpha)


class PReLU(Layer):
    def __init__(self, num_parameters=1, init=0.25, weight_attr=None, data_format="NCHW", name=None):
        super().__init__()
        from .. import initializer as I

        self._weight = self.create_parameter(
            [num_parameters], ParamAttr._to_attr(weight_attr), self._dtype,
            default_initializer=I.Constant(init),
        )
        self._data_format = data_format

    def forward(self, x):
        w = self._weight
        if w.size > 1 and x.ndim > 1:
            shape = [1] * x.ndim
            c_axis = 1 if self._data_format == "NCHW" else x.ndim - 1
            shape[c_axis] = w.size
            w = w.reshape(shape)
        return F.prelu(x, w)


class Softmax(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return F.softmax(x, self.axis)


class LogSoftmax(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return F.log_softmax(x, self.axis)


class Softplus(Layer):
    def __init__(self, beta=1.0, threshold=20.0, name=None):
        super().__init__()
        self.beta, self.threshold = beta, threshold

    def forward(self, x):
        return F.softplus(x, self.beta, self.threshold)


class Hardshrink(Layer):
    def __init__(self, threshold=0.5, name=None):
        super().__init__()
        self.threshold = threshold

    def forward(self, x):
        return F.hardshrink(x, self.threshold)


class Softshrink(Layer):
    def __init__(self, threshold=0.5, name=None):
        super().__init__()
        self.threshold = threshold

    def forward(self, x):
        return F.softshrink(x, self.threshold)


class Hardtanh(Layer):
    def __init__(self, min=-1.0, max=1.0, name=None):
        super().__init__()
        self.min, self.max = min, max

    def forward(self, x):
        return F.hardtanh(x, self.min, self.max)


class ThresholdedReLU(Layer):
    def __init__(self, threshold=1.0, value=0.0, name=None):
        super().__init__()
        self.threshold, self.value = threshold, value

    def forward(self, x):
        return F.thresholded_relu(x, self.threshold, self.value)


class Maxout(Layer):
    def __init__(self, groups, axis=1, name=None):
        super().__init__()
        self.groups, self.axis = groups, axis

    def forward(self, x):
        return F.maxout(x, self.groups, self.axis)


class GLU(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return F.glu(x, self.axis)
