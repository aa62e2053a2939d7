"""Weight initializers: port of `paddle_tpu/nn/initializer/__init__.py`.

Each initializer maps (shape, dtype) to a torch tensor on the current
place (`core/place.py`), drawing from `core/rng.py`'s generator of that
device. Fans and gains are the reference's; the draws differ (jax
threefry against torch Philox), which is why models that must start
alike load the reference's weights instead (`Layer.set_state_dict`
takes numpy arrays).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ...core import dtype as dtype_mod, rng
from ...core.place import torch_device


def _fans(shape):
    shape = list(shape)
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = int(np.prod(shape[2:]))
    # conv weight [out_c, in_c, *k] (paddle layout)
    return shape[1] * receptive, shape[0] * receptive


def _gain(nonlinearity, negative_slope):
    if nonlinearity in ("relu", "leaky_relu"):
        return math.sqrt(2.0 / (1 + negative_slope ** 2))
    return 1.0


def _normal(shape, dtype):
    dev = torch_device()
    return torch.randn(list(shape), generator=rng.next_generator(dev),
                       dtype=dtype_mod.to_torch(dtype), device=dev)


def _uniform(shape, dtype, low, high):
    dev = torch_device()
    u = torch.rand(list(shape), generator=rng.next_generator(dev),
                   dtype=dtype_mod.to_torch(dtype), device=dev)
    return low + (high - low) * u


class Initializer:
    def __call__(self, shape, dtype="float32"):
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, shape, dtype="float32"):
        return torch.full(list(shape), self.value,
                          dtype=dtype_mod.to_torch(dtype),
                          device=torch_device())


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype="float32"):
        return self.mean + self.std * _normal(shape, dtype)


class TruncatedNormal(Initializer):
    def __init__(self, mean=0.0, std=1.0, a=-2.0, b=2.0):
        self.mean, self.std, self.a, self.b = mean, std, a, b

    def __call__(self, shape, dtype="float32"):
        z = torch.empty(list(shape), dtype=dtype_mod.to_torch(dtype),
                        device=torch_device())
        dev = z.device
        torch.nn.init.trunc_normal_(z, 0.0, 1.0, self.a, self.b,
                                    generator=rng.next_generator(dev))
        return self.mean + self.std * z


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def __call__(self, shape, dtype="float32"):
        return _uniform(shape, dtype, self.low, self.high)


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype="float32"):
        fi, fo = _fans(shape)
        std = self.gain * math.sqrt(2.0 / ((self.fan_in or fi)
                                           + (self.fan_out or fo)))
        return std * _normal(shape, dtype)


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype="float32"):
        fi, fo = _fans(shape)
        limit = self.gain * math.sqrt(6.0 / ((self.fan_in or fi)
                                             + (self.fan_out or fo)))
        return _uniform(shape, dtype, -limit, limit)


class KaimingNormal(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in, self.negative_slope, self.nonlinearity = \
            fan_in, negative_slope, nonlinearity

    def __call__(self, shape, dtype="float32"):
        fi = self.fan_in or _fans(shape)[0]
        std = _gain(self.nonlinearity, self.negative_slope) / math.sqrt(fi)
        return std * _normal(shape, dtype)


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in, self.negative_slope, self.nonlinearity = \
            fan_in, negative_slope, nonlinearity

    def __call__(self, shape, dtype="float32"):
        fi = self.fan_in or _fans(shape)[0]
        limit = _gain(self.nonlinearity, self.negative_slope) \
            * math.sqrt(3.0 / fi)
        return _uniform(shape, dtype, -limit, limit)


class Assign(Initializer):
    def __init__(self, value):
        self.value = value

    def __call__(self, shape, dtype="float32"):
        v = self.value
        v = v._data if hasattr(v, "_data") else v
        t = torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor)
                            else v).to(dtype_mod.to_torch(dtype))
        if list(t.shape) != list(shape):
            t = t.reshape(list(shape))
        return t.to(torch_device())


class Orthogonal(Initializer):
    def __init__(self, gain=1.0):
        self.gain = gain

    def __call__(self, shape, dtype="float32"):
        z = torch.empty(list(shape), dtype=dtype_mod.to_torch(dtype),
                        device=torch_device())
        return torch.nn.init.orthogonal_(
            z, self.gain, generator=rng.next_generator(z.device))


class Dirac(Initializer):
    def __init__(self, groups=1):
        self.groups = groups

    def __call__(self, shape, dtype="float32"):
        arr = torch.zeros(list(shape), dtype=dtype_mod.to_torch(dtype))
        oc, ic = shape[0], shape[1]
        k_center = [s // 2 for s in shape[2:]]
        for i in range(min(oc, ic * self.groups)):
            arr[(i, i % ic, *k_center)] = 1.0
        return arr.to(torch_device())


constant = Constant
normal = Normal
uniform = Uniform
xavier_normal = XavierNormal
xavier_uniform = XavierUniform
kaiming_normal = KaimingNormal
kaiming_uniform = KaimingUniform


def calculate_gain(nonlinearity, param=None):
    mapping = {
        "sigmoid": 1.0, "linear": 1.0, "conv1d": 1.0, "conv2d": 1.0,
        "conv3d": 1.0, "tanh": 5.0 / 3.0, "relu": math.sqrt(2.0),
        "leaky_relu": math.sqrt(
            2.0 / (1 + (param if param is not None else 0.01) ** 2)),
        "selu": 3.0 / 4.0,
    }
    return mapping[nonlinearity]
