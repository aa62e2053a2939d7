"""Elementwise and scalar math kernels: port of
`paddle_tpu/ops/kernels/math.py`, one torch op each (on the card, the
library's elementwise kernels; the reference has no Pallas kernel
here)."""
from __future__ import annotations

import builtins

import torch

from ..dispatch import register_op
from ._util import tensors

_S = torch.special


@register_op
def add(x, y):
    return x + y


@register_op
def subtract(x, y):
    return x - y


@register_op
def multiply(x, y):
    return x * y


@register_op
def divide(x, y):
    return x / y


@register_op
def floor_divide(x, y):
    x, y = tensors(x, y)
    return torch.floor_divide(x, y)


@register_op
def remainder(x, y):
    x, y = tensors(x, y)
    return torch.remainder(x, y)


mod = remainder


@register_op
def pow(x, y):
    return x ** y


@register_op
def elementwise_rpow(x, y):
    return y ** x


@register_op
def scale(x, scale=1.0, bias=0.0, bias_after_scale=True):
    if bias_after_scale:
        return x * scale + bias
    return (x + bias) * scale


@register_op
def abs(x):
    return torch.abs(x)


@register_op
def sqrt(x):
    return torch.sqrt(x)


@register_op
def rsqrt(x):
    return torch.rsqrt(x)


@register_op
def square(x):
    return torch.square(x)


@register_op
def reciprocal(x):
    return 1.0 / x


@register_op
def exp(x):
    return torch.exp(x)


@register_op
def expm1(x):
    return torch.expm1(x)


@register_op
def log(x):
    return torch.log(x)


@register_op
def log2(x):
    return torch.log2(x)


@register_op
def log10(x):
    return torch.log10(x)


@register_op
def log1p(x):
    return torch.log1p(x)


@register_op
def sin(x):
    return torch.sin(x)


@register_op
def cos(x):
    return torch.cos(x)


@register_op
def tan(x):
    return torch.tan(x)


@register_op
def asin(x):
    return torch.asin(x)


@register_op
def acos(x):
    return torch.acos(x)


@register_op
def atan(x):
    return torch.atan(x)


@register_op
def atan2(x, y):
    x, y = tensors(x, y)
    return torch.atan2(x, y)


@register_op
def sinh(x):
    return torch.sinh(x)


@register_op
def cosh(x):
    return torch.cosh(x)


@register_op
def tanh(x):
    return torch.tanh(x)


@register_op
def asinh(x):
    return torch.asinh(x)


@register_op
def acosh(x):
    return torch.acosh(x)


@register_op
def atanh(x):
    return torch.atanh(x)


@register_op
def floor(x):
    return torch.floor(x)


@register_op
def ceil(x):
    return torch.ceil(x)


@register_op
def round(x, decimals=0):
    return torch.round(x, decimals=decimals)


@register_op
def trunc(x):
    return torch.trunc(x)


@register_op
def frac(x):
    return x - torch.trunc(x)


@register_op
def sign(x):
    return torch.sign(x)


@register_op
def maximum(x, y):
    x, y = tensors(x, y)
    return torch.maximum(x, y)


@register_op
def minimum(x, y):
    x, y = tensors(x, y)
    return torch.minimum(x, y)


@register_op
def fmax(x, y):
    x, y = tensors(x, y)
    return torch.fmax(x, y)


@register_op
def fmin(x, y):
    x, y = tensors(x, y)
    return torch.fmin(x, y)


@register_op
def clip(x, min=None, max=None):
    if min is None and max is None:
        return x.clone()
    return torch.clamp(x, min, max)


@register_op(nondiff=True)
def isnan(x):
    return torch.isnan(x)


@register_op(nondiff=True)
def isinf(x):
    return torch.isinf(x)


@register_op(nondiff=True)
def isfinite(x):
    return torch.isfinite(x)


@register_op
def erf(x):
    return torch.erf(x)


@register_op
def erfinv(x):
    return torch.erfinv(x)


@register_op
def lgamma(x):
    return torch.lgamma(x)


@register_op
def digamma(x):
    return torch.digamma(x)


@register_op
def logit(x, eps=None):
    if eps is not None:
        x = torch.clamp(x, eps, 1.0 - eps)
    return torch.log(x / (1.0 - x))


@register_op
def logaddexp(x, y):
    x, y = tensors(x, y)
    return torch.logaddexp(x, y)


@register_op
def hypot(x, y):
    x, y = tensors(x, y)
    return torch.hypot(x, y)


def _flat(x, axis):
    return (x.reshape(-1), 0) if axis is None else (x, int(axis))


@register_op
def cumsum(x, axis=None):
    x, axis = _flat(x, axis)
    return torch.cumsum(x, axis)


@register_op
def cumprod(x, dim=None):
    x, dim = _flat(x, dim)
    return torch.cumprod(x, dim)


@register_op
def cummax(x, axis=None):
    x, axis = _flat(x, axis)
    return torch.cummax(x, axis).values


@register_op
def cummin(x, axis=None):
    x, axis = _flat(x, axis)
    return torch.cummin(x, axis).values


@register_op
def stanh(x, scale_a=0.67, scale_b=1.7159):
    return scale_b * torch.tanh(scale_a * x)


@register_op
def multiply_add(x, y, z):
    return x * y + z


@register_op
def nan_to_num(x, nan=0.0, posinf=None, neginf=None):
    return torch.nan_to_num(x, nan=nan, posinf=posinf, neginf=neginf)


@register_op
def lerp(x, y, weight):
    return x + weight * (y - x)


@register_op
def angle(x):
    return torch.angle(x)


@register_op
def conj(x):
    return torch.conj_physical(x)


@register_op
def real(x):
    return torch.real(x).clone() if x.is_complex() else x.clone()


@register_op
def imag(x):
    return torch.imag(x).clone() if x.is_complex() else torch.zeros_like(x)


@register_op
def deg2rad(x):
    return torch.deg2rad(x)


@register_op
def rad2deg(x):
    return torch.rad2deg(x)


@register_op
def gcd(x, y):
    x, y = tensors(x, y)
    return torch.gcd(x, y)


@register_op
def lcm(x, y):
    x, y = tensors(x, y)
    return torch.lcm(x, y)


@register_op
def heaviside(x, y):
    x, y = tensors(x, y)
    dt = torch.result_type(x, y)
    return torch.heaviside(x.to(dt), y.to(dt))


@register_op
def ldexp(x, y):
    x, y = tensors(x, y)
    return torch.ldexp(x, y)


@register_op
def sigmoid(x):
    return torch.sigmoid(x)


@register_op
def polygamma(x, n=1):
    return torch.polygamma(builtins.int(n), x)


@register_op
def i0(x):
    return _S.i0(x)


@register_op
def i0e(x):
    return _S.i0e(x)


@register_op
def i1(x):
    return _S.i1(x)


@register_op
def i1e(x):
    return _S.i1e(x)
