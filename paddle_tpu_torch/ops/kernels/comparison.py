"""Comparison, logical and bitwise kernels: port of
`paddle_tpu/ops/kernels/comparison.py`."""
from __future__ import annotations

import torch

from ..dispatch import register_op
from ._util import tensors


def _binary(fn):
    def op(x, y):
        x, y = tensors(x, y)
        return fn(x, y)
    return op


@register_op(nondiff=True)
def equal(x, y):
    return _binary(torch.eq)(x, y)


@register_op(nondiff=True)
def not_equal(x, y):
    return _binary(torch.ne)(x, y)


@register_op(nondiff=True)
def less_than(x, y):
    return _binary(torch.lt)(x, y)


@register_op(nondiff=True)
def less_equal(x, y):
    return _binary(torch.le)(x, y)


@register_op(nondiff=True)
def greater_than(x, y):
    return _binary(torch.gt)(x, y)


@register_op(nondiff=True)
def greater_equal(x, y):
    return _binary(torch.ge)(x, y)


@register_op(nondiff=True)
def logical_and(x, y):
    return _binary(torch.logical_and)(x, y)


@register_op(nondiff=True)
def logical_or(x, y):
    return _binary(torch.logical_or)(x, y)


@register_op(nondiff=True)
def logical_xor(x, y):
    return _binary(torch.logical_xor)(x, y)


@register_op(nondiff=True)
def logical_not(x):
    return torch.logical_not(x)


@register_op(nondiff=True)
def bitwise_and(x, y):
    return _binary(torch.bitwise_and)(x, y)


@register_op(nondiff=True)
def bitwise_or(x, y):
    return _binary(torch.bitwise_or)(x, y)


@register_op(nondiff=True)
def bitwise_xor(x, y):
    return _binary(torch.bitwise_xor)(x, y)


@register_op(nondiff=True)
def bitwise_not(x):
    return torch.bitwise_not(x)


@register_op(nondiff=True)
def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False):
    x, y = tensors(x, y)
    return torch.isclose(x, y, rtol=rtol, atol=atol, equal_nan=equal_nan)


@register_op(nondiff=True)
def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False):
    x, y = tensors(x, y)
    return torch.isclose(x, y, rtol=rtol, atol=atol,
                         equal_nan=equal_nan).all()


@register_op(nondiff=True)
def equal_all(x, y):
    x, y = tensors(x, y)
    return torch.tensor(x.shape == y.shape and bool(torch.equal(x, y)),
                        device=x.device)
