"""Tensor creation kernels: port of `paddle_tpu/ops/kernels/creation.py`.

Ops with no tensor input create on the current place (`core/place.py`);
`*_like` ops create beside their input.
"""
from __future__ import annotations

import builtins

import numpy as np
import torch

from ..dispatch import register_op
from ._util import device, td, tensors


def _shape(shape):
    if isinstance(shape, torch.Tensor):
        return [int(s) for s in shape.tolist()]
    if isinstance(shape, (int, np.integer)):
        return [int(shape)]
    return [int(s) for s in shape]


@register_op(nondiff=True)
def zeros(shape, dtype=None):
    return torch.zeros(_shape(shape), dtype=td(dtype), device=device())


@register_op(nondiff=True)
def ones(shape, dtype=None):
    return torch.ones(_shape(shape), dtype=td(dtype), device=device())


@register_op(nondiff=True)
def full(shape, fill_value, dtype=None):
    if dtype is None:
        if isinstance(fill_value, bool):
            dtype = "bool"
        elif isinstance(fill_value, int):
            dtype = "int64"
    if isinstance(fill_value, torch.Tensor):
        fill_value = fill_value.item()
    return torch.full(_shape(shape), fill_value, dtype=td(dtype),
                      device=device())


@register_op
def full_like(x, fill_value, dtype=None):
    return torch.full_like(x, fill_value,
                           dtype=td(dtype) if dtype else x.dtype)


@register_op
def zeros_like(x, dtype=None):
    return torch.zeros_like(x, dtype=td(dtype) if dtype else x.dtype)


@register_op
def ones_like(x, dtype=None):
    return torch.ones_like(x, dtype=td(dtype) if dtype else x.dtype)


@register_op(nondiff=True)
def arange(start=0, end=None, step=1, dtype=None):
    if end is None:
        start, end = 0, start
    if dtype is None and builtins.all(
            isinstance(v, (int, np.integer)) for v in (start, end, step)):
        dtype = "int64"
    return torch.arange(start, end, step, dtype=td(dtype), device=device())


@register_op(nondiff=True)
def linspace(start, stop, num, dtype=None):
    return torch.linspace(start, stop, int(num), dtype=td(dtype),
                          device=device())


@register_op(nondiff=True)
def logspace(start, stop, num, base=10.0, dtype=None):
    return torch.logspace(start, stop, int(num), base=base, dtype=td(dtype),
                          device=device())


@register_op(nondiff=True)
def eye(num_rows, num_columns=None, dtype=None):
    return torch.eye(num_rows, num_columns if num_columns is not None
                     else num_rows, dtype=td(dtype), device=device())


@register_op
def tril(x, diagonal=0):
    return torch.tril(x, diagonal)


@register_op
def triu(x, diagonal=0):
    return torch.triu(x, diagonal)


@register_op
def diag(x, offset=0, padding_value=0):
    if x.dim() == 1:
        out = torch.diag(x, offset)
        if padding_value != 0:
            mask = torch.diag(torch.ones_like(x, dtype=torch.bool), offset)
            out = torch.where(mask, out, torch.full_like(out, padding_value))
        return out
    return torch.diagonal(x, offset, dim1=-2, dim2=-1)


@register_op
def diagflat(x, offset=0):
    return torch.diagflat(x, offset)


@register_op
def diag_embed(x, offset=0, dim1=-2, dim2=-1):
    return torch.diag_embed(x, offset, dim1, dim2)


@register_op
def assign(x):
    return x.clone()


@register_op
def cast(x, dtype):
    return x.to(td(dtype))


@register_op
def meshgrid(*xs):
    if len(xs) == 1 and isinstance(xs[0], (list, tuple)):
        xs = tuple(xs[0])
    return tuple(torch.meshgrid(*xs, indexing="ij"))


@register_op(nondiff=True)
def one_hot(x, num_classes):
    return torch.nn.functional.one_hot(x.long(), num_classes).float()


@register_op(nondiff=True)
def empty(shape, dtype=None):
    return torch.zeros(_shape(shape), dtype=td(dtype), device=device())


@register_op(nondiff=True)
def empty_like(x, dtype=None):
    return torch.zeros_like(x, dtype=td(dtype) if dtype else x.dtype)


@register_op
def complex(real, imag):
    real, imag = tensors(real, imag)
    return torch.complex(real, imag)


@register_op(nondiff=True)
def tril_indices(row, col, offset=0):
    return torch.tril_indices(row, col, offset, device=device())


@register_op(nondiff=True)
def triu_indices(row, col, offset=0):
    return torch.triu_indices(row, col, offset, device=device())
