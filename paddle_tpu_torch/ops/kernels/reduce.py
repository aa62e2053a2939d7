"""Reduction kernels: port of `paddle_tpu/ops/kernels/reduce.py`."""
from __future__ import annotations

import torch

from ..dispatch import register_op
from ._util import axes, td


def _dims(x, axis):
    a = axes(axis)
    if a is None:
        return tuple(range(x.dim()))
    return a if isinstance(a, tuple) else (a,)


@register_op
def sum(x, axis=None, dtype=None, keepdim=False):
    if x.dtype == torch.bool:
        x = x.long()
    out = torch.sum(x, _dims(x, axis), keepdim=keepdim)
    return out if dtype is None else out.to(td(dtype))


@register_op
def mean(x, axis=None, keepdim=False):
    return torch.mean(x, _dims(x, axis), keepdim=keepdim)


@register_op
def max(x, axis=None, keepdim=False):
    return torch.amax(x, _dims(x, axis), keepdim=keepdim)


@register_op
def min(x, axis=None, keepdim=False):
    return torch.amin(x, _dims(x, axis), keepdim=keepdim)


amax = register_op("amax")(max._kernel)
amin = register_op("amin")(min._kernel)


@register_op
def prod(x, axis=None, keepdim=False, dtype=None):
    out = x
    for d in sorted(_dims(x, axis), reverse=True):
        out = torch.prod(out, d, keepdim=keepdim)
    return out


@register_op(nondiff=True)
def any(x, axis=None, keepdim=False):
    return torch.any(x.bool(), _dims(x, axis), keepdim=keepdim) \
        if x.dim() else x.bool().clone()


@register_op(nondiff=True)
def all(x, axis=None, keepdim=False):
    return torch.all(x.bool(), _dims(x, axis), keepdim=keepdim) \
        if x.dim() else x.bool().clone()


@register_op
def logsumexp(x, axis=None, keepdim=False):
    return torch.logsumexp(x, _dims(x, axis), keepdim=keepdim)


@register_op(nondiff=True)
def argmax(x, axis=None, keepdim=False, dtype="int64"):
    out = torch.argmax(x, axis, keepdim=keepdim if axis is not None else False)
    return out.to(td(dtype))


@register_op(nondiff=True)
def argmin(x, axis=None, keepdim=False, dtype="int64"):
    out = torch.argmin(x, axis, keepdim=keepdim if axis is not None else False)
    return out.to(td(dtype))


@register_op
def var(x, axis=None, unbiased=True, keepdim=False):
    return torch.var(x, _dims(x, axis), correction=1 if unbiased else 0,
                     keepdim=keepdim)


@register_op
def std(x, axis=None, unbiased=True, keepdim=False):
    return torch.std(x, _dims(x, axis), correction=1 if unbiased else 0,
                     keepdim=keepdim)


@register_op
def median(x, axis=None, keepdim=False):
    # the mean of the two middle values for an even count, as numpy's
    return torch.quantile(x, 0.5, dim=axis, keepdim=keepdim) \
        if axis is not None else torch.quantile(x.reshape(-1), 0.5)


@register_op
def quantile(x, q, axis=None, keepdim=False):
    q = torch.as_tensor(q, dtype=x.dtype, device=x.device)
    if axis is None:
        return torch.quantile(x.reshape(-1), q)
    if isinstance(axis, (list, tuple)):
        dims = sorted(a % x.dim() for a in axis)
        rest = [d for d in range(x.dim()) if d not in dims]
        y = x.permute(*rest, *dims).reshape(
            *[x.shape[d] for d in rest], -1)
        out = torch.quantile(y, q, dim=-1)
        if keepdim:
            for d in dims:
                out = out.unsqueeze(d + (out.dim() - x.dim() + len(dims)
                                         if q.dim() else 0))
        return out
    return torch.quantile(x, q, dim=axis, keepdim=keepdim)


@register_op
def nanmean(x, axis=None, keepdim=False):
    return torch.nanmean(x, _dims(x, axis), keepdim=keepdim)


@register_op
def nansum(x, axis=None, dtype=None, keepdim=False):
    return torch.nansum(x, _dims(x, axis), keepdim=keepdim)


@register_op(nondiff=True)
def count_nonzero(x, axis=None, keepdim=False):
    out = torch.count_nonzero(x, _dims(x, axis))
    if keepdim:
        for d in sorted(a % x.dim() for a in _dims(x, axis)):
            out = out.unsqueeze(d)
    return out
