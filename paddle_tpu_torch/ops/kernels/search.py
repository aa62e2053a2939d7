"""Search and sort kernels: port of `paddle_tpu/ops/kernels/search.py`."""
from __future__ import annotations

import numpy as np
import torch

from ..dispatch import register_op


@register_op
def topk(x, k, axis=-1, largest=True, sorted=True):
    vals, idx = torch.topk(x, int(k), dim=axis, largest=largest,
                           sorted=sorted)
    return vals, idx


@register_op
def sort(x, axis=-1, descending=False, stable=False):
    out = torch.sort(x, dim=axis, stable=stable).values
    return torch.flip(out, [axis]) if descending else out


@register_op(nondiff=True)
def argsort(x, axis=-1, descending=False, stable=False):
    idx = torch.argsort(x, dim=axis, stable=stable)
    return torch.flip(idx, [axis]) if descending else idx


@register_op(nondiff=True)
def searchsorted(sorted_sequence, values, out_int32=False, right=False):
    return torch.searchsorted(sorted_sequence, values, out_int32=out_int32,
                              right=right)


@register_op(nondiff=True)
def nonzero(x, as_tuple=False):
    idx = torch.nonzero(x)
    if as_tuple:
        return tuple(idx[:, i:i + 1] for i in range(idx.shape[1]))
    return idx


@register_op
def kthvalue(x, k, axis=-1, keepdim=False):
    vals, idx = torch.sort(x, dim=axis, stable=True)
    v = torch.narrow(vals, axis, k - 1, 1)
    i = torch.narrow(idx, axis, k - 1, 1)
    if not keepdim:
        v, i = v.squeeze(axis), i.squeeze(axis)
    return v, i


@register_op(nondiff=True)
def mode(x, axis=-1, keepdim=False):
    """The smallest most frequent value along `axis` and the index of its
    first occurrence (scipy's rule, as the reference)."""
    xs = x.cpu().numpy()
    moved = np.moveaxis(xs, axis, -1)
    flat = moved.reshape(-1, moved.shape[-1])
    vals = np.empty(flat.shape[0], xs.dtype)
    for r, row in enumerate(flat):
        u, c = np.unique(row, return_counts=True)
        vals[r] = u[np.argmax(c)]
    val = vals.reshape(moved.shape[:-1])
    idx = np.argmax(moved == val[..., None], axis=-1)
    if keepdim:
        val = np.expand_dims(val, axis)
        idx = np.expand_dims(idx, axis)
    return (torch.as_tensor(val, device=x.device),
            torch.as_tensor(idx.astype(np.int64), device=x.device))
