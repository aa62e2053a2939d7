"""Helpers shared by the base kernel modules (the port's own; the
reference's kernels lean on jax.numpy for the same)."""
from __future__ import annotations

import torch

from ...core import dtype as dtype_mod
from ...core.place import torch_device


def td(dtype, default=None) -> torch.dtype:
    """The torch dtype of a paddle dtype argument (None: `default`, else
    the default float dtype)."""
    if dtype is None:
        return dtype_mod.to_torch(default) if default is not None \
            else dtype_mod.default_torch()
    return dtype_mod.to_torch(dtype)


def device():
    """Where a creation op with no tensor input puts its output: the
    current place (raises on the card's default with no CUDA device)."""
    return torch_device()


def tensors(*xs):
    """xs with python scalars turned into 0-d tensors on the device of the
    first tensor among them, of the dtype torch's promotion gives the
    pair (a scalar does not widen a tensor, as jax's weak types)."""
    like = next((x for x in xs if isinstance(x, torch.Tensor)), None)
    if like is None:
        return tuple(torch.as_tensor(x) for x in xs)
    out = []
    for x in xs:
        if isinstance(x, torch.Tensor):
            out.append(x)
        else:
            out.append(torch.as_tensor(
                x, dtype=torch.result_type(like, x), device=like.device))
    return tuple(out)


def axes(axis):
    """paddle's axis argument as torch's dim (None, an int or a tuple)."""
    if axis is None:
        return None
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return int(axis)


def pair(v, n=2):
    if isinstance(v, (list, tuple)):
        return list(v)
    return [v] * n
