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


# Ops of the reference that wait for another item of the port: name ->
# the function that raises (`waiting`). They are not in the registry;
# `_C_ops` raises `WaitingOp` for their names, naming the item.
WAITING = {}
_ITEMS = {9: "ROADMAP item 9, sparse"}


class WaitingOp(NotImplementedError, AttributeError):
    """An op of the reference that another item of the port brings: a
    NotImplementedError naming the item, and an AttributeError to
    attribute lookups (`hasattr` is False), as any op not ported."""


def waiting_error(name: str) -> WaitingOp:
    item = WAITING[name]._waiting_item
    return WaitingOp(
        f"op {name!r} is not ported yet: it comes with {_ITEMS[item]}")


def waiting(name: str, item: int):
    """The stand-in of the reference op `name` until item `item` ports
    what it needs: calling it raises WaitingOp naming the item."""
    def op(*args, **kwargs):
        raise waiting_error(name)

    op.__name__ = op.__qualname__ = name
    op._waiting_item = item
    WAITING[name] = op
    return op


# item 9's ops that no kernel module of the tail holds: `geometric`'s
# seven graph and segment ops and `quantization`'s fake quantizer
for _name in ("graph_send_recv", "graph_send_ue_recv", "graph_send_uv",
              "segment_max", "segment_mean", "segment_min", "segment_sum",
              "fake_quantize_dequantize_abs_max"):
    waiting(_name, 9)
