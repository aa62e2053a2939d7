"""The port's op registry.

Counterpart of the registry half of `paddle_tpu/ops/dispatch.py`: `OPS`,
`register_op` (:635), `get_op` (:671) and the grad-mode switches (:39).
The reference's `call_op` unwraps paddle Tensors, records a `jax.vjp`
pullback on its tape, caches jit executables and feeds the static
recorder; in PyTorch none of that is needed — an op is a plain function
on `torch.Tensor`s, autograd is torch's own and it runs eagerly — so a
registered op is the function itself, and grad mode is torch's.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict

import torch

__all__ = ["OPS", "register_op", "get_op", "no_grad", "enable_grad",
           "is_grad_enabled", "set_grad_enabled"]

OPS: Dict[str, Callable] = {}

no_grad = torch.no_grad
enable_grad = torch.enable_grad
is_grad_enabled = torch.is_grad_enabled


def set_grad_enabled(mode: bool) -> None:
    """Turn autograd recording on or off for this thread."""
    torch.set_grad_enabled(bool(mode))


def register_op(name_or_fn=None, *, name=None, nondiff=False):
    """Register a function on torch.Tensors as the op `name` (default:
    the function's name). Used bare (`@register_op`), with a name
    (`@register_op("x")`, `@register_op(name="x")`) or with `nondiff=True`
    for an op whose outputs take no gradient: it then runs under
    `torch.no_grad()`."""

    def deco(fn):
        opname = name or fn.__name__
        api = fn
        if nondiff:
            @functools.wraps(fn)
            def api(*args, **kwargs):
                with torch.no_grad():
                    return fn(*args, **kwargs)
        OPS[opname] = api
        return api

    if callable(name_or_fn):
        return deco(name_or_fn)
    if isinstance(name_or_fn, str):
        name = name_or_fn
    return deco


def get_op(name: str) -> Callable:
    return OPS[name]
