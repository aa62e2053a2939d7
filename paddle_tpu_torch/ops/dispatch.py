"""The port's op registry and eager dispatch: `register_op`, `call_op`.

Port of `paddle_tpu/ops/dispatch.py`. A registered op is a function on
`torch.Tensor`s. Calling it through the registry goes through `call_op`
(:func:`call_op`), which unwraps the port's `Tensor`s (`core/tensor.py`)
to their `torch.Tensor`s, runs the function, and wraps the torch tensors
it returns as `Tensor`s. Autograd is torch's own: an op records its
backward in torch's graph as it runs, so there is no tape here and no
pullback to trace. An op registered ``nondiff=True`` runs under
`torch.no_grad()`.

Wrapping rule: outputs are wrapped when a port `Tensor` is among the
arguments, or when no tensor at all is (a creation op such as `zeros`).
A call whose tensors are all bare `torch.Tensor`s is the function's own
call: `call_op` finds no port Tensor, calls the function with the
arguments as given and returns what it returns, before any flag check or
counter. That is how the engine, the predictor and the fused-op callers
have always called the ops.

There is no dispatch cache. The reference caches a jitted forward+vjp
executable per signature to skip retracing `jax.vjp`; the port has
nothing to trace, and what a call pays for is finding the Tensors among
its arguments, one `isinstance` test a slot, which a cache keyed on the
slots' types cost as much to look up (timed on the card by
`tools/eager_ab_torch.py`). `dispatch_cache_stats` keeps the reference's
keys: `hits`, `misses`, `traces` and `entries` are always 0 and
`hit_rate` is None, since nothing is cached or traced; `dispatches`
counts the calls that went through the port layer (a port Tensor among
the arguments, or no tensor at all).
"""
from __future__ import annotations

import functools
from typing import Callable, Dict

import torch

from ..core import flags
from ..core.tensor import Tensor

__all__ = ["OPS", "register_op", "get_op", "call_op", "no_grad",
           "enable_grad", "is_grad_enabled", "set_grad_enabled",
           "dispatch_cache_stats", "reset_dispatch_cache_stats"]

OPS: Dict[str, Callable] = {}

no_grad = torch.no_grad
enable_grad = torch.enable_grad
is_grad_enabled = torch.is_grad_enabled


def set_grad_enabled(mode: bool) -> None:
    """Turn autograd recording on or off for this thread."""
    torch.set_grad_enabled(bool(mode))


# -- counters and flags --------------------------------------------------------

_stats = {"dispatches": 0}
_flag_state = {"nan": False, "bench": False}


def _read_flags(*_):
    _flag_state["nan"] = bool(flags.flag_value("check_nan_inf"))
    _flag_state["bench"] = bool(flags.flag_value("benchmark"))


_read_flags()
flags.on_change(_read_flags)


def dispatch_cache_stats() -> dict:
    """The reference's cache counters: `hits`, `misses`, `traces` and
    `entries` are 0 and `hit_rate` None, as the port caches and traces
    nothing; `dispatches` counts the calls through the port layer."""
    return {"hits": 0, "misses": 0, "traces": 0, "entries": 0,
            "hit_rate": None, "dispatches": _stats["dispatches"]}


def reset_dispatch_cache_stats():
    _stats["dispatches"] = 0


def _unwrap_deep(x, seen):
    """x with every Tensor inside lists, tuples and dicts unwrapped;
    seen[0] is set when a Tensor was found, seen[1] when a torch.Tensor."""
    if isinstance(x, Tensor):
        seen[0] = True
        return x._data
    if isinstance(x, torch.Tensor):
        seen[1] = True
        return x
    if isinstance(x, list):
        return [_unwrap_deep(v, seen) for v in x]
    if isinstance(x, tuple):
        out = [_unwrap_deep(v, seen) for v in x]
        return tuple(out) if type(x) is tuple else type(x)(*out)
    if isinstance(x, dict):
        return {k: _unwrap_deep(v, seen) for k, v in x.items()}
    return x


def _wrap_out(out):
    if isinstance(out, torch.Tensor):
        return Tensor._wrap(out)
    if isinstance(out, tuple):
        return tuple(_wrap_out(o) for o in out)
    if isinstance(out, list):
        return [_wrap_out(o) for o in out]
    return out


def _check_nan_inf(name, out):
    """FLAGS_check_nan_inf: raise when a float output holds a NaN or Inf."""
    ts = [out] if isinstance(out, torch.Tensor) else [
        o for o in (out if isinstance(out, (list, tuple)) else ())
        if isinstance(o, torch.Tensor)]
    for t in ts:
        if t.is_floating_point() and not bool(torch.isfinite(t).all()):
            raise FloatingPointError(f"Operator {name} output contains Inf/Nan")


def call_op(name: str, kernel: Callable, args, kwargs, nondiff: bool = False):
    """Run the registered op `name` (its function `kernel`) on `args`,
    unwrapping and wrapping port Tensors as the module docstring says."""
    seen = [False, False]     # a port Tensor, a bare torch.Tensor
    new_args = [_unwrap_deep(a, seen) for a in args]
    new_kwargs = {k: _unwrap_deep(v, seen) for k, v in kwargs.items()}
    port, bare = seen
    if not port and bare:
        # the function's own call: bare torch tensors in, its result out
        if nondiff:
            with torch.no_grad():
                return kernel(*args, **kwargs)
        return kernel(*args, **kwargs)
    _stats["dispatches"] += 1
    if nondiff:
        with torch.no_grad():
            out = kernel(*new_args, **new_kwargs)
    else:
        out = kernel(*new_args, **new_kwargs)
    if _flag_state["nan"]:
        _check_nan_inf(name, out)
    if _flag_state["bench"] and torch.cuda.is_available():
        torch.cuda.synchronize()
    return _wrap_out(out)


def register_op(name_or_fn=None, *, name=None, nondiff=False):
    """Register a function on torch.Tensors as the op `name` (default: the
    function's name). Used bare (`@register_op`), with a name
    (`@register_op("x")`, `@register_op(name="x")`) or with `nondiff=True`
    for an op whose outputs take no gradient. Returns the op: the function
    called through `call_op`; `api._kernel` is the function itself."""

    def deco(fn):
        opname = name or fn.__name__

        @functools.wraps(fn)
        def api(*args, **kwargs):
            return call_op(opname, fn, args, kwargs, nondiff)

        api._kernel = fn
        api._op_name = opname
        OPS[opname] = api
        return api

    if callable(name_or_fn):
        return deco(name_or_fn)
    if isinstance(name_or_fn, str):
        name = name_or_fn
    return deco


def get_op(name: str) -> Callable:
    return OPS[name]
