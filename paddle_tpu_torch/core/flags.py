"""Runtime flag registry: a copy of `paddle_tpu/core/flags.py` (jax-free).

Analog of the reference's exported gflags
(`paddle/common/flags.h:38` PD_DEFINE_* macros; 184 exported flags in
`paddle/common/flags.cc`). Flags are registered with a default, overridable
by a ``FLAGS_<name>`` environment variable at import time, and readable /
writable at runtime through ``get_flags`` / ``set_flags`` — the same user
surface the reference exposes via pybind
(`paddle/fluid/pybind/global_value_getter_setter.cc`).
"""
from __future__ import annotations

import difflib
import os
from typing import Any, Dict, Iterable, Optional

_REGISTRY: Dict[str, dict] = {}
# change watchers: fn(name, value) called after every set_flags update —
# lets hot paths cache flag values instead of dict-looking-up per call
# (the observability emit() fast path relies on this)
_WATCHERS: list = []


def on_change(fn):
    _WATCHERS.append(fn)
    return fn


def _coerce(value, proto):
    if isinstance(proto, bool):
        if isinstance(value, str):
            return value.lower() in ("1", "true", "yes", "on")
        return bool(value)
    if isinstance(proto, int) and not isinstance(proto, bool):
        return int(value)
    if isinstance(proto, float):
        return float(value)
    return value


def define_flag(name: str, default: Any, help: str = "", env: bool = True):
    """Register a flag. Env var FLAGS_<name> overrides the default."""
    value = default
    if env:
        ev = os.environ.get(f"FLAGS_{name}")
        if ev is not None:
            value = _coerce(ev, default)
    _REGISTRY[name] = {"default": default, "value": value, "help": help}
    return value


def _unknown_flag(key: str) -> ValueError:
    msg = f"Flag FLAGS_{key} is not registered"
    close = difflib.get_close_matches(key, list(_REGISTRY), n=3, cutoff=0.6)
    if close:
        msg += "; did you mean " + ", ".join(f"FLAGS_{c}" for c in close) + "?"
    return ValueError(msg)


def get_flags(flags) -> Dict[str, Any]:
    """paddle.get_flags parity."""
    if isinstance(flags, str):
        flags = [flags]
    out = {}
    for f in flags:
        key = f[6:] if f.startswith("FLAGS_") else f
        if key not in _REGISTRY:
            raise _unknown_flag(key)
        out[f"FLAGS_{key}"] = _REGISTRY[key]["value"]
    return out


def set_flags(flags: Dict[str, Any]):
    """paddle.set_flags parity."""
    for f, v in flags.items():
        key = f[6:] if f.startswith("FLAGS_") else f
        if key not in _REGISTRY:
            raise _unknown_flag(key)
        _REGISTRY[key]["value"] = _coerce(v, _REGISTRY[key]["default"])
        for fn in _WATCHERS:
            fn(key, _REGISTRY[key]["value"])


def flag_value(name: str):
    return _REGISTRY[name]["value"]


def all_flags() -> Iterable[str]:
    return _REGISTRY.keys()


# Core flags (the reference's names and defaults; the port reads
# check_nan_inf, benchmark and eager_async_depth, and keeps the rest for
# API parity) --------------------------------------------------------------
define_flag("check_nan_inf", False, "Scan op outputs for NaN/Inf after each eager op")
define_flag("benchmark", False, "Synchronize after each op for timing")
define_flag("use_bf16_default", True, "Prefer bf16 in AMP autocast")
define_flag("eager_delete_tensor_gb", 0.0, "Kept for API parity; torch's caching allocator owns memory")
define_flag("jit_cache_size", 4096, "Kept for API parity; the port compiles and caches nothing per op")
define_flag("log_level", 0, "VLOG-style verbosity tier")
define_flag("eager_async_depth", 2,
            "Max training steps in flight before dispatch backpressures; "
            "0 = fully synchronous eager execution (debugging)")
define_flag("eager_dispatch_cache", True,
            "Kept for API parity; the port's dispatch has no cache")
define_flag("fused_optimizer", True,
            "Kept for API parity; the port's optimizers update each "
            "parameter in a plain loop")
