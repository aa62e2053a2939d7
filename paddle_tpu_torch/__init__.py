"""PyTorch/CUDA port of paddle_tpu.

The JAX package `paddle_tpu/` is the reference; this package mirrors its
layout where that helps a reader find the counterpart and uses PyTorch
idiom inside. It imports torch and numpy only, never jax and never
`paddle_tpu`.

Every entry point runs on `cuda` unless the caller passes
`device="cpu"` (the eager API: `set_device("cpu")` or `place="cpu"`);
with no CUDA device and no explicit CPU request it raises. The Pallas
kernels of the reference are hand-written CUDA C++ for Hopper
(`ops/cuda/csrc/`), built with `nvcc` at first use. Each kernel wrapper
runs its plain PyTorch version only for CPU tensors, launches the kernel
for CUDA tensors, and raises otherwise.

The eager paddle API (`to_tensor`, `Tensor`, the ops as functions,
`nn`, `optimizer`, `vision`, `seed`, `set_device`, ...) loads on first
use, so `import paddle_tpu_torch` stays cheap.
"""
import importlib

from .device import available, resolve

__all__ = ["available", "resolve"]

_MODULES = ("nn", "optimizer", "vision", "autograd", "tensor")
_NAMES = {
    "Tensor": ".core.tensor", "Parameter": ".core.tensor",
    "to_tensor": ".core.tensor",
    "Place": ".core.place", "CPUPlace": ".core.place",
    "CUDAPlace": ".core.place", "set_device": ".core.place",
    "get_device": ".core.place",
    "seed": ".core.rng", "get_rng_state": ".core.rng",
    "set_rng_state": ".core.rng",
    "get_flags": ".core.flags", "set_flags": ".core.flags",
    "set_default_dtype": ".core.dtype", "get_default_dtype": ".core.dtype",
    "no_grad": ".ops.dispatch", "enable_grad": ".ops.dispatch",
    "is_grad_enabled": ".ops.dispatch", "set_grad_enabled": ".ops.dispatch",
    "grad": ".autograd", "synchronize": ".core.async_engine",
}
_DTYPES = ("bool_", "uint8", "int8", "int16", "int32", "int64", "float16",
           "bfloat16", "float32", "float64", "complex64", "complex128")


def __getattr__(name):
    if name in _MODULES:
        return importlib.import_module("." + name, __name__)
    if name in _NAMES:
        return getattr(importlib.import_module(_NAMES[name], __name__), name)
    if name in _DTYPES or name == "bool":
        from .core import dtype
        return getattr(dtype, "bool_" if name == "bool" else name)
    from . import tensor as _tensor  # noqa: F401  (registers the base ops)
    from .ops.dispatch import OPS
    if name in OPS:
        return OPS[name]
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
