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
`nn`, `optimizer`, `vision`, `amp`, `io`, `incubate`, `seed`,
`set_device`, `save` / `load`, ...) loads on first use, so `import
paddle_tpu_torch` stays cheap. The ops as functions are the defs of
`ops/generated_bindings.py`, written from the port's `ops/ops.yaml`,
as the reference's are; the other names of paddle's `__all__` come from
`tensor/compat_ext.py`.
"""
import importlib

from .device import available, resolve

__all__ = ["available", "resolve"]

_MODULES = ("nn", "optimizer", "vision", "autograd", "tensor", "amp", "io",
            "incubate", "framework", "models", "inference", "distributed")
_NAMES = {
    "Tensor": ".core.tensor", "Parameter": ".core.tensor",
    "to_tensor": ".core.tensor",
    "Place": ".core.place", "CPUPlace": ".core.place",
    "CUDAPlace": ".core.place", "set_device": ".core.place",
    "get_device": ".core.place", "CUDAPinnedPlace": ".core.place",
    "TPUPlace": ".core.place", "is_compiled_with_cuda": ".core.place",
    "is_compiled_with_tpu": ".core.place",
    "is_compiled_with_xpu": ".core.place", "DType": ".core.dtype",
    "seed": ".core.rng", "get_rng_state": ".core.rng",
    "set_rng_state": ".core.rng", "ParamAttr": ".nn",
    "get_flags": ".core.flags", "set_flags": ".core.flags",
    "set_default_dtype": ".core.dtype", "get_default_dtype": ".core.dtype",
    "no_grad": ".ops.dispatch", "enable_grad": ".ops.dispatch",
    "is_grad_enabled": ".ops.dispatch", "set_grad_enabled": ".ops.dispatch",
    "grad": ".autograd", "synchronize": ".core.async_engine",
    "save": ".framework.io_api", "load": ".framework.io_api",
}
_DTYPES = ("bool_", "uint8", "int8", "int16", "int32", "int64", "float16",
           "bfloat16", "float32", "float64", "complex64", "complex128",
           "float8_e4m3fn", "float8_e5m2")
# reference spellings of other names
_ALIASES = {"dtype": ("DType", ".core.dtype"),
            "get_cuda_rng_state": ("get_rng_state", ".core.rng"),
            "set_cuda_rng_state": ("set_rng_state", ".core.rng")}


def __getattr__(name):
    if name in _MODULES:
        return importlib.import_module("." + name, __name__)
    if name in _NAMES:
        return getattr(importlib.import_module(_NAMES[name], __name__), name)
    if name in _ALIASES:
        attr, mod = _ALIASES[name]
        return getattr(importlib.import_module(mod, __name__), attr)
    if name in _DTYPES or name == "bool":
        from .core import dtype
        return getattr(dtype, "bool_" if name == "bool" else name)
    if name.startswith("_"):          # submodules such as `_C_ops`
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    from . import tensor as _tensor  # noqa: F401  (registers every op)
    from .tensor import toplevel
    if name in toplevel.__all__:
        return getattr(toplevel, name)
    from .ops import generated_bindings as gen
    from .ops.kernels._util import WAITING, waiting_error
    if name in WAITING:
        raise waiting_error(name)
    if name in gen.__all__:
        return getattr(gen, name)
    from .tensor import compat_ext
    if name in compat_ext.__all__:
        return getattr(compat_ext, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
