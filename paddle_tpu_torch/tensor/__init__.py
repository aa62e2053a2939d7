"""The Tensor method library and the op namespace of the eager API.

Port of `paddle_tpu/tensor/__init__.py`. As in the reference, the
methods come from the generated bindings (`ops/generated_bindings.py`,
written from the port's `ops/ops.yaml`): every op of the manifest whose
first argument is a tensor becomes a method, with paddle's aliases and
the in-place `op_` variants (which rebind the Tensor to the op's result,
as the reference's do). An op that waits for another item of the port
(`ops/kernels/_util.py` `WAITING`) is no method. The same ops are
`paddle_tpu_torch.<name>` (`paddle_tpu_torch/__init__`).
"""
from __future__ import annotations

from .. import _C_ops  # noqa: F401  (registers every op of the manifest)
from ..core.tensor import Tensor, register_tensor_method
from ..ops import generated_bindings as _gen
from ..ops.dispatch import OPS
from ..ops.kernels import (comparison, creation, linalg,  # noqa: F401
                           manipulation, math, nn_ops, random, reduce, search)

BASE_MODULES = (creation, math, manipulation, reduce, comparison, nn_ops,
                linalg, search, random)

# the ops of the nine base modules, by module
BASE_OPS = {m.__name__.rsplit(".", 1)[1]: sorted(
    n for n, fn in OPS.items()
    if getattr(fn, "__module__", None) == m.__name__)
    for m in BASE_MODULES}
BASE_OPS["nn_ops"] = sorted(BASE_OPS["nn_ops"] + ["swiglu"])

# ops whose first argument is not a tensor: no method
_NON_METHODS = {"zeros", "ones", "full", "arange", "linspace", "logspace",
                "eye", "empty", "meshgrid", "tril_indices", "triu_indices",
                "randint", "randperm", "uniform", "gaussian", "complex",
                "multi_dot", "getitem", "setitem", "einsum"}

_ALIASES = {"mod": "remainder", "floor_mod": "remainder"}

_INPLACE = ("add", "subtract", "multiply", "divide", "remainder", "pow",
            "scale", "clip", "exp", "sqrt", "rsqrt", "reciprocal", "floor",
            "ceil", "round", "abs", "tanh", "sigmoid", "relu", "erfinv",
            "lerp", "cast", "flatten", "squeeze", "unsqueeze", "reshape",
            "masked_fill", "index_add")


def _inplace(op):
    def method(self, *args, **kwargs):
        return self._rebind(op(self, *args, **kwargs))
    return method


def _install():
    waiting = set(_gen.WAITING)
    for name in _gen.__all__:
        if name in _NON_METHODS or name.endswith("_") or name in waiting:
            continue
        if not hasattr(Tensor, name):
            setattr(Tensor, name, getattr(_gen, name))
    for alias, opname in _ALIASES.items():
        if not hasattr(Tensor, alias):
            setattr(Tensor, alias, getattr(_gen, opname))
    for base in _INPLACE:
        if not hasattr(Tensor, base + "_"):
            setattr(Tensor, base + "_", _inplace(OPS[base]))

    register_tensor_method(
        "zero_", lambda self: self._rebind(OPS["zeros_like"](self)))
    register_tensor_method(
        "fill_", lambda self, value: self._rebind(OPS["full_like"](self, value)))
    register_tensor_method(
        "normal_", lambda self, mean=0.0, std=1.0:
        self._rebind(OPS["normal_like"](self, mean, std)))
    register_tensor_method(
        "uniform_", lambda self, min=-1.0, max=1.0:
        self._rebind(OPS["uniform_random_like"](self, min, max)))
    register_tensor_method(
        "exponential_", lambda self, lam=1.0:
        self._rebind(OPS["exponential_"](self, lam)))
    register_tensor_method("mm", OPS["matmul"])
    register_tensor_method(
        "t", lambda self: OPS["transpose"](self, list(range(self.ndim))[::-1]))


_install()

