"""The small top-level wrappers of paddle's API that are neither ops of
the manifest nor names of `compat_ext`: port of the definitions in
`paddle_tpu/__init__.py:95-163` (`rand`, `randn`, `normal`, `clone`,
`is_tensor`, `device_count`, ...). They override the manifest's ops of
the same name at the top level, as in the reference (`shape`,
`numel`, `ones_like`, `zeros_like`)."""
from __future__ import annotations

import torch

from ..core.tensor import Tensor, to_tensor
from ..ops.dispatch import OPS

__all__ = ["rand", "randn", "normal", "ones_like", "zeros_like", "clone",
           "numel", "shape", "is_tensor", "get_default_device",
           "in_dynamic_mode", "device_count"]


def rand(shape, dtype=None):
    return OPS["uniform"](shape, dtype, 0.0, 1.0)


def randn(shape, dtype=None):
    return OPS["gaussian"](shape, 0.0, 1.0, dtype)


def normal(mean=0.0, std=1.0, shape=None):
    if shape is None:
        if isinstance(mean, Tensor):
            shape = mean.shape
        elif isinstance(std, Tensor):
            shape = std.shape
        else:
            shape = [1]
    return OPS["gaussian"](shape, mean, std, None)


def ones_like(x, dtype=None):
    return OPS["ones_like"](x, dtype)


def zeros_like(x, dtype=None):
    return OPS["zeros_like"](x, dtype)


def clone(x):
    return OPS["assign"](x)


def numel(x):
    return to_tensor(x.size, dtype="int64", place=x.place)


def shape(x):
    return to_tensor(x.shape, dtype="int32", place=x.place)


def is_tensor(x):
    return isinstance(x, Tensor)


def get_default_device():
    from ..core.place import current_place
    return current_place()


def in_dynamic_mode():
    """Always True: the port has no static graph (`jit`, `static`:
    ROADMAP item 9)."""
    return True


def device_count():
    return torch.cuda.device_count()
