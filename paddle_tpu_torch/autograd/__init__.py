"""Autograd: paddle's entry points over torch's autograd (port of
`paddle_tpu/autograd/`): `grad`, `backward`, `PyLayer`, the functional
forms `jacobian`, `hessian`, `vjp`, `jvp`, and `saved_tensors_hooks`.
`GradNode` is the node type of torch's graph (a tensor's `grad_fn`),
which stands where the reference's tape nodes do."""
import torch as _torch

from ..core.tensor import Tensor as _Tensor
from ..ops.dispatch import (enable_grad, is_grad_enabled, no_grad,  # noqa: F401
                            set_grad_enabled)
from .backward_mode import backward  # noqa: F401
from .engine import grad, run_backward  # noqa: F401
from .functional import Hessian, Jacobian, hessian, jacobian, jvp, vjp  # noqa: F401
from .py_layer import PyLayer, PyLayerContext  # noqa: F401

GradNode = _torch.autograd.graph.Node


class saved_tensors_hooks:
    """Context manager that routes every tensor saved for backward through
    pack() / unpack() (paddle's autograd/saved_tensors_hooks.py, the
    activation-offload hook point): pack(tensor) runs when an op saves
    the tensor and may return anything (a host copy, say); unpack(obj)
    returns the tensor at backward time. The hooks see the port's
    Tensors; underneath it is torch's `saved_tensors_hooks`."""

    def __init__(self, pack_hook, unpack_hook):
        self.pair = (pack_hook, unpack_hook)
        self._ctx = None

    def __enter__(self):
        pack, unpack = self.pair

        def unpacked(obj):
            t = unpack(obj)
            return t._data if isinstance(t, _Tensor) else t

        self._ctx = _torch.autograd.graph.saved_tensors_hooks(
            lambda t: pack(_Tensor._wrap(t)), unpacked)
        self._ctx.__enter__()
        return self

    def __exit__(self, *exc):
        self._ctx.__exit__(*exc)
        return False
