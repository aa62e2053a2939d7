"""The eager Tensor: a paddle API over a `torch.Tensor`.

Port of `paddle_tpu/core/tensor.py`. The reference's Tensor holds a
`jax.Array` plus its own autograd metadata (stop_gradient, grad, the
producing GradNode), because jax has no tape. Here `_data` is a
`torch.Tensor` and torch's autograd is the tape:

- ``stop_gradient`` is ``not _data.requires_grad`` for float and complex
  tensors (setting it True on a non-leaf detaches, as paddle cuts the
  graph there); integer and bool tensors keep the flag on the wrapper,
  since no gradient flows through them;
- ``grad`` / ``clear_grad`` / ``register_hook`` are torch's, with the
  gradients wrapped as Tensors and a hook's Tensor result unwrapped;
- ``numpy()`` / ``item()`` / ``__float__`` are the device-to-host points
  and go through `async_engine.scalar_fetch`.

The method surface (`x.sum()`, `x.reshape(...)`, ...) is attached by
`paddle_tpu_torch.tensor` from the op registry, through
`register_tensor_method`.
"""
from __future__ import annotations

import itertools
from typing import List, Optional

import numpy as np
import torch

from . import dtype as dtype_mod
from .dtype import DType
from .place import Place, current_place, to_place

_name_counter = itertools.count()
_OPS: dict = {}


def _op(name):
    """The registered op `name`; the first call imports the op library."""
    fn = _OPS.get(name)
    if fn is None:
        from .. import tensor as _tensor_api  # noqa: F401  (registers)
        from ..ops.dispatch import OPS

        _OPS.update(OPS)
        fn = _OPS[name]
    return fn


def _inexact(t: torch.Tensor) -> bool:
    return t.is_floating_point() or t.is_complex()


class Tensor:
    __slots__ = ("_data", "_stop", "name", "persistable", "is_parameter",
                 "trainable", "__weakref__")

    def __init__(self, data=None, dtype=None, place=None, stop_gradient=True,
                 name=None):
        if data is None:
            data = np.zeros([], dtype_mod.get_default_dtype())
        self._data = _coerce(data, dtype, place)
        self._stop = True
        self.name = name or f"generated_tensor_{next(_name_counter)}"
        self.persistable = False
        self.is_parameter = False
        self.trainable = True
        self.stop_gradient = stop_gradient

    @classmethod
    def _wrap(cls, data: torch.Tensor, name=None) -> "Tensor":
        """A Tensor over `data` as it is (no copy); stop_gradient follows
        `data.requires_grad`."""
        t = object.__new__(cls)
        t._data = data
        t._stop = True
        t.name = name or f"generated_tensor_{next(_name_counter)}"
        t.persistable = False
        t.is_parameter = False
        t.trainable = True
        return t

    _from_data = _wrap

    # -- metadata ------------------------------------------------------------
    @property
    def shape(self) -> List[int]:
        return list(self._data.shape)

    @property
    def ndim(self) -> int:
        return self._data.dim()

    ndimension = ndim

    @property
    def size(self) -> int:
        return self._data.numel()

    @property
    def dtype(self) -> DType:
        return DType(self._data.dtype)

    @property
    def place(self) -> Place:
        return to_place(self._data.device)

    @property
    def is_leaf(self) -> bool:
        return self._data.grad_fn is None

    @property
    def stop_gradient(self) -> bool:
        if _inexact(self._data):
            return not self._data.requires_grad
        return self._stop

    @stop_gradient.setter
    def stop_gradient(self, value):
        value = bool(value)
        d = self._data
        if not _inexact(d):
            self._stop = value
            return
        if value == (not d.requires_grad):
            return
        if value:
            if d.grad_fn is None:
                d.requires_grad_(False)
            else:
                self._data = d.detach()   # cut the graph here, as paddle
        else:
            d.requires_grad_(True)

    @property
    def grad(self) -> Optional["Tensor"]:
        d = self._data
        if not d.is_leaf and not d.retains_grad:
            return None
        g = d.grad
        return None if g is None else Tensor._wrap(g, self.name + "@GRAD")

    @grad.setter
    def grad(self, value):
        self._data.grad = None if value is None else _unwrap(value)

    # -- autograd ------------------------------------------------------------
    def backward(self, grad_tensor=None, retain_graph=False):
        from ..autograd import engine

        engine.run_backward([self], [grad_tensor], retain_graph=retain_graph)

    def clear_grad(self, set_to_zero=False):
        g = self._data.grad
        if g is not None and set_to_zero:
            g.zero_()
        else:
            self._data.grad = None

    clear_gradient = clear_grad

    def register_hook(self, hook):
        """hook(grad Tensor) -> Tensor or None, run when this tensor's
        gradient is computed. Returns a handle with `remove()`."""
        def run(g):
            res = hook(Tensor._wrap(g))
            return None if res is None else _unwrap(res)

        if not self._data.requires_grad:
            raise RuntimeError(
                "cannot register a hook on a tensor with stop_gradient=True")
        return self._data.register_hook(run)

    def register_grad_final_hook(self, hook):
        """hook(self) once this leaf's gradient has received its last
        contribution of a backward pass (torch's post-accumulate-grad
        hook): the DataParallel reducer's bucket-ready signal. Returns a
        handle with `remove()`."""
        return self._data.register_post_accumulate_grad_hook(
            lambda _leaf: hook(self))

    def retain_grads(self):
        self._data.retain_grad()

    def detach(self) -> "Tensor":
        return Tensor._wrap(self._data.detach(), self.name)

    def detach_(self):
        self._data = self._data.detach()
        return self

    # -- host transfer -------------------------------------------------------
    def numpy(self) -> np.ndarray:
        """The value on the host (bfloat16 and float8 widen to float32:
        numpy has no such types)."""
        from . import async_engine

        async_engine.scalar_fetch(self, self.name)
        d = self._data.detach()
        if d.dtype in (torch.bfloat16, torch.float8_e4m3fn, torch.float8_e5m2):
            d = d.float()
        return d.cpu().numpy()

    def item(self, *args):
        if args:
            return self.numpy().item(*args)
        from . import async_engine

        async_engine.scalar_fetch(self, self.name)
        return self._data.item()

    def tolist(self):
        return self.numpy().tolist()

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a.astype(dtype) if dtype is not None else a

    # -- device and dtype transfer -------------------------------------------
    def to(self, *args, **kwargs):
        device = kwargs.get("device")
        dtype = kwargs.get("dtype")
        for a in args:
            if isinstance(a, (Place, torch.device)) or (
                    isinstance(a, str) and not _is_dtype_like(a)):
                device = a
            else:
                dtype = a
        data = self._data
        if dtype is not None:
            data = data.to(dtype_mod.to_torch(dtype))
        if device is not None:
            data = data.to(to_place(device).torch_device())
        return Tensor._wrap(data, self.name)

    def cpu(self):
        return self.to(Place("cpu"))

    def cuda(self, device_id=0, blocking=True):
        return self.to(Place("gpu", device_id))

    def pin_memory(self):
        return Tensor._wrap(self._data.cpu().pin_memory(), self.name)

    # -- in-place data --------------------------------------------------------
    def _rebind(self, other: "Tensor"):
        """Adopt another tensor's value and graph (functional in-place)."""
        self._data = other._data
        return self

    def set_value(self, value):
        arr = _unwrap(value)
        if not isinstance(arr, torch.Tensor):
            arr = torch.tensor(np.asarray(arr))
        if tuple(arr.shape) != tuple(self._data.shape):
            raise ValueError(
                f"set_value shape mismatch: {list(arr.shape)} vs {self.shape}")
        with torch.no_grad():
            self._data.copy_(arr)
        return self

    def copy_(self, other, blocking=True):
        return self.set_value(other)

    # -- misc ----------------------------------------------------------------
    def clone(self):
        return _op("assign")(self)

    def astype(self, dtype):
        return _op("cast")(self, dtype)

    cast = astype

    def numel(self):
        return self.size

    def element_size(self):
        return self._data.element_size()

    def dim(self):
        return self.ndim

    def rank(self):
        return self.ndim

    @property
    def T(self):
        return _op("transpose")(self, list(range(self.ndim))[::-1])

    def __len__(self):
        if self.ndim == 0:
            raise TypeError("len() of a 0-d tensor")
        return self._data.shape[0]

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __bool__(self):
        if self.size != 1:
            raise ValueError(
                "The truth value of a Tensor with more than one element is "
                "ambiguous")
        return bool(self.item())

    def __int__(self):
        return int(self.item())

    def __float__(self):
        return float(self.item())

    def __index__(self):
        return int(self.item())

    def __format__(self, spec):
        if self.size == 1:
            return format(self.item(), spec)
        return format(str(self), spec)

    def __repr__(self):
        vals = np.array2string(self.numpy(), precision=8, separator=", ",
                               threshold=100)
        return (f"Tensor(shape={self.shape}, dtype={self.dtype.name}, "
                f"place={self.place}, stop_gradient={self.stop_gradient},\n"
                f"       {vals})")

    __hash__ = object.__hash__

    # -- indexing ------------------------------------------------------------
    def __getitem__(self, idx):
        return _op("getitem")(self, idx)

    def __setitem__(self, idx, value):
        self._rebind(_op("setitem")(self, value, idx))

    # -- arithmetic (the op library) -----------------------------------------
    def __add__(self, o):
        return _op("add")(self, o)

    def __radd__(self, o):
        return _op("add")(o, self)

    def __sub__(self, o):
        return _op("subtract")(self, o)

    def __rsub__(self, o):
        return _op("subtract")(o, self)

    def __mul__(self, o):
        return _op("multiply")(self, o)

    def __rmul__(self, o):
        return _op("multiply")(o, self)

    def __truediv__(self, o):
        return _op("divide")(self, o)

    def __rtruediv__(self, o):
        return _op("divide")(o, self)

    def __floordiv__(self, o):
        return _op("floor_divide")(self, o)

    def __rfloordiv__(self, o):
        return _op("floor_divide")(o, self)

    def __mod__(self, o):
        return _op("remainder")(self, o)

    def __rmod__(self, o):
        return _op("remainder")(o, self)

    def __pow__(self, o):
        return _op("pow")(self, o)

    def __rpow__(self, o):
        return _op("elementwise_rpow")(self, o)

    def __neg__(self):
        return _op("scale")(self, -1.0)

    def __abs__(self):
        return _op("abs")(self)

    def __matmul__(self, o):
        return _op("matmul")(self, o)

    def __rmatmul__(self, o):
        return _op("matmul")(o, self)

    def __eq__(self, o):
        return _op("equal")(self, o)

    def __ne__(self, o):
        return _op("not_equal")(self, o)

    def __lt__(self, o):
        return _op("less_than")(self, o)

    def __le__(self, o):
        return _op("less_equal")(self, o)

    def __gt__(self, o):
        return _op("greater_than")(self, o)

    def __ge__(self, o):
        return _op("greater_equal")(self, o)

    def __invert__(self):
        return _op("logical_not" if self.dtype == "bool" else "bitwise_not")(self)

    def __and__(self, o):
        return _op("logical_and" if self.dtype == "bool" else "bitwise_and")(self, o)

    def __or__(self, o):
        return _op("logical_or" if self.dtype == "bool" else "bitwise_or")(self, o)

    def __xor__(self, o):
        return _op("logical_xor" if self.dtype == "bool" else "bitwise_xor")(self, o)


class Parameter(Tensor):
    """A trainable Tensor (the reference's EagerParamBase): its `_data` is
    a torch leaf that requires grad while trainable."""

    __slots__ = ("optimize_attr", "regularizer", "need_clip",
                 "is_distributed", "sequence_parallel")

    def __init__(self, data, name=None, trainable=True):
        super().__init__(data, name=name or f"param_{next(_name_counter)}",
                         stop_gradient=not trainable)
        self._init_param(trainable)

    def _init_param(self, trainable):
        self.is_parameter = True
        self.persistable = True
        self.trainable = trainable
        self.optimize_attr = {"learning_rate": 1.0}
        self.regularizer = None
        self.need_clip = True
        self.is_distributed = False
        self.sequence_parallel = False

    @classmethod
    def from_tensor(cls, t, name=None, trainable=True):
        data = _unwrap(t)
        p = cls.__new__(cls)
        p._data = data.detach().requires_grad_(
            trainable and _inexact(data))
        p._stop = not trainable
        p.name = name or f"param_{next(_name_counter)}"
        p._init_param(trainable)
        return p


def _unwrap(x):
    return x._data if isinstance(x, Tensor) else x


def _is_dtype_like(x) -> bool:
    if isinstance(x, (DType, torch.dtype)):
        return True
    if isinstance(x, str):
        try:
            DType(x)
            return True
        except TypeError:
            return False
    return False


def _coerce(data, dtype=None, place=None) -> torch.Tensor:
    """A torch tensor for `to_tensor`'s arguments: a copy on the place
    asked for (default: the current place), with paddle's dtype rules
    (python and numpy float64 values become the default dtype)."""
    dev = (current_place() if place is None else to_place(place)).torch_device()
    td = None if dtype is None else dtype_mod.to_torch(dtype)
    if isinstance(data, Tensor):
        data = data._data
    if isinstance(data, torch.Tensor):
        return data.detach().to(device=dev, dtype=td, copy=True)
    if isinstance(data, (list, tuple)) and any(
            isinstance(v, (Tensor, torch.Tensor)) for v in data):
        return torch.stack([_coerce(v, dtype, place) for v in data])
    arr = np.asarray(data)
    if td is None and arr.dtype == np.float64:
        td = dtype_mod.default_torch()
    if arr.dtype.kind in "OUS":
        raise TypeError(f"Unsupported data for to_tensor: {arr.dtype}")
    return torch.as_tensor(arr).to(device=dev, dtype=td, copy=True)


def to_tensor(data, dtype=None, place=None, stop_gradient=True) -> Tensor:
    """``paddle.to_tensor`` parity: a copy on `place` (default: the current
    place, ``gpu:0`` unless `set_device` chose another)."""
    return Tensor(data, dtype=dtype, place=place, stop_gradient=stop_gradient)


def register_tensor_method(name, fn=None):
    """Attach `fn` to Tensor as method `name`."""
    if fn is None:
        def deco(f):
            setattr(Tensor, name, f)
            return f
        return deco
    setattr(Tensor, name, fn)
    return fn
