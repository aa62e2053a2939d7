"""Data types: paddle dtype names and `torch.dtype`.

Port of `paddle_tpu/core/dtype.py`. A ``DType`` compares equal to its
name string, its numpy dtype, its `torch.dtype` and itself, which is what
code written against the reference expects (``x.dtype == paddle.float32``
or ``x.dtype == 'float32'``). Each carries the `torch.dtype` tensors of
that type hold; bfloat16 and the float8 types have no numpy dtype here
(numpy has none; the reference takes them from ml_dtypes).
"""
from __future__ import annotations

import numpy as np
import torch

_TORCH = {
    "bool": torch.bool,
    "uint8": torch.uint8,
    "int8": torch.int8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float64": torch.float64,
    "complex64": torch.complex64,
    "complex128": torch.complex128,
    "float8_e4m3fn": torch.float8_e4m3fn,
    "float8_e5m2": torch.float8_e5m2,
}
_FROM_TORCH = {v: k for k, v in _TORCH.items()}
_NO_NUMPY = ("bfloat16", "float8_e4m3fn", "float8_e5m2")


def _canonical_name(name) -> str:
    if isinstance(name, DType):
        return name.name
    if isinstance(name, torch.dtype):
        n = _FROM_TORCH.get(name)
        if n is None:
            raise TypeError(f"Unsupported dtype: {name!r}")
        return n
    if isinstance(name, str):
        n = name[6:] if name.startswith("paddle.") else name
        if n in _TORCH:
            return n
    try:
        n = np.dtype(name).name      # numpy dtypes, python types, 'float'
    except TypeError:
        raise TypeError(f"Unsupported dtype: {name!r}") from None
    if n not in _TORCH:
        raise TypeError(f"Unsupported dtype: {name!r}")
    return n


class DType:
    """A framework dtype; one instance per name."""

    __slots__ = ("name", "torch_dtype")
    _registry: dict = {}

    def __new__(cls, name):
        if isinstance(name, DType):
            return name
        key = _canonical_name(name)
        inst = cls._registry.get(key)
        if inst is None:
            inst = object.__new__(cls)
            inst.name = key
            inst.torch_dtype = _TORCH[key]
            cls._registry[key] = inst
        return inst

    @property
    def np_dtype(self) -> np.dtype:
        if self.name in _NO_NUMPY:
            raise TypeError(f"{self.name} has no numpy dtype")
        return np.dtype(self.name)

    def __repr__(self):
        return f"paddle.{self.name}"

    def __str__(self):
        return self.name

    def __hash__(self):
        return hash(self.name)

    def __eq__(self, other):
        if isinstance(other, DType):
            return self is other
        try:
            return self.name == _canonical_name(other)
        except (TypeError, ValueError):
            return NotImplemented

    def __ne__(self, other):
        eq = self.__eq__(other)
        return eq if eq is NotImplemented else not eq

    @property
    def is_floating_point(self):
        return self.torch_dtype.is_floating_point

    @property
    def is_complex(self):
        return self.torch_dtype.is_complex

    @property
    def is_integer(self):
        return self.name in ("uint8", "int8", "int16", "int32", "int64")

    @property
    def itemsize(self):
        return self.torch_dtype.itemsize


bool_ = DType("bool")
uint8 = DType("uint8")
int8 = DType("int8")
int16 = DType("int16")
int32 = DType("int32")
int64 = DType("int64")
float16 = DType("float16")
bfloat16 = DType("bfloat16")
float32 = DType("float32")
float64 = DType("float64")
complex64 = DType("complex64")
complex128 = DType("complex128")
float8_e4m3fn = DType("float8_e4m3fn")
float8_e5m2 = DType("float8_e5m2")

_DEFAULT_DTYPE = float32


def set_default_dtype(d):
    """paddle.set_default_dtype parity."""
    global _DEFAULT_DTYPE
    d = DType(d)
    if d not in (float16, bfloat16, float32, float64):
        raise TypeError(
            "set_default_dtype only supports [float16, bfloat16, float32, float64]"
            f", but received {d}")
    _DEFAULT_DTYPE = d


def get_default_dtype() -> str:
    return _DEFAULT_DTYPE.name


def to_torch(d) -> torch.dtype:
    """The torch.dtype of a paddle dtype, name, numpy or torch dtype."""
    if isinstance(d, torch.dtype):
        return d
    return DType(d).torch_dtype


def default_torch() -> torch.dtype:
    return _DEFAULT_DTYPE.torch_dtype


def from_torch(td: torch.dtype) -> DType:
    return DType(td)


def is_floating_dtype(dt) -> bool:
    """True for float dtypes, bfloat16 and float8 included."""
    return to_torch(dt).is_floating_point


def is_inexact_dtype(dt) -> bool:
    """Float or complex: the types a gradient flows through."""
    td = to_torch(dt)
    return td.is_floating_point or td.is_complex
