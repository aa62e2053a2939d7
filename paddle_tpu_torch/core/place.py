"""Device placement: `Place`, `set_device`, `get_device`.

Port of `paddle_tpu/core/place.py`. The places are ``gpu`` (a CUDA card,
`torch.device("cuda", i)`) and ``cpu``. The default is ``gpu:0``; with no
CUDA device it raises (through `device.resolve`) unless the caller ran
``set_device("cpu")`` or passed ``place="cpu"``. The reference's default
falls back to the CPU when no accelerator is attached; the port never
carries on on the CPU by itself. ``tpu`` requests name the accelerator,
as the reference's ``gpu`` requests do there.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..device import resolve


class Place:
    __slots__ = ("device_type", "device_id")

    def __init__(self, device_type: str, device_id: int = 0):
        if ":" in device_type:
            device_type, _, idx = device_type.partition(":")
            device_id = int(idx)
        device_type = device_type.lower()
        if device_type in ("cuda", "tpu"):
            device_type = "gpu"
        if device_type not in ("cpu", "gpu"):
            raise ValueError(
                f"Unsupported device type: {device_type!r} (use 'gpu' or 'cpu')")
        self.device_type = device_type
        self.device_id = int(device_id) if device_type == "gpu" else 0

    def is_cpu_place(self):
        return self.device_type == "cpu"

    def is_gpu_place(self):
        return self.device_type == "gpu"

    # reference-API compat: the reference's accelerator is the TPU
    is_tpu_place = is_gpu_place

    def torch_device(self) -> torch.device:
        """The torch device; raises when it is a card and there is none."""
        if self.device_type == "cpu":
            return torch.device("cpu")
        return resolve(torch.device("cuda", self.device_id))

    def __repr__(self):
        return f"Place({self.device_type}:{self.device_id})"

    def __eq__(self, other):
        if isinstance(other, str):
            try:
                other = Place(other)
            except ValueError:
                return False
        return (isinstance(other, Place)
                and self.device_type == other.device_type
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_type, self.device_id))


def CPUPlace():
    return Place("cpu", 0)


def CUDAPlace(device_id: int = 0):
    return Place("gpu", device_id)


def CUDAPinnedPlace():
    return Place("cpu", 0)


TPUPlace = CUDAPlace   # reference-API compat: the accelerator

_DEFAULT = Place("gpu", 0)
_current: list = [None]


def to_place(p) -> Place:
    """A Place from a Place, a string or a torch.device."""
    if isinstance(p, Place):
        return p
    if isinstance(p, torch.device):
        return Place(p.type, p.index or 0)
    return Place(str(p))


def set_device(device) -> Place:
    """paddle.set_device parity: the place new tensors go to. Raises when
    it names the card and there is none."""
    p = to_place(device)
    p.torch_device()
    _current[0] = p
    return p


def get_device() -> str:
    p = current_place()
    return f"{p.device_type}:{p.device_id}"


def current_place() -> Place:
    """The place set by `set_device`, else ``gpu:0``."""
    return _current[0] or _DEFAULT


def torch_device(place: Optional[object] = None) -> torch.device:
    """The torch device for `place` (default: the current place); raises
    when it is the card and there is no CUDA device."""
    p = current_place() if place is None else to_place(place)
    return p.torch_device()


def is_compiled_with_cuda() -> bool:
    return torch.cuda.is_available()


def is_compiled_with_tpu() -> bool:
    return False


def is_compiled_with_xpu() -> bool:
    return False
