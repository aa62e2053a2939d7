"""`paddle.device`: device resolution for the port's entry points, and
the reference's device namespace (`paddle_tpu/device/__init__.py`) over
`torch.cuda`.

- `available()` and `resolve()`, the port's own: the counterpart of
  `paddle_tpu/ops/pallas/flash_attention.py:85 available` (there "is
  this a TPU", here "is this a Hopper card"); entry points default to
  `cuda` and raise when there is none, never carrying on on the CPU
  unless the caller asked for it.
- The reference's names: the places and `set_device` / `get_device`
  (`core/place.py`), the `is_compiled_with_*` probes, `device_count`,
  `synchronize`, the memory namespaces `cuda` (and `tpu`, `xpu`, which
  answer for the card too), `get_cudnn_version`, and `Stream`, `Event`,
  `current_stream`, `set_stream`, `stream_guard`. The reference's values
  are the TPU's; here the streams, events and memory statistics are
  `torch.cuda`'s, and on the CPU (where torch runs every op before it
  returns) a stream and an event are always complete.
"""
from __future__ import annotations

import gc
from typing import Optional, Union

import torch

__all__ = ["available", "resolve"]

_PLACE_NAMES = ("CPUPlace", "Place", "TPUPlace", "get_device",
                "is_compiled_with_cuda", "is_compiled_with_tpu",
                "is_compiled_with_xpu", "set_device")


def available() -> bool:
    """True when a CUDA device of compute capability (9, 0) is present."""
    return (torch.cuda.is_available()
            and torch.cuda.get_device_capability(0) == (9, 0))


def resolve(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: `cuda` unless the caller names
    another. Raises RuntimeError when CUDA is asked for (explicitly or by
    default) and there is no CUDA device."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card by default; pass "
            "device='cpu' to run the plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def __getattr__(name):
    # the places live in core/place.py, which imports this module
    if name in _PLACE_NAMES:
        from .core import place
        return getattr(place, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def _cuda() -> bool:
    return torch.cuda.is_available()


def get_all_device_type():
    return ["cpu", "gpu"] if _cuda() else ["cpu"]


def get_available_device():
    return ["cpu"] + [f"gpu:{i}" for i in range(torch.cuda.device_count())]


def get_available_custom_device():
    return []


def get_all_custom_device_type():
    return []


def device_count() -> int:
    """The CUDA devices."""
    return torch.cuda.device_count()


def synchronize(device=None):
    """Wait for every step in flight and for the card
    (`core/async_engine.synchronize`)."""
    from .core import async_engine
    async_engine.synchronize()


def _dev_id(device) -> int:
    if device is None:
        return torch.cuda.current_device() if _cuda() else 0
    if isinstance(device, int):
        return device
    s = str(device)
    return int(s.split(":")[-1]) if ":" in s else 0


class _MemNamespace:
    """Memory statistics of a card (`torch.cuda`'s caching allocator);
    0 with no CUDA device (reference: device/cuda/__init__.py)."""

    @staticmethod
    def max_memory_allocated(device=None) -> int:
        return torch.cuda.max_memory_allocated(_dev_id(device)) \
            if _cuda() else 0

    @staticmethod
    def max_memory_reserved(device=None) -> int:
        return torch.cuda.max_memory_reserved(_dev_id(device)) \
            if _cuda() else 0

    @staticmethod
    def memory_allocated(device=None) -> int:
        return torch.cuda.memory_allocated(_dev_id(device)) \
            if _cuda() else 0

    @staticmethod
    def memory_reserved(device=None) -> int:
        return torch.cuda.memory_reserved(_dev_id(device)) \
            if _cuda() else 0

    @staticmethod
    def device_count() -> int:
        return torch.cuda.device_count()

    @staticmethod
    def synchronize(device=None):
        synchronize(device)

    @staticmethod
    def empty_cache():
        gc.collect()
        if _cuda():
            torch.cuda.empty_cache()


cuda = _MemNamespace()
tpu = _MemNamespace()
xpu = _MemNamespace()


def XPUPlace(device_id: int = 0):
    """XPU code targets the card here."""
    from .core.place import Place
    return Place("gpu", device_id)


def IPUPlace(*a, **k):
    raise RuntimeError("paddle_tpu_torch is not compiled with IPU support")


def is_compiled_with_rocm():
    return torch.version.hip is not None


def is_compiled_with_ipu():
    return False


def is_compiled_with_cinn():
    return False


def is_compiled_with_custom_device(device_type=None):
    return False


def is_compiled_with_distribute():
    return torch.distributed.is_available()


def get_cudnn_version():
    """cuDNN's version, or None without one (as the reference)."""
    if not _cuda() or not torch.backends.cudnn.is_available():
        return None
    return torch.backends.cudnn.version()


class Stream:
    """An execution stream: a `torch.cuda.Stream` on the card (`device`,
    default the current one), complete at once on the CPU."""

    def __init__(self, device=None, priority=2, stream=None):
        self.device = device
        self.priority = priority
        if stream is None and _cuda():
            # paddle's priorities are 1 (high) and 2 (normal); torch's
            # are 0 (normal) and below
            stream = torch.cuda.Stream(_dev_id(device),
                                       priority=-1 if priority == 1 else 0)
        self._stream = stream

    def synchronize(self):
        if self._stream is not None:
            self._stream.synchronize()

    def query(self) -> bool:
        return self._stream is None or self._stream.query()

    def wait_event(self, event):
        if self._stream is not None and event._event is not None:
            self._stream.wait_event(event._event)

    def wait_stream(self, stream):
        if self._stream is not None and stream._stream is not None:
            self._stream.wait_stream(stream._stream)

    def record_event(self, event=None):
        event = event or Event()
        event.record(self)
        return event


class Event:
    """A stream event: a `torch.cuda.Event` on the card, complete at once
    on the CPU."""

    def __init__(self, enable_timing=False, blocking=False,
                 interprocess=False):
        self._event = (torch.cuda.Event(enable_timing=enable_timing,
                                        blocking=blocking,
                                        interprocess=interprocess)
                       if _cuda() else None)

    def record(self, stream=None):
        if self._event is not None:
            s = (stream or current_stream())._stream
            self._event.record(s)

    def query(self) -> bool:
        return self._event is None or self._event.query()

    def synchronize(self):
        if self._event is not None:
            self._event.synchronize()

    def elapsed_time(self, end) -> float:
        return self._event.elapsed_time(end._event)


_cpu_stream = Stream.__new__(Stream)
_cpu_stream.device, _cpu_stream.priority, _cpu_stream._stream = None, 2, None


def current_stream(device=None) -> Stream:
    if not _cuda():
        return _cpu_stream
    return Stream(device, stream=torch.cuda.current_stream(
        _dev_id(device)))


def set_stream(stream: Stream) -> Stream:
    """Make `stream` current; returns the stream it replaces."""
    prev = current_stream()
    if stream._stream is not None:
        torch.cuda.set_stream(stream._stream)
    return prev


class stream_guard:
    """Context: ops run on `stream`."""

    def __init__(self, stream=None):
        self.stream = stream

    def __enter__(self):
        self._prev = set_stream(self.stream or current_stream())
        return self.stream

    def __exit__(self, *exc):
        set_stream(self._prev)
        return False
