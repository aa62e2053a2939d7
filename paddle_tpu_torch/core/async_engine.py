"""Pipelined eager execution on a CUDA stream: the in-flight step queue.

Port of `paddle_tpu/core/async_engine.py`; the contract is MIGRATION.md
"Async eager semantics". torch already enqueues card work without
waiting; this module bounds how far the host runs ahead and makes the
points where values materialize explicit:

- ``mark_step(tensors, tag)`` is called at step boundaries
  (`Optimizer.step`). On the card it records a `torch.cuda.Event` on the
  current stream: that event is the step in flight. When more than
  ``depth()`` steps are in flight the host waits on the OLDEST event
  (backpressure), so host run-ahead, and the activation memory it keeps
  alive, stays bounded. At depth 0 every mark waits on its own event
  (synchronous eager, for debugging).
- ``scalar_fetch(tensor, tag)`` is the device-to-host point behind
  `Tensor.numpy()` / `item()` / `__float__`: it counts the fetch and
  retires the steps whose events have completed; the copy itself waits
  only for the stream work that produces the value.
- ``wait_for(tasks)`` waits on collective handles (the
  DataParallel reducer's buckets) and returns the seconds waited;
- ``drain()`` waits for every in-flight step; ``synchronize()`` drains
  and then waits for the whole device.

On the CPU torch runs every op before it returns, so a step is complete
when it is marked: nothing is queued, and the counters still count.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Iterable

import torch

from . import flags

_lock = threading.Lock()
_queue: deque = deque()   # (tag, torch.cuda.Event) in dispatch order
_stats = {"steps_marked": 0, "backpressure_waits": 0, "sync_fetches": 0,
          "drains": 0, "max_depth_seen": 0}
_wait_s = [0.0]


def depth() -> int:
    """Steps that may be in flight before `mark_step` waits; 0 means
    synchronous."""
    return max(0, int(flags.flag_value("eager_async_depth")))


def in_flight() -> int:
    return len(_queue)


def stats() -> dict:
    out = dict(_stats)
    out["in_flight"] = len(_queue)
    out["depth"] = depth()
    out["wait_s"] = _wait_s[0]
    return out


def reset_stats():
    for k in _stats:
        _stats[k] = 0
    _wait_s[0] = 0.0


def _device_of(tensors: Iterable[Any]):
    for t in tensors:
        data = getattr(t, "_data", t)
        if isinstance(data, torch.Tensor) and data.is_cuda:
            return data.device
    return None


def _record(dev):
    """The event that marks a step: recorded on the device's current
    stream after the step's work."""
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(dev))
    return ev


def _wait(ev) -> None:
    t0 = time.perf_counter()
    ev.synchronize()
    _wait_s[0] += time.perf_counter() - t0


def mark_step(tensors: Iterable[Any] = (), tag: str = "step"):
    """Note a step's dispatch. On the card, record its event and wait on
    the oldest once more than ``depth()`` are in flight (at depth 0, on
    this one)."""
    _stats["steps_marked"] += 1
    dev = _device_of(tensors)
    if dev is None:
        return
    ev = _record(dev)
    d = depth()
    if d == 0:
        _wait(ev)
        return
    with _lock:
        _queue.append((tag, ev))
        overflow = []
        while len(_queue) > d:
            overflow.append(_queue.popleft())
        _stats["max_depth_seen"] = max(_stats["max_depth_seen"], len(_queue))
    for _tag, old in overflow:
        _stats["backpressure_waits"] += 1
        _wait(old)


def _retire_ready():
    with _lock:
        while _queue and _queue[0][1].query():
            _queue.popleft()


def scalar_fetch(tensor, tag: str = "tensor"):
    """The device-to-host sync point: count it and retire finished
    steps. The caller's copy waits for the value itself."""
    _stats["sync_fetches"] += 1
    if _queue:
        _retire_ready()
    return tensor


def wait_for(tasks: Iterable[Any]) -> float:
    """Wait on each handle (`distributed.collective.Task`, or anything
    with `wait()`); the seconds the host waited."""
    t0 = time.perf_counter()
    for t in tasks:
        t.wait()
    dt = time.perf_counter() - t0
    _wait_s[0] += dt
    return dt


def drain():
    """Wait for every in-flight step and clear the queue."""
    with _lock:
        groups = list(_queue)
        _queue.clear()
    _stats["drains"] += 1
    for _tag, ev in groups:
        _wait(ev)


def synchronize():
    """paddle.device.synchronize: drain, then wait for the card."""
    drain()
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
