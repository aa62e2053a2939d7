"""CUDA-graph capture of the port's decode loops, with the kernels'
launch counts kept true across replays.

The reference compiles a decode loop into one program (a `lax.scan` of
decode steps inside `jax.jit`, one executable per tick signature); the
torch counterpart is a captured `torch.cuda.CUDAGraph`, replayed with
one host call. The kernels' wrappers launch on torch's current stream
and read no device value, so capture records them like any other op.

Each wrapper counts a launch in Python where it calls its C entry
(`build.Kernel.launches`, `Kernel.paths`). Under capture that Python
runs once and the kernels are only recorded; a replay runs them with no
Python at all. :class:`CapturedGraph` takes each kernel's count delta
over the capture back out and adds it again on every replay, so the
counts say how many times each kernel ran on the card.

A capture or replay error raises: nothing falls back to eager
execution. Python's cyclic garbage collector is kept out of a capture:
a dead engine's graph, freed by the collector inside another capture,
would destroy its CUDA graph there, which the driver refuses while a
stream captures, and that invalidates the capture (torch's capture
context no longer collects garbage before it begins).
"""
from __future__ import annotations

import gc
from typing import Callable, Dict, Iterable, Tuple

import torch

from . import KERNELS

__all__ = ["CapturedGraph", "warm_up"]

_Counts = Dict[str, Tuple[int, Dict[str, int]]]


def _counts() -> _Counts:
    return {k.name: (k.launches, dict(k.paths)) for k in KERNELS}


def warm_up(fn: Callable, stream: torch.cuda.Stream):
    """Run fn once eagerly on `stream` (the stream a capture then uses),
    as torch asks before a capture: libraries load, the kernels build,
    cuBLAS makes its workspace for that stream. Returns fn's result."""
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        out = fn()
    torch.cuda.current_stream().wait_stream(stream)
    return out


class CapturedGraph:
    """fn captured into one CUDA graph; `outputs` is what fn returned
    during the capture (tensors in the graph's pool, rewritten by every
    replay). `delta` holds each kernel's launches (and launches by path)
    in one replay. `generators` are the torch.Generators fn draws from:
    each is registered with the graph, so a replay draws fresh numbers
    from the generator's current state and advances it."""

    def __init__(self, fn: Callable, pool=None, stream=None,
                 generators: Iterable[torch.Generator] = ()):
        self.graph = torch.cuda.CUDAGraph()
        for gen in generators:
            self.graph.register_generator_state(gen)
        before = _counts()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(self.graph, pool=pool, stream=stream):
                self.outputs = fn()
        finally:
            if collecting:
                gc.enable()
            after = _counts()
            for k in KERNELS:               # the capture ran nothing
                k.launches, k.paths = before[k.name][0], before[k.name][1]
        self.delta: _Counts = {}
        for name, (n, paths) in after.items():
            n0, paths0 = before[name]
            moved = {p: c - paths0.get(p, 0) for p, c in paths.items()
                     if c != paths0.get(p, 0)}
            if n != n0:
                self.delta[name] = (n - n0, moved)

    def replay(self):
        """Run the graph once and count its launches; returns `outputs`."""
        self.graph.replay()
        for k in KERNELS:
            n, paths = self.delta.get(k.name, (0, {}))
            if n:
                k.launches += n
                for p, c in paths.items():
                    k.paths[p] = k.paths.get(p, 0) + c
        return self.outputs
