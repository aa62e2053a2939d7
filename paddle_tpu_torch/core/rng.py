"""Random number generation over explicit `torch.Generator`s.

Port of `paddle_tpu/core/rng.py`. The reference splits a jax PRNG key on
every draw; here one `torch.Generator` a device (the CPU's and each
card's) holds the stream, all seeded by `seed`. `consumption_count`
counts draws from the global stream, as the reference's does, so the
dispatch cache and tests can tell a random op from a pure one. A draw
with a nonzero per-op seed uses a fresh generator of that seed (the
reference's `seed_or_next`). Values cannot match the reference's: jax
threefry against torch Philox.
"""
from __future__ import annotations

import threading
from typing import Dict, List

import torch

_lock = threading.Lock()
_seed = [0]
_gens: Dict[torch.device, torch.Generator] = {}
_consumed = [0]


class Generator:
    """paddle's Generator over the global streams: `manual_seed` reseeds
    every device's generator."""

    def manual_seed(self, s: int):
        seed(s)
        return self

    def initial_seed(self) -> int:
        return _seed[0]

    def get_state(self):
        return get_rng_state()

    def set_state(self, states):
        set_rng_state(states)


default_generator = Generator()


def _key(device) -> torch.device:
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def generator(device) -> torch.Generator:
    """The global stream's generator on `device` (made on first use,
    seeded with the current seed)."""
    d = _key(device)
    g = _gens.get(d)
    if g is None:
        with _lock:
            g = _gens.get(d)
            if g is None:
                g = torch.Generator(device=d)
                g.manual_seed(_seed[0])
                _gens[d] = g
    return g


def seed(s: int):
    """paddle.seed parity: reseed every device's generator."""
    with _lock:
        _seed[0] = int(s)
        for g in _gens.values():
            g.manual_seed(_seed[0])
    return default_generator


def consumption_count() -> int:
    return _consumed[0]


def next_generator(device) -> torch.Generator:
    """The generator a draw on `device` takes from the global stream."""
    _consumed[0] += 1
    return generator(device)


def seed_or_next(op_seed: int, device) -> torch.Generator:
    """The op-level seeding rule of every random kernel: a nonzero per-op
    seed gives a fixed generator (a reproducible op), 0 draws from the
    global stream."""
    if op_seed:
        g = torch.Generator(device=_key(device))
        g.manual_seed(int(op_seed))
        return g
    return next_generator(device)


def get_rng_state() -> List:
    """[(device, state)] for every generator made so far."""
    return [(str(d), g.get_state()) for d, g in _gens.items()]


def set_rng_state(states) -> None:
    for dev, state in states:
        generator(dev).set_state(state)
