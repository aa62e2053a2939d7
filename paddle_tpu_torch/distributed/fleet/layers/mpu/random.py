"""Model-parallel RNG state tracking: the port of
`paddle_tpu/distributed/fleet/layers/mpu/random.py` (Paddle's random.py
`RNGStatesTracker`).

Named RNG states, so dropout inside a tensor-parallel region differs
across mp ranks while ordinary dropout stays the same on every rank. A
state is its own set of explicit `torch.Generator`s, one a device, seeded
from the state's seed (`core/rng.py`'s layout); `rng_state(name)` makes
them the global stream for the scope and keeps where they got to.
Values cannot match the reference's: jax threefry against torch Philox.
"""
from __future__ import annotations

import contextlib
from typing import Dict

from .....core import rng as rng_mod

MODEL_PARALLEL_RNG = "model_parallel_rng"


class _State:
    """One named stream: its seed and its generators by device."""

    def __init__(self, seed: int):
        self.seed = int(seed)
        self.gens: Dict = {}

    def initial_seed(self) -> int:
        return self.seed


class RNGStatesTracker:
    def __init__(self):
        self.states_: Dict[str, _State] = {}
        self.seeds_ = set()

    def reset(self):
        self.states_ = {}
        self.seeds_ = set()

    def get_states_tracker(self):
        return {n: (s.seed, [(str(d), g.get_state())
                             for d, g in s.gens.items()])
                for n, s in self.states_.items()}

    def set_states_tracker(self, states):
        import torch

        for n, (seed, gens) in states.items():
            st = self.states_.setdefault(n, _State(seed))
            st.seed = int(seed)
            for dev, state in gens:
                g = st.gens.get(torch.device(dev))
                if g is None:
                    g = st.gens[torch.device(dev)] = torch.Generator(
                        device=torch.device(dev))
                g.set_state(state)

    def add(self, name: str, seed: int):
        if seed in self.seeds_:
            raise ValueError(f"seed {seed} already exists")
        self.seeds_.add(seed)
        if name in self.states_:
            raise ValueError(f"state {name} already exists")
        self.states_[name] = _State(seed)

    @contextlib.contextmanager
    def rng_state(self, name: str = MODEL_PARALLEL_RNG):
        if name not in self.states_:
            raise ValueError(f"state {name} does not exist")
        st = self.states_[name]
        with rng_mod._lock:
            saved = rng_mod._seed[0], dict(rng_mod._gens)
            rng_mod._seed[0] = st.seed
            rng_mod._gens.clear()
            rng_mod._gens.update(st.gens)
        try:
            yield
        finally:
            with rng_mod._lock:
                st.gens = dict(rng_mod._gens)
                rng_mod._seed[0] = saved[0]
                rng_mod._gens.clear()
                rng_mod._gens.update(saved[1])


RNG_STATE_TRACKER = RNGStatesTracker()


def get_rng_state_tracker() -> RNGStatesTracker:
    return RNG_STATE_TRACKER


def model_parallel_random_seed(seed: int = 0):
    """Reference: random.py model_parallel_random_seed: the global stream
    seeded with `seed`, the model-parallel one with seed + 1024 + the mp
    rank."""
    from ...base.topology import get_hcg

    hcg = get_hcg()
    mp_rank = hcg.get_model_parallel_rank() if hcg else 0
    RNG_STATE_TRACKER.reset()
    rng_mod.seed(seed)
    RNG_STATE_TRACKER.add(MODEL_PARALLEL_RNG, seed + 1024 + mp_rank)


def determinate_seed(name: str) -> int:
    s = RNG_STATE_TRACKER.states_.get(name)
    return s.initial_seed() if s else 0
