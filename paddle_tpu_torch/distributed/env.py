"""Distributed environment: rank and world discovery — the port of
`paddle_tpu/distributed/env.py`.

`get_rank` / `get_world_size` read what a launcher sets: paddle's
`PADDLE_TRAINER_ID` / `PADDLE_TRAINERS_NUM` first, then torch's `RANK` /
`WORLD_SIZE` (`torchrun`, `torch.multiprocessing` launchers); with
neither, an initialized default process group, else rank 0 of a world
of one. `ParallelEnv` is the reference's view of the same.
"""
from __future__ import annotations

import os

__all__ = ["get_rank", "get_world_size", "ParallelEnv"]


def _from_env(*names):
    for n in names:
        v = os.environ.get(n)
        if v is not None:
            return int(v)
    return None


def get_rank() -> int:
    v = _from_env("PADDLE_TRAINER_ID", "RANK")
    if v is not None:
        return v
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def get_world_size() -> int:
    v = _from_env("PADDLE_TRAINERS_NUM", "WORLD_SIZE")
    if v is not None:
        return v
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


class ParallelEnv:
    @property
    def rank(self):
        return get_rank()

    @property
    def local_rank(self):
        v = _from_env("PADDLE_LOCAL_RANK", "LOCAL_RANK")
        return get_rank() if v is None else v

    @property
    def world_size(self):
        return get_world_size()

    @property
    def nranks(self):
        return get_world_size()

    @property
    def dev_id(self):
        return self.local_rank
