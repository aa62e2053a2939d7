"""`paddle.distributed.spawn` — the port of
`paddle_tpu/distributed/spawn.py`: `nprocs` worker processes running
`func(*args)` over `torch.multiprocessing` (the "spawn" start method),
each with its rank's env set, joined; a worker that raises has its
traceback raised in the parent.

Each worker gets paddle's `PADDLE_TRAINER_ID`, `PADDLE_TRAINERS_NUM`,
`PADDLE_LOCAL_RANK` and `PADDLE_MASTER`, and torch's `RANK`,
`WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR` and `MASTER_PORT` (a free port
on this host unless `master_port=` names one), so
`collective.init_parallel_env()` forms the group over torch's TCPStore,
hosted by rank 0.
"""
from __future__ import annotations

import os
import socket
from typing import Tuple

import torch.multiprocessing as mp

__all__ = ["spawn", "free_port", "rank_env"]


def free_port() -> int:
    """A TCP port on localhost that no one listens on right now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_env(rank: int, nprocs: int, port: int, local_rank=None,
             addr: str = "127.0.0.1") -> dict:
    """The env a worker of rank `rank` in a world of `nprocs` needs."""
    local = rank if local_rank is None else local_rank
    return {"PADDLE_TRAINER_ID": str(rank),
            "PADDLE_TRAINERS_NUM": str(nprocs),
            "PADDLE_LOCAL_RANK": str(local),
            "PADDLE_MASTER": f"{addr}:{port}",
            "RANK": str(rank), "WORLD_SIZE": str(nprocs),
            "LOCAL_RANK": str(local), "MASTER_ADDR": addr,
            "MASTER_PORT": str(port)}


def _worker(rank, func, args, nprocs, port):
    os.environ.update(rank_env(rank, nprocs, port))
    func(*args)


def spawn(func, args: Tuple = (), nprocs: int = 1, join: bool = True,
          daemon: bool = False, **options):
    """Start `nprocs` processes running `func(*args)` (func must be
    importable by name: the spawn start method pickles it). join: wait
    for all and raise the first failure with its worker's traceback
    (torch's `ProcessRaisedException`, or `ProcessExitedException` for a
    worker killed by a signal) and return the processes; else return
    the context at once, whose `processes` and `join()` are torch's."""
    port = int(options.get("master_port") or free_port())
    ctx = mp.start_processes(_worker, args=(func, tuple(args), nprocs, port),
                             nprocs=nprocs, join=False, daemon=daemon,
                             start_method=options.get("start_method",
                                                      "spawn"))
    if not join:
        return ctx
    while not ctx.join():
        pass
    return ctx.processes
