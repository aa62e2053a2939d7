"""The distributed launcher — `python -m paddle_tpu_torch.distributed.launch
--nproc_per_node N script.py [args]`, the port of
`paddle_tpu/distributed/launch/main.py`.

It starts one worker process a local card (every visible card, or
`--nproc_per_node`; on a host without a card `--nproc_per_node` is
required: CPU workers) and sets each worker's paddle env
(`PADDLE_TRAINER_ID`, `PADDLE_TRAINERS_NUM`, `PADDLE_LOCAL_RANK`,
`PADDLE_MASTER`, `PADDLE_JOB_ID`) and torch's (`MASTER_ADDR`,
`MASTER_PORT`, `RANK`, `WORLD_SIZE`, `LOCAL_RANK`): the workers'
`collective.init_parallel_env()` rendezvouses through torch's TCPStore,
hosted by rank 0. Each worker's output goes to `<log_dir>/workerlog.<rank>`.
The launcher waits for every worker, stops the rest when one fails and
exits with the first failure's code.

Several nodes: `--nnodes N --rank r --master host:port` on each. The
reference's restarts (`--max_restart` above 0) and elastic worlds
(`--nnodes min:max`) come with ROADMAP item 7d: asking for them raises.
"""
from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import time
from typing import List, Optional

from ..spawn import free_port, rank_env

__all__ = ["parse_args", "Pod", "launch", "main"]


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(
        prog="paddle_tpu_torch.distributed.launch",
        description="Launch distributed training, one process a card")
    p.add_argument("--master", type=str, default=None,
                   help="node 0's ip:port for the rendezvous")
    p.add_argument("--nnodes", type=str, default="1",
                   help="node count (min:max, elastic, is ROADMAP item 7d)")
    p.add_argument("--rank", type=int, default=-1, help="this node's rank")
    p.add_argument("--nproc_per_node", type=int, default=None,
                   help="workers on this node (default: its card count)")
    p.add_argument("--devices", "--gpus", type=str, default=None,
                   help="visible card ids for this node")
    p.add_argument("--log_dir", type=str, default="log")
    p.add_argument("--job_id", type=str, default="default")
    p.add_argument("--max_restart", type=int, default=0)
    p.add_argument("--run_mode", type=str, default="collective")
    p.add_argument("training_script", type=str)
    p.add_argument("training_script_args", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def _nproc(args) -> int:
    if args.nproc_per_node:
        return args.nproc_per_node
    if args.devices:
        return len(args.devices.split(","))
    import torch
    n = torch.cuda.device_count()
    if n == 0:
        raise ValueError("no card on this node: pass --nproc_per_node for "
                         "CPU workers")
    return n


class Pod:
    """A node's worker processes (reference: launch/job/pod.py)."""

    def __init__(self, args):
        self.args = args
        self.procs: List[subprocess.Popen] = []
        self.logs = []

    def spawn(self, node_rank: int, nnodes: int, addr: str, port: int):
        nproc = _nproc(self.args)
        os.makedirs(self.args.log_dir, exist_ok=True)
        world = nnodes * nproc
        for lr in range(nproc):
            rank = node_rank * nproc + lr
            env = dict(os.environ)
            env.update(rank_env(rank, world, port, local_rank=lr,
                                addr=addr))
            env["PADDLE_JOB_ID"] = self.args.job_id
            if self.args.devices:
                env["CUDA_VISIBLE_DEVICES"] = self.args.devices
            logf = open(os.path.join(self.args.log_dir,
                                     f"workerlog.{rank}"), "a")
            cmd = [sys.executable, "-u", self.args.training_script,
                   *self.args.training_script_args]
            self.procs.append(subprocess.Popen(cmd, env=env, stdout=logf,
                                               stderr=subprocess.STDOUT))
            self.logs.append(logf)

    def poll(self) -> Optional[int]:
        """None while any worker runs; else 0 or the first failure's code."""
        alive = False
        for p in self.procs:
            rc = p.poll()
            if rc is None:
                alive = True
            elif rc != 0:
                return rc
        return None if alive else 0

    def watch(self) -> int:
        """Block until all exit (0) or one fails (its code)."""
        while True:
            rc = self.poll()
            if rc is not None:
                return rc
            time.sleep(0.2)

    def terminate(self):
        for p in self.procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        deadline = time.time() + 10
        for p in self.procs:
            try:
                p.wait(timeout=max(0.1, deadline - time.time()))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        for f in self.logs:
            f.close()
        self.procs.clear()
        self.logs.clear()


def launch(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    if ":" in str(args.nnodes) or os.environ.get("PADDLE_ELASTIC_JOB_ID"):
        raise NotImplementedError(
            "elastic worlds (--nnodes min:max) come with ROADMAP item 7d")
    if args.max_restart > 0:
        raise NotImplementedError(
            "restarts (--max_restart > 0) come with ROADMAP item 7d "
            "(elastic)")
    nnodes = int(args.nnodes)
    node_rank = args.rank if args.rank >= 0 else int(
        os.environ.get("PADDLE_NODE_RANK", "0"))
    if args.master:
        addr, port = args.master.rsplit(":", 1)
        port = int(port)
    elif nnodes > 1:
        raise ValueError("--nnodes above 1 needs --master ip:port")
    else:
        addr, port = "127.0.0.1", free_port()
    pod = Pod(args)
    try:
        pod.spawn(node_rank, nnodes, addr, port)
        rc = pod.watch()
    finally:
        pod.terminate()
    if rc == 0:
        print(f"[launch] job {args.job_id} finished OK")
    else:
        print(f"[launch] a worker failed (exit {rc}); see "
              f"{args.log_dir}/workerlog.*", file=sys.stderr)
    return rc


def main():  # pragma: no cover - thin CLI shim
    sys.exit(launch())
